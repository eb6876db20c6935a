"""Plain versions of the port's kernels against the JAX package's Pallas
kernels (run in interpret mode off the TPU, as the JAX package's own tests
run them): K1 and K3, the batch-last and batch-major pivot-free solves, and
K2 and K4, the dof combine and its double-single variant.  The CUDA kernels
themselves run only on the card; ``chip_smoke.py`` holds them against these
plain versions there."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dolfinx_eqlb_tpu.eqlb.engine import EqlbEngine as JaxEngine
from dolfinx_eqlb_tpu.eqlb.patches import build_patches as jax_patches
from dolfinx_eqlb_tpu.fem import FunctionSpace as JaxSpace
from dolfinx_eqlb_tpu.mesh import unit_square as jax_unit_square
from dolfinx_eqlb_tpu.ops.patch_solve import batched_kkt_solve as jax_k3
from dolfinx_eqlb_tpu.ops.patch_solve import batched_kkt_solve_bl as jax_k1

from dolfinx_eqlb_tpu_torch.ops.lane_select import (
    combine_gather, combine_gather_plain, ds_combine_gather,
    ds_combine_gather_plain,
)
from dolfinx_eqlb_tpu_torch.ops.patch_solve import (
    batched_kkt_solve, batched_kkt_solve_bl, batched_kkt_solve_bl_plain,
    batched_kkt_solve_plain,
)

torch.set_num_threads(2)


def _spd_batch(D, R, X, seed):
    """Random SPD systems, batch-last: A (D, D, X), b (D, R, X)."""
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(X, D, D))
    A = B @ np.swapaxes(B, 1, 2) + D * np.eye(D)
    b = rng.normal(size=(X, D, R))
    return (np.ascontiguousarray(np.moveaxis(A, 0, -1)),
            np.ascontiguousarray(np.moveaxis(b, 0, -1)))


@pytest.mark.parametrize("D", [4, 6, 9])
@pytest.mark.parametrize("rhs", ["one", "square"])
def test_k1_plain_matches_pallas_and_linalg(D, rhs):
    R = 1 if rhs == "one" else D
    A, b = _spd_batch(D, R, 200, seed=D * 10 + R)
    x_jax = np.asarray(jax_k1(jnp.asarray(A, jnp.float64),
                              jnp.asarray(b, jnp.float64)))
    At = torch.tensor(A, dtype=torch.float64)
    bt = torch.tensor(b, dtype=torch.float64)
    x_plain = batched_kkt_solve_bl_plain(At, bt).numpy()
    x_lin = torch.linalg.solve(At.permute(2, 0, 1),
                               bt.permute(2, 0, 1)).permute(1, 2, 0).numpy()
    scale = np.abs(x_jax).max()
    assert np.abs(x_plain - x_jax).max() <= 1e-12 * scale
    assert np.abs(x_plain - x_lin).max() <= 1e-12 * scale


def test_k1_wrapper_on_cpu_is_the_plain_version():
    A, b = _spd_batch(5, 5, 64, seed=1)
    At, bt = torch.tensor(A), torch.tensor(b)
    before = batched_kkt_solve_bl.launches
    torch.testing.assert_close(batched_kkt_solve_bl(At, bt),
                               batched_kkt_solve_bl_plain(At, bt),
                               rtol=0, atol=0)
    assert batched_kkt_solve_bl.launches == before  # no kernel launch on CPU


def test_k1_wrapper_rejects_bad_shapes():
    A = torch.zeros(4, 4, 8, dtype=torch.float64)
    with pytest.raises(ValueError):
        batched_kkt_solve_bl(A, torch.zeros(3, 1, 8, dtype=torch.float64))
    with pytest.raises(ValueError):
        batched_kkt_solve_bl(A, torch.zeros(4, 1, 8, dtype=torch.float32))
    with pytest.raises(ValueError):  # the kernel needs contiguous operands
        batched_kkt_solve_bl(A.transpose(0, 1),
                             torch.zeros(4, 1, 8, dtype=torch.float64))


def test_k2_plain_matches_pallas_combine(monkeypatch):
    """The JAX engine's n_rhs = 1 combine through the interpret-mode Pallas
    lane select, on the engine's own combine tables and a random flat
    vector, against the port's plain combine_gather on the same tables."""
    monkeypatch.setitem(os.environ, "EQLB_FORCE_LANE_SELECT", "1")
    monkeypatch.setitem(os.environ, "EQLB_NO_DS_COMBINE", "1")
    msh = jax_unit_square(3)
    eng = JaxEngine(JaxSpace(msh, "RT", 2), jax_patches(msh))
    assert not eng._use_elem_combine(1) and not eng._use_ds_combine(1)
    _, refd = eng._device_tables()
    cm = eng._combine
    total = cm["total"]
    rng = np.random.default_rng(7)
    flat = rng.normal(size=(1, eng._flat_len))
    x_jax = np.asarray(eng._combine_flat(jnp.asarray(flat), refd))

    ndofs, nfk = eng.V.ndofs, cm["nfk"]
    src = np.full((ndofs, 3), total, dtype=np.int32)
    src[:, :2] = cm["src01"]
    src[nfk:, 2] = cm["src2"][:, 0]
    flat_pad = np.concatenate([flat, np.zeros((1, total + 1 - flat.shape[1]))],
                              axis=1)
    x_port = combine_gather_plain(torch.tensor(flat_pad), torch.tensor(src),
                                  nfk).numpy()
    assert x_port.shape == x_jax.shape
    assert np.abs(x_port - x_jax).max() <= 1e-14 * np.abs(x_jax).max()


def test_k2_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(3)
    flat = torch.tensor(rng.normal(size=(2, 41)))
    flat[:, -1] = 0.0
    src = torch.tensor(rng.integers(0, 41, size=(17, 3)), dtype=torch.int32)
    before = combine_gather.launches
    out = combine_gather(flat, src, 6)
    torch.testing.assert_close(out, combine_gather_plain(flat, src, 6),
                               rtol=0, atol=0)
    ref = flat[:, src[:, 0].long()] + flat[:, src[:, 1].long()]
    ref[:, 6:] += flat[:, src[6:, 2].long()]
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert combine_gather.launches == before


def test_k2_wrapper_rejects_bad_tables():
    flat = torch.zeros(1, 10, dtype=torch.float64)
    with pytest.raises(ValueError):
        combine_gather(flat, torch.zeros(4, 3, dtype=torch.int64), 0)
    with pytest.raises(ValueError):
        combine_gather(flat, torch.zeros(4, 2, dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        combine_gather(flat, torch.zeros(4, 3, dtype=torch.int32), 5)
    with pytest.raises(ValueError):
        combine_gather(torch.zeros(10, 2, dtype=torch.float64).t(),
                       torch.zeros(4, 3, dtype=torch.int32), 0)


def _spd_batch_bm(lead, D, R, seed):
    """Random SPD systems, batch-major: A (*lead, D, D), b (*lead, D, R)."""
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(*lead, D, D))
    A = B @ np.swapaxes(B, -1, -2) + D * np.eye(D)
    return A, rng.normal(size=(*lead, D, R))


@pytest.mark.parametrize("D", [16, 28, 56])
def test_k3_plain_matches_pallas_and_linalg(D):
    """Leading axes (2, P) are folded, as the KKT mode's (n_rhs, P)."""
    A, b = _spd_batch_bm((2, 9), D, 1, seed=D)
    x_jax = np.asarray(jax_k3(jnp.asarray(A, jnp.float64),
                              jnp.asarray(b, jnp.float64)))
    At, bt = torch.tensor(A), torch.tensor(b)
    x_plain = batched_kkt_solve_plain(At, bt).numpy()
    x_lin = torch.linalg.solve(At, bt).numpy()
    assert x_plain.shape == x_jax.shape == b.shape
    scale = np.abs(x_jax).max()
    assert np.abs(x_plain - x_jax).max() <= 1e-12 * scale
    assert np.abs(x_plain - x_lin).max() <= 1e-12 * scale


def test_k3_wrapper_on_cpu_is_the_plain_version():
    A, b = _spd_batch_bm((2, 5), 12, 3, seed=2)
    At, bt = torch.tensor(A), torch.tensor(b)
    before = batched_kkt_solve.launches
    torch.testing.assert_close(batched_kkt_solve(At, bt),
                               batched_kkt_solve_plain(At, bt),
                               rtol=0, atol=0)
    assert batched_kkt_solve.launches == before  # no kernel launch on CPU


def test_k3_wrapper_rejects_bad_args():
    A = torch.zeros(3, 6, 6, dtype=torch.float64)
    b = torch.zeros(3, 6, 1, dtype=torch.float64)
    with pytest.raises(ValueError):  # A and b disagree on the batch
        batched_kkt_solve(A, torch.zeros(2, 6, 1, dtype=torch.float64))
    with pytest.raises(ValueError):  # A not square
        batched_kkt_solve(torch.zeros(3, 6, 5, dtype=torch.float64), b)
    with pytest.raises(ValueError):
        batched_kkt_solve(A, b.float())
    with pytest.raises(ValueError):  # the kernel needs contiguous operands
        batched_kkt_solve(A.transpose(1, 2), b)
    with pytest.raises(ValueError):  # [A | b] exceeds a block's shared memory
        batched_kkt_solve(torch.zeros(1, 200, 200, dtype=torch.float64),
                          torch.zeros(1, 200, 1, dtype=torch.float64))


def test_k4_plain_matches_pallas_ds_combine(monkeypatch):
    """The JAX engine's double-single combine (interpret-mode Pallas
    ``lane_select_ds`` on its paired tables) on a random f64 flat vector,
    against the port's plain ds_combine_gather on the same contributor
    columns: the same f32 operations in the same order."""
    monkeypatch.setitem(os.environ, "EQLB_FORCE_LANE_SELECT", "1")
    msh = jax_unit_square(3)
    eng = JaxEngine(JaxSpace(msh, "RT", 2), jax_patches(msh))
    assert eng._use_ds_combine(1)
    eng._ensure_combine_tables(1)
    _, refd = eng._device_tables()
    cm = eng._combine
    rng = np.random.default_rng(5)
    flat = rng.normal(size=(1, eng._flat_len)) * 10.0 ** rng.integers(
        -3, 4, size=(1, eng._flat_len))
    x_jax = np.asarray(eng._ds_combine(jnp.asarray(flat), refd))

    ndofs, nfk, total = eng.V.ndofs, cm["nfk"], cm["total"]
    src = np.full((ndofs, 3), total, dtype=np.int32)
    src[:, :2] = cm["src01"]
    src[nfk:, 2] = cm["src2"][:, 0]
    flat_pad = np.concatenate([flat, np.zeros((1, total + 1 - flat.shape[1]))],
                              axis=1)
    x_port = ds_combine_gather_plain(torch.tensor(flat_pad),
                                     torch.tensor(src), nfk).numpy()
    np.testing.assert_array_equal(x_port, x_jax)
    # and the double-single sum is the f64 sum to ~2^-48
    x64 = combine_gather_plain(torch.tensor(flat_pad), torch.tensor(src),
                               nfk).numpy()
    assert np.abs(x_port - x64).max() <= 1e-14 * np.abs(x64).max()


def test_k4_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(4)
    flat = torch.tensor(rng.normal(size=(2, 41)))
    flat[:, -1] = 0.0
    src = torch.tensor(rng.integers(0, 41, size=(17, 3)), dtype=torch.int32)
    before = ds_combine_gather.launches
    out = ds_combine_gather(flat, src, 6)
    torch.testing.assert_close(out, ds_combine_gather_plain(flat, src, 6),
                               rtol=0, atol=0)
    x64 = combine_gather_plain(flat, src, 6)
    assert (out - x64).abs().max() <= 1e-14 * x64.abs().max()
    assert ds_combine_gather.launches == before


def test_k4_wrapper_rejects_bad_tables():
    src = torch.zeros(4, 3, dtype=torch.int32)
    with pytest.raises(ValueError):  # double-single needs f64 data
        ds_combine_gather(torch.zeros(1, 10, dtype=torch.float32), src, 0)
    with pytest.raises(ValueError):
        ds_combine_gather(torch.zeros(1, 10, dtype=torch.float64),
                          src.long(), 0)
    with pytest.raises(ValueError):
        ds_combine_gather(torch.zeros(1, 10, dtype=torch.float64), src, 5)
