"""Plain versions of the port's kernels against the JAX package's Pallas
kernels (run in interpret mode off the TPU, as the JAX package's own tests
run them): K1, the batch-last pivot-free solve, and K2, the dof combine.
The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against these plain versions there."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dolfinx_eqlb_tpu.eqlb.engine import EqlbEngine as JaxEngine
from dolfinx_eqlb_tpu.eqlb.patches import build_patches as jax_patches
from dolfinx_eqlb_tpu.fem import FunctionSpace as JaxSpace
from dolfinx_eqlb_tpu.mesh import unit_square as jax_unit_square
from dolfinx_eqlb_tpu.ops.patch_solve import batched_kkt_solve_bl as jax_k1

from dolfinx_eqlb_tpu_torch.ops.lane_select import (
    combine_gather, combine_gather_plain,
)
from dolfinx_eqlb_tpu_torch.ops.patch_solve import (
    batched_kkt_solve_bl, batched_kkt_solve_bl_plain,
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
