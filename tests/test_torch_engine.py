"""Slice 1 of the PyTorch port end to end: the port's
``EqlbEngine.equilibrate`` (fused semi-explicit path, f64, on CPU) against
the JAX engine on the same inputs, within 1e-11 * max(1, max|x|) — the bar
of tests/test_combine_paths.py.

The JAX engines are built once per (mesh, k) with three RHS and padded patch
axes (``pad_to_multiple``), so their host tables carry pad rows for the
``from_host_tables`` case; every case feeds fresh data through the same
compiled program."""

import numpy as np
import pytest
import torch

from dolfinx_eqlb_tpu.eqlb.engine import EqlbEngine as JaxEngine
from dolfinx_eqlb_tpu.eqlb.patches import build_patches as jax_patches
from dolfinx_eqlb_tpu.fem import FunctionSpace as JaxSpace
from dolfinx_eqlb_tpu.mesh import generators as jax_gen

from dolfinx_eqlb_tpu_torch.eqlb.engine import EqlbEngine
from dolfinx_eqlb_tpu_torch.eqlb.patches import build_patches
from dolfinx_eqlb_tpu_torch.fem import FunctionSpace
from dolfinx_eqlb_tpu_torch.mesh import generators as gen

torch.set_num_threads(2)

N_RHS = 3  # the JAX engines' batch; smaller n_rhs cases use its first rows

_MESHES = {
    "crossed": lambda g: g.unit_square(3),
    "unstructured": lambda g: g.unit_square_unstructured(4),
}


@pytest.fixture(scope="module")
def jax_engines():
    cache = {}

    def get(mesh, k):
        if (mesh, k) not in cache:
            msh = _MESHES[mesh](jax_gen)
            cache[mesh, k] = JaxEngine(JaxSpace(msh, "RT", k),
                                       jax_patches(msh), pad_to_multiple=8)
        return cache[mesh, k]

    return get


def _data(msh, k, seed, kinds=False):
    rng = np.random.default_rng(seed)
    nc, nf, ndg = msh.num_cells, msh.num_facets, k * (k + 1) // 2
    dp = rng.normal(size=(N_RHS, nc, 2, ndg))
    dr = rng.normal(size=(N_RHS, nc, ndg))
    fk = np.where(msh.is_boundary_facet, 1, 0).astype(np.int8)[None].repeat(
        N_RHS, 0)
    bv = np.zeros((N_RHS, nf, k))
    if kinds:
        # per RHS, a random split of the boundary into primal-Dirichlet (1)
        # and flux-essential (2) facets, with data on the essential ones
        bf = msh.boundary_facets
        fk[:, bf] = rng.integers(1, 3, size=(N_RHS, len(bf)))
        bv[:, bf] = rng.normal(size=(N_RHS, len(bf), k))
        bv[fk != 2] = 0.0
    return dp, dr, fk, bv


def _port(mesh, k, **kw):
    msh = _MESHES[mesh](gen)
    return EqlbEngine(FunctionSpace(msh, "RT", k), build_patches(msh),
                      dtype=torch.float64, device="cpu", **kw)


def _check(x_port, x_jax):
    x_jax = np.asarray(x_jax)
    assert x_port.shape == x_jax.shape
    assert np.isfinite(x_port).all()
    tol = 1e-11 * max(1.0, np.abs(x_jax).max())
    assert np.abs(x_port - x_jax).max() <= tol


@pytest.mark.parametrize("mesh", sorted(_MESHES))
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("n_rhs", [1, 2, 3])
def test_equilibrate_matches_jax(jax_engines, mesh, k, n_rhs):
    """k = 4 takes K1's global route on every reduced system."""
    jeng = jax_engines(mesh, k)
    dp, dr, fk, bv = _data(jeng.mesh, k, seed=10 * k + n_rhs)
    x_jax = jeng.equilibrate(dp, dr, fk, bv)
    eng = _port(mesh, k)
    x = eng.equilibrate(dp[:n_rhs], dr[:n_rhs], fk[:n_rhs], bv[:n_rhs])
    _check(x.numpy(), np.asarray(x_jax)[:n_rhs])


@pytest.mark.parametrize("mode", ["semiexplicit", "kkt"])
def test_tensor_inputs(mode):
    """Tensors go in as they are, one with requires_grad included, and give
    exactly the NumPy-input result; a tensor on another device raises."""
    eng = _port("crossed", 2)
    eng.mode = mode
    dp, dr, fk, bv = _data(eng.mesh, 2, seed=12, kinds=True)
    x_np = eng.equilibrate(dp, dr, fk, bv)
    dp_t = torch.tensor(dp, requires_grad=True)
    x_t = eng.equilibrate(dp_t, torch.as_tensor(dr), torch.as_tensor(fk),
                          torch.as_tensor(bv))
    assert not x_t.requires_grad
    assert torch.equal(x_t, x_np)
    # f32 tensors are cast to the engine's dtype on their device
    x_32 = eng.equilibrate(torch.as_tensor(dp, dtype=torch.float32),
                           torch.as_tensor(dr, dtype=torch.float32), fk, bv)
    assert torch.equal(x_32, eng.equilibrate(dp.astype(np.float32),
                                             dr.astype(np.float32), fk, bv))
    with pytest.raises(ValueError, match="engine runs on"):
        eng.equilibrate(torch.as_tensor(dp, device="meta"), dr, fk, bv)


@pytest.mark.parametrize("mesh", sorted(_MESHES))
def test_facet_kinds_and_flux_data(jax_engines, mesh):
    k = 2
    jeng = jax_engines(mesh, k)
    dp, dr, fk, bv = _data(jeng.mesh, k, seed=5, kinds=True)
    assert (fk == 2).any() and (fk == 1).any() and (bv != 0).any()
    x = _port(mesh, k).equilibrate(dp, dr, fk, bv)
    _check(x.numpy(), jeng.equilibrate(dp, dr, fk, bv))


def test_chunked_buckets(jax_engines):
    jeng = jax_engines("crossed", 2)
    dp, dr, fk, bv = _data(jeng.mesh, 2, seed=6, kinds=True)
    eng = _port("crossed", 2, max_patches_per_bucket=3)
    assert any(len(key) == 3 for key in eng.buckets)  # chunk keys
    assert max(b.npatches for b in eng.buckets.values()) <= 3
    _check(eng.equilibrate(dp, dr, fk, bv).numpy(),
           jeng.equilibrate(dp, dr, fk, bv))


def test_from_host_tables(jax_engines):
    """The port's device stages on the JAX engine's own host tables (with
    its pad rows, gdofs == ndofs)."""
    jeng = jax_engines("unstructured", 2)
    assert any(t["gdofs"].shape[0] > b.npatches
               for t, b in ((jeng.tables[key], jeng.buckets[key])
                            for key in jeng.tables))
    dp, dr, fk, bv = _data(jeng.mesh, 2, seed=8, kinds=True)
    eng = EqlbEngine.from_host_tables(
        jeng.V, jeng.buckets, jeng.tables, jeng.se_static, jeng.ref,
        dtype=torch.float64, device="cpu")
    _check(eng.equilibrate(dp, dr, fk, bv).numpy(),
           jeng.equilibrate(dp, dr, fk, bv))


def test_torch_solver(jax_engines):
    """solver="torch" (torch.linalg.solve) in place of K1."""
    jeng = jax_engines("crossed", 3)
    dp, dr, fk, bv = _data(jeng.mesh, 3, seed=9, kinds=True)
    eng = _port("crossed", 3)
    eng.solver = "torch"
    _check(eng.equilibrate(dp, dr, fk, bv).numpy(),
           jeng.equilibrate(dp, dr, fk, bv))


def test_default_device_is_the_card(monkeypatch):
    """Without device=, the engine runs on the card; with none, it raises
    instead of falling back to the CPU."""
    eng = _port("crossed", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EqlbEngine(eng.V, eng.buckets)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EqlbEngine.from_host_tables(eng.V, eng.buckets, eng.tables,
                                    eng.se_static, eng.ref)


def test_transposed_inputs(jax_engines):
    jeng = jax_engines("crossed", 1)
    dp, dr, fk, bv = _data(jeng.mesh, 1, seed=4)
    eng = _port("crossed", 1)
    dpT, drT = eng.put_transposed(dp, dr)
    x = eng.equilibrate(dpT, drT, fk, bv, transposed_inputs=True)
    _check(x.numpy(), jeng.equilibrate(dp, dr, fk, bv))
