"""The port's precision routes against the JAX engine's:

* ``solver="kernel_mixed"`` — K1's plain version in f32 plus f64 residual
  corrections (``EqlbEngine._dense_solve_bl``), the reference's
  "pallas_mixed" — within 1e-9 of the f64 results, the bar of
  tests/test_mixed_precision.py, with either combine;
* ``combine="ds"`` — K4's plain version, the double-single combine — within
  1e-12 * scale of the JAX engine's double-single route and of the port's
  f64 combine, the bar of tests/test_combine_paths.py."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dolfinx_eqlb_tpu.eqlb.engine import EqlbEngine as JaxEngine
from dolfinx_eqlb_tpu.eqlb.patches import build_patches as jax_patches
from dolfinx_eqlb_tpu.fem import FunctionSpace as JaxSpace
from dolfinx_eqlb_tpu.mesh import unit_square as jax_unit_square

from dolfinx_eqlb_tpu_torch.eqlb.engine import EqlbEngine
from dolfinx_eqlb_tpu_torch.eqlb.patches import build_patches
from dolfinx_eqlb_tpu_torch.fem import FunctionSpace
from dolfinx_eqlb_tpu_torch.mesh import unit_square

torch.set_num_threads(2)


def _data(msh, k, n_rhs, seed, kinds=False):
    rng = np.random.default_rng(seed)
    nc, nf, ndg = msh.num_cells, msh.num_facets, k * (k + 1) // 2
    dp = rng.normal(size=(n_rhs, nc, 2, ndg))
    dr = rng.normal(size=(n_rhs, nc, ndg))
    fk = np.where(msh.is_boundary_facet, 1, 0).astype(np.int8)[None].repeat(
        n_rhs, 0)
    bv = np.zeros((n_rhs, nf, k))
    if kinds:
        bf = msh.boundary_facets
        fk[:, bf] = rng.integers(1, 3, size=(n_rhs, len(bf)))
        bv[:, bf] = rng.normal(size=(n_rhs, len(bf), k))
        bv[fk != 2] = 0.0
    return dp, dr, fk, bv


def _port(n, k, dtype=torch.float64, **options):
    msh = unit_square(n)
    eng = EqlbEngine(FunctionSpace(msh, "RT", k), build_patches(msh),
                     dtype=dtype, device="cpu")
    for name, value in options.items():
        setattr(eng, name, value)
    return eng


@pytest.fixture(scope="module")
def mixed_refs():
    """unit_square(5), RT2, f64 (tests/test_mixed_precision.py): the JAX
    engine's "pallas_mixed" result and the port's f64 "torch" result."""
    msh = jax_unit_square(5)
    data = _data(msh, 2, 1, seed=0)
    jeng = JaxEngine(JaxSpace(msh, "RT", 2), jax_patches(msh),
                     dtype=jnp.float64)
    jeng.solver = "pallas_mixed"
    x_jax = np.asarray(jeng.equilibrate(*data))
    x_f64 = _port(5, 2, solver="torch").equilibrate(*data).numpy()
    return data, x_jax, x_f64


@pytest.mark.parametrize("combine", ["gather", "ds"])
def test_kernel_mixed_matches_f64(mixed_refs, combine):
    data, x_jax, x_f64 = mixed_refs
    eng = _port(5, 2, solver="kernel_mixed", combine=combine)
    x = eng.equilibrate(*data).numpy()
    assert np.isfinite(x).all()
    assert np.abs(x - x_jax).max() < 1e-9
    assert np.abs(x - x_f64).max() < 1e-9


def test_kernel_mixed_refinement_does_the_work(mixed_refs):
    """Without its f64 correction the f32 factorisation misses the 1e-9
    bar more than tenfold; a second correction stays within it."""
    data, _, x_f64 = mixed_refs
    errs = {}
    for steps in (0, 2):
        eng = _port(5, 2, solver="kernel_mixed", mixed_refine_steps=steps)
        errs[steps] = np.abs(eng.equilibrate(*data).numpy() - x_f64).max()
    assert errs[0] > 1e-8 and errs[2] < 1e-9


@pytest.mark.parametrize("k", [2, 4])
def test_ds_combine_matches_jax(k, monkeypatch):
    """The JAX engine's double-single route (EQLB_FORCE_LANE_SELECT runs its
    Pallas kernels in interpret mode off the TPU)."""
    msh = jax_unit_square(3)
    data = _data(msh, k, 1, seed=11)
    monkeypatch.setitem(os.environ, "EQLB_FORCE_LANE_SELECT", "1")
    jeng = JaxEngine(JaxSpace(msh, "RT", k), jax_patches(msh))
    assert jeng._use_ds_combine(1)
    x_jax = np.asarray(jeng.equilibrate(*data))
    x = _port(3, k, combine="ds").equilibrate(*data).numpy()
    assert np.abs(x - x_jax).max() < 1e-12 * np.abs(x_jax).max()


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_ds_combine_matches_gather(k):
    msh = unit_square(3)
    data = _data(msh, k, 2, seed=40 + k, kinds=True)
    x_gather = _port(3, k).equilibrate(*data)
    x_ds = _port(3, k, combine="ds").equilibrate(*data)
    scale = x_gather.abs().max()
    assert (x_ds - x_gather).abs().max() < 1e-12 * scale


def test_options_are_checked():
    msh = unit_square(2)
    data = _data(msh, 1, 1, seed=1)
    with pytest.raises(ValueError, match="f64"):
        _port(2, 1, dtype=torch.float32, combine="ds").equilibrate(*data)
    for name in ("mode", "solver", "combine"):
        with pytest.raises(ValueError, match=f"unknown {name}"):
            _port(2, 1, **{name: "nonsense"}).equilibrate(*data)
