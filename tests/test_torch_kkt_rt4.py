"""The port's KKT mode at RT4 on an unstructured mesh, where every patch
system but the boundary ones has D + R > 128: D = 130 / 156 / 182 / 208
(interior patches of 5-8 cells, 26 dofs a cell), which K3 takes on its
cluster route on the card (``k3_admits``: D + R <= 256) and the reference
pivots.  Against the JAX engine's KKT mode (``solver="xla"``, a pivoted
solve) within 1e-11 * max(1, max|x|), the bar of tests/test_torch_kkt.py,
whose data and engine it shares; the pivot-free solve of these operands
against ``torch.linalg.solve`` and their pivots are held there.

A file of its own: the JAX reference at RT4 compiles for 24-33 s on the
CPU (the module fixture).  No generator mesh up to
``unit_square_unstructured(15)`` has an interior patch of 9 cells (D = 234
at RT4, 135 at RT3), so those sizes are held on the card only
(``chip_smoke.py`` phases 8, 24 and 25)."""

import numpy as np
import pytest
import torch

from dolfinx_eqlb_tpu.eqlb.engine import EqlbEngine as JaxEngine
from dolfinx_eqlb_tpu.eqlb.patches import build_patches as jax_patches
from dolfinx_eqlb_tpu.fem import FunctionSpace as JaxSpace
from dolfinx_eqlb_tpu.mesh import generators as jax_gen

import dolfinx_eqlb_tpu_torch.eqlb.engine as port_engine
from dolfinx_eqlb_tpu_torch.ops.patch_solve import K3_CLUSTER_TILES, k3_plan
from tests.test_torch_kkt import _MESHES, _data, _port

K = 4
MESH = "unstructured7"  # unit_square_unstructured(7): 98 cells


@pytest.fixture(scope="module")
def jax_rt4():
    msh = _MESHES[MESH](jax_gen)
    eng = JaxEngine(JaxSpace(msh, "RT", K), jax_patches(msh))
    eng.mode = "kkt"
    eng.solver = "xla"
    data = _data(msh, K, seed=44)
    return data, np.asarray(eng.equilibrate(*data))


@pytest.mark.parametrize("n_rhs", [1, 2])
def test_kkt_rt4_matches_jax(jax_rt4, n_rhs, monkeypatch):
    """Every KKT system of the mesh goes to K3 (its plain version here),
    the cluster route's sizes among them, and the result matches JAX's
    pivoted solve."""
    (dp, dr, fk, bv), x_jax = jax_rt4
    assert (fk == 2).any() and (fk == 1).any() and (bv != 0).any()
    sizes, k3 = [], port_engine.batched_kkt_solve

    def counted_k3(A, b):
        sizes.append(A.shape[-1])
        return k3(A, b)

    monkeypatch.setattr(port_engine, "batched_kkt_solve", counted_k3)
    eng = _port(MESH, K)
    x = eng.equilibrate(dp[:n_rhs], dr[:n_rhs], fk[:n_rhs], bv[:n_rhs])
    assert sorted(sizes) == sorted(eng.kkt_size(key)[0] for key in eng.buckets)
    assert {130, 156, 182, 208} <= set(sizes)
    assert all(k3_plan(D, 1, torch.float64) in K3_CLUSTER_TILES[torch.float64]
               for D in sizes if D > 127)
    x = x.numpy()
    assert x.shape == x_jax[:n_rhs].shape and np.isfinite(x).all()
    tol = 1e-11 * max(1.0, np.abs(x_jax).max())
    assert np.abs(x - x_jax[:n_rhs]).max() <= tol
