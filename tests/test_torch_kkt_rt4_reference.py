"""The port's KKT mode at RT4 against the benchmark's plain reference
(``eqlb_bench/reference/kkt.py``: plain torch and NumPy, one pivoted
``torch.linalg.solve`` a patch, nothing of the port imported), without JAX.

``unit_square_unstructured(7)`` at RT4: its interior patches of 5-8 cells
give D = 130 / 156 / 182 / 208, which K3 takes on its cluster route on the
card (the plain version of the same pivot-free loop here); its one interior
patch of 4 cells (D = 104) takes the wide route.  The data are two load
cases of ``eqlb_bench.data.make_data`` (f = div sigma_h, so every interior
patch's compatibility condition holds and the KKT mode answers the problem
the reference solves), every boundary facet primal Dirichlet.

Tolerance: 1e-11 * max|x_ref|, the bar of tests/test_torch_kkt.py.  The
port's pivot-free f64 solve and the reference's pivoted one differ by the
rounding of systems of D <= 208 (3.6-3.8e-13 relative here, the elimination
orders apart); 1e-11 leaves ~25x of room above that, and the f32 engine,
4.2-4.5e-5 off, misses it by more than 1e3.

``torch.linalg.solve`` on the CPU build of torch (MKL) can hang on batched
systems of D >= ~156 with more than one thread: the reference solves on
one."""

import numpy as np
import pytest
import torch

from dolfinx_eqlb_tpu_torch.eqlb.bcs import BoundaryData
from dolfinx_eqlb_tpu_torch.eqlb.engine import EqlbEngine
from dolfinx_eqlb_tpu_torch.eqlb.patches import build_patches
from dolfinx_eqlb_tpu_torch.fem import FunctionSpace
from dolfinx_eqlb_tpu_torch.mesh import unit_square_unstructured
from dolfinx_eqlb_tpu_torch.ops.patch_solve import (
    K3_CLUSTER_TILES, K3_WIDE_TILES, k3_plan,
)
from eqlb_bench.check import row_errors
from eqlb_bench.data import make_data
from eqlb_bench.reference.kkt import Reference

K = 4
N_RHS = 2
TOL = 1e-11


@pytest.fixture(scope="module")
def rt4():
    """(mesh, buckets, data, the reference's answer)."""
    msh = unit_square_unstructured(7, seed=0)
    ref = Reference(msh.points, msh.cells, K)
    dp, dr = make_data(msh.points, ref.topo, K, N_RHS, 2**31 + 25, "cpu")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        x_ref = ref.solve(dp, dr)
    finally:
        torch.set_num_threads(n)
    return msh, build_patches(msh), ref, (dp, dr), x_ref


def _engine(msh, buckets, dtype):
    eng = EqlbEngine(FunctionSpace(msh, "RT", K), buckets, dtype=dtype,
                     device="cpu", max_patches_per_bucket=8)
    eng.mode = "kkt"
    eng.solver = "kernel"
    return eng


def _errors(eng, msh, ref, data, x_ref):
    bd = BoundaryData(msh, K, N_RHS)
    x = eng.equilibrate(*data, bd.facet_kind, bd.bvals)
    assert x.shape == x_ref.shape
    return row_errors(x, msh.facet_vertices, ref, x_ref)


def test_interior_patches_take_the_cluster_route(rt4):
    """Every interior bucket of 5 or more cells is planned on a cluster
    tile, and they hold all interior patches but the one of 4 cells."""
    msh, buckets, *_ = rt4
    eng = _engine(msh, buckets, torch.float64)
    interior = {}
    for key, b in eng.buckets.items():  # the engine's chunks of them
        if not b.is_boundary:
            D = eng.kkt_size(key)[0]
            interior[D] = interior.get(D, 0) + b.npatches
    assert set(interior) == {104, 130, 156, 182, 208}
    for D in interior:
        route = k3_plan(D, 1, torch.float64)
        assert route in (K3_CLUSTER_TILES[torch.float64] if D > 128
                         else K3_WIDE_TILES), (D, route)
    assert interior[104] == 1 and sum(interior.values()) == 37


def test_kkt_rt4_matches_the_plain_reference(rt4):
    msh, buckets, ref, data, x_ref = rt4
    errs = _errors(_engine(msh, buckets, torch.float64), msh, ref, data, x_ref)
    assert len(errs) == N_RHS and np.isfinite(errs).all()
    assert max(errs) <= TOL


def test_f32_engine_misses_the_bar(rt4):
    """The bar is tight: the engine in f32 (data cast on entry) is off by
    far more than it."""
    msh, buckets, ref, data, x_ref = rt4
    errs = _errors(_engine(msh, buckets, torch.float32), msh, ref, data, x_ref)
    assert min(errs) > 100 * TOL
