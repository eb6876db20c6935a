"""K3's cluster route on the card: the f64 blocked kernel
(``lu_solve_bm_cluster_blocked_kernel``, tiles ``blocked*``) and the f32
scalar-step kernel (``cluster*``) against the plain pivot-free loop
(``batched_kkt_solve_plain``) on the same operands, on the card.

Shapes: the KKT sizes of RT3 and RT4 on unstructured meshes (D = 130, 135,
150, 156, 182, 208, 234 at R = 1) and the tiles' edges: D + R = 129 (the
route's first shape), 160 / 161 (f64's one-block tile against its
two-block one), 192 / 193 and 256, R = 2 on both sides of 160 / 161.
Operands: non-symmetric diagonally dominant systems at every shape, and
the engine's own KKT systems of RT4 on ``unit_square_unstructured(7)``
(D = 130 / 156 / 182 / 208, the pivot profile of
``tests/test_torch_kkt.py``'s ``PIVOT_RATIOS``: smallest pivot ~1.5e-7 of
max|A|), assembled on the CPU.  Bar: 1e-12 * max(1, max|x|) in f64; in f32
1e-4, both sides rounding in f32.

Marker ``card``: skipped without one.  No JAX here, so on the card:

    python -m pytest --noconftest tests/test_torch_k3_cluster.py -m card
"""

import numpy as np
import pytest
import torch

from dolfinx_eqlb_tpu_torch import ops
from dolfinx_eqlb_tpu_torch.eqlb.engine import EqlbEngine
from dolfinx_eqlb_tpu_torch.eqlb.patches import build_patches
from dolfinx_eqlb_tpu_torch.fem import FunctionSpace
from dolfinx_eqlb_tpu_torch.mesh import unit_square_unstructured
from dolfinx_eqlb_tpu_torch.ops.patch_solve import (
    K3_CLUSTER_TILES, batched_kkt_solve, batched_kkt_solve_plain, k3_plan,
)

BARS = {torch.float64: 1e-12, torch.float32: 1e-4}
SHAPES = [
    (130, 1), (135, 1), (150, 1), (156, 1), (182, 1), (208, 1), (234, 1),
    (128, 1),              # D + R = 129
    (159, 1), (160, 1),    # 160 / 161: f64 one block / two
    (158, 2), (159, 2),
    (191, 1), (192, 1),    # 192 / 193
    (255, 1),              # 256
]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda", 0)


def _dominant(X, D, R, seed):
    """X non-symmetric systems, each row's diagonal above the sum of its
    other entries' magnitudes, f64 on the CPU."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(X, D, D))
    idx = np.arange(D)
    A[:, idx, idx] = np.abs(A).sum(-1) + 1.0
    return torch.tensor(A), torch.tensor(rng.normal(size=(X, D, R)))


def _check(A, b, device, dtype):
    """The planned route against plain on the card; the route and its
    launches."""
    A, b = A.to(device, dtype), b.to(device, dtype)
    route = k3_plan(A.shape[-1], b.shape[-1], dtype)
    before = ops.launches(split=True)["K3"][route]
    x = batched_kkt_solve(A, b)
    torch.cuda.synchronize(device)
    xp = batched_kkt_solve_plain(A, b)
    err = float((x - xp).abs().max())
    bar = BARS[dtype] * max(1.0, float(xp.abs().max()))
    assert bool(torch.isfinite(x).all()) and err <= bar, (route, err, bar)
    assert ops.launches(split=True)["K3"][route] == before + 1
    return route


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("D,R", SHAPES)
def test_cluster_route_matches_plain(card, D, R, dtype):
    route = _check(*_dominant(96, D, R, seed=D + 1000 * R), card, dtype)
    assert route in K3_CLUSTER_TILES[dtype]


@pytest.fixture(scope="module")
def rt4_systems():
    """The engine's KKT systems of RT4 past the wide route, D -> (A, b),
    recorded from one CPU call on random data."""
    msh = unit_square_unstructured(7)
    eng = EqlbEngine(FunctionSpace(msh, "RT", 4), build_patches(msh),
                     dtype=torch.float64, device="cpu")
    eng.mode = "kkt"
    systems, solve = {}, eng._kkt_solve

    def record(A, b):
        if A.shape[-1] > 128:
            D = A.shape[-1]
            systems.setdefault(D, []).append(
                (A.reshape(-1, D, D).clone(), b.reshape(-1, D, 1).clone()))
        return solve(A, b)

    eng._kkt_solve = record
    rng = np.random.default_rng(7)
    nc, nf = msh.num_cells, msh.num_facets
    fk = np.zeros((1, nf), dtype=np.int8)
    fk[:, msh.boundary_facets] = 1
    eng.equilibrate(rng.normal(size=(1, nc, 2, 10)),
                    rng.normal(size=(1, nc, 10)), fk, np.zeros((1, nf, 4)))
    return {D: (torch.cat([a for a, _ in s]), torch.cat([v for _, v in s]))
            for D, s in systems.items()}


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("D", [130, 156, 182, 208])
def test_cluster_route_on_rt4_systems(card, rt4_systems, D, dtype):
    A, b = rt4_systems[D]
    assert _check(A, b, card, dtype) in K3_CLUSTER_TILES[dtype]
