"""The work the roofline shares count, against hand counts at small D."""

import pytest
import torch

from eqlb_bench import meshes
from eqlb_bench.reference.kkt import Reference
from eqlb_bench.roofline import bound, lu_bound, lu_flops, solve_work


def _hand_lu_flops(D, R):
    n = 0
    for m in range(D):  # step j eliminates the m = D - 1 - j rows below it
        n += m * (1 + 2 * m + 2 * R)
    for m in range(D):
        n += R * (2 * m + 1)
    return n


@pytest.mark.parametrize("D,R", [(1, 1), (2, 1), (3, 2), (6, 1), (28, 1)])
def test_lu_flops_by_hand(D, R):
    assert lu_flops(D, R) == _hand_lu_flops(D, R)
    assert lu_flops(2, 1) == (0 + 1 * (1 + 2 + 2)) + (1 + 3)


def test_bound_picks_the_larger_side():
    t, by = bound(3.35e12, 0.0, torch.float64)
    assert by == "bytes" and t == pytest.approx(1e3)
    t, by = bound(0.0, 67e12, torch.float32)
    assert by == "operations" and t == pytest.approx(1e3)
    t, by = lu_bound(4, 1, 10, torch.float64)
    assert t == pytest.approx(max((16 + 8) * 10 * 8 / 3.35e12,
                                  lu_flops(4, 1) * 10 / 67e12) * 1e3)


def test_patch_sizes_and_solve_work_on_a_crossed_mesh():
    """unit_square(2) crossed: 4 interior 4-cell patches (quad centres), 1
    interior 8-cell patch, 4 boundary 2-cell corners, 4 boundary 4-cell
    edge midpoints."""
    pts, cells = meshes.crossed(2)
    ref = Reference(pts, cells, 2)
    assert ref.patch_sizes() == [(2, True, 4, 2 * 3 + 2 * 2, 10 + 6),
                                 (4, False, 4, 2 * 4 + 4 * 2, 16 + 12),
                                 (4, True, 4, 2 * 5 + 4 * 2, 18 + 12),
                                 (8, False, 1, 2 * 8 + 8 * 2, 32 + 24)]
    nb, nf = solve_work(ref.patch_sizes(), 2, "kkt", torch.float64)
    kkt = [(16, 4), (28, 4), (30, 4), (56, 1)]
    assert nf == sum(lu_flops(D, 1) * X for D, X in kkt)
    assert nb == sum((D * D + 2 * D) * X * 8 for D, X in kkt)
    # the reduced solves: boundary patches only, D = nflux - n ndg
    nb, nf = solve_work(ref.patch_sizes(), 2, "reduced", torch.float32)
    red = [(10 - 6, 4), (18 - 12, 4)]
    assert nf == sum(lu_flops(D, 1) * X for D, X in red)
    assert nb == sum((D * D + 2 * D) * X * 4 for D, X in red)
