"""The plain reference and the frozen copies against the program, on the
CPU at tiny sizes, in f64."""

import numpy as np
import pytest
import torch

from dolfinx_eqlb_tpu_torch.elements.rt import rt_cached
from dolfinx_eqlb_tpu_torch.eqlb.engine import reference_tensors
from dolfinx_eqlb_tpu_torch.mesh import unit_square, unit_square_unstructured
from eqlb_bench import check, meshes
from eqlb_bench.data import make_data
from eqlb_bench.program import Program
from eqlb_bench.reference import element
from eqlb_bench.reference.kkt import Reference


def _config(mode, k, mesh, n, dtype="float64"):
    return {"mode": mode, "solver": "kernel", "dtype": dtype, "degree": k,
            "mesh": mesh, "mesh_n": n, "mesh_seed": 0,
            "boundary": "primal_dirichlet", "max_patches_per_bucket": 16}


@pytest.mark.parametrize("n", [3, 4, 7, 30])
def test_mesh_copies_equal_the_program_generators(n):
    msh = unit_square(n)
    pts, cells = meshes.crossed(n)
    assert np.array_equal(pts, msh.points) and np.array_equal(cells, msh.cells)
    msh = unit_square_unstructured(n, seed=0)
    pts, cells = meshes.unstructured(n, 0)
    assert np.array_equal(pts, msh.points) and np.array_equal(cells, msh.cells)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_element_copy_matches_the_program(k):
    assert np.allclose(element.rt_coeffs(k), rt_cached(k).coeffs,
                       rtol=0, atol=1e-10)
    mine, theirs = element.reference_tensors(k), reference_tensors(k)
    for name in ("Mhat", "Dhat", "Rhat", "T3"):
        assert np.abs(mine[name] - theirs[name]).max() < 1e-10
    assert np.abs(mine["cmean"] - theirs["cpen"]).max() < 1e-14


@pytest.mark.parametrize("mode,k,mesh,n", [
    ("semiexplicit", 2, "crossed", 4),
    ("kkt", 2, "crossed", 4),
    ("semiexplicit", 3, "unstructured", 7),
    ("kkt", 3, "unstructured", 7),
])
def test_reference_matches_the_program(mode, k, mesh, n):
    """Both modes of the program give the reference's flux on data that
    meets every compatibility condition; its f32 engine does not."""
    conf = _config(mode, k, mesh, n)
    pts, cells = meshes.GENERATORS[mesh](*((n, 0) if mesh == "unstructured" else (n,)))
    ref = Reference(pts, cells, k)
    dp, dr = make_data(pts, ref.topo, k, 3, 2**31 + 5, "cpu")
    x_ref = ref.solve(dp, dr)
    prog = Program(conf, pts, cells, torch.device("cpu"))
    x = torch.cat([prog(dp[i:i + 1], dr[i:i + 1]) for i in range(3)])
    errs = check.row_errors(x, prog.facet_vertices(), ref, x_ref)
    assert max(errs) < 1e-12
    f32 = Program(conf, pts, cells, torch.device("cpu"), dtype=torch.float32)
    x32 = torch.cat([f32(dp[i:i + 1], dr[i:i + 1]) for i in range(3)])
    assert min(check.row_errors(x32, f32.facet_vertices(), ref, x_ref)) > 1e-8


def test_data_meet_the_hat_compatibility():
    """int psi_z f + grad psi_z . sigma_h = 0 on every interior patch."""
    pts, cells = meshes.unstructured(6, 0)
    ref = Reference(pts, cells, 3)
    dp, dr = make_data(pts, ref.topo, 3, 2, 7, "cpu")
    T = element.reference_tensors(3)
    J = np.stack([pts[cells[:, 1]] - pts[cells[:, 0]],
                  pts[cells[:, 2]] - pts[cells[:, 0]]], axis=-1)
    detJ = np.linalg.det(J)
    Kinv = np.linalg.inv(J)
    resid = np.zeros((2, len(pts)))
    for loc in range(3):
        gpsi = np.einsum("cba,b->ca", Kinv, element.HAT_GRADS[loc])
        f_part = np.einsum("lcm,mq,q->lc", dr.numpy(), T["T3"][loc], T["cmean"])
        g_part = np.einsum("ca,lcam,m->lc", gpsi, dp.numpy(), T["cmean"])
        np.add.at(resid, (slice(None), cells[:, loc]),
                  (f_part + g_part) * np.abs(detJ))
    inner = ~ref.topo.is_boundary_vertex
    scale = np.abs(dr.numpy()).max() * np.abs(detJ).max()
    assert np.abs(resid[:, inner]).max() < 1e-12 * scale
    assert np.abs(resid[:, ~inner]).max() > 1e-6 * scale


def test_data_depend_on_the_seed_alone():
    pts, cells = meshes.crossed(3)
    ref = Reference(pts, cells, 2)
    a = make_data(pts, ref.topo, 2, 2, 2**31 + 11, "cpu")
    b = make_data(pts, ref.topo, 2, 2, 2**31 + 11, "cpu")
    c = make_data(pts, ref.topo, 2, 2, 2**31 + 12, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_facet_map_refuses_a_wrong_table():
    pts, cells = meshes.crossed(3)
    ref = Reference(pts, cells, 2)
    fv = ref.topo.facet_vertices[::-1].copy()
    assert check.facet_map(fv, ref) is not None
    bad = fv.copy()
    bad[0] = bad[1]
    assert check.facet_map(bad, ref) is None
    assert check.facet_map(fv[:, ::-1], ref) is None
