"""The port's Biot u-p-pt primal solver (``models/biot.py``) against the
JAX package's, f64 on the CPU:

* ``BiotSolverUPP``'s element tensors, ``diag``, ``matvec`` and
  ``load_vector`` within 1e-12 (relative to max(1, max|.|)) of JAX's;
* the Jacobi MINRES solve on ``unit_square(4)`` and the ``BiotMG`` solve
  on ``mesh_hierarchy(unit_square(3), 3)`` within 1e-10, iteration counts
  within one.  (On the finer hierarchy mesh the Jacobi count at rtol 1e-12
  runs past the system size and is set by rounding: JAX's own count moves
  by two when f is scaled by 1 + 2^-50.  So the Jacobi counts are held on
  the coarser mesh);
* ``biot_fields`` on JAX's uh, ph, pth within 1e-12;
* ``biot_bench_fields`` on ``unit_square(3)`` within 1e-10;
* the specs of ``tests/test_biot.py`` (primal residual, bench-field
  shapes, chunked MINRES) on the port alone;
* every new entry point wants the card by default and raises without
  one."""

import numpy as np
import pytest
import torch

from dolfinx_eqlb_tpu import fem as jfem
from dolfinx_eqlb_tpu.mesh import generators as jgen
from dolfinx_eqlb_tpu.models import biot as jbiot

from dolfinx_eqlb_tpu_torch import fem as tfem
from dolfinx_eqlb_tpu_torch.demos import biot as demo
from dolfinx_eqlb_tpu_torch.fem import multigrid as tmg
from dolfinx_eqlb_tpu_torch.mesh import generators as tgen
from dolfinx_eqlb_tpu_torch.models import biot as tbiot
from dolfinx_eqlb_tpu_torch.utils.perftest import run_perftest

from tests.test_biot import f_body, g_flow

torch.set_num_threads(2)

_PKG = {"jax": (jfem, jgen, jbiot), "torch": (tfem, tgen, tbiot)}


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rel):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= rel * max(1.0, np.abs(want).max())


def _kw(pkg):
    return {"device": "cpu"} if pkg == "torch" else {}


def _setup(pkg, msh, k=2):
    """Spaces, the DG_{k-1}-projected data and the solver."""
    fem, _, biot = _PKG[pkg]
    Vu = fem.FunctionSpace(msh, "P", k, vs=2)
    Vp = fem.FunctionSpace(msh, "P", k)
    Vpt = fem.FunctionSpace(msh, "P", k - 1)
    fe = fem.local_projection(
        fem.FunctionSpace(msh, "DG", k - 1, vs=2),
        [fem.expr_from_callable(f_body, msh, value_size=2)],
        quadrature_degree=2 * k + 6, **_kw(pkg))[0]
    ge = fem.local_projection(
        fem.FunctionSpace(msh, "DG", k - 1),
        [fem.expr_from_callable(g_flow, msh, value_size=1)],
        quadrature_degree=2 * k + 6, **_kw(pkg))[0]
    if pkg == "jax":
        import jax.numpy as jnp

        solver = biot.BiotSolverUPP(Vu, Vp, Vpt, dtype=jnp.float64)
    else:
        solver = biot.BiotSolverUPP(Vu, Vp, Vpt, dtype=torch.float64,
                                    device="cpu")
    return solver, fe, ge


def _dofs(sol):
    return np.concatenate([_np(f.x) for f in sol])


@pytest.fixture(scope="module")
def jacobi():
    """Both packages' Jacobi MINRES solves on unit_square(4), rtol 1e-12."""
    out = {}
    for pkg in ("jax", "torch"):
        _, gen, _ = _PKG[pkg]
        msh = gen.unit_square(4)
        solver, fe, ge = _setup(pkg, msh)
        sol = solver.solve(fe, ge, msh.boundary_facets, rtol=1e-12)
        out[pkg] = dict(solver=solver, fe=fe, ge=ge, sol=sol,
                        its=solver.last_iterations)
    return out


@pytest.mark.parametrize("name", ["Ae_uu", "Be", "Me_pt", "Me_ppt", "Ke_p",
                                  "diag"])
def test_operator_tensors_match_jax(jacobi, name):
    _close(getattr(jacobi["torch"]["solver"], name),
           getattr(jacobi["jax"]["solver"], name), 1e-12)


def test_dof_tables_match_jax(jacobi):
    t, j = jacobi["torch"]["solver"], jacobi["jax"]["solver"]
    for name in ("cdu", "cdp", "cdpt"):
        assert np.array_equal(_np(getattr(t, name)),
                              np.asarray(getattr(j, name)))


def test_matvec_and_load_vector_match_jax(jacobi):
    import jax.numpy as jnp

    t, j = jacobi["torch"]["solver"], jacobi["jax"]["solver"]
    x = np.random.default_rng(0).standard_normal(t.nu + t.np_ + t.npt)
    _close(t.matvec(torch.as_tensor(x)), j.matvec(jnp.asarray(x)), 1e-12)
    _close(t.load_vector(jacobi["torch"]["fe"], jacobi["torch"]["ge"]),
           j.load_vector(jacobi["jax"]["fe"], jacobi["jax"]["ge"]), 1e-12)


def test_jacobi_solve_matches_jax(jacobi):
    _close(_dofs(jacobi["torch"]["sol"]), _dofs(jacobi["jax"]["sol"]), 1e-10)
    assert abs(jacobi["torch"]["its"] - jacobi["jax"]["its"]) <= 1
    assert jacobi["torch"]["solver"].last_maxiter == 90 * int(
        np.sqrt(jacobi["torch"]["solver"].diag.shape[0]) + 100)


def test_mg_solve_matches_jax():
    """BiotMG on mesh_hierarchy(unit_square(3), 3); the port's BiotMG
    built beforehand and the hierarchy passed as ``mg`` agree bitwise."""
    out = {}
    for pkg in ("jax", "torch"):
        fem, gen, biot = _PKG[pkg]
        meshes = fem.mesh_hierarchy(gen.unit_square(3), 3)
        msh = meshes[-1]
        solver, fe, ge = _setup(pkg, msh)
        sol = solver.solve(fe, ge, msh.boundary_facets, rtol=1e-12,
                           mg=biot.BiotMG(solver, meshes))
        out[pkg] = (_dofs(sol), solver.last_iterations)
        if pkg == "torch":
            again = solver.solve(fe, ge, msh.boundary_facets, rtol=1e-12,
                                 mg=meshes)
            assert np.array_equal(_dofs(again), out[pkg][0])
            assert solver.last_maxiter == 400
    _close(out["torch"][0], out["jax"][0], 1e-10)
    assert abs(out["torch"][1] - out["jax"][1]) <= 1


def test_biot_fields_match_jax(jacobi):
    """The port's fields from JAX's uh, ph, pth and projected data."""
    j = jacobi["jax"]
    jproj, jrhs = jbiot.biot_fields(*j["sol"], j["fe"], j["ge"], 2)
    ts = jacobi["torch"]["solver"]
    sol = [tfem.Function(V, torch.tensor(np.asarray(f.x)))
           for V, f in zip((ts.Vu, ts.Vp, ts.Vpt), j["sol"])]
    data = [tfem.Function(t.space, torch.tensor(np.asarray(f.x)))
            for t, f in ((jacobi["torch"]["fe"], j["fe"]),
                         (jacobi["torch"]["ge"], j["ge"]))]
    tproj, trhs = tbiot.biot_fields(*sol, *data, 2)
    assert len(tproj) == len(trhs) == 3
    for a, b in zip(tproj + trhs, jproj + jrhs):
        _close(a.x, b.x, 1e-12)


def test_bench_fields_match_jax():
    """Default arguments (Jacobi, rtol 1e-10, f64) on unit_square(3)."""
    jp, jr = jbiot.biot_bench_fields(jgen.unit_square(3), 2)
    tp, tr = tbiot.biot_bench_fields(tgen.unit_square(3), 2, device="cpu")
    assert tp.dtype == tr.dtype == torch.float64
    _close(tp, jp, 1e-10)
    _close(tr, jr, 1e-10)


def test_bench_fields_mg_and_info():
    """The MG data path in f32 (the bench's): shapes, finite values, the
    solver and stage seconds in ``info``, close to the f64 Jacobi data."""
    meshes = tmg.mesh_hierarchy(tgen.unit_square(3), 2)
    info = {}
    dp, dr = tbiot.biot_bench_fields(
        meshes[-1], 2, rtol=1e-6, maxiter=400, dtype=torch.float32,
        mg_meshes=meshes, device="cpu", info=info)
    ref_p, ref_r = tbiot.biot_bench_fields(meshes[-1], 2, device="cpu")
    assert info["solver"].dtype == torch.float32
    assert info["mg"].mg_u.dtype == torch.float32
    assert 0 < info["solver"].last_iterations <= 400
    assert set(info["stages_s"]) == {"solver_setup", "project_data",
                                     "mg_setup", "solve", "biot_fields"}
    # f32 MINRES to rtol 1e-6
    _close(dp, ref_p, 1e-4)
    _close(dr, ref_r, 1e-4)


# --- the specs of tests/test_biot.py on the port ---------------------------------------

def test_biot_primal_residual():
    msh = tgen.unit_square(4)
    solver, fe, ge = _setup("torch", msh)
    sol = solver.solve(fe, ge, msh.boundary_facets, rtol=1e-13)
    assert solver.last_residual < 1e-10
    r = _np(solver.load_vector(fe, ge)
            - solver.matvec(torch.as_tensor(_dofs(sol))))
    assert np.abs(r[-solver.npt:]).max() < 1e-9


def test_biot_bench_fields_shapes():
    msh = tgen.unit_square(3)
    k = 2
    d_proj, d_rhs = tbiot.biot_bench_fields(msh, k, device="cpu")
    ndg = k * (k + 1) // 2
    assert d_proj.shape == (3, msh.num_cells, 2, ndg)
    assert d_rhs.shape == (3, msh.num_cells, ndg)
    assert torch.isfinite(d_proj).all() and torch.isfinite(d_rhs).all()
    assert float(d_proj.abs().max()) > 1e-3


def test_chunked_minres_matches_unchunked():
    msh = tgen.unit_square(5)
    kw = dict(rtol=1e-10, maxiter=4000, dtype=torch.float64, device="cpu")
    ref_p, ref_r = tbiot.biot_bench_fields(msh, 2, chunk=None, **kw)
    for chunk in (37, 4000):
        d_p, d_r = tbiot.biot_bench_fields(msh, 2, chunk=chunk, **kw)
        assert torch.equal(ref_p, d_p) and torch.equal(ref_r, d_r), chunk


# --- entry points --------------------------------------------------------------------------

def _spaces():
    msh = tgen.unit_square(2)
    return (tfem.FunctionSpace(msh, "P", 2, vs=2),
            tfem.FunctionSpace(msh, "P", 2), tfem.FunctionSpace(msh, "P", 1))


_ENTRIES = {
    "GeometricMG": lambda: tmg.GeometricMG(
        tmg.mesh_hierarchy(tgen.unit_square(2), 2), 1,
        lambda m: tmg.scalar_stiffness_tensors(m, 1)),
    "BiotSolverUPP": lambda: tbiot.BiotSolverUPP(*_spaces()),
    "biot_bench_fields": lambda: tbiot.biot_bench_fields(
        tgen.unit_square(2), 2),
    "run_perftest": lambda: run_perftest("biot", orders=(2,), nrefs=1,
                                         n0=2, out_csv=None),
    "biot.run": lambda: demo.run(4, verbose=False),
}


@pytest.mark.parametrize("name", sorted(_ENTRIES))
def test_entry_points_default_to_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        _ENTRIES[name]()
