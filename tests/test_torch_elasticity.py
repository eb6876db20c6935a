"""The port's elasticity layer against the JAX package's and its committed
runs, f64 on the CPU:

* ``ElasticitySolver`` (Jacobi CG) and ``ElasticitySolverUP`` (Jacobi
  MINRES) on the same data: the solutions within 1e-10 * max(1, max|x|);
  ``fem.krylov.minres`` on a small symmetric indefinite system, with a
  vector and with a callable preconditioner, within 1e-10;
* ``estimate_elasticity`` on JAX's inputs (its projected stress rows,
  correctors and Korn constants), with and without the Herrmann pressure
  term: eta and its components within 1e-12 relative, the cell values
  within 1e-12 * max|cell|;
* ``demos.elasticity`` against the committed
  ``artifacts/ConvStudyElasticity-u_porder-2_eorder-2.csv`` and
  ``-up_porder-2_eorder-3.csv``, rows n = 4 and 8, within 1e-9 relative;
* the specs of ``tests/test_elasticity.py`` and ``tests/test_herrmann.py``
  on the port alone;
* every new entry point wants the card by default and raises without
  one; each demo's ``main`` runs with ``--device cpu``."""

import csv
from pathlib import Path

import numpy as np
import pytest
import torch

from dolfinx_eqlb_tpu import fem as jfem
from dolfinx_eqlb_tpu import eqlb as jeqlb
from dolfinx_eqlb_tpu.estimation import estimate_elasticity as jax_estimate
from dolfinx_eqlb_tpu.fem.krylov import minres as jax_minres
from dolfinx_eqlb_tpu.mesh import generators as jgen
from dolfinx_eqlb_tpu.models import elasticity as jel

from dolfinx_eqlb_tpu_torch import eqlb as teqlb
from dolfinx_eqlb_tpu_torch import fem as tfem
from dolfinx_eqlb_tpu_torch.demos import cook_adaptive, elasticity as demo
from dolfinx_eqlb_tpu_torch.elements.quadrature import gauss_triangle
from dolfinx_eqlb_tpu_torch.eqlb.korn import estimate_korn_constants
from dolfinx_eqlb_tpu_torch.estimation import estimate_elasticity
from dolfinx_eqlb_tpu_torch.fem.krylov import minres
from dolfinx_eqlb_tpu_torch.mesh import generators as tgen
from dolfinx_eqlb_tpu_torch.models import elasticity as tel

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PI_1 = 1.0
_PKG = {"jax": (jfem, jeqlb, jgen, jel), "torch": (tfem, teqlb, tgen, tel)}

# tests/test_elasticity.py's manufactured solution u = (x^2 y, -x y^2)
u_ext = lambda x: np.stack([x[..., 0] ** 2 * x[..., 1],  # noqa: E731
                            -x[..., 0] * x[..., 1] ** 2], -1)
f_body = lambda x: np.stack([-2 * x[..., 1], 2 * x[..., 0]], -1)  # noqa: E731
F_ROWS = [lambda x: f_body(x)[..., 0], lambda x: f_body(x)[..., 1]]


def _close(a_port, a_jax, rel):
    a_port = a_port.cpu().numpy() if isinstance(a_port, torch.Tensor) \
        else np.asarray(a_port)
    a_jax = np.asarray(a_jax)
    assert a_port.shape == a_jax.shape
    assert np.isfinite(a_port).all()
    tol = rel * max(1.0, float(np.abs(a_jax).max()))
    assert np.abs(a_port - a_jax).max() <= tol


def _rel(got, want):
    return abs(got - want) / abs(want)


def _kw(pkg):
    return {"device": "cpu"} if pkg == "torch" else {}


# --- solvers ---------------------------------------------------------------------

def test_elasticity_solver_matches_jax():
    """P3 on the permuted unit_square(3), the exact polynomial solution."""
    out = {}
    for pkg in ("jax", "torch"):
        fem, _, g, el = _PKG[pkg]
        msh = g.permute_vertices(g.unit_square(3), seed=31)
        V = fem.FunctionSpace(msh, "P", 3, vs=2)
        solver = el.ElasticitySolver(V, PI_1, **_kw(pkg))
        uh = solver.solve(fem.expr_from_callable(f_body, msh, value_size=2),
                          msh.boundary_facets,
                          fem.expr_from_callable(u_ext, msh, value_size=2),
                          rtol=1e-13)
        out[pkg] = (uh.x, solver.last_iterations)
    _close(out["torch"][0], out["jax"][0], 1e-10)
    assert abs(out["torch"][1] - out["jax"][1]) <= 1


def _sin_u(x):
    return np.stack([np.sin(np.pi * x[..., 0]) * np.cos(np.pi * x[..., 1]),
                     -np.cos(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1])],
                    -1)


@pytest.fixture(scope="module")
def up_flows():
    """tests/test_herrmann.py's flow at n = 3 on both packages: the
    Taylor-Hood P3 x P2 MINRES solve, the projected stress rows, SE with
    stress and Korn constants, RT2."""
    out = {}
    for pkg in ("jax", "torch"):
        fem, eqlb, g, el = _PKG[pkg]
        msh = g.unit_square(3)
        rhs = fem.local_projection(
            fem.FunctionSpace(msh, "DG", 1),
            [lambda x: 2 * np.pi**2 * _sin_u(x)[..., 0],
             lambda x: 2 * np.pi**2 * _sin_u(x)[..., 1]],
            quadrature_degree=12, **_kw(pkg))
        solver = el.ElasticitySolverUP(fem.FunctionSpace(msh, "P", 3, vs=2),
                                       fem.FunctionSpace(msh, "P", 2), PI_1,
                                       **_kw(pkg))
        uh, ph = solver.solve(fem.as_vector(rhs, msh), msh.boundary_facets,
                              fem.expr_from_callable(_sin_u, msh,
                                                     value_size=2),
                              rtol=1e-12)
        proj = fem.local_projection(
            fem.FunctionSpace(msh, "DG", 1, vs=2),
            [el.stress_row_expr_up(uh, ph, 0, -1.0),
             el.stress_row_expr_up(uh, ph, 1, -1.0)])
        eq = eqlb.FluxEqlbSE(2, msh, rhs, proj, equilibrate_stress=True,
                             estimate_korn_constant=True)
        eq.set_boundary_conditions([msh.boundary_facets] * 2, [[], []])
        eq.equilibrate_fluxes()
        out[pkg] = dict(mesh=msh, solver=solver, uh=uh, ph=ph, rhs=rhs,
                        proj=proj, eq=eq)
    return out


def test_elasticity_solver_up_matches_jax(up_flows):
    t, j = up_flows["torch"], up_flows["jax"]
    _close(t["uh"].x, j["uh"].x, 1e-10)
    _close(t["ph"].x, j["ph"].x, 1e-10)
    assert abs(t["solver"].last_iterations - j["solver"].last_iterations) <= 2
    for i in range(2):
        _close(t["eq"].list_flux[i].x, j["eq"].list_flux[i].x, 1e-10)


@pytest.mark.parametrize("precond", ["vector", "callable"])
def test_minres_matches_jax(precond):
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    n = 40
    B = rng.normal(size=(n, n))
    A = B + B.T + np.diag(np.where(np.arange(n) < n // 2, 12.0, -12.0))
    b = rng.normal(size=n)
    x0 = np.where(np.arange(n) % 7 == 0, rng.normal(size=n), 0.0)
    free = np.arange(n) % 7 != 0
    d = 1.0 / np.abs(np.diag(A))
    out = {}
    for pkg, arr, fn in (("jax", jnp.asarray, jax_minres),
                         ("torch", torch.as_tensor, minres)):
        As, ds = arr(A), arr(d)
        if precond == "vector":
            Minv, ops = ds, None

            def mv(v, As=As):
                return As @ v
        else:
            def Minv(r, o):
                return o["d"] * r

            ops = {"A": As, "d": ds}

            def mv(v, o):
                return o["A"] @ v
        st = fn(mv, arr(b), arr(x0), Minv, free, rtol=1e-12, atol=1e-14,
                maxiter=500, operands=ops)
        out[pkg] = (np.asarray(st["x"]), int(st["it"]),
                    float(st["phibar"]))
    _close(out["torch"][0], out["jax"][0], 1e-10)
    assert out["torch"][1] == out["jax"][1]
    assert out["torch"][2] <= 1e-10 * float(np.linalg.norm(b))


# --- the estimator ------------------------------------------------------------------

def _to_port(f, V):
    return tfem.Function(V, np.asarray(f.x), device="cpu")


def _port_inputs(j):
    """The port's Functions holding JAX's dofs."""
    tm = tgen.unit_square(3)
    Vf = tfem.FunctionSpace(tm, "DG", 1, vs=2)
    Vd = tfem.FunctionSpace(tm, "DRT", 2)
    V0 = tfem.FunctionSpace(tm, "DG", 0)
    return (tm, [_to_port(p, Vf) for p in j["proj"]],
            [_to_port(s, Vd) for s in j["eq"].list_flux],
            _to_port(j["eq"].get_korn_constants(), V0))


@pytest.mark.parametrize("pressure", [False, True])
def test_estimate_elasticity_matches_jax(up_flows, pressure):
    j = up_flows["jax"]
    tm, proj, flux, korn = _port_inputs(j)
    frows = [lambda x: 2 * np.pi**2 * _sin_u(x)[..., 0],
             lambda x: 2 * np.pi**2 * _sin_u(x)[..., 1]]
    jp = tp = None
    if pressure:
        jp = jel.pressure_mismatch_expr(j["uh"], j["ph"], PI_1)
        uh = _to_port(j["uh"], tfem.FunctionSpace(tm, "P", 3, vs=2))
        ph = _to_port(j["ph"], tfem.FunctionSpace(tm, "P", 2))
        tp = tel.pressure_mismatch_expr(uh, ph, PI_1)
    want = jax_estimate(frows, PI_1, j["proj"], j["eq"].list_flux,
                        j["eq"].get_korn_constants(), pressure_term=jp)
    got = estimate_elasticity(frows, PI_1, proj, flux, korn, pressure_term=tp)
    assert _rel(got[0], want[0]) <= 1e-12
    for a, b in zip(got[1], want[1]):
        assert _rel(a, b) <= 1e-12
    _close(got[2], want[2], 1e-12)


def test_korn_constants_match_jax(up_flows):
    _close(up_flows["torch"]["eq"].get_korn_constants().x,
           up_flows["jax"]["eq"].get_korn_constants().x, 1e-12)


# --- the demo against the committed runs ------------------------------------------------

def _csv_rows(name):
    with open(REPO / "artifacts" / name) as f:
        return [{k: float(v) for k, v in row.items()}
                for row in csv.DictReader(f)]


@pytest.mark.parametrize("form, degree", [("u", 2), ("up", 3)])
def test_demo_matches_committed_csv(form, degree):
    rows = _csv_rows(f"ConvStudyElasticity-{form}_porder-2_eorder-"
                     f"{degree}.csv")
    for want in rows[:2]:
        eta, comps, err = demo.run(int(want["n"]), 2, degree, check=True,
                                   formulation=form, device="cpu",
                                   verbose=False)
        got = dict(eta=eta, eta_sig=comps[0], eta_wsym=comps[1],
                   eta_osc=comps[2], energy_error=err, I_eff=eta / err)
        for key, val in got.items():
            assert _rel(val, want[key]) <= 1e-9, (want["n"], key)


# --- the specs of tests/test_elasticity.py and tests/test_herrmann.py ----------------------

def _u_flow(msh, order, deg):
    V = tfem.FunctionSpace(msh, "P", order, vs=2)
    solver = tel.ElasticitySolver(V, PI_1, device="cpu")
    uh = solver.solve(tfem.expr_from_callable(f_body, msh, value_size=2),
                      msh.boundary_facets,
                      tfem.expr_from_callable(u_ext, msh, value_size=2),
                      rtol=1e-13)
    proj = tfem.local_projection(
        tfem.FunctionSpace(msh, "DG", deg - 1, vs=2),
        [tel.stress_row_expr(uh, PI_1, 0, -1.0),
         tel.stress_row_expr(uh, PI_1, 1, -1.0)])
    rhs = tfem.local_projection(tfem.FunctionSpace(msh, "DG", deg - 1),
                                F_ROWS, device="cpu")
    eq = teqlb.FluxEqlbSE(deg, msh, rhs, proj, equilibrate_stress=True,
                          estimate_korn_constant=True)
    eq.set_boundary_conditions([msh.boundary_facets] * 2, [[], []])
    eq.equilibrate_fluxes()
    eta, comps, cells = estimate_elasticity(F_ROWS, PI_1, proj,
                                            eq.list_flux,
                                            eq.get_korn_constants())
    return uh, proj, rhs, eq, eta, comps


def test_elasticity_polynomial_exact():
    msh = tgen.permute_vertices(tgen.unit_square(3), seed=31)
    V = tfem.FunctionSpace(msh, "P", 3, vs=2)
    uh = tel.ElasticitySolver(V, PI_1, device="cpu").solve(
        tfem.expr_from_callable(f_body, msh, value_size=2),
        msh.boundary_facets,
        tfem.expr_from_callable(u_ext, msh, value_size=2), rtol=1e-13)
    err = tfem.expr_from_callable(u_ext, msh, value_size=2) - uh
    assert float(tfem.cell_integrals_sq(err, 10, device="cpu").sum()) < 1e-20


@pytest.mark.parametrize("mesh", ["crossed", "permuted"])
def test_stress_equilibration_end_to_end(mesh):
    msh = tgen.unit_square(3)
    if mesh == "permuted":
        msh = tgen.permute_vertices(msh, seed=33)
    _, proj, rhs, eq, eta, comps = _u_flow(msh, 3, 2)
    for i in range(2):
        assert teqlb.check_divergence_condition(eq.list_flux[i], proj[i],
                                                rhs[i])
        assert teqlb.check_jump_condition(eq.list_flux[i], proj[i])
    assert teqlb.check_weak_symmetry_condition(eq.list_flux, proj)
    assert np.isfinite(eta) and eta > 0
    assert comps[2] < 1e-9  # oscillation: f is resolved exactly


def _energy_error(msh, uh):
    pts, w = gauss_triangle(10)
    g = uh.evaluate_grad(pts).numpy()
    xq = msh.map_points(pts)
    gex = np.stack(
        [np.stack([2 * xq[..., 0] * xq[..., 1], xq[..., 0] ** 2], -1),
         np.stack([-xq[..., 1] ** 2, -2 * xq[..., 0] * xq[..., 1]], -1)],
        -2)
    de = g - gex
    eps = 0.5 * (de + np.swapaxes(de, -1, -2))
    dv = de[..., 0, 0] + de[..., 1, 1]
    adet = np.abs(msh.detJ)
    return np.sqrt(np.einsum("q,c,cqab,cqab->", w, adet, eps, 2 * eps)
                   + PI_1 * np.einsum("q,c,cq,cq->", w, adet, dv, dv))


def test_stress_equilibration_estimator_bounds():
    msh = tgen.unit_square(4)
    uh, _, _, _, eta, _ = _u_flow(msh, 2, 2)
    ieff = eta / _energy_error(msh, uh)
    assert 1.0 <= ieff < 100.0, ieff


def test_estimator_grade_at_one_degree_higher():
    def ieff(n, deg):
        msh = tgen.unit_square(n)
        uh, _, _, _, eta, _ = _u_flow(msh, 2, deg)
        return eta / _energy_error(msh, uh)

    i4, i8 = ieff(4, 3), ieff(8, 3)
    assert i8 <= i4 * 1.05, (i4, i8)
    j4, j8 = ieff(4, 2), ieff(8, 2)
    assert j8 > j4, (j4, j8)


def test_herrmann_equilibration_and_bound():
    errs, etas = [], []
    for n in (3, 6):
        info = {}
        eta, _, err = demo.run(n, 2, 2, check=True, formulation="up",
                               device="cpu", verbose=False, info=info)
        assert eta >= err, "guaranteed bound violated"
        assert info["checks"] and all(info["checks"].values())
        errs.append(err)
        etas.append(eta)
    assert etas[1] < etas[0] and errs[1] < errs[0]


# --- entry points -----------------------------------------------------------------------

_ENTRIES = {
    "ElasticitySolver": lambda: tel.ElasticitySolver(
        tfem.FunctionSpace(tgen.unit_square(2), "P", 2, vs=2), PI_1),
    "ElasticitySolverUP": lambda: tel.ElasticitySolverUP(
        tfem.FunctionSpace(tgen.unit_square(2), "P", 3, vs=2),
        tfem.FunctionSpace(tgen.unit_square(2), "P", 2), PI_1),
    "estimate_korn_constants": lambda: estimate_korn_constants(
        tgen.unit_square(2)),
    "elasticity.run": lambda: demo.run(2, verbose=False),
    "cook_adaptive.run": lambda: cook_adaptive.run(max_iter=1,
                                                   verbose=False),
}


@pytest.mark.parametrize("name", sorted(_ENTRIES))
def test_entry_points_default_to_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        _ENTRIES[name]()


_MAINS = {
    "elasticity_u": (demo, ["--n", "3"]),
    "elasticity_up": (demo, ["--n", "3", "--formulation", "up"]),
    "cook_adaptive": (cook_adaptive, ["--max-iter", "2", "--degree", "2",
                                      "--outfile", "cook.csv"]),
}


@pytest.mark.parametrize("name", sorted(_MAINS))
def test_demo_main_on_cpu(name, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    mod, argv = _MAINS[name]
    mod.main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out
    if "--outfile" in argv:
        assert (tmp_path / "cook.csv").read_text().count("\n") == 3
