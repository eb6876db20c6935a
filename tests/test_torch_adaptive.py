"""The port's demos and adaptive loops on the CPU (plain versions), held to
the JAX package's committed runs and to its test specs:

* ``demos.lshape_adaptive`` (P3/RT3, theta = 0.6) against
  ``artifacts/AdaptiveLShape_p3_e3.csv``, rows 0-5: ``ncells`` identical,
  eta and err_H1 within 1e-9 relative;
* ``demos.error_estimation.run`` (SE, P1/RT1, Dirichlet, 3 meshes) against
  ``ConvStudyFluxEqlb-SE_porder-1_eorder-1.csv`` within 1e-10 relative;
* ``demos.discont_coeff`` (Kellogg) against the JAX demo's loop, two
  iterations;
* the specs of ``tests/test_poisson.py`` and ``tests/test_convergence.py``
  run on the port alone;
* every demo's entry point wants the card by default and raises without
  one; each ``main`` runs with ``--device cpu``."""

import csv
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from dolfinx_eqlb_tpu_torch.demos import (
    discont_coeff, error_estimation, local_projection, lshape_adaptive,
    reconstruction,
)
from dolfinx_eqlb_tpu_torch.elements.quadrature import gauss_triangle
from dolfinx_eqlb_tpu_torch.eqlb import FluxEqlbEV, FluxEqlbSE, fluxbc
from dolfinx_eqlb_tpu_torch.eqlb.checks import reconstructed_flux_expr
from dolfinx_eqlb_tpu_torch.fem import (
    FunctionSpace, cell_integrals_sq, expr_from_callable, grad,
    local_projection as project, project_facet_trace,
)
from dolfinx_eqlb_tpu_torch.mesh import permute_vertices, unit_square
from dolfinx_eqlb_tpu_torch.models import PoissonSolver

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _rel(got, want):
    return abs(got - want) / abs(want)


# --- the committed runs -------------------------------------------------------

def test_lshape_loop_matches_artifact(tmp_path):
    with open(REPO / "artifacts" / "AdaptiveLShape_p3_e3.csv") as f:
        ref = list(csv.DictReader(f))[:6]
    out = tmp_path / "trace.csv"
    _, hist = lshape_adaptive.adaptive_loop(
        3, 3, 0.6, 1e-6, max_iter=6, verbose=False, csv_path=out,
        device="cpu")
    assert len(hist) == 6
    for (ncells, err_h1, eta, i_eff, cg), row in zip(hist, ref):
        assert ncells == int(row["ncells"])
        assert _rel(eta, float(row["eta"])) <= 1e-9
        assert _rel(err_h1, float(row["err_h1"])) <= 1e-9
        assert 0 < cg < 20 * (math.sqrt(1e6) + 100)
    with open(out) as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == lshape_adaptive.CSV_HEADER.split(",")
    assert [int(r["ncells"]) for r in rows] == [h[0] for h in hist]
    assert [int(r["cg_iterations"]) for r in rows] == [h[4] for h in hist]


def test_lshape_loop_step_hook_and_stop():
    """The hook sees every iteration with its stage seconds; the loop stops
    at the tolerance without refining."""
    steps = []
    _, hist = lshape_adaptive.adaptive_loop(
        1, 1, 0.5, 0.2, max_iter=10, verbose=False, device="cpu",
        step_hook=steps.append)
    assert [s["it"] for s in steps] == list(range(len(hist)))
    assert hist[-1][2] <= 0.2 < hist[-2][2]
    assert steps[-1]["marked"] is None and steps[0]["marked"] is not None
    assert {"poisson_solve", "equilibrate", "estimate", "refine"} <= set(
        steps[0]["stages_s"])
    assert steps[-1]["cell_eta_sq"].shape == (hist[-1][0],)


def test_error_estimation_matches_csv():
    want = np.loadtxt(REPO / "ConvStudyFluxEqlb-SE_porder-1_eorder-1.csv",
                      delimiter=",")
    stats = []
    got = error_estimation.run(FluxEqlbSE, 1, 1, "dirichlet", 3,
                               device="cpu", stats=stats)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= 1e-10 * np.abs(want))
    assert [s["cells"] for s in stats] == [16, 64, 256]


def _jax_kellogg_demo():
    spec = importlib.util.spec_from_file_location(
        "jax_demo_discont_coeff", REPO / "demos" / "demo_discont_coeff.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_kellogg_matches_jax():
    """Two iterations of the Kellogg loop: the coefficient in the primal
    solve, the projected flux -kappa grad(uh), SE and the estimator's
    ``coefficient`` branch, then marking and refinement."""
    want = _jax_kellogg_demo().adaptive_loop(max_iter=2, verbose=False)
    got = discont_coeff.adaptive_loop(max_iter=2, verbose=False,
                                      device="cpu")
    assert [h[0] for h in got] == [h[0] for h in want]
    for (_, eta), (_, eta_j) in zip(got, want):
        assert _rel(eta, eta_j) <= 1e-10


# --- entry points ----------------------------------------------------------------

_ENTRIES = {
    "reconstruction": lambda **kw: reconstruction.solve_and_equilibrate(
        unit_square(2), 1, 1, "dirichlet", FluxEqlbSE, **kw),
    "error_estimation": lambda **kw: error_estimation.run(
        FluxEqlbSE, 1, 1, "dirichlet", 1, **kw),
    "lshape_adaptive": lambda **kw: lshape_adaptive.adaptive_loop(
        max_iter=1, verbose=False, **kw),
    "discont_coeff": lambda **kw: discont_coeff.adaptive_loop(
        max_iter=1, verbose=False, **kw),
    "local_projection": lambda **kw: local_projection.projection_errors(
        4, **kw),
}


@pytest.mark.parametrize("name", sorted(_ENTRIES))
def test_demo_defaults_to_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        _ENTRIES[name]()


_MAINS = {
    "reconstruction": (reconstruction, ["--n", "3", "--degree", "2",
                                        "--bc", "neumann_inhom"]),
    "error_estimation": (error_estimation, ["--nref", "2", "--eqlb", "EV"]),
    "lshape_adaptive": (lshape_adaptive, ["--max-iter", "5", "--csv",
                                          "trace.csv"]),
    "discont_coeff": (discont_coeff, ["--max-iter", "5", "--csv",
                                      "trace.csv"]),
    "local_projection": (local_projection, ["--n", "4"]),
}


@pytest.mark.parametrize("name", sorted(_MAINS))
def test_demo_main_on_cpu(name, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    mod, argv = _MAINS[name]
    mod.main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out
    if "--csv" in argv:
        assert (tmp_path / "trace.csv").read_text().count("\n") == 6


def test_local_projection_errors():
    """DG2 projection errors on unit_square(16) fall with the mesh."""
    e16 = local_projection.projection_errors(16, device="cpu")
    e8 = local_projection.projection_errors(8, device="cpu")
    for name in ("f1", "f2"):
        assert 0.0 < e16[name] < e8[name] / 6


# --- the specs of tests/test_poisson.py on the port ----------------------------------

@pytest.mark.parametrize("mesh_fn", [
    lambda: unit_square(4),
    lambda: permute_vertices(unit_square(4), seed=11),
])
@pytest.mark.parametrize("deg", [1, 2, 3])
def test_poisson_polynomial_exact(mesh_fn, deg):
    """P_k solver reproduces a degree-k polynomial solution exactly."""
    msh = mesh_fn()

    def u_ext(x):
        return (x[..., 0] + 0.5 * x[..., 1]) ** deg

    def f(x):  # -laplace(u)
        if deg < 2:
            return np.zeros_like(x[..., 0])
        return -deg * (deg - 1) * (x[..., 0] + 0.5 * x[..., 1]) ** (deg - 2) * (
            1.0 + 0.25
        )

    V = FunctionSpace(msh, "P", deg)
    solver = PoissonSolver(V, device="cpu")
    uh = solver.solve(f, msh.boundary_facets, u_ext, rtol=1e-14)
    err = grad(uh) - expr_from_callable(
        lambda x: np.stack(
            [
                deg * (x[..., 0] + 0.5 * x[..., 1]) ** (deg - 1),
                0.5 * deg * (x[..., 0] + 0.5 * x[..., 1]) ** (deg - 1),
            ],
            axis=-1,
        ),
        msh,
        value_size=2,
    )
    e = float(cell_integrals_sq(err, 2 * deg + 2).sum())
    assert e < 1e-20, e


def test_poisson_convergence_rate():
    u = lambda x: np.sin(2 * np.pi * x[..., 0]) * np.cos(2 * np.pi * x[..., 1])
    f = lambda x: 8 * np.pi**2 * u(x)
    errs = []
    hs = []
    for n in [4, 8, 16]:
        msh = unit_square(n)
        V = FunctionSpace(msh, "P", 1)
        uh = PoissonSolver(V, device="cpu").solve(f, msh.boundary_facets, u,
                                                  rtol=1e-12)

        def gu(x):
            return np.stack(
                [
                    2 * np.pi * np.cos(2 * np.pi * x[..., 0]) * np.cos(2 * np.pi * x[..., 1]),
                    -2 * np.pi * np.sin(2 * np.pi * x[..., 0]) * np.sin(2 * np.pi * x[..., 1]),
                ],
                axis=-1,
            )

        err = grad(uh) - expr_from_callable(gu, msh, value_size=2)
        errs.append(np.sqrt(float(cell_integrals_sq(err, 8).sum())))
        hs.append(1.0 / n)
    rate = np.log(errs[-2] / errs[-1]) / np.log(hs[-2] / hs[-1])
    assert rate > 0.9, (errs, rate)


def test_poisson_neumann():
    """Mixed Dirichlet/Neumann: u = x^2 + y, Dirichlet on x in {0,1},
    Neumann (grad u . n) on y in {0,1}."""
    msh = unit_square(6)
    u = lambda x: x[..., 0] ** 2 + x[..., 1]
    f = lambda x: -2.0 * np.ones_like(x[..., 0])
    V = FunctionSpace(msh, "P", 2)
    dir_facets = np.concatenate(
        [
            msh.locate_boundary_facets(lambda x: np.isclose(x[..., 0], 0.0)),
            msh.locate_boundary_facets(lambda x: np.isclose(x[..., 0], 1.0)),
        ]
    )
    bottom = msh.locate_boundary_facets(lambda x: np.isclose(x[..., 1], 0.0))
    top = msh.locate_boundary_facets(lambda x: np.isclose(x[..., 1], 1.0))
    # outward normal flux grad(u).n: bottom n=(0,-1): -du/dy = -1; top: +1
    solver = PoissonSolver(V, device="cpu")
    uh = solver.solve(
        f,
        dir_facets,
        u,
        neumann=[
            (bottom, lambda x: -np.ones_like(x[..., 0])),
            (top, lambda x: np.ones_like(x[..., 0])),
        ],
        rtol=1e-14,
    )
    err = expr_from_callable(u, msh) - uh
    assert float(cell_integrals_sq(err, 8).sum()) < 1e-22


# --- the specs of tests/test_convergence.py on the port --------------------------------

def _u_pi(x):
    return np.sin(np.pi * x[..., 0]) * np.cos(np.pi * x[..., 1])


def _f_pi(x):
    return 2 * np.pi**2 * _u_pi(x)


def _sig_pi(x):  # -grad u
    return np.stack(
        [
            -np.pi * np.cos(np.pi * x[..., 0]) * np.cos(np.pi * x[..., 1]),
            np.pi * np.sin(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1]),
        ],
        -1,
    )


@pytest.mark.parametrize("Eqlb", [FluxEqlbSE, FluxEqlbEV])
@pytest.mark.parametrize("degree", [1, 2, 3, 4])
@pytest.mark.parametrize("bc_type", ["dirichlet", "neumann", "neumann_hom"])
def test_flux_convergence_rate(Eqlb, degree, bc_type):
    """The equilibrated flux converges at the JAX package's rates: the
    divergence error at rate >= k - 0.1, the L2 flux error at k - 0.1 for
    k <= 2 and k - 1.1 above (``tests/test_convergence.py`` explains the
    k >= 3 deficit, a property of the formulation)."""
    k = degree
    if k == 4:
        # CPU torch.linalg.solve with MKL hangs on large batched systems
        # with several threads (ROADMAP fault 3); keep k = 4 on one
        torch.set_num_threads(1)
    errs, errs_div, hs = [], [], []
    try:
        for n in (2, 4, 8):
            msh = unit_square(n)
            V = FunctionSpace(msh, "P", k)
            Vr = FunctionSpace(msh, "DG", k - 1)
            Vf = FunctionSpace(msh, "DG", k - 1, vs=2)
            rhs_proj = project(Vr, [_f_pi], quadrature_degree=2 * k + 10,
                               device="cpu")
            side = {name: msh.locate_boundary_facets(
                lambda x, a=a, v=v: np.isclose(x[..., a], v))
                for name, a, v in (("left", 0, 0.0), ("right", 0, 1.0),
                                   ("bot", 1, 0.0), ("top", 1, 1.0))}
            solver = PoissonSolver(V, device="cpu")
            if bc_type == "dirichlet":
                uh = solver.solve(rhs_proj[0], msh.boundary_facets, _u_pi,
                                  rtol=1e-13)
                fcts_prime, bcs = msh.boundary_facets, []
            elif bc_type == "neumann_hom":
                # du/dn vanishes on y in {0, 1}: homogeneous natural BC in
                # the primal solve, zero-valued essential flux BC
                fcts_prime = np.concatenate([side["left"], side["right"]])
                uh = solver.solve(rhs_proj[0], fcts_prime, _u_pi, rtol=1e-13)
                bcs = [fluxbc(0.0, side["bot"], None),
                       fluxbc(0.0, side["top"], None)]
            else:
                # sigma.n_out = -du/dn: inhomogeneous Neumann on x in {0, 1}
                gx = lambda x: (-np.pi * np.cos(np.pi * x[..., 0])
                                * np.cos(np.pi * x[..., 1]))
                gl = project_facet_trace(msh, side["left"], gx, k)
                gr = project_facet_trace(msh, side["right"],
                                         lambda x: -gx(x), k)
                fcts_prime = np.concatenate([side["bot"], side["top"]])
                uh = solver.solve(rhs_proj[0], fcts_prime, _u_pi,
                                  neumann=[(side["left"], gl),
                                           (side["right"], gr)],
                                  rtol=1e-13)
                bcs = [fluxbc(-gl, side["left"], None),
                       fluxbc(-gr, side["right"], None)]
            sigma_proj = project(Vf, [-1.0 * grad(uh)])
            eq = Eqlb(k, msh, rhs_proj, sigma_proj)
            eq.set_boundary_conditions([fcts_prime], [bcs])
            eq.equilibrate_fluxes()
            sig = reconstructed_flux_expr(eq.list_flux[0], sigma_proj[0])
            err = sig - expr_from_callable(_sig_pi, msh, value_size=2)
            errs.append(math.sqrt(float(cell_integrals_sq(
                err, 2 * k + 10).sum())))
            pts, w = gauss_triangle(2 * k + 10)
            dv = sig.evaluate_div(pts)[..., 0].numpy()
            fe = _f_pi(msh.map_points(pts))
            errs_div.append(math.sqrt(float(
                (np.abs(msh.detJ) * np.einsum("q,cq->c", w,
                                              (dv - fe) ** 2)).sum())))
            hs.append(1.0 / n)
    finally:
        torch.set_num_threads(2)
    rate_div = np.log(errs_div[-2] / errs_div[-1]) / np.log(hs[-2] / hs[-1])
    assert rate_div > degree - 0.1, (errs_div, rate_div)
    rate = np.log(errs[-2] / errs[-1]) / np.log(hs[-2] / hs[-1])
    expected = degree - 0.1 if degree <= 2 else degree - 1.1
    assert rate > expected, (errs, rate)
