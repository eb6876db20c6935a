"""Demo: weakly symmetric stress equilibration for linear elasticity.

Port of the JAX package's ``demos/demo_elasticity.py`` (reference
``demo/elasticity/demo_reconstruction.py`` + ``demo_error_estimation.py``),
both primal formulations:

* ``--formulation u``:  displacement, sigma = 2 eps(u) + pi_1 div(u) I
* ``--formulation up``: Herrmann displacement-pressure (Taylor-Hood
  P_{k+1} x P_k), sigma = 2 eps(u) + p I, with the C_a-weighted
  constitutive-mismatch term in the guaranteed bound.

Equilibrates the negated stress rows with weak symmetry and Korn
constants, and reports the guaranteed bound and its efficiency index
against the energy error.  The equilibration degree defaults to the
displacement order + 1 (see the JAX demo's docstring for why).

Run:  python -m dolfinx_eqlb_tpu_torch.demos.elasticity [--n 8]
      [--order-prime 2] [--degree D] [--formulation u|up] [--study]
      [--outfile F.csv] [--device cpu]

``--study`` runs n = 4, 8, 16, 32 and writes the CSV of the committed
``artifacts/ConvStudyElasticity-*.csv`` runs.
"""

from __future__ import annotations

import argparse
import csv

import numpy as np

from ..elements.quadrature import gauss_triangle
from ..eqlb import (
    FluxEqlbSE,
    check_divergence_condition,
    check_jump_condition,
    check_weak_symmetry_condition,
)
from ..estimation import estimate_elasticity
from ..fem import FunctionSpace, as_vector, expr_from_callable, local_projection
from ..fem.spaces import resolve_device
from ..mesh import unit_square
from ..models import ElasticitySolver, stress_row_expr
from ..models.elasticity import (
    ElasticitySolverUP,
    pressure_mismatch_expr,
    stress_row_expr_up,
)
from ._stages import Stages

__all__ = ["u_exact", "f_body", "run", "study", "CSV_HEADER"]

PI_1 = 1.0
CSV_HEADER = ["n", "h", "eta", "eta_sig", "eta_wsym", "eta_osc",
              "energy_error", "I_eff"]


# manufactured solution (divergence free)
def u_exact(x):
    return np.stack(
        [
            np.sin(np.pi * x[..., 0]) * np.cos(np.pi * x[..., 1]),
            -np.cos(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1]),
        ],
        -1,
    )


def f_body(x):
    # f = -div sigma(u) with div u = 0: f = -2 div eps(u) = -laplace(u)
    return 2 * np.pi**2 * u_exact(x)


def _f_rows():
    return [lambda x: f_body(x)[..., 0], lambda x: f_body(x)[..., 1]]


def _energy_error(msh, uh, ph, formulation):
    """Reference energy norms (``demo_error_estimation.py:185-208``)."""
    pts, w = gauss_triangle(12)
    xq = msh.map_points(pts)
    g = uh.evaluate_grad(pts).cpu().numpy()  # (nc, nq, 2, 2)
    # exact gradient of u_exact
    c, s_ = np.cos, np.sin
    pi = np.pi
    gex = np.empty_like(g)
    gex[..., 0, 0] = pi * c(pi * xq[..., 0]) * c(pi * xq[..., 1])
    gex[..., 0, 1] = -pi * s_(pi * xq[..., 0]) * s_(pi * xq[..., 1])
    gex[..., 1, 0] = pi * s_(pi * xq[..., 0]) * s_(pi * xq[..., 1])
    gex[..., 1, 1] = -pi * c(pi * xq[..., 0]) * c(pi * xq[..., 1])
    de = g - gex
    eps = 0.5 * (de + np.swapaxes(de, -1, -2))
    adet = np.abs(msh.detJ)
    if formulation == "u":
        dens = np.einsum("cqab,cqab->cq", eps, eps) + (
            de[..., 0, 0] + de[..., 1, 1]
        ) ** 2
    else:
        # div u_exact = 0
        dp = ph.evaluate(pts).cpu().numpy()[..., 0] / PI_1
        dens = 2.0 * np.einsum("cqab,cqab->cq", eps, eps) + dp**2
    return float(np.sqrt(np.einsum("q,cq,c->", w, dens, adet)))


def run(n=8, order_prime=2, degree=2, check=True, formulation="u",
        device=None, verbose=True, info=None, mode="semiexplicit"):
    """Solve, project, equilibrate with weak symmetry and Korn constants,
    estimate; returns (eta, [eta_sig, eta_wsym, eta_osc], energy error).
    With ``check`` the divergence, jump and weak-symmetry conditions must
    hold (AssertionError otherwise).  ``mode``: the engine's mode,
    "semiexplicit" or "kkt".  ``info``: a dict that gets the stage seconds
    (``stages_s``), the primal solver's ``iterations`` and ``maxiter``, the
    ``checks`` run, the projected stress rows ``sigma_proj`` and the
    equilibrator ``eq``."""
    dev = resolve_device(device, "elasticity.run")
    st = Stages(dev)
    msh = st("mesh", lambda: unit_square(n))
    Vf = FunctionSpace(msh, "DG", degree - 1, vs=2)
    Vr = FunctionSpace(msh, "DG", degree - 1)
    # project the body force FIRST and use the projected data in the primal
    # solve too: the weak-symmetry compatibility of interior patches rests
    # on the rotational Galerkin orthogonality of the primal residual, which
    # requires identical data on both sides
    rhs_proj = st("project_rhs", lambda: local_projection(
        Vr, _f_rows(), quadrature_degree=2 * degree + 8, device=dev))
    u_d = expr_from_callable(u_exact, msh, value_size=2)

    pressure_term = None
    if formulation == "u":
        V = FunctionSpace(msh, "P", order_prime, vs=2)
        solver = st("primal_setup", lambda: ElasticitySolver(V, PI_1,
                                                             device=dev))
        uh = st("primal_solve", lambda: solver.solve(
            as_vector(rhs_proj, msh), msh.boundary_facets, u_d, rtol=1e-12))
        ph = None
        kind = "CG"
        rows = [stress_row_expr(uh, PI_1, 0, -1.0),
                stress_row_expr(uh, PI_1, 1, -1.0)]
    else:
        Vu = FunctionSpace(msh, "P", order_prime + 1, vs=2)
        Vp = FunctionSpace(msh, "P", order_prime)
        solver = st("primal_setup", lambda: ElasticitySolverUP(
            Vu, Vp, PI_1, device=dev))
        uh, ph = st("primal_solve", lambda: solver.solve(
            as_vector(rhs_proj, msh), msh.boundary_facets, u_d, rtol=1e-12))
        kind = "MINRES"
        rows = [stress_row_expr_up(uh, ph, 0, -1.0),
                stress_row_expr_up(uh, ph, 1, -1.0)]
        pressure_term = pressure_mismatch_expr(uh, ph, PI_1)
    if verbose:
        print(f"Primal {formulation} elasticity solved "
              f"({solver.last_iterations} {kind} iters)")

    sigma_proj = st("project_stress", lambda: local_projection(Vf, rows))
    eq = st("construct", lambda: FluxEqlbSE(
        degree, msh, rhs_proj, sigma_proj, equilibrate_stress=True,
        estimate_korn_constant=True))
    eq.engine.mode = mode
    st("set_bcs", lambda: eq.set_boundary_conditions(
        [msh.boundary_facets] * 2, [[], []]))
    st("equilibrate", eq.equilibrate_fluxes)

    checks = {}
    if check:
        def run_checks():
            for i in range(2):
                checks[f"divergence_{i}"] = check_divergence_condition(
                    eq.list_flux[i], sigma_proj[i], rhs_proj[i])
                checks[f"jump_{i}"] = check_jump_condition(
                    eq.list_flux[i], sigma_proj[i])
            checks["weak_symmetry"] = check_weak_symmetry_condition(
                eq.list_flux, sigma_proj)

        st("checks", run_checks)
        if info is not None:
            info["checks"] = checks
        assert all(checks.values()), checks
        if verbose:
            print("Equilibration conditions (incl. weak symmetry) fulfilled")

    eta, comps, _ = st("estimate", lambda: estimate_elasticity(
        _f_rows(), PI_1, sigma_proj, eq.list_flux, eq.get_korn_constants(),
        pressure_term=pressure_term))
    err = st("error", lambda: _energy_error(msh, uh, ph, formulation))
    if verbose:
        print(f"guaranteed bound eta = {eta:.4e} "
              f"(eta_sig {comps[0]:.3e}, eta_wsym {comps[1]:.3e}, "
              f"eta_osc {comps[2]:.3e})")
        print(f"energy error = {err:.4e}, I_eff = {eta / err:.3f}")
    if info is not None:
        info.update(stages_s=st.s, iterations=solver.last_iterations,
                    maxiter=solver.last_maxiter, checks=checks, eq=eq,
                    sigma_proj=sigma_proj, cells=msh.num_cells)
    return eta, comps, err


def study(ns, order_prime, degree, formulation, outfile, device=None):
    """Refinement study: eta components, energy error, I_eff per level,
    written as CSV (reference ``demo_error_estimation.py:185-208``).
    Returns the rows."""
    rows_out = []
    for n in ns:
        eta, comps, err = run(n, order_prime, degree, check=False,
                              formulation=formulation, device=device,
                              verbose=False)
        rows_out.append([n, 1.0 / n, eta, comps[0], comps[1], comps[2],
                         err, eta / err])
    with open(outfile, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(CSV_HEADER)
        w.writerows(rows_out)
    print(f"\n{'n':>4} {'eta':>11} {'eta_sig':>11} {'eta_wsym':>11} "
          f"{'err':>11} {'I_eff':>8} {'rate(err)':>9}")
    for i, r in enumerate(rows_out):
        rate = (np.log(rows_out[i - 1][6] / r[6]) / np.log(2.0)
                if i else float("nan"))
        print(f"{r[0]:>4} {r[2]:>11.4e} {r[3]:>11.4e} {r[4]:>11.4e} "
              f"{r[6]:>11.4e} {r[7]:>8.3f} {rate:>9.2f}")
    print(f"study written to {outfile}")
    return rows_out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=8)
    p.add_argument("--order-prime", type=int, default=2)
    p.add_argument("--degree", type=int, default=None,
                   help="equilibration degree; default = displacement "
                        "order + 1 (u: order_prime + 1, up: order_prime + 2)")
    p.add_argument("--formulation", choices=["u", "up"], default="u")
    p.add_argument("--study", action="store_true",
                   help="run the n = 4..32 refinement study, write CSV")
    p.add_argument("--outfile", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    a = p.parse_args(argv)
    if a.degree is None:
        a.degree = a.order_prime + (1 if a.formulation == "u" else 2)
    if a.study:
        out = a.outfile or (
            f"ConvStudyElasticity-{a.formulation}_porder-{a.order_prime}"
            f"_eorder-{a.degree}.csv"
        )
        study((4, 8, 16, 32), a.order_prime, a.degree, a.formulation, out,
              device=a.device)
    else:
        run(a.n, a.order_prime, a.degree, formulation=a.formulation,
            device=a.device)


if __name__ == "__main__":
    main()
