"""Demo: adaptive weakly-symmetric stress equilibration on Cook's membrane.

Port of the JAX package's ``demos/demo_cook_adaptive.py`` (reference
``demo/elasticity_adaptive/demo_cook.py``): clamped left edge, traction
(0, 1/16) on the right edge, guaranteed estimator driving Doerfler marking
and bisection refinement.  The deficient pure-traction corner patches
(right edge) are handled by the engine's patch grouping
(``eqlb.grouping``); the user's mesh is never modified.

True-error reporting: a numerical overkill solution (final mesh uniformly
refined once, degree + 1) serves as reference.  All meshes are nested, so
the energy error in the a-norm reduces to the traction functional
difference  |||u_ref - u_h|||^2 = L(u_ref) - L(u_h),
L(v) = int_right t . v ds, and needs no cross-mesh interpolation.

Run:  python -m dolfinx_eqlb_tpu_torch.demos.cook_adaptive [--max-iter 6]
      [--theta 0.5] [--order-prime 2] [--degree D] [--outfile F.csv]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import csv

import numpy as np

from ..elements.quadrature import LOCAL_EDGE_VERTICES as LOC, gauss_interval
from ..eqlb import FluxEqlbSE, fluxbc
from ..estimation import doerfler_mark, estimate_elasticity
from ..fem import FunctionSpace, expr_from_callable, local_projection
from ..fem.spaces import resolve_device
from ..mesh import cook_membrane, refine_marked, refine_uniform
from ..models import ElasticitySolver, stress_row_expr
from ._stages import Stages

__all__ = ["run", "CSV_HEADER"]

PI_1 = 1.0
TRACTION = 1.0 / 16.0
CSV_HEADER = ["ncells", "eta", "err", "I_eff", "eta_sig", "eta_wsym",
              "eta_osc"]


def _zero2(x):
    return np.zeros(x.shape[:-1] + (2,))


def _zero(x):
    return np.zeros(x.shape[:-1])


def _solve_primal(msh, order_prime, device, rtol=1e-11):
    """(uh, left facets, right facets, solver)."""
    V = FunctionSpace(msh, "P", order_prime, vs=2)
    left = msh.locate_boundary_facets(lambda x: np.isclose(x[..., 0], 0.0))
    right = msh.locate_boundary_facets(lambda x: np.isclose(x[..., 0], 48.0))
    solver = ElasticitySolver(V, PI_1, device=device)
    uh = solver.solve(
        expr_from_callable(_zero2, msh, value_size=2),
        left,
        expr_from_callable(_zero2, msh, value_size=2),
        tractions=[
            (right, lambda x: np.stack(
                [np.zeros(x.shape[:-1]), TRACTION * np.ones(x.shape[:-1])], -1
            ))
        ],
        rtol=rtol,
    )
    return uh, left, right, solver


def _load_functional(msh, uh, right):
    """L(u) = int_right (0, TRACTION) . u ds (2-pt Gauss per facet)."""
    t, w = gauss_interval(3)
    vref = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    pts = np.concatenate([
        vref[a][None] + t[:, None] * (vref[b] - vref[a])[None]
        for a, b in LOC
    ], 0)  # (3*nq, 2)
    vals = uh.evaluate(pts).cpu().numpy().reshape(
        msh.num_cells, 3, len(t), 2)
    c, l = msh.facet_cells[right, 0], msh.facet_local[right, 0]
    uy = vals[c, l][..., 1]  # (nF, nq)
    gv = msh.facet_vertices[right]
    hF = np.linalg.norm(msh.points[gv[:, 1]] - msh.points[gv[:, 0]], axis=1)
    return float(TRACTION * np.einsum("q,fq,f->", w, uy, hF))


def run(order_prime=2, degree=None, theta=0.5, max_iter=6, n0=2,
        verbose=True, device=None, step_hook=None, overkill=True,
        max_cells=None):
    """Rows (ncells, eta, err, I_eff, eta_sig, eta_wsym, eta_osc) per
    iteration; err and I_eff against the overkill reference (NaN without
    ``overkill``).  ``max_cells``: also stop after the first iteration on
    a mesh of at least this many cells.

    ``step_hook(step)``, if given, is called at the end of every iteration
    with a dict: ``it``, ``mesh``, ``solver``, ``uh``, ``sigma_proj``,
    ``eq``, ``eta``, ``L_h``, ``comps`` and ``stages_s``, the seconds of
    each stage (device work included)."""
    dev = resolve_device(device, "cook_adaptive.run")
    if degree is None:
        degree = order_prime + 1  # estimator-grade (see demos.elasticity)
    msh = cook_membrane(n0, n0)
    history = []
    for it in range(max_iter):
        st = Stages(dev)
        uh, left, right, solver = st("primal", lambda: _solve_primal(
            msh, order_prime, dev))
        other = np.setdiff1d(msh.boundary_facets,
                             np.concatenate([left, right]))

        Vf = FunctionSpace(msh, "DG", degree - 1, vs=2)
        Vr = FunctionSpace(msh, "DG", degree - 1)
        sigma_proj = st("project_stress", lambda: local_projection(
            Vf, [stress_row_expr(uh, PI_1, 0, -1.0),
                 stress_row_expr(uh, PI_1, 1, -1.0)]))
        rhs_proj = st("project_rhs", lambda: local_projection(
            Vr, [_zero] * 2, device=dev))
        # deficient pure-traction corner patches are grouped automatically
        eq = st("construct", lambda: FluxEqlbSE(
            degree, msh, rhs_proj, sigma_proj, equilibrate_stress=True,
            estimate_korn_constant=True))
        # flux BCs: the equilibrated rows are -sigma rows, so sigma.n = t
        # becomes row_i . n = -t_i on traction/free boundaries; the clamped
        # (Dirichlet) edge leaves the flux free
        bcs_row0 = [fluxbc(0.0, np.concatenate([right, other]))]
        bcs_row1 = [fluxbc(-TRACTION, right), fluxbc(0.0, other)]
        st("set_bcs", lambda: eq.set_boundary_conditions(
            [left, left], [bcs_row0, bcs_row1]))
        st("equilibrate", eq.equilibrate_fluxes)

        eta, comps, cell_eta = st("estimate", lambda: estimate_elasticity(
            [_zero] * 2, PI_1, sigma_proj, eq.list_flux,
            eq.get_korn_constants()))
        L_h = st("functional", lambda: _load_functional(msh, uh, right))
        history.append([msh.num_cells, eta, L_h, comps[0], comps[1],
                        comps[2]])
        if verbose:
            print(f"it {it}: cells {msh.num_cells:6d}  eta {eta:.4e} "
                  f"(sig {comps[0]:.2e}, wsym {comps[1]:.2e}, "
                  f"osc {comps[2]:.2e})  L(u_h) {L_h:.8e}", flush=True)
        refined = None
        last = it + 1 == max_iter or (max_cells is not None
                                      and msh.num_cells >= max_cells)
        if not last:
            refined = st("refine", lambda: refine_marked(
                msh, doerfler_mark(cell_eta, theta)))
        if step_hook is not None:
            step_hook({"it": it, "mesh": msh, "solver": solver, "uh": uh,
                       "sigma_proj": sigma_proj, "eq": eq, "eta": eta, "L_h": L_h, "comps": comps,
                       "stages_s": st.s})
        if last:
            break
        msh = refined

    L_ref = float("nan")
    if overkill:
        # overkill reference: final mesh refined once, degree + 1
        msh_ref = refine_uniform(msh)
        u_ref, _, right_ref, _ = _solve_primal(msh_ref, order_prime + 1, dev,
                                               rtol=1e-12)
        L_ref = _load_functional(msh_ref, u_ref, right_ref)
        if verbose:
            print(f"overkill: cells {msh_ref.num_cells}, "
                  f"P{order_prime + 1}, L(u_ref) {L_ref:.8e}", flush=True)
    out = []
    for cells, eta, L_h, *c in history:
        err = float(np.sqrt(max(L_ref - L_h, 0.0))) if overkill \
            else float("nan")
        ieff = eta / err if err > 0 else float("inf")
        out.append((cells, eta, err, ieff, *c))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--max-iter", type=int, default=6)
    p.add_argument("--theta", type=float, default=0.5)
    p.add_argument("--order-prime", type=int, default=2)
    p.add_argument("--degree", type=int, default=None)
    p.add_argument("--outfile", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    a = p.parse_args(argv)
    hist = run(order_prime=a.order_prime, degree=a.degree,
               max_iter=a.max_iter, theta=a.theta, device=a.device)
    print(f"\n{'cells':>7} {'eta':>11} {'err':>11} {'I_eff':>7}")
    for cells, eta, err, ieff, *_ in hist:
        print(f"{cells:>7} {eta:>11.4e} {err:>11.4e} {ieff:>7.3f}")
    if len(hist) > 2:
        h = np.array([(c, e) for c, e, *_ in hist])
        rate = np.polyfit(np.log(h[1:, 0]), np.log(h[1:, 1]), 1)[0]
        print(f"eta ~ ncells^{rate:.2f}")
    if a.outfile:
        with open(a.outfile, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(CSV_HEADER)
            w.writerows(hist)
        print(f"written to {a.outfile}")


if __name__ == "__main__":
    main()
