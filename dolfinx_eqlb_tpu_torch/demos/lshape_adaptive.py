"""Demo: adaptive Poisson on the L-shaped domain.

Port of the JAX package's ``demos/demo_lshape_adaptive.py`` (reference
``demo/poisson_adaptive/demo_lshape.py``): the singular corner solution
u = r^(2/3) sin(2 theta / 3) (f = 0, Dirichlet data from the exact
solution), equilibrated-estimator driven Doerfler marking and
longest-edge-bisection refinement down to a target energy error.

Run:  python -m dolfinx_eqlb_tpu_torch.demos.lshape_adaptive
      [--order-prime 3] [--degree 3] [--theta 0.6] [--tol 1e-6]
      [--max-iter 90] [--csv trace.csv] [--device cpu]

The CSV has the JAX demo's columns (``iteration,ncells,eta,err_h1,I_eff``)
and one more, the primal solve's CG iterations.
"""

from __future__ import annotations

import argparse
import math

import numpy as np

from ..eqlb import FluxEqlbEV, FluxEqlbSE
from ..estimation import doerfler_mark, estimate_poisson
from ..fem import (
    FunctionSpace,
    cell_integrals_sq,
    expr_from_callable,
    grad,
    local_projection,
)
from ..fem.spaces import resolve_device
from ..mesh import lshape, refine_marked
from ..models import PoissonSolver
from ._stages import Stages

__all__ = ["u_exact", "grad_u_exact", "adaptive_loop", "CSV_HEADER"]

CSV_HEADER = "iteration,ncells,eta,err_h1,I_eff,cg_iterations"


def _polar(x):
    r = np.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)
    th = np.arctan2(x[..., 1], x[..., 0])
    th = np.where(th < 0, th + 2 * np.pi, th)
    return r, th


def u_exact(x):
    r, th = _polar(x)
    return r ** (2.0 / 3.0) * np.sin(2.0 * th / 3.0)


def grad_u_exact(x):
    r, th = _polar(x)
    r = np.maximum(r, 1e-300)
    ur = (2.0 / 3.0) * r ** (-1.0 / 3.0) * np.sin(2.0 * th / 3.0)
    ut = (2.0 / 3.0) * r ** (-1.0 / 3.0) * np.cos(2.0 * th / 3.0)
    c, s = np.cos(th), np.sin(th)
    return np.stack([ur * c - ut * s, ur * s + ut * c], axis=-1)


def _zero(x):
    return np.zeros(x.shape[:-1])


def adaptive_loop(order_prime=1, order_eqlb=1, theta=0.5, tol=1e-2,
                  max_iter=20, n0=2, Equilibrator=FluxEqlbSE, verbose=True,
                  csv_path=None, device=None, step_hook=None):
    """Returns (final mesh, history): one (ncells, err_h1, eta, I_eff,
    cg_iterations) row per iteration.

    ``step_hook(step)``, if given, is called at the end of every iteration
    with a dict: ``it``, ``mesh``, ``solver``, ``uh``, ``eq``, ``eta``,
    ``err_h1``, ``cell_eta_sq``, ``marked`` (None on the last iteration) and
    ``stages_s``, the seconds of each stage (device work included)."""
    dev = resolve_device(device, "adaptive_loop")
    msh = lshape(n0)
    history = []
    for it in range(max_iter):
        st = Stages(dev)
        k = order_eqlb
        V, Vr, Vf = st("spaces", lambda: (
            FunctionSpace(msh, "P", order_prime),
            FunctionSpace(msh, "DG", k - 1),
            FunctionSpace(msh, "DG", k - 1, vs=2)))
        rhs_proj = st("project_rhs", lambda: local_projection(
            Vr, [_zero], device=dev))
        solver = st("poisson_setup", lambda: PoissonSolver(V, device=dev))
        uh = st("poisson_solve", lambda: solver.solve(
            rhs_proj[0], msh.boundary_facets, u_exact, rtol=1e-12))
        sigma_proj = st("project_flux", lambda: local_projection(
            Vf, [-1.0 * grad(uh)]))
        eq = st("construct", lambda: Equilibrator(k, msh, rhs_proj,
                                                  sigma_proj))
        st("set_bcs", lambda: eq.set_boundary_conditions(
            [msh.boundary_facets], [[]]))
        st("equilibrate", eq.equilibrate_fluxes)
        sig_arg = None if Equilibrator is FluxEqlbEV else sigma_proj[0]
        eta, eta_sig, eta_osc, cell_eta = st("estimate", lambda: (
            estimate_poisson(_zero, uh, eq.list_flux[0], sig_arg)))

        def h1_error():
            err = grad(uh) - expr_from_callable(grad_u_exact, msh,
                                                value_size=2)
            return math.sqrt(float(cell_integrals_sq(err, 12).sum()))

        err_h1 = st("error", h1_error)
        cg = solver.last_iterations
        history.append((msh.num_cells, err_h1, eta,
                        eta / max(err_h1, 1e-300), cg))
        if verbose:
            print(f"it {it:2d}: cells {msh.num_cells:6d}  err {err_h1:.4e}  "
                  f"eta {eta:.4e}  I_eff {eta/err_h1:.3f}  CG {cg}",
                  flush=True)
        if csv_path is not None:
            # re-written every iteration: a long run killed mid-way still
            # leaves a complete trace (reference writes per-level CSVs too,
            # poisson_adaptive/demo_lshape.py:200-216)
            with open(csv_path, "w") as f:
                f.write(CSV_HEADER + "\n")
                for j, (nc_j, e_j, eta_j, ie_j, cg_j) in enumerate(history):
                    f.write(f"{j},{nc_j},{eta_j:.12e},{e_j:.12e},{ie_j:.6f},"
                            f"{cg_j}\n")
        done = eta <= tol
        marked = None
        if not done:
            marked = st("mark", lambda: doerfler_mark(cell_eta, theta))
            refined = st("refine", lambda: refine_marked(msh, marked))
        if step_hook is not None:
            step_hook({"it": it, "mesh": msh, "solver": solver, "uh": uh,
                       "eq": eq, "eta": eta, "err_h1": err_h1,
                       "cell_eta_sq": cell_eta, "marked": marked,
                       "stages_s": st.s})
        if done:
            break
        msh = refined
    return msh, history


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tol", type=float, default=1e-1)
    p.add_argument("--theta", type=float, default=0.5)
    p.add_argument("--max-iter", type=int, default=25)
    p.add_argument("--order-prime", type=int, default=1)
    p.add_argument("--degree", type=int, default=1)
    p.add_argument("--csv", type=str, default=None,
                   help="write the per-iteration trace (ncells, eta, err, "
                        "I_eff, CG iterations) to this CSV, updated every "
                        "iteration")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    a = p.parse_args(argv)
    msh, hist = adaptive_loop(a.order_prime, a.degree, a.theta, a.tol,
                              a.max_iter, csv_path=a.csv, device=a.device)
    h = np.array(hist)
    # adaptive convergence rate w.r.t. ncells (optimal: -p/2 for P_p)
    rate = np.polyfit(np.log(h[3:, 0]), np.log(h[3:, 2]), 1)[0]
    print(f"final: {int(h[-1,0])} cells, eta {h[-1,2]:.3e}, "
          f"eta ~ ncells^{rate:.2f} (optimal {-a.order_prime / 2})")


if __name__ == "__main__":
    main()
