"""Demo: adaptive Poisson with a discontinuous (Kellogg checkerboard)
coefficient.

Port of the JAX package's ``demos/demo_discont_coeff.py`` (reference
``demo/poisson_adaptive/demo_discont-coeff.py``): the Kellogg problem
-div(kappa grad u) = 0 on (-1,1)^2 with kappa = a on the quadrants
x*y > 0 and kappa = 1 elsewhere; the exact solution u = r^gamma mu(theta)
has a severe singularity at the origin (gamma = 0.1) that uniform
refinement cannot resolve — the equilibrated estimator + Doerfler marking
recovers the optimal adaptive rate.

Run:  python -m dolfinx_eqlb_tpu_torch.demos.discont_coeff [--max-iter 12]
      [--theta 0.5] [--csv trace.csv] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..eqlb import FluxEqlbSE
from ..estimation import doerfler_mark, estimate_poisson
from ..fem import FunctionSpace, cell_scale, grad, local_projection
from ..fem.spaces import resolve_device
from ..mesh import rectangle, refine_marked
from ..models import PoissonSolver

__all__ = ["kappa", "u_exact", "adaptive_loop"]

# Kellogg parameters for gamma = 0.1
GAMMA = 0.1
RHO = np.pi / 4.0
SIGMA = -14.9225651045515
A_COEF = 161.4476387975881


def kappa(x):
    return np.where(x[..., 0] * x[..., 1] > 0.0, A_COEF, 1.0)


def u_exact(x):
    r = np.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)
    th = np.arctan2(x[..., 1], x[..., 0])
    th = np.where(th < 0, th + 2 * np.pi, th)
    g = GAMMA
    mu = np.where(
        th < 0.5 * np.pi,
        np.cos((0.5 * np.pi - SIGMA) * g) * np.cos((th - 0.5 * np.pi + RHO) * g),
        np.where(
            th < np.pi,
            np.cos(RHO * g) * np.cos((th - np.pi + SIGMA) * g),
            np.where(
                th < 1.5 * np.pi,
                np.cos(SIGMA * g) * np.cos((th - np.pi - RHO) * g),
                np.cos((0.5 * np.pi - RHO) * g) * np.cos((th - 1.5 * np.pi - SIGMA) * g),
            ),
        ),
    )
    return r**g * mu


def _zero(x):
    return np.zeros(x.shape[:-1])


def adaptive_loop(theta=0.5, max_iter=15, order=1, verbose=True, device=None,
                  stats=None):
    """Returns the history, one (ncells, eta) row per iteration.  ``stats``:
    a list that gets one dict per iteration (cells, eta, CG iterations)."""
    dev = resolve_device(device, "adaptive_loop")
    msh = rectangle((-1.0, -1.0), (1.0, 1.0), 4, 4, diagonal="crossed")
    history = []
    for it in range(max_iter):
        k = order
        V = FunctionSpace(msh, "P", order)
        Vr = FunctionSpace(msh, "DG", k - 1)
        Vf = FunctionSpace(msh, "DG", k - 1, vs=2)
        solver = PoissonSolver(V, coefficient=kappa, device=dev)
        rhs_proj = local_projection(Vr, [_zero], device=dev)
        uh = solver.solve(rhs_proj[0], msh.boundary_facets, u_exact, rtol=1e-12)
        # flux sigma = -kappa grad u
        sigma_proj = local_projection(
            Vf, [cell_scale(grad(uh), -solver.coefficient)]
        )
        eq = FluxEqlbSE(k, msh, rhs_proj, sigma_proj)
        eq.set_boundary_conditions([msh.boundary_facets], [[]])
        eq.equilibrate_fluxes()
        eta, eta_sig, eta_osc, cell_eta = estimate_poisson(
            _zero,
            uh,
            eq.list_flux[0],
            sigma_proj[0],
            coefficient=solver.coefficient,
        )
        history.append((msh.num_cells, eta))
        if stats is not None:
            stats.append({"it": it, "cells": msh.num_cells, "eta": eta,
                          "cg_iterations": solver.last_iterations})
        if verbose:
            print(f"it {it:2d}: cells {msh.num_cells:6d}  eta {eta:.4e}")
        if it + 1 < max_iter:
            msh = refine_marked(msh, doerfler_mark(cell_eta, theta))
    return history


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--max-iter", type=int, default=12)
    p.add_argument("--theta", type=float, default=0.5)
    p.add_argument("--csv", type=str, default=None,
                   help="write the trace (iteration, ncells, eta) to this CSV")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    a = p.parse_args(argv)
    hist = adaptive_loop(theta=a.theta, max_iter=a.max_iter, device=a.device)
    h = np.array(hist)
    if a.csv is not None:
        with open(a.csv, "w") as f:
            f.write("iteration,ncells,eta\n")
            for j, (nc_j, eta_j) in enumerate(hist):
                f.write(f"{j},{nc_j},{eta_j:.12e}\n")
    rate = np.polyfit(np.log(h[3:, 0]), np.log(h[3:, 1]), 1)[0]
    print(f"eta ~ ncells^{rate:.2f} (optimal -0.5)")


if __name__ == "__main__":
    main()
