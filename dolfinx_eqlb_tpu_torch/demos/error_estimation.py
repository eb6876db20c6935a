"""Demo: a-posteriori error estimation for Poisson (convergence study).

Port of the JAX package's ``demos/demo_error_estimation.py`` (reference
``demo/poisson/demo_error_estimation.py``): uniform refinement series,
equilibrated Ern-Vohralik estimator, true H1 error, convergence rates and
efficiency index, CSV output.

Run:  python -m dolfinx_eqlb_tpu_torch.demos.error_estimation [--eqlb SE|EV]
      [--order-prime 1] [--degree 1] [--bc dirichlet] [--nref 5]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np

from ..eqlb import FluxEqlbEV, FluxEqlbSE
from ..estimation import estimate_poisson
from ..fem import cell_integrals_sq, expr_from_callable, grad
from ..fem.spaces import resolve_device
from ..mesh import unit_square
from .reconstruction import rhs, solve_and_equilibrate

__all__ = ["grad_u", "run", "HEADER"]

HEADER = "h, n_elmt, err_u_h1, convrate_u_h1, eta, eta_sig, eta_osc, I_eff"


def grad_u(x):
    return np.stack(
        [
            2 * np.pi * np.cos(2 * np.pi * x[..., 0]) * np.cos(2 * np.pi * x[..., 1]),
            -2 * np.pi * np.sin(2 * np.pi * x[..., 0]) * np.sin(2 * np.pi * x[..., 1]),
        ],
        axis=-1,
    )


def run(Equilibrator, order_prime, order_eqlb, bc_type, nref, n0=2,
        device=None, stats=None):
    """Rows (nref, 8) of ``HEADER`` for n = n0 * 2**i, i < nref.  ``stats``:
    a list that gets one dict per row (cells, CG iterations, seconds)."""
    dev = resolve_device(device, "error_estimation.run")
    rows = np.zeros((nref, 8))
    for i in range(nref):
        t0 = time.perf_counter()
        n = n0 * 2**i
        msh = unit_square(n)
        info = {}
        uh, sigma_proj, eq = solve_and_equilibrate(
            msh, order_prime, order_eqlb, bc_type, Equilibrator, check=False,
            device=dev, verbose=False, info=info,
        )
        sig_arg = (
            None if Equilibrator is FluxEqlbEV else sigma_proj
        )
        eta, eta_sig, eta_osc, _ = estimate_poisson(
            rhs, uh, eq.list_flux[0], sig_arg
        )
        err = grad(uh) - expr_from_callable(grad_u, msh, value_size=2)
        err_h1 = math.sqrt(float(cell_integrals_sq(err, 12).sum()))
        rows[i] = [1.0 / n, msh.num_cells, err_h1, 0.0, eta, eta_sig, eta_osc,
                   eta / err_h1]
        if stats is not None:
            stats.append({"n": n, "cells": msh.num_cells,
                          "cg_iterations": info["cg_iterations"],
                          "seconds": time.perf_counter() - t0})
    rows[1:, 3] = np.log(rows[1:, 2] / rows[:-1, 2]) / np.log(
        rows[1:, 0] / rows[:-1, 0]
    )
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--eqlb", default="SE", choices=["SE", "EV"])
    p.add_argument("--order-prime", type=int, default=1)
    p.add_argument("--degree", type=int, default=1)
    p.add_argument("--bc", default="dirichlet")
    p.add_argument("--nref", type=int, default=5)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    a = p.parse_args(argv)
    Eq = FluxEqlbSE if a.eqlb == "SE" else FluxEqlbEV
    rows = run(Eq, a.order_prime, a.degree, a.bc, a.nref, device=a.device)
    out = f"ConvStudyFluxEqlb-{a.eqlb}_porder-{a.order_prime}_eorder-{a.degree}.csv"
    np.savetxt(out, rows, delimiter=",", header=HEADER)
    print(HEADER)
    for r in rows:
        print(", ".join(f"{v:.4e}" for v in r))


if __name__ == "__main__":
    main()
