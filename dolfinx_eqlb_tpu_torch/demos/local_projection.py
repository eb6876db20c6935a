"""Demo: cell-local L2 projection.

Port of the JAX package's ``demos/demo_local_projection.py`` (reference
``demo/projection/demo_local_projection.py``): project two non-polynomial
functions into DG2 and report the projection residuals.

Run:  python -m dolfinx_eqlb_tpu_torch.demos.local_projection [--n 16]
      [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..fem import (
    FunctionSpace,
    cell_integrals_sq,
    expr_from_callable,
    local_projection,
)
from ..fem.spaces import resolve_device
from ..mesh import unit_square

__all__ = ["f1", "f2", "projection_errors"]


def f1(x):
    return np.sin(2 * np.pi * x[..., 0]) * np.sin(2 * np.pi * x[..., 1])


def f2(x):
    return np.exp(-10 * ((x[..., 0] - 0.5) ** 2 + (x[..., 1] - 0.5) ** 2))


def projection_errors(n=16, device=None) -> dict:
    """L2 errors of the DG2 projections of ``f1`` and ``f2`` on
    ``unit_square(n)``."""
    dev = resolve_device(device, "projection_errors")
    msh = unit_square(n)
    V = FunctionSpace(msh, "DG", 2)
    u1, u2 = local_projection(V, [f1, f2], quadrature_degree=12, device=dev)
    return {name: np.sqrt(float(cell_integrals_sq(
        expr_from_callable(f, msh) - u, 12).sum()))
        for name, u, f in (("f1", u1, f1), ("f2", u2, f2))}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=16)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    a = p.parse_args(argv)
    for name, err in projection_errors(a.n, device=a.device).items():
        print(f"||{name} - P(f)||_L2 = {err:.3e}")


if __name__ == "__main__":
    main()
