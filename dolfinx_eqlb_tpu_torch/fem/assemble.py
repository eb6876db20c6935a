"""Batched assembly utilities.

Port of the JAX package's ``fem/assemble.py``: every cell integral is a
quadrature contraction with per-cell geometry factors (affine cells),
evaluated for the whole mesh in one batched op.
"""

from __future__ import annotations

import torch

from ..elements.quadrature import gauss_triangle
from .expressions import as_expr, target_device
from .spaces import mesh_geometry

__all__ = ["cell_integrals", "cell_integrals_sq", "assemble_scalar"]


def _values(e, quadrature_degree, device):
    pts, w = gauss_triangle(quadrature_degree)
    dev = target_device([e], device, "cell_integrals")
    vals = e.evaluate(pts).to(dev)  # (nc, nq, vs)
    adet = mesh_geometry(e.mesh, dev)["detJ"].abs()
    return vals, adet, torch.as_tensor(w, dtype=vals.dtype, device=dev)


def cell_integrals(expr, quadrature_degree: int, device=None):
    """Per-cell integrals of a scalar expression -> (nc,) tensor.

    Used for the DG0 error-estimator vectors (reference
    ``demo_error_estimation.py:104-112`` assembles ``err^2 * v * dx`` with a
    DG0 test function — identical to per-cell integration)."""
    vals, adet, w = _values(as_expr(expr), quadrature_degree, device)
    return adet * torch.einsum("q,cq->c", w, vals[..., 0])


def cell_integrals_sq(expr, quadrature_degree: int, device=None):
    """Per-cell integrals of |expr|^2 (any value size) -> (nc,)."""
    vals, adet, w = _values(as_expr(expr), quadrature_degree, device)
    return adet * torch.einsum("q,cqa,cqa->c", w, vals, vals)


def assemble_scalar(expr, quadrature_degree: int, device=None):
    """Integral of a scalar expression over the whole mesh."""
    return cell_integrals(expr, quadrature_degree, device).sum()
