"""Gauss quadrature on the reference interval / triangle.

Replaces the reference's ``base/QuadratureRule.hpp`` (Basix Gauss rules on a
cell or on every sub-entity, reference ``QuadratureRule.hpp:76-134``).  Rules
are host-side NumPy constants baked into jitted programs.
"""

from __future__ import annotations

import numpy as np

__all__ = ["gauss_interval", "gauss_triangle", "facet_param_points"]


def gauss_interval(npts: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre rule on [0, 1]; exact for degree 2*npts - 1."""
    x, w = np.polynomial.legendre.leggauss(npts)
    return 0.5 * (x + 1.0), 0.5 * w


def gauss_triangle(degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Quadrature on the unit triangle, exact for polynomials of ``degree``.

    Duffy / collapsed tensor-product rule: with x = a, y = b (1 - a) the
    Jacobian is (1 - a), so a polynomial of total degree d becomes degree
    d + 1 in a and d in b.  Points (n*n, 2), weights (n*n,).
    """
    n = max(1, (degree + 2 + 1) // 2)  # ceil((d+2)/2)
    a, wa = gauss_interval(n)
    b, wb = gauss_interval(n)
    A, B = np.meshgrid(a, b, indexing="ij")
    WA, WB = np.meshgrid(wa, wb, indexing="ij")
    x = A.ravel()
    y = (B * (1.0 - A)).ravel()
    w = (WA * WB * (1.0 - A)).ravel()
    return np.stack([x, y], axis=-1), w


# local edges of the reference triangle (Basix convention: edge i is opposite
# vertex i, with vertices in ascending local order):
#   edge 0: v1 -> v2, edge 1: v0 -> v2, edge 2: v0 -> v1
LOCAL_EDGE_VERTICES = np.array([[1, 2], [0, 2], [0, 1]], dtype=np.int32)

_REF_VERTS = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])

# reference tangent of each local edge (second vertex - first vertex)
REF_EDGE_TANGENT = np.array([[-1.0, 1.0], [0.0, 1.0], [1.0, 0.0]])
# rotated tangent rot(t) = (t_y, -t_x): the *scaled normal* used in all facet
# functionals; satisfies J^T rot(J t) = det(J) rot(t)
REF_EDGE_ROTT = np.stack(
    [REF_EDGE_TANGENT[:, 1], -REF_EDGE_TANGENT[:, 0]], axis=-1
)


def facet_param_points(s: np.ndarray) -> np.ndarray:
    """Map parameter values s in [0,1] to reference-cell coords on each edge.

    Returns (3, len(s), 2): edge 0: (1-s, s); edge 1: (0, s); edge 2: (s, 0).
    """
    out = np.zeros((3, len(s), 2))
    for e in range(3):
        v0 = _REF_VERTS[LOCAL_EDGE_VERTICES[e, 0]]
        v1 = _REF_VERTS[LOCAL_EDGE_VERTICES[e, 1]]
        out[e] = v0[None, :] + s[:, None] * (v1 - v0)[None, :]
    return out
