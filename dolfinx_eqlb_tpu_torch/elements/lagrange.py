"""Lagrange P_k / discontinuous (Dubiner) elements on the reference triangle.

The continuous P_k element mirrors the reference's use of DOLFINx "CG"/"P"
spaces for the primal problem and the P1 hat functions (reference
``FluxEqlbEV.py:94-108``).  The DG spaces used for projected fluxes / RHS
(reference ``lsolver/projection.py``) are represented in the *orthonormal
Dubiner* basis, which makes cell-local L2 projection a quadrature moment
evaluation instead of a linear solve.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .polynomials import dubiner_basis, poly_diff, poly_eval
from .quadrature import LOCAL_EDGE_VERTICES

__all__ = ["LagrangeTri", "DubinerTri", "lagrange_nodes"]

_REF_VERTS = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])


def lagrange_nodes(degree: int) -> np.ndarray:
    """Equispaced Lagrange nodes: vertices, edge interiors, cell interior.

    Edge-interior nodes are listed along the local edge direction
    (LOCAL_EDGE_VERTICES order) — the dofmap reverses the block when a
    cell's edge is anti-aligned with the global facet direction.
    """
    k = degree
    pts = [_REF_VERTS[i] for i in range(3)]
    if k >= 2:
        for e in range(3):
            a = _REF_VERTS[LOCAL_EDGE_VERTICES[e, 0]]
            b = _REF_VERTS[LOCAL_EDGE_VERTICES[e, 1]]
            for i in range(1, k):
                pts.append(a + (b - a) * i / k)
    if k >= 3:
        for i in range(1, k):
            for j in range(1, k - i):
                pts.append(np.array([i / k, j / k]))
    return np.array(pts)


class LagrangeTri:
    """Continuous Lagrange element of given degree on the triangle."""

    def __init__(self, degree: int):
        self.degree = degree
        self.nodes = lagrange_nodes(degree)
        self.ndofs = len(self.nodes)
        self.ndofs_vertex = 1
        self.ndofs_edge = degree - 1
        self.ndofs_cell = (degree - 1) * (degree - 2) // 2 if degree >= 3 else 0
        modes = dubiner_basis(degree)
        V = np.array([poly_eval(C, self.nodes) for C in modes]).T  # (node, mode)
        Vinv = np.linalg.inv(V)
        # basis i = sum_m Vinv[m, i] * mode_m  -> coeff arrays
        n = max(C.shape[0] for C in modes)
        self.coeffs = np.zeros((self.ndofs, n, n))
        for i in range(self.ndofs):
            for m, C in enumerate(modes):
                self.coeffs[i, : C.shape[0], : C.shape[1]] += Vinv[m, i] * C

    def tabulate(self, pts: np.ndarray) -> np.ndarray:
        """Basis values, shape (ndofs, npts)."""
        return np.array([poly_eval(C, pts) for C in self.coeffs])

    def tabulate_grad(self, pts: np.ndarray) -> np.ndarray:
        """Reference gradients, shape (ndofs, 2, npts)."""
        out = np.zeros((self.ndofs, 2, len(pts)))
        for i, C in enumerate(self.coeffs):
            out[i, 0] = poly_eval(poly_diff(C, 0), pts)
            out[i, 1] = poly_eval(poly_diff(C, 1), pts)
        return out


class DubinerTri:
    """Orthonormal (Dubiner) modal basis of P_degree — the DG element.

    Mode 0 is the constant sqrt(2).  Physical basis is defined by pull-back
    Q_m(x) := Q^_m(xhat), so the cell mass matrix is |detJ| * Identity.
    """

    def __init__(self, degree: int):
        self.degree = degree
        self.modes = dubiner_basis(degree)
        self.ndofs = len(self.modes)

    def tabulate(self, pts: np.ndarray) -> np.ndarray:
        return np.array([poly_eval(C, pts) for C in self.modes])

    def tabulate_grad(self, pts: np.ndarray) -> np.ndarray:
        out = np.zeros((self.ndofs, 2, len(pts)))
        for i, C in enumerate(self.modes):
            out[i, 0] = poly_eval(poly_diff(C, 0), pts)
            out[i, 1] = poly_eval(poly_diff(C, 1), pts)
        return out


@lru_cache(maxsize=None)
def lagrange_cached(degree: int) -> LagrangeTri:
    return LagrangeTri(degree)


@lru_cache(maxsize=None)
def dubiner_cached(degree: int) -> DubinerTri:
    return DubinerTri(degree)
