"""Function spaces and dofmaps (host side).

Host-only counterpart of the JAX package's ``fem/spaces.py``: the
``FunctionSpace`` dofmap tables are plain NumPy, copied unchanged.  The
device ``Function`` (evaluation, div, grad) is not ported yet.

Four families on triangles:

* ``"P"``    continuous Lagrange of degree k (primal solutions, hat functions)
* ``"DG"``   discontinuous, *orthonormal Dubiner* modal basis of degree k
             (projected fluxes / RHS; mass matrix = |detJ| * I per cell)
* ``"RT"``   H(div)-conforming hierarchic Raviart-Thomas of degree k
             (equilibrated fluxes; facet dofs shared, orientation signs)
* ``"DRT"``  cell-wise (discontinuous) hierarchic RT (SE flux correctors,
             reference ``FluxEqlbSE.py:98-101``)
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..elements.lagrange import lagrange_cached, dubiner_cached
from ..elements.rt import rt_cached
from ..mesh.topology import TriMesh

__all__ = ["FunctionSpace"]


class FunctionSpace:
    def __init__(self, mesh: TriMesh, family: str, degree: int, vs: int = 1):
        self.mesh = mesh
        self.family = family
        self.degree = degree
        nc = mesh.num_cells

        if family == "P":
            if degree < 1:
                raise ValueError("P degree >= 1")
            el = self.element = lagrange_cached(degree)
            k = degree
            nv, nf = mesh.num_vertices, mesh.num_facets
            n_edge = k - 1
            n_int = el.ndofs_cell
            self.ndofs_scalar = nv + nf * n_edge + nc * n_int
            cd = np.empty((nc, el.ndofs), dtype=np.int64)
            cd[:, :3] = mesh.cells
            for e in range(3):
                f = mesh.cell_facets[:, e].astype(np.int64)
                aligned = mesh.edge_aligned[:, e]
                for i in range(n_edge):
                    # element node order runs along the local edge direction;
                    # reverse the block when anti-aligned with the canonical
                    # (ascending-global-id) facet direction
                    ii = np.where(aligned, i, n_edge - 1 - i)
                    cd[:, 3 + e * n_edge + i] = nv + f * n_edge + ii
            base = nv + nf * n_edge
            for j in range(n_int):
                cd[:, 3 + 3 * n_edge + j] = base + np.arange(nc) * n_int + j
            self.cell_dofs = cd.astype(np.int32)
            self.dof_signs = None
            self.vs = vs
        elif family == "DG":
            el = self.element = dubiner_cached(degree)
            nd = el.ndofs
            self.ndofs_scalar = nc * nd
            self.cell_dofs = (
                np.arange(nc, dtype=np.int64)[:, None] * nd
                + np.arange(nd)[None, :]
            ).astype(np.int32)
            self.dof_signs = None
            self.vs = vs
        elif family == "RT":
            el = self.element = rt_cached(degree)
            if vs != 1:
                raise ValueError("RT is intrinsically vector-valued")
            k = degree
            nf = mesh.num_facets
            kk1 = el.ndofs_cell
            self.ndofs_scalar = nf * k + nc * kk1
            cd = np.empty((nc, el.ndofs), dtype=np.int64)
            sg = np.ones((nc, el.ndofs))
            for e in range(3):
                f = mesh.cell_facets[:, e].astype(np.int64)
                aligned = mesh.edge_aligned[:, e]
                for m in range(k):
                    cd[:, e * k + m] = f * k + m
                    # facet reversal: s -> 1-s and normal flip give the
                    # diagonal sign (-1)^(m+1) (cf. the reference's binomial
                    # transformation se/KernelData.cpp:46-64 for monomials)
                    sg[:, e * k + m] = np.where(aligned, 1.0, (-1.0) ** (m + 1))
            for j in range(kk1):
                cd[:, 3 * k + j] = nf * k + np.arange(nc) * kk1 + j
            self.cell_dofs = cd.astype(np.int32)
            self.dof_signs = sg
            self.vs = 2  # physical value shape
        elif family == "DRT":
            el = self.element = rt_cached(degree)
            nd = el.ndofs
            self.ndofs_scalar = nc * nd
            self.cell_dofs = (
                np.arange(nc, dtype=np.int64)[:, None] * nd
                + np.arange(nd)[None, :]
            ).astype(np.int32)
            self.dof_signs = None
            self.vs = 2
        else:
            raise ValueError(f"unknown family {family}")

        if family in ("P", "DG"):
            self.block_size = vs
        else:
            self.block_size = 1
        self.ndofs = self.ndofs_scalar * self.block_size

    # --- tabulation caches (host NumPy) -------------------------------------

    @lru_cache(maxsize=32)
    def _tab(self, pts_key):
        pts = np.array(pts_key)
        return self.element.tabulate(pts)

    def tabulate(self, pts: np.ndarray) -> np.ndarray:
        return self._tab(tuple(map(tuple, np.asarray(pts))))
