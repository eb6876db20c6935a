"""Plain mesh topology of a triangle mesh given as (points, cells): facets,
cell-facet incidence and orientation, boundary facets and vertices, and the
vertex patches grouped by size.  NumPy only; written for the reference and
for the benchmark's mesh generators, independent of the program's tables.

Conventions (those that give a global RT dof vector its meaning): local
edge e of a cell is opposite local vertex e, its vertices in ascending local
order; a facet's canonical direction runs from its lower to its higher
global vertex id.  Facets are numbered here in ascending order of
(lower, higher) vertex id.
"""

from __future__ import annotations

import numpy as np

from .element import LOCAL_EDGES


class Topology:
    def __init__(self, cells: np.ndarray, num_vertices: int):
        cells = np.asarray(cells, dtype=np.int64)
        self.cells = cells
        self.num_cells = nc = len(cells)
        self.num_vertices = nv = int(num_vertices)
        ev = cells[:, LOCAL_EDGES]  # (nc, 3, 2), local order
        lo, hi = ev.min(-1), ev.max(-1)
        keys, inv = np.unique(lo * nv + hi, return_inverse=True)
        self.facet_keys = keys
        self.facet_vertices = np.stack([keys // nv, keys % nv], axis=-1)
        self.num_facets = nf = len(keys)
        self.cell_facets = inv.reshape(nc, 3)
        self.edge_aligned = ev[..., 0] < ev[..., 1]
        ncell_of = np.bincount(inv.ravel(), minlength=nf)
        if ncell_of.max() > 2:
            raise ValueError("non-manifold mesh: a facet of more than 2 cells")
        self.is_boundary_facet = ncell_of == 1
        bv = np.zeros(nv, dtype=bool)
        bv[self.facet_vertices[self.is_boundary_facet].ravel()] = True
        self.is_boundary_vertex = bv
        self.vertex_ncells = np.bincount(cells.ravel(), minlength=nv)

    def patches(self) -> dict[tuple[int, bool], tuple[np.ndarray, np.ndarray,
                                                      np.ndarray]]:
        """The vertex patches grouped by (cells in the patch, on the
        boundary): per group (vertices (P,), cells (P, n), the local index
        of the vertex in each cell (P, n)), cells in ascending id."""
        flat = self.cells.ravel()
        order = np.argsort(flat, kind="stable")
        cell_of, loc_of = order // 3, order % 3
        starts = np.concatenate([[0], np.cumsum(self.vertex_ncells)])
        groups = {}
        for n in np.unique(self.vertex_ncells):
            if n == 0:
                continue
            for bnd in (False, True):
                zs = np.where((self.vertex_ncells == n)
                              & (self.is_boundary_vertex == bnd))[0]
                if not len(zs):
                    continue
                rows = starts[zs][:, None] + np.arange(n)[None, :]
                groups[(int(n), bnd)] = (zs, cell_of[rows], loc_of[rows])
        return groups
