"""Triangle-mesh topology and geometry as flat NumPy index tables.

TPU-native replacement for the DOLFINx mesh objects the reference leans on
(connectivities 0<->1<->2 created in ``FluxEquilibrator.py:52-67``, facet
permutations via ``get_facet_permutations`` in
``se/solve_patch_semiexplt.hpp:296-424``): all connectivity is computed once
on the host with vectorized NumPy; the resulting int32 arrays are baked into
jitted programs as constants.

Conventions
-----------
* cells: (nc, 3) int32 vertex ids, any orientation (detJ may be negative —
  handled exactly like DOLFINx-sorted meshes so the orientation machinery is
  always exercised).
* local edge i of a cell is opposite local vertex i, with vertices in
  ascending *local* order: e0=(v1,v2), e1=(v0,v2), e2=(v0,v1).
* every global facet has a canonical direction: from its lower to its higher
  global vertex id. ``edge_aligned[c, i]`` is True when cell c's local edge i
  runs in the canonical direction.
"""

from __future__ import annotations

import numpy as np

__all__ = ["TriMesh"]

_LOC = np.array([[1, 2], [0, 2], [0, 1]], dtype=np.int64)


class TriMesh:
    def __init__(self, points: np.ndarray, cells: np.ndarray):
        self.points = np.asarray(points, dtype=np.float64)
        self.cells = np.ascontiguousarray(cells, dtype=np.int32)
        nc = self.num_cells = len(self.cells)
        self.num_vertices = len(self.points)

        # --- facets: unique sorted vertex pairs over all cell edges.
        # Native C++ extraction when available (facet ids in discovery
        # order), NumPy fallback (ids in sorted-key order) — the numbering
        # is internal and each mesh is self-consistent.
        ev = self.cells[:, _LOC]  # (nc, 3, 2) edge vertices (local order)
        from .. import native

        nat = native.build_facets(self.cells, self.num_vertices)
        if nat is not None:
            fv, cf, fc, fl = nat
            self.num_facets = len(fv)
            self.facet_vertices = fv
            self.cell_facets = cf
            self.facet_cells = fc
            self.facet_local = fl
        else:
            ev_sorted = np.sort(ev, axis=-1)
            key = ev_sorted[..., 0].astype(np.int64) * self.num_vertices + ev_sorted[
                ..., 1
            ].astype(np.int64)
            uniq, inv = np.unique(key.ravel(), return_inverse=True)
            self.num_facets = len(uniq)
            self.facet_vertices = np.stack(
                [uniq // self.num_vertices, uniq % self.num_vertices], axis=-1
            ).astype(np.int32)  # (nf, 2) canonical (lo, hi)
            self.cell_facets = inv.reshape(nc, 3).astype(np.int32)

            # facet -> (cells, local ids): at most 2 cells per facet
            order = np.argsort(inv.ravel(), kind="stable")
            f_sorted = inv.ravel()[order]
            cell_of = (order // 3).astype(np.int32)
            loc_of = (order % 3).astype(np.int32)
            counts = np.bincount(f_sorted, minlength=self.num_facets)
            if counts.max() > 2:
                raise ValueError("non-manifold mesh: facet shared by > 2 cells")
            starts = np.concatenate([[0], np.cumsum(counts)])
            self.facet_cells = np.full((self.num_facets, 2), -1, dtype=np.int32)
            self.facet_local = np.full((self.num_facets, 2), -1, dtype=np.int32)
            first = starts[:-1]
            self.facet_cells[:, 0] = cell_of[first]
            self.facet_local[:, 0] = loc_of[first]
            has2 = counts == 2
            self.facet_cells[has2, 1] = cell_of[first[has2] + 1]
            self.facet_local[has2, 1] = loc_of[first[has2] + 1]

        # edge alignment: local direction (ascending local index -> vertices
        # ev[..., 0] -> ev[..., 1]) vs canonical (ascending global id)
        self.edge_aligned = ev[..., 0] < ev[..., 1]  # (nc, 3) bool
        self.is_boundary_facet = self.facet_cells[:, 1] < 0
        self.boundary_facets = np.where(self.is_boundary_facet)[0].astype(
            np.int32
        )

        # --- vertex -> cells CSR (3 entries per cell)
        vflat = self.cells.ravel().astype(np.int64)
        vorder = np.argsort(vflat, kind="stable")
        self.v2c_offsets = np.concatenate(
            [[0], np.cumsum(np.bincount(vflat, minlength=self.num_vertices))]
        ).astype(np.int64)
        self.v2c_data = (vorder // 3).astype(np.int32)

        # --- vertex -> facets CSR
        fv = self.facet_vertices.ravel().astype(np.int64)
        forder = np.argsort(fv, kind="stable")
        self.v2f_offsets = np.concatenate(
            [[0], np.cumsum(np.bincount(fv, minlength=self.num_vertices))]
        ).astype(np.int64)
        self.v2f_data = (forder // 2).astype(np.int32)

        bv = np.zeros(self.num_vertices, dtype=bool)
        bv[self.facet_vertices[self.boundary_facets].ravel()] = True
        self.is_boundary_vertex = bv

        # --- affine geometry
        v0 = self.points[self.cells[:, 0]]
        v1 = self.points[self.cells[:, 1]]
        v2 = self.points[self.cells[:, 2]]
        self.J = np.stack([v1 - v0, v2 - v0], axis=-1)  # (nc, 2, 2)
        self.detJ = (
            self.J[:, 0, 0] * self.J[:, 1, 1] - self.J[:, 0, 1] * self.J[:, 1, 0]
        )
        # degeneracy must be judged relative to the cell scale: |detJ| = 2*area
        # ~ h^2 for a healthy triangle of any size, and deep adaptive
        # refinement at a corner singularity legitimately reaches h ~ 1e-11
        # (detJ ~ 1e-22).  An absolute cutoff would reject those healthy cells.
        e01 = np.linalg.norm(v1 - v0, axis=-1)
        e02 = np.linalg.norm(v2 - v0, axis=-1)
        e12 = np.linalg.norm(v2 - v1, axis=-1)
        h_max2 = np.maximum(np.maximum(e01, e02), e12) ** 2
        if np.any(np.abs(self.detJ) <= 1e-12 * h_max2):
            raise ValueError("degenerate cell in mesh")
        inv_det = 1.0 / self.detJ
        self.K = np.empty_like(self.J)  # J^{-1}
        self.K[:, 0, 0] = self.J[:, 1, 1] * inv_det
        self.K[:, 0, 1] = -self.J[:, 0, 1] * inv_det
        self.K[:, 1, 0] = -self.J[:, 1, 0] * inv_det
        self.K[:, 1, 1] = self.J[:, 0, 0] * inv_det
        self.cell_volumes = 0.5 * np.abs(self.detJ)
        self.cell_origins = v0

        # facet tangent in canonical direction + length
        fpts = self.points[self.facet_vertices]
        self.facet_tangent = fpts[:, 1] - fpts[:, 0]  # (nf, 2)
        self.facet_length = np.linalg.norm(self.facet_tangent, axis=-1)
        # cell diameter = longest edge (matches dolfinx cpp::mesh::h used by
        # the estimator, reference demo_error_estimation.py:87-93)
        self.h_cell = np.sqrt(h_max2)

        # outward sign of the canonical scaled normal rot(T) = (T_y, -T_x)
        # on boundary facets, w.r.t. their owning cell
        bf = self.boundary_facets
        own = self.facet_cells[bf, 0]
        cent = (
            self.points[self.cells[own, 0]]
            + self.points[self.cells[own, 1]]
            + self.points[self.cells[own, 2]]
        ) / 3.0
        mid = 0.5 * (fpts[bf, 0] + fpts[bf, 1])
        rotT = np.stack(
            [self.facet_tangent[bf, 1], -self.facet_tangent[bf, 0]], axis=-1
        )
        sgn = np.sign(np.einsum("fa,fa->f", rotT, mid - cent))
        self.boundary_outward_sign = np.zeros(self.num_facets)
        self.boundary_outward_sign[bf] = sgn

    # --- convenience -------------------------------------------------------

    def vertex_cells(self, v: int) -> np.ndarray:
        return self.v2c_data[self.v2c_offsets[v] : self.v2c_offsets[v + 1]]

    def vertex_facets(self, v: int) -> np.ndarray:
        return self.v2f_data[self.v2f_offsets[v] : self.v2f_offsets[v + 1]]

    def map_points(self, qpoints_ref: np.ndarray) -> np.ndarray:
        """Map reference points (nq, 2) into every cell -> (nc, nq, 2).

        One (2 nc, 2) x (2, nq) matrix product: a plain ``np.einsum`` of
        the same contraction takes most of a 1M-cell projection's time."""
        q = np.asarray(qpoints_ref, dtype=np.float64)
        nc = self.num_cells
        Jq = (self.J.reshape(2 * nc, 2) @ q.T).reshape(nc, 2, len(q))
        return self.cell_origins[:, None, :] + Jq.transpose(0, 2, 1)

    def locate_boundary_facets(self, marker) -> np.ndarray:
        """Facet ids on the boundary whose *both* endpoints satisfy marker(x).

        Mirrors ``dolfinx.mesh.locate_entities`` usage in the demos
        (demo_reconstruction.py:97-115).
        """
        ok = marker(self.points)  # (nv,) bool
        f = self.boundary_facets
        both = ok[self.facet_vertices[f, 0]] & ok[self.facet_vertices[f, 1]]
        return f[both]
