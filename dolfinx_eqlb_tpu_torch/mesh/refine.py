"""Facet bisection: split exactly the given facets of a mesh.

``unit_square_unstructured`` uses it to repair 1-cell boundary patches
(reference ``test/unit/utils.py:141-176``).
"""

from __future__ import annotations

import numpy as np

from .topology import TriMesh

__all__ = ["refine_facets"]


def _midpoint_ids(msh: TriMesh, split: np.ndarray):
    """Assign new vertex ids to split facets; returns (new_points, mid_of)."""
    nsplit = int(split.sum())
    mid_of = -np.ones(msh.num_facets, dtype=np.int64)
    mid_of[split] = msh.num_vertices + np.arange(nsplit)
    fv = msh.facet_vertices[split]
    mids = 0.5 * (msh.points[fv[:, 0]] + msh.points[fv[:, 1]])
    return np.concatenate([msh.points, mids]), mid_of


def refine_facets(msh: TriMesh, facets: np.ndarray) -> TriMesh:
    """Bisect exactly the given facets (no propagation).

    Conformity is automatic: every cell is subdivided according to its
    split facets, recursively by the longest split edge."""
    split = np.zeros(msh.num_facets, dtype=bool)
    split[np.asarray(facets, dtype=np.int64)] = True
    points, mid_of = _midpoint_ids(msh, split)
    midpts = mid_of[msh.cell_facets.astype(np.int64)]  # (nc, 3), -1 if unsplit

    cells_out: list[tuple[int, int, int]] = []
    pts = points

    def bisect(tri, mids):
        """tri = (v0, v1, v2); mids = (m0, m1, m2) midpoint of edge opposite
        v_i or -1.  Recursively bisect by the longest split edge."""
        m0, m1, m2 = mids
        if m0 < 0 and m1 < 0 and m2 < 0:
            cells_out.append(tri)
            return
        v0, v1, v2 = tri
        lens = [
            np.linalg.norm(pts[v1] - pts[v2]),
            np.linalg.norm(pts[v0] - pts[v2]),
            np.linalg.norm(pts[v0] - pts[v1]),
        ]
        order = sorted(
            (i for i in range(3) if mids[i] >= 0),
            key=lambda i: (lens[i], max(tri[(i + 1) % 3], tri[(i + 2) % 3])),
            reverse=True,
        )
        i = order[0]
        if i == 1:
            bisect((v1, v2, v0), (m1, m2, m0))
            return
        if i == 2:
            bisect((v2, v0, v1), (m2, m0, m1))
            return
        # split edge (v1, v2) at m0: children (v0, v1, m0), (v0, m0, v2).
        # child 1 edges: opp v0 = (v1,m0) half of old e0 -> unsplit;
        #   opp v1 = (v0, m0) new edge -> unsplit; opp m0 = (v0, v1) = old e2
        bisect((v0, v1, m0), (-1, -1, m2))
        bisect((v0, m0, v2), (-1, m1, -1))

    for c in range(msh.num_cells):
        v = tuple(int(x) for x in msh.cells[c])
        m = tuple(int(x) for x in midpts[c])
        bisect(v, m)

    return TriMesh(points, np.array(cells_out, dtype=np.int32))
