"""Uniform (red) and adaptive (longest-edge bisection) mesh refinement.

Port of the JAX package's ``mesh/refine.py``, copied unchanged so that both
packages refine a mesh into identical arrays.  Drives the adaptive demos
(reference ``poisson_adaptive/demo_lshape.py:179-258`` uses Doerfler
marking + ``dolfinx.mesh.refine``): Rivara longest-edge bisection with
propagation, which always terminates and produces conforming meshes.
``refine_facets`` bisects given facets without propagation;
``unit_square_unstructured`` uses it to repair 1-cell boundary patches
(reference ``test/unit/utils.py:141-176``).
"""

from __future__ import annotations

import numpy as np

from .topology import TriMesh

__all__ = ["refine_uniform", "refine_marked", "refine_facets"]


def _midpoint_ids(msh: TriMesh, split: np.ndarray):
    """Assign new vertex ids to split facets; returns (new_points, mid_of)."""
    nsplit = int(split.sum())
    mid_of = -np.ones(msh.num_facets, dtype=np.int64)
    mid_of[split] = msh.num_vertices + np.arange(nsplit)
    fv = msh.facet_vertices[split]
    mids = 0.5 * (msh.points[fv[:, 0]] + msh.points[fv[:, 1]])
    return np.concatenate([msh.points, mids]), mid_of


def refine_uniform(msh: TriMesh) -> TriMesh:
    """Red refinement: every triangle into 4 congruent children."""
    split = np.ones(msh.num_facets, dtype=bool)
    points, mid_of = _midpoint_ids(msh, split)
    c = msh.cells.astype(np.int64)
    # midpoint of local edge i (opposite vertex i)
    m = mid_of[msh.cell_facets.astype(np.int64)]  # (nc, 3)
    cells = np.concatenate(
        [
            np.stack([c[:, 0], m[:, 2], m[:, 1]], axis=-1),
            np.stack([c[:, 1], m[:, 0], m[:, 2]], axis=-1),
            np.stack([c[:, 2], m[:, 1], m[:, 0]], axis=-1),
            np.stack([m[:, 0], m[:, 1], m[:, 2]], axis=-1),
        ]
    )
    return TriMesh(points, cells.astype(np.int32))


def _longest_edge(msh: TriMesh) -> np.ndarray:
    """Local index of the longest edge per cell (ties broken by the larger
    global facet id, so neighbours agree on the shared edge)."""
    L = msh.facet_length[msh.cell_facets]  # (nc, 3)
    # lexicographic: length, then global id.  The tie-break perturbation is
    # RELATIVE to each edge's own length — a mean-scaled absolute term would
    # swamp the true lengths on deeply refined corner cells (h ~ 1e-9 x mean)
    # and bisect by the shortest edge, degrading cell quality.
    key = L * (1.0 + 1e-9 * msh.cell_facets / max(msh.num_facets, 1))
    return np.argmax(key, axis=1)


def refine_facets(msh: TriMesh, facets: np.ndarray) -> TriMesh:
    """Bisect exactly the given facets (no propagation).

    Used e.g. to enlarge 2-cell pure-traction corner patches before stress
    equilibration (the role of the reference's patch grouping /
    boundary-patch refinement, ``se/reconstruction.hpp:166-234`` and
    ``test/unit/utils.py:141-176``)."""
    split = np.zeros(msh.num_facets, dtype=bool)
    split[np.asarray(facets, dtype=np.int64)] = True
    # no longest-edge propagation: conformity is automatic (every cell is
    # subdivided according to its split facets); propagation would co-split
    # longer incident edges and defeat e.g. corner-degree enlargement
    return _refine_split(msh, split, propagate=False)


def refine_marked(msh: TriMesh, marked_cells: np.ndarray) -> TriMesh:
    """Rivara longest-edge bisection of ``marked_cells`` with propagation."""
    le = _longest_edge(msh)
    split = np.zeros(msh.num_facets, dtype=bool)
    split[msh.cell_facets[np.asarray(marked_cells, dtype=np.int64), le[marked_cells]]] = True
    return _refine_split(msh, split)


def _refine_split(msh: TriMesh, split: np.ndarray, propagate=True) -> TriMesh:
    le = _longest_edge(msh)
    # propagate: if a cell has any split edge, its longest edge must be split
    while propagate:
        has_split = split[msh.cell_facets].any(axis=1)
        need = msh.cell_facets[np.arange(msh.num_cells), le]
        new = has_split & ~split[need]
        if not new.any():
            break
        split[need[new]] = True

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
