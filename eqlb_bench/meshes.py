"""The benchmark's meshes, as (points, cells) arrays.

Frozen copy of ``dolfinx_eqlb_tpu_torch/mesh/generators.py``'s
``unit_square(n)`` (``rectangle`` with crossed diagonals) and
``unit_square_unstructured(n, seed)``, with the 1-cell boundary-patch
repair of ``mesh/refine.py``'s ``refine_facets``; the loops over quads and
cells are vectorised, the arrays they give are the same.  NumPy and SciPy
only.
"""

from __future__ import annotations

import numpy as np

from .reference.topology import Topology


def crossed(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Unit square, n x n quads, each cut by both diagonals into 4 cells
    about its centre: 4 n^2 cells, (n + 1)^2 + n^2 vertices."""
    x = np.linspace(0.0, 1.0, n + 1)
    X, Y = np.meshgrid(x, x, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=-1)
    centres = np.stack([(X[:-1, :-1] + X[1:, 1:]).ravel() / 2,
                        (Y[:-1, :-1] + Y[1:, 1:]).ravel() / 2], axis=-1)
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    i, j = i.ravel(), j.ravel()
    a, b = i * (n + 1) + j, (i + 1) * (n + 1) + j
    d, e = (i + 1) * (n + 1) + j + 1, i * (n + 1) + j + 1
    c = (n + 1) ** 2 + i * n + j
    cells = np.stack([np.stack([a, b, c], -1), np.stack([b, d, c], -1),
                      np.stack([d, e, c], -1), np.stack([e, a, c], -1)], 1)
    return np.concatenate([pts, centres]), cells.reshape(-1, 3).astype(np.int32)


def _bisect_facets(points, cells, topo: Topology, split: np.ndarray):
    """Bisect the facets marked in ``split`` (no propagation): a cell with
    one split edge becomes two, in place, children in the order of
    ``refine_facets``; a cell with more takes the recursive rule."""
    nv = len(points)
    # new vertices in the order the facets are first met going through the
    # cells' local edges, cell by cell (the program's facet numbering)
    first = np.unique(topo.cell_facets.ravel(), return_index=True)[1]
    fs = np.where(split)[0]
    fs = fs[np.argsort(first[fs], kind="stable")]
    mid_of = -np.ones(topo.num_facets, dtype=np.int64)
    mid_of[fs] = nv + np.arange(len(fs))
    fv = topo.facet_vertices[fs]
    points = np.concatenate([points, 0.5 * (points[fv[:, 0]] + points[fv[:, 1]])])
    m = mid_of[topo.cell_facets]  # (nc, 3), midpoint of the edge opposite v_i
    c = cells.astype(np.int64)
    nsplit = (m >= 0).sum(1)
    children = np.zeros(len(c), dtype=np.int64)
    children[nsplit == 0] = 1
    one = np.where(nsplit == 1)[0]
    children[one] = 2
    many = np.where(nsplit > 1)[0]
    extra = {}
    for q in many:
        extra[q] = _bisect_rec(points, tuple(c[q]), tuple(m[q]))
        children[q] = len(extra[q])
    start = np.concatenate([[0], np.cumsum(children)])
    res = np.empty((start[-1], 3), dtype=np.int64)
    zero = np.where(nsplit == 0)[0]
    res[start[zero]] = c[zero]
    # one split edge, opposite local vertex i: rotate so it is edge 0, then
    # children (v0, v1, m0), (v0, m0, v2)
    ie = np.argmax(m[one] >= 0, axis=1)
    rot = (ie[:, None] + np.arange(3)) % 3
    v = np.take_along_axis(c[one], rot, 1)
    mm = m[one, ie]
    res[start[one]] = np.stack([v[:, 0], v[:, 1], mm], -1)
    res[start[one] + 1] = np.stack([v[:, 0], mm, v[:, 2]], -1)
    for q, tris in extra.items():
        res[start[q]:start[q] + len(tris)] = tris
    return points, res.astype(np.int32)


def _bisect_rec(pts, tri, mids):
    """``refine._refine_split``'s recursive bisection of one cell: the
    longest split edge first (ties to the larger vertex id)."""
    if all(x < 0 for x in mids):
        return [tri]
    v0, v1, v2 = tri
    lens = [np.linalg.norm(pts[v1] - pts[v2]), np.linalg.norm(pts[v0] - pts[v2]),
            np.linalg.norm(pts[v0] - pts[v1])]
    i = sorted((i for i in range(3) if mids[i] >= 0),
               key=lambda i: (lens[i], max(tri[(i + 1) % 3], tri[(i + 2) % 3])),
               reverse=True)[0]
    m0, m1, m2 = mids
    if i == 1:
        return _bisect_rec(pts, (v1, v2, v0), (m1, m2, m0))
    if i == 2:
        return _bisect_rec(pts, (v2, v0, v1), (m2, m0, m1))
    return (_bisect_rec(pts, (v0, v1, m0), (-1, -1, m2))
            + _bisect_rec(pts, (v0, m0, v2), (-1, m1, -1)))


def unstructured(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Delaunay triangulation of an (n + 1)^2 grid of the unit square,
    interior points jittered by up to 0.38 / n, boundary points slid along
    their side, vertex ids scrambled (reversed edges), and every boundary
    vertex of a single cell repaired by bisecting that cell's outer facet."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    h = 1.0 / n
    xs = np.linspace(0.0, 1.0, n + 1)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    pts = np.stack([X.reshape(-1), Y.reshape(-1)], axis=1)
    bx = np.isclose(pts[:, 0], 0) | np.isclose(pts[:, 0], 1)
    by = np.isclose(pts[:, 1], 0) | np.isclose(pts[:, 1], 1)
    on_b, corner = bx | by, bx & by
    jit = rng.uniform(-0.38 * h, 0.38 * h, size=pts.shape)
    pts[~on_b] += jit[~on_b]
    side_x, side_y = on_b & ~corner & by, on_b & ~corner & bx
    pts[side_x, 0] += jit[side_x, 0]
    pts[side_y, 1] += jit[side_y, 1]
    cells = Delaunay(pts).simplices.astype(np.int64)
    v1 = pts[cells[:, 1]] - pts[cells[:, 0]]
    v2 = pts[cells[:, 2]] - pts[cells[:, 0]]
    cells = cells[np.abs(v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0]) > 1e-12 * h * h]
    perm = rng.permutation(len(pts))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(pts))
    pts, cells = pts[perm], inv[cells].astype(np.int32)
    for _ in range(4):
        topo = Topology(cells, len(pts))
        bad = np.where(topo.is_boundary_vertex & (topo.vertex_ncells == 1))[0]
        if not len(bad):
            return pts, cells
        cell, loc = np.nonzero(np.isin(cells, bad))
        split = np.zeros(topo.num_facets, dtype=bool)
        split[topo.cell_facets[cell, loc]] = True
        pts, cells = _bisect_facets(pts, cells, topo, split)
    topo = Topology(cells, len(pts))
    if np.any(topo.is_boundary_vertex & (topo.vertex_ncells == 1)):
        raise RuntimeError("could not repair 1-cell boundary patches")
    return pts, cells


GENERATORS = {"crossed": crossed, "unstructured": unstructured}
