"""Built-in mesh generators for the flux-equilibration workloads.

Covers the mesh families the reference obtains from DOLFINx / gmsh
(``demo_reconstruction.py:63-246``): structured unit squares (left / right /
crossed diagonals), an unstructured Delaunay fixture with reversed facet
orientations (the role of ``create_unitsquare_gmsh`` in the reference test
fixtures, ``test/unit/utils.py:136-176``), the adaptive-demo L-shape
(``poisson_adaptive/demo_lshape.py``) and Cook's membrane
(``elasticity_adaptive/demo_cook.py``).
"""

from __future__ import annotations

import numpy as np

from .topology import TriMesh

__all__ = [
    "unit_square",
    "unit_square_unstructured",
    "rectangle",
    "lshape",
    "permute_vertices",
    "cook_membrane",
]


def rectangle(
    p0, p1, nx: int, ny: int, diagonal: str = "crossed"
) -> TriMesh:
    x = np.linspace(p0[0], p1[0], nx + 1)
    y = np.linspace(p0[1], p1[1], ny + 1)
    X, Y = np.meshgrid(x, y, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=-1)

    def vid(i, j):
        return i * (ny + 1) + j

    cells = []
    if diagonal == "crossed":
        # centre point per quad
        nv = len(pts)
        centres = np.stack(
            [
                (X[:-1, :-1] + X[1:, 1:]).ravel() / 2,
                (Y[:-1, :-1] + Y[1:, 1:]).ravel() / 2,
            ],
            axis=-1,
        )
        pts = np.concatenate([pts, centres])
        for i in range(nx):
            for j in range(ny):
                c = nv + i * ny + j
                a, b = vid(i, j), vid(i + 1, j)
                d, e = vid(i + 1, j + 1), vid(i, j + 1)
                cells += [[a, b, c], [b, d, c], [d, e, c], [e, a, c]]
    elif diagonal in ("left", "right"):
        for i in range(nx):
            for j in range(ny):
                a, b = vid(i, j), vid(i + 1, j)
                d, e = vid(i + 1, j + 1), vid(i, j + 1)
                if diagonal == "right":
                    cells += [[a, b, d], [a, d, e]]
                else:
                    cells += [[a, b, e], [b, d, e]]
    else:
        raise ValueError(f"unknown diagonal: {diagonal}")
    return TriMesh(pts, np.array(cells, dtype=np.int32))


def unit_square(n: int, diagonal: str = "crossed") -> TriMesh:
    """Unit square [0,1]^2, ``n`` elements per direction (reference
    ``create_unit_square_builtin``, demo_reconstruction.py:63-119)."""
    return rectangle((0.0, 0.0), (1.0, 1.0), n, n, diagonal)


def permute_vertices(msh: TriMesh, seed: int = 0) -> TriMesh:
    """Randomly renumber vertices and flip the orientation of a random
    subset of cells.

    This produces facets whose canonical (ascending-global-id) direction
    disagrees with one of the adjacent cells' local direction, and cells
    with negative Jacobian determinant — the "mesh has reversed edges"
    property the reference's gmsh fixture asserts
    (``test/unit/utils.py:136-139``), so every orientation code path is
    exercised.
    """
    rng = np.random.default_rng(seed)
    perm = rng.permutation(msh.num_vertices)
    pts = np.empty_like(msh.points)
    pts[perm] = msh.points
    cells = perm[msh.cells].astype(np.int32)
    flip = rng.random(len(cells)) < 0.5
    cells[flip] = cells[flip][:, [0, 2, 1]]
    return TriMesh(pts, cells)


def unit_square_unstructured(n: int, seed: int = 0) -> TriMesh:
    """Unstructured Delaunay triangulation of the unit square — the role of
    the reference's gmsh fixture (``python/test/unit/utils.py:96-176``):
    mixed vertex valences, obtuse cells and reversed edges, with the
    reference's repair of 1-cell boundary patches (``utils.py:141-176``).

    Interior grid points are jittered by up to 0.38 h, boundary points
    slide tangentially along their side (corners fixed), so the boundary
    stays exactly on the unit-square edges and the standard coordinate
    locators keep working.
    """
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    h = 1.0 / n
    xs = np.linspace(0.0, 1.0, n + 1)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    pts = np.stack([X.reshape(-1), Y.reshape(-1)], axis=1)
    on_b = (
        np.isclose(pts[:, 0], 0) | np.isclose(pts[:, 0], 1)
        | np.isclose(pts[:, 1], 0) | np.isclose(pts[:, 1], 1)
    )
    corner = (
        (np.isclose(pts[:, 0], 0) | np.isclose(pts[:, 0], 1))
        & (np.isclose(pts[:, 1], 0) | np.isclose(pts[:, 1], 1))
    )
    jit = rng.uniform(-0.38 * h, 0.38 * h, size=pts.shape)
    interior = ~on_b
    pts[interior] += jit[interior]
    # tangential slide on the boundary
    side_x = on_b & ~corner & (np.isclose(pts[:, 1], 0) | np.isclose(pts[:, 1], 1))
    side_y = on_b & ~corner & (np.isclose(pts[:, 0], 0) | np.isclose(pts[:, 0], 1))
    pts[side_x, 0] += jit[side_x, 0]
    pts[side_y, 1] += jit[side_y, 1]

    tri = Delaunay(pts)
    cells = tri.simplices.astype(np.int64)
    # drop degenerate slivers (collinear boundary points cannot occur here,
    # but keep the guard) and orient positively
    v1 = pts[cells[:, 1]] - pts[cells[:, 0]]
    v2 = pts[cells[:, 2]] - pts[cells[:, 0]]
    det = v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0]
    cells = cells[np.abs(det) > 1e-12 * h * h]
    # scramble vertex ids so facet orientations are non-aligned (reversed
    # edges), like the reference's gmsh meshes
    perm = rng.permutation(len(pts))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(pts))
    msh = TriMesh(pts[perm], inv[cells])

    # repair 1-cell boundary patches: bisect the outer facet of each such
    # patch until none remain (reference ``utils.py:141-176``)
    from .refine import refine_facets

    for _ in range(4):
        counts = msh.v2c_offsets[1:] - msh.v2c_offsets[:-1]
        bad = np.where(msh.is_boundary_vertex & (counts == 1))[0]
        if len(bad) == 0:
            break
        outer = []
        for z in bad:
            c = int(msh.vertex_cells(int(z))[0])
            ln = int(np.where(msh.cells[c] == z)[0][0])
            outer.append(int(msh.cell_facets[c, ln]))
        msh = refine_facets(msh, np.unique(outer))
    # recheck after the final iteration: the 4th refine_facets call may
    # itself have repaired every remaining 1-cell patch
    counts = msh.v2c_offsets[1:] - msh.v2c_offsets[:-1]
    if np.any(msh.is_boundary_vertex & (counts == 1)):
        raise RuntimeError("could not repair 1-cell boundary patches")
    return msh


def lshape(n: int) -> TriMesh:
    """L-shaped domain (-1,1)^2 minus the fourth quadrant [0,1]x[-1,0],
    structured triangulation with 2*n divisions across (-1,1)."""
    m = 2 * n
    x = np.linspace(-1.0, 1.0, m + 1)
    y = np.linspace(-1.0, 1.0, m + 1)
    idx = -np.ones((m + 1, m + 1), dtype=np.int64)
    pts = []
    for i in range(m + 1):
        for j in range(m + 1):
            if x[i] <= 0.0 or y[j] >= 0.0:
                idx[i, j] = len(pts)
                pts.append([x[i], y[j]])
    cells = []
    for i in range(m):
        for j in range(m):
            # quad is inside L iff not (x>0 and y<0)
            if x[i] >= 0.0 and y[j + 1] <= 0.0:
                continue
            a, b = idx[i, j], idx[i + 1, j]
            d, e = idx[i + 1, j + 1], idx[i, j + 1]
            # bisect towards the reentrant corner for symmetry
            cells += [[a, b, d], [a, d, e]]
    return TriMesh(np.array(pts), np.array(cells, dtype=np.int32))


def cook_membrane(nx: int, ny: int) -> TriMesh:
    """Cook's membrane: quadrilateral (0,0)-(48,44)-(48,60)-(0,44), mapped
    structured grid (reference ``elasticity_adaptive/demo_cook.py``).

    Crossed diagonals so every boundary vertex patch has >= 2 cells (the
    reference refines 1-cell boundary patches away and groups 2-cell
    boundary patches, ``se/Patch.cpp:60-104``)."""
    xi = np.linspace(0.0, 1.0, nx + 1)
    eta = np.linspace(0.0, 1.0, ny + 1)

    def xymap(XI, ETA):
        X = 48.0 * XI
        Y = 44.0 * ETA * (1.0 - XI) + XI * (44.0 + 16.0 * ETA)
        return X, Y

    XI, ETA = np.meshgrid(xi, eta, indexing="ij")
    X, Y = xymap(XI, ETA)
    pts = np.stack([X.ravel(), Y.ravel()], axis=-1)

    def vid(i, j):
        return i * (ny + 1) + j

    nv = len(pts)
    XIc, ETAc = np.meshgrid(
        0.5 * (xi[:-1] + xi[1:]), 0.5 * (eta[:-1] + eta[1:]), indexing="ij"
    )
    Xc, Yc = xymap(XIc, ETAc)
    pts = np.concatenate([pts, np.stack([Xc.ravel(), Yc.ravel()], axis=-1)])
    cells = []
    for i in range(nx):
        for j in range(ny):
            c = nv + i * ny + j
            a, b = vid(i, j), vid(i + 1, j)
            d, e = vid(i + 1, j + 1), vid(i, j + 1)
            cells += [[a, b, c], [b, d, c], [d, e, c], [e, a, c]]
    return TriMesh(pts, np.array(cells, dtype=np.int32))
