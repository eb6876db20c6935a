"""Vertex-patch extraction into bucketed, padded index tables.

TPU-native replacement for the reference's per-patch C++ machinery
(``ev/Patch.cpp:482-676``, ``se/Patch.cpp:406-635``): the counter-clockwise
facet walk around each mesh vertex, the patch-local sub-dofmap and the
orientation prefactors are all *host integer precompute*.  Patches are
bucketed by (cell count, boundary flag); within a bucket every patch has the
same dense structure, so the device-side assembly is static block placement
and one batched LU per bucket (SURVEY.md section 7).

Canonical per-cell RT dof order inside a patch:
    [k dofs on the entry spoke, k dofs on the exit spoke, cell dofs]
(the facet opposite the patch vertex — the "outer" facet — always carries a
zero normal trace since the hat function vanishes there, so its dofs are
dropped from the patch problem entirely.)

Patch-local dof layout (ns = number of spokes = n, or n+1 on the boundary):
    [spoke_0 (k) | ... | spoke_{ns-1} (k) | cell_0 RT-cell dofs (k(k-1)) |
     ... | cell_0 DG dofs (ndg) | ... | lambda]
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..fem.spaces import FunctionSpace
from ..mesh.topology import TriMesh

__all__ = ["PatchBucket", "build_patches", "build_patches_reference",
           "deficient_stress_vertices", "refine_for_stress"]


@dataclass
class PatchBucket:
    ncells: int
    is_boundary: bool
    nodes: np.ndarray  # (P,)
    cells: np.ndarray  # (P, n)
    lnode: np.ndarray  # (P, n) local index of the patch vertex in each cell
    spokes: np.ndarray  # (P, ns) global facet ids, walk order
    entry_loc: np.ndarray  # (P, n) local facet id of cell i's entry spoke
    exit_loc: np.ndarray  # (P, n) local facet id of cell i's exit spoke

    @property
    def npatches(self):
        return len(self.nodes)

    @property
    def nspokes(self):
        return self.ncells + (1 if self.is_boundary else 0)


def _walk_patch(msh: TriMesh, z: int):
    """Order the cells of vertex z's patch along the spoke-facet walk.

    Returns (cells, lnode, spokes, entry_loc, exit_loc); for an internal
    patch spokes has length n and the walk is cyclic (cell i sits between
    spoke i and spoke (i+1) % n); boundary patches start and end at the two
    boundary spokes (length n+1).
    """
    cells = msh.vertex_cells(z)
    n = len(cells)
    # spoke facets of each cell: the two local edges containing z
    # (local edge i is opposite local vertex i)
    lnode = np.array(
        [int(np.where(msh.cells[c] == z)[0][0]) for c in cells], dtype=np.int32
    )
    spk = {}  # facet -> list of (cell position, local facet id)
    for i, c in enumerate(cells):
        for le in ((lnode[i] + 1) % 3, (lnode[i] + 2) % 3):
            f = int(msh.cell_facets[c, le])
            spk.setdefault(f, []).append((i, le))

    boundary_spokes = [f for f, adj in spk.items() if len(adj) == 1]
    if boundary_spokes:
        if len(boundary_spokes) != 2:
            raise ValueError(
                f"patch around vertex {z} is not simply connected "
                f"({len(boundary_spokes)} boundary spokes)"
            )
        start_f = min(boundary_spokes)
    else:
        start_f = min(spk.keys())

    order, entry, exit_, spokes = [], [], [], [start_f]
    cur_f = start_f
    prev_cell = -1
    for _ in range(n):
        cand = [ic for ic, _ in spk[cur_f] if ic != prev_cell and ic not in order]
        ic = cand[0]
        les = {le for jc, le in spk[cur_f] if jc == ic}
        e_in = les.pop()
        # exit spoke: the cell's other z-edge
        other = [
            (le, int(msh.cell_facets[cells[ic], le]))
            for le in ((lnode[ic] + 1) % 3, (lnode[ic] + 2) % 3)
            if le != e_in
        ]
        e_out, f_out = other[0]
        order.append(ic)
        entry.append(e_in)
        exit_.append(e_out)
        spokes.append(f_out)
        prev_cell = ic
        cur_f = f_out
    if not boundary_spokes:
        assert spokes[-1] == spokes[0], (z, spokes)
        spokes = spokes[:-1]
    return (
        cells[order],
        lnode[order],
        np.array(spokes, dtype=np.int32),
        np.array(entry, dtype=np.int32),
        np.array(exit_, dtype=np.int32),
    )


def build_patches_reference(msh: TriMesh) -> dict[tuple[int, bool], PatchBucket]:
    """Per-vertex Python walk (reference implementation, used for
    cross-checking the vectorized builder)."""
    groups: dict[tuple[int, bool], list] = {}
    for z in range(msh.num_vertices):
        cells, lnode, spokes, entry, exit_ = _walk_patch(msh, z)
        key = (len(cells), bool(msh.is_boundary_vertex[z]))
        groups.setdefault(key, []).append((z, cells, lnode, spokes, entry, exit_))

    out = {}
    for key, items in groups.items():
        n, is_b = key
        out[key] = PatchBucket(
            ncells=n,
            is_boundary=is_b,
            nodes=np.array([it[0] for it in items], dtype=np.int32),
            cells=np.stack([it[1] for it in items]).astype(np.int32),
            lnode=np.stack([it[2] for it in items]).astype(np.int32),
            spokes=np.stack([it[3] for it in items]).astype(np.int32),
            entry_loc=np.stack([it[4] for it in items]).astype(np.int32),
            exit_loc=np.stack([it[5] for it in items]).astype(np.int32),
        )
    return out


def build_patches(msh: TriMesh) -> dict[tuple[int, bool], PatchBucket]:
    """Vectorized patch extraction: all vertices walk their spoke fans
    simultaneously, so million-cell meshes precompute in seconds.  Uses the
    native C++ walker (``native``) when available, else the
    NumPy lock-step walk below.

    Same output as :func:`build_patches_reference` up to the (irrelevant)
    walk direction of interior patches.
    """
    nv = msh.num_vertices
    counts = (msh.v2c_offsets[1:] - msh.v2c_offsets[:-1]).astype(np.int64)
    nmax = int(counts.max())

    from .. import native

    nat = native.walk_patches(msh, counts, nmax)
    if nat is not None:
        cells_w, lnode_w, entry_w, exit_w, spokes_w = nat
        return _bucketize(
            msh, counts, cells_w, lnode_w, entry_w, exit_w, spokes_w
        )
    cells_tab = np.full((nv, nmax), -1, dtype=np.int64)
    # fill vertex->cells table from the CSR
    idx = np.arange(len(msh.v2c_data))
    row = np.searchsorted(msh.v2c_offsets, idx, side="right") - 1
    col = idx - msh.v2c_offsets[row]
    cells_tab[row, col] = msh.v2c_data

    is_b = msh.is_boundary_vertex
    # start spoke: boundary vertices use their smallest boundary spoke;
    # interior use their smallest spoke
    nfv = msh.v2f_offsets[1:] - msh.v2f_offsets[:-1]
    nfmax = int(nfv.max())
    fac_tab = np.full((nv, nfmax), np.iinfo(np.int64).max, dtype=np.int64)
    idx = np.arange(len(msh.v2f_data))
    row = np.searchsorted(msh.v2f_offsets, idx, side="right") - 1
    col = idx - msh.v2f_offsets[row]
    fac_tab[row, col] = msh.v2f_data
    fb = np.where(
        msh.is_boundary_facet[np.clip(fac_tab, 0, msh.num_facets - 1)]
        & (fac_tab < msh.num_facets),
        fac_tab,
        np.iinfo(np.int64).max,
    )
    start = np.where(is_b, fb.min(axis=1), fac_tab.min(axis=1))

    z_all = np.arange(nv, dtype=np.int64)
    cur_f = start.copy()
    prev_c = np.full(nv, -1, dtype=np.int64)
    cells_w = np.full((nv, nmax), -1, dtype=np.int32)
    lnode_w = np.zeros((nv, nmax), dtype=np.int32)
    entry_w = np.zeros((nv, nmax), dtype=np.int32)
    exit_w = np.zeros((nv, nmax), dtype=np.int32)
    spokes_w = np.full((nv, nmax + 1), -1, dtype=np.int32)
    spokes_w[:, 0] = start

    for step in range(nmax):
        active = counts > step
        f = cur_f
        c01 = msh.facet_cells[np.clip(f, 0, msh.num_facets - 1)].astype(np.int64)
        # next cell: adjacent to f, not prev_c (boundary starts have one)
        c = np.where(c01[:, 0] != prev_c, c01[:, 0], c01[:, 1])
        c = np.where(active, c, 0)
        ln = np.argmax(msh.cells[c] == z_all[:, None], axis=1).astype(np.int64)
        cf = msh.cell_facets[c].astype(np.int64)  # (nv, 3)
        e_in = np.argmax(cf == f[:, None], axis=1).astype(np.int64)
        e1, e2 = (ln + 1) % 3, (ln + 2) % 3
        e_out = np.where(e_in == e1, e2, e1)
        f_out = cf[np.arange(nv), e_out]
        cells_w[active, step] = c[active]
        lnode_w[active, step] = ln[active]
        entry_w[active, step] = e_in[active]
        exit_w[active, step] = e_out[active]
        wrote = active & (counts >= step + 1)
        spokes_w[wrote, step + 1] = f_out[wrote]
        prev_c = np.where(active, c, prev_c)
        cur_f = np.where(active, f_out, cur_f)

    return _bucketize(msh, counts, cells_w, lnode_w, entry_w, exit_w, spokes_w)


def _bucketize(msh, counts, cells_w, lnode_w, entry_w, exit_w, spokes_w):
    is_b = msh.is_boundary_vertex
    out: dict[tuple[int, bool], PatchBucket] = {}
    for n in np.unique(counts):
        n = int(n)
        for b in (False, True):
            sel = np.where((counts == n) & (is_b == b))[0]
            if len(sel) == 0:
                continue
            ns = n + 1 if b else n
            # order patches by their smallest spoke facet id: global dofs are
            # facet-major, so this makes a dof's contributor patches sit at
            # flat positions near the dof index — the locality the windowed
            # combine kernel exploits (vertex-id order scatters them: e.g.
            # the crossed-square generator numbers cell-center vertices in a
            # separate block ~n^2/2 ids away from the grid corners)
            sel = sel[np.argsort(
                spokes_w[sel][:, :ns].min(axis=1), kind="stable")]
            spk = spokes_w[sel][:, : ns].copy()
            if not b:
                # interior walk closes: last exit spoke equals spoke 0
                closes = spokes_w[sel, n] == spokes_w[sel, 0]
                if not closes.all():
                    raise RuntimeError("interior patch walk did not close")
            out[(n, b)] = PatchBucket(
                ncells=n,
                is_boundary=b,
                nodes=sel.astype(np.int32),
                cells=cells_w[sel, :n],
                lnode=lnode_w[sel, :n],
                spokes=spk,
                entry_loc=entry_w[sel, :n],
                exit_loc=exit_w[sel, :n],
            )
    return out


def bucket_dof_tables(bucket: PatchBucket, V_flux: FunctionSpace):
    """Per-bucket canonical permutations, signs, patch layout and global ids.

    Returns a dict of host arrays consumed by the engine:
      perm      (P, n, nkeep): element-local RT dof index per canonical slot
      signs     (P, n, nkeep): orientation signs of those dofs
      patch_idx (n, nkeep):    patch-local row of each canonical slot (static)
      gdofs     (P, Dflux):    global dof of each patch flux dof
      layout:   dict of sizes
    """
    el = V_flux.element
    k = V_flux.degree
    kk1 = el.ndofs_cell
    n = bucket.ncells
    ns = bucket.nspokes
    P = bucket.npatches
    nkeep = 2 * k + kk1

    # canonical -> element-local dof indices + orientation signs (native
    # single-pass fill; the NumPy fallback's take_along_axis gathers are
    # the hottest host op at 1M cells)
    from .. import native

    out = native.perm_signs(bucket.cells, bucket.entry_loc,
                            bucket.exit_loc, V_flux.dof_signs, k, kk1)
    if out is not None:
        perm, signs = out
    else:
        perm = np.empty((P, n, nkeep), dtype=np.int32)
        for m in range(k):
            perm[:, :, m] = bucket.entry_loc * k + m
            perm[:, :, k + m] = bucket.exit_loc * k + m
        perm[:, :, 2 * k :] = 3 * k + np.arange(kk1)[None, None, :]
        signs = np.take_along_axis(
            V_flux.dof_signs[bucket.cells.astype(np.int64)], perm, axis=2
        )

    # static patch-local placement
    patch_idx = np.empty((n, nkeep), dtype=np.int64)
    for i in range(n):
        patch_idx[i, :k] = i * k + np.arange(k)
        patch_idx[i, k : 2 * k] = ((i + 1) % ns if not bucket.is_boundary else i + 1) * k + np.arange(k)
        patch_idx[i, 2 * k :] = ns * k + i * kk1 + np.arange(kk1)

    # global dofs of the patch flux unknowns: spokes then cell blocks
    gd_spokes = (
        bucket.spokes.astype(np.int32)[:, :, None] * k
        + np.arange(k, dtype=np.int32)[None, None, :]
    ).reshape(P, ns * k)
    nf = V_flux.mesh.num_facets
    gd_cells = (
        np.int32(nf * k)
        + bucket.cells.astype(np.int32)[:, :, None] * kk1
        + np.arange(kk1, dtype=np.int32)[None, None, :]
    ).reshape(P, n * kk1)
    gdofs = np.concatenate([gd_spokes, gd_cells], axis=1)

    # --- patch-local continuous-P1 constraint space (weak symmetry) ---------
    # patch P1 node numbering: 0 = the patch vertex z, 1 + j = outer end of
    # spoke j.  Cell i touches [z, end(spoke_i), end(spoke_{i+1})].
    from ..elements.quadrature import LOCAL_EDGE_VERTICES as LOC

    lv_hats = np.empty((P, n, 3), dtype=np.int64)
    lv_hats[:, :, 0] = bucket.lnode
    for slot, loc in ((1, bucket.entry_loc), (2, bucket.exit_loc)):
        pair = LOC[loc.astype(np.int64)]  # (P, n, 2) local vertices of edge
        other = np.where(
            pair[..., 0] == bucket.lnode, pair[..., 1], pair[..., 0]
        )
        lv_hats[:, :, slot] = other
    p1_idx = np.empty((n, 3), dtype=np.int64)
    for i in range(n):
        p1_idx[i] = [
            0,
            1 + i,
            1 + ((i + 1) % ns if not bucket.is_boundary else i + 1),
        ]

    return {
        "perm": perm,
        "signs": signs,
        "patch_idx": patch_idx,
        "gdofs": gdofs,
        "nkeep": nkeep,
        "lv_hats": lv_hats,
        "p1_idx": p1_idx,
        "np1": 1 + ns,
    }


def deficient_stress_vertices(mesh, facet_kind2: np.ndarray) -> np.ndarray:
    """Boundary vertices whose patch cannot satisfy the weak-symmetry
    constraints at flux degree 2: pure-traction patches with <= 2 cells.

    Dimension count (k = 2): the joint divergence-free correction space of
    the two stress rows has dimension 2(n-1), the P1 constraint space n+1 —
    infeasible exactly for n <= 2.  The reference handles these by patch
    grouping (``se/reconstruction.hpp:166-234``) or raises "Incompatible
    mesh!" — here the caller either refines (``refine_for_stress``) or
    groups them (``eqlb.grouping``).
    """
    counts = (mesh.v2c_offsets[1:] - mesh.v2c_offsets[:-1]).astype(np.int64)
    out = []
    for z in np.where(mesh.is_boundary_vertex & (counts <= 2))[0]:
        spokes = mesh.vertex_facets(z)
        bspokes = spokes[mesh.is_boundary_facet[spokes]]
        if np.all(facet_kind2[:, bspokes] == 2):
            out.append(z)
    return np.array(out, dtype=np.int64)


def refine_for_stress(mesh, traction_facets: np.ndarray):
    """Bisect the outer facets of deficient pure-traction corner patches so
    every boundary patch has >= 3 cells (sufficient for the weak-symmetry
    constraints at degree 2; cf. deficient_stress_vertices)."""
    from ..mesh.refine import refine_facets

    kind = np.zeros((1, mesh.num_facets), dtype=np.int8)
    kind[0, mesh.boundary_facets] = 1
    kind[0, np.asarray(traction_facets, dtype=np.int64)] = 2
    bad = deficient_stress_vertices(mesh, np.repeat(kind, 2, axis=0))
    if len(bad) == 0:
        return mesh
    outer = []
    for z in bad:
        for c in mesh.vertex_cells(z):
            ln = int(np.where(mesh.cells[c] == z)[0][0])
            outer.append(int(mesh.cell_facets[c, ln]))
    return refine_facets(mesh, np.unique(outer))
