"""Gmsh ``.msh`` import (ASCII v2.2 and v4.1) for triangle meshes.

Host NumPy, copied from the JAX package's ``mesh/msh_io.py``.

The reference's demos build their unstructured meshes through the gmsh API
(``demo/poisson/demo_reconstruction.py:125-160``); users switching to this
framework bring those meshes as exported ``.msh`` files.  Returns a
:class:`TriMesh` plus the physical-tag markers:

    mesh, facet_tags, cell_tags = read_msh(path)

``facet_tags``: dict physical-tag -> facet indices (matched through the
tagged line elements), directly usable as the boundary-facet lists of
``set_boundary_conditions`` / ``fluxbc``.  ``cell_tags``: dict
physical-tag -> cell indices (e.g. material subdomains).
"""

from __future__ import annotations

import numpy as np

from .topology import TriMesh

__all__ = ["read_msh"]


def _facet_index_map(mesh: TriMesh):
    """vertex-pair key -> facet id."""
    fv = np.sort(mesh.facet_vertices, axis=1).astype(np.int64)
    keys = fv[:, 0] * mesh.num_vertices + fv[:, 1]
    order = np.argsort(keys)
    return keys[order], order


def _lines_to_facets(mesh: TriMesh, lines: np.ndarray) -> np.ndarray:
    """Map (nl, 2) vertex pairs to facet indices (raises on unknown)."""
    if len(lines) == 0:
        return np.zeros(0, dtype=np.int64)
    keys_sorted, order = _facet_index_map(mesh)
    ls = np.sort(lines.astype(np.int64), axis=1)
    lk = ls[:, 0] * mesh.num_vertices + ls[:, 1]
    pos = np.searchsorted(keys_sorted, lk)
    ok = (pos < len(keys_sorted)) & (keys_sorted[np.minimum(
        pos, len(keys_sorted) - 1)] == lk)
    if not ok.all():
        raise ValueError("tagged line element is not a mesh facet")
    return order[pos]


def _read_v2(lines: list[str], i: int):
    pts, elems = None, []
    while i < len(lines):
        ln = lines[i].strip()
        if ln == "$Nodes":
            n = int(lines[i + 1])
            raw = np.array(
                [lines[i + 2 + j].split() for j in range(n)], dtype=np.float64
            )
            ids = raw[:, 0].astype(np.int64)
            pts = np.zeros((ids.max() + 1, 2))
            pts[ids] = raw[:, 1:3]
            remap = np.full(ids.max() + 1, -1, dtype=np.int64)
            remap[ids] = np.arange(n)
            i += 2 + n
        elif ln == "$Elements":
            n = int(lines[i + 1])
            for j in range(n):
                w = lines[i + 2 + j].split()
                etype, ntags = int(w[1]), int(w[2])
                phys = int(w[3]) if ntags >= 1 else 0
                verts = [int(v) for v in w[3 + ntags:]]
                elems.append((etype, phys, verts))
            i += 2 + n
        else:
            i += 1
    return pts, remap, elems


def _read_v4(lines: list[str], i: int):
    pts, elems = None, []
    remap = None
    while i < len(lines):
        ln = lines[i].strip()
        if ln == "$Nodes":
            hdr = lines[i + 1].split()
            nblocks, n = int(hdr[0]), int(hdr[1])
            max_tag = int(hdr[3])
            pts = np.zeros((max_tag + 1, 2))
            remap = np.full(max_tag + 1, -1, dtype=np.int64)
            i += 2
            count = 0
            for _b in range(nblocks):
                bn = int(lines[i].split()[3])
                tags = [int(lines[i + 1 + j]) for j in range(bn)]
                for j in range(bn):
                    xyz = lines[i + 1 + bn + j].split()
                    pts[tags[j]] = [float(xyz[0]), float(xyz[1])]
                    remap[tags[j]] = count
                    count += 1
                i += 1 + 2 * bn
            pts2 = np.zeros((count, 2))
            pts2[remap[remap >= 0]] = pts[np.where(remap >= 0)[0]]
            pts = pts2
        elif ln == "$Elements":
            hdr = lines[i + 1].split()
            nblocks = int(hdr[0])
            i += 2
            for _b in range(nblocks):
                bh = lines[i].split()
                etag, etype, bn = int(bh[1]), int(bh[2]), int(bh[3])
                for j in range(bn):
                    w = [int(v) for v in lines[i + 1 + j].split()]
                    elems.append((etype, etag, w[1:]))
                i += 1 + bn
        else:
            i += 1
    return pts, remap, elems


def read_msh(path_or_text: str):
    """Read a Gmsh ``.msh`` file (or its text) -> (TriMesh, facet_tags,
    cell_tags)."""
    if "\n" in path_or_text:
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()
    lines = text.splitlines()
    version = None
    for j, ln in enumerate(lines):
        if ln.strip() == "$MeshFormat":
            version = float(lines[j + 1].split()[0])
            break
    if version is None:
        raise ValueError("not a Gmsh .msh file (no $MeshFormat)")
    if version >= 4.0:
        pts_full, remap, elems = _read_v4(lines, 0)
        pts = pts_full
    else:
        pts_full, remap, elems = _read_v2(lines, 0)
        pts = pts_full[np.where(remap >= 0)[0]]

    tris, tri_phys, segs, seg_phys = [], [], [], []
    for etype, phys, verts in elems:
        if etype == 2:  # 3-node triangle
            tris.append(verts)
            tri_phys.append(phys)
        elif etype == 1:  # 2-node line
            segs.append(verts)
            seg_phys.append(phys)
    if not tris:
        raise ValueError("no triangles in .msh file")
    cells = remap[np.asarray(tris, dtype=np.int64)]
    mesh = TriMesh(pts, cells.astype(np.int32))

    cell_tags: dict[int, np.ndarray] = {}
    for t in sorted(set(tri_phys)):
        cell_tags[t] = np.where(np.asarray(tri_phys) == t)[0]
    facet_tags: dict[int, np.ndarray] = {}
    if segs:
        fidx = _lines_to_facets(mesh, remap[np.asarray(segs, dtype=np.int64)])
        sp = np.asarray(seg_phys)
        for t in sorted(set(seg_phys)):
            facet_tags[t] = np.sort(fidx[sp == t])
    return mesh, facet_tags, cell_tags
