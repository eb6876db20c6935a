"""Cell-wise Korn-constant estimation (Kim 2011 via the reference).

Port of the JAX package's ``eqlb/korn.py``.  Geometric estimate of the
squared Korn constant of every vertex patch, C_K^2 = 2 / sin^2(theta_min / 2),
from the minimal star-shapedness angles of the patch stencil (reference
``se/Patch.cpp:130-334``):

* internal patches: for every cell with outer vertices b0, b1 (the two
  vertices != z), the angles between the outer facet b1 - b0 and the rays
  from b0 / b1 to the patch centre z; theta_min is capped at pi/2.
* boundary patches: three candidate stencil centres (centroids/midpoints of
  the middle cells/facets depending on parity); walk the patch boundary
  polygon z, end(s_0), ..., end(s_{n-1}) accumulating the angles between the
  centre ray and the two incident polygon edges; theta = max over candidates
  of the minimal angle.

Each cell accumulates (gdim + 1) * C_K^2 from each of its vertex patches
(reference ``se/reconstruction.hpp:247-260``); the user-facing constant is
the square root (``FluxEqlbSE.py:163-166``).  Host NumPy, copied from the
JAX package; the result is a DG0 ``Function`` on the requested device.
"""

from __future__ import annotations

import numpy as np

from ..fem.spaces import Function, mesh_space, resolve_device
from .patches import build_patches

__all__ = ["estimate_korn_constants", "patch_squared_korn_constants"]


def _angle(v1, v2):
    """Angle between vectors along last axis, numerically clipped."""
    c = np.einsum("...a,...a->...", v1, v2)
    n = np.linalg.norm(v1, axis=-1) * np.linalg.norm(v2, axis=-1)
    return np.arccos(np.clip(c / np.maximum(n, 1e-300), -1.0, 1.0))


def patch_squared_korn_constants(mesh, buckets=None):
    """Squared Korn constant per patch; returns dict bucket-key -> (P,)."""
    if buckets is None:
        buckets = build_patches(mesh)
    pts = mesh.points
    out = {}
    for key, b in buckets.items():
        n = b.ncells
        z = pts[b.nodes]  # (P, 2)
        cv = mesh.cells[b.cells.astype(np.int64)]  # (P, n, 3) vertex ids
        ln = b.lnode.astype(np.int64)
        b0 = np.take_along_axis(cv, ((ln + 1) % 3)[..., None], axis=2)[..., 0]
        b1 = np.take_along_axis(cv, ((ln + 2) % 3)[..., None], axis=2)[..., 0]
        x0, x1 = pts[b0], pts[b1]  # (P, n, 2)
        if not b.is_boundary:
            v2 = x1 - x0
            a1 = _angle(z[:, None] - x0, v2)
            a2 = _angle(z[:, None] - x1, -v2)
            theta = np.minimum(
                0.5 * np.pi, np.minimum(a1.min(axis=1), a2.min(axis=1))
            )
        else:
            # outer ends of the spokes, walk order (P, n+1)
            fv = mesh.facet_vertices[b.spokes.astype(np.int64)]  # (P,ns,2)
            ends = np.where(fv[..., 0] == b.nodes[:, None], fv[..., 1],
                            fv[..., 0])
            xe = pts[ends]  # (P, ns, 2)
            # candidate stencil centres (bucket-static indexing)
            if n % 2 == 0:
                c_mid = [
                    pts[cv[:, n // 2 - 1]].mean(axis=1),
                    pts[cv[:, min(n // 2, n - 1)]].mean(axis=1),
                    0.5 * (pts[fv[:, n // 2, 0]] + pts[fv[:, n // 2, 1]]),
                ]
            else:
                h = (n + 1) // 2
                c_mid = [
                    0.5 * (pts[fv[:, h, 0]] + pts[fv[:, h, 1]]),
                    0.5 * (pts[fv[:, h - 1, 0]] + pts[fv[:, h - 1, 1]]),
                    pts[cv[:, (n - 1) // 2]].mean(axis=1),
                ]
            centres = np.stack(c_mid, axis=1)  # (P, 3, 2)
            # stencil polygon nodes visited: z, end(s_0), ..., end(s_{n-1})
            nodes_seq = np.concatenate([z[:, None], xe[:, :n]], axis=1)
            prev_seq = np.concatenate([xe[:, n:], nodes_seq[:, :-1]], axis=1)
            next_seq = xe  # node_i's v3 target: end(s_i)
            v2 = prev_seq - nodes_seq  # (P, n+1, 2)
            v3 = next_seq - nodes_seq
            v1 = centres[:, :, None, :] - nodes_seq[:, None, :, :]
            a2 = _angle(v1, v2[:, None])
            a3 = _angle(v1, v3[:, None])
            phi_min = np.minimum(a2.min(axis=2), a3.min(axis=2))  # (P, 3)
            theta = phi_min.max(axis=1)
        out[key] = 2.0 / np.sin(0.5 * theta) ** 2
    return out


def estimate_korn_constants(mesh, buckets=None, device=None) -> Function:
    """DG0 function of cell Korn constants: sqrt of the accumulated
    (gdim+1)-weighted patch contributions, on ``device`` (the CUDA card by
    default; ``"cpu"`` for the CPU)."""
    device = resolve_device(device, "estimate_korn_constants")
    if buckets is None:
        buckets = getattr(mesh, "_torch_patches", None)
    if buckets is None:
        buckets = build_patches(mesh)
    ck2 = patch_squared_korn_constants(mesh, buckets)
    acc = np.zeros(mesh.num_cells)
    for key, b in buckets.items():
        np.add.at(acc, b.cells.astype(np.int64).ravel(),
                  np.repeat(3.0 * ck2[key], b.ncells))
    V0 = mesh_space(mesh, "DG", 0)
    # DG0 Dubiner mode is the constant sqrt(2): dof = value / sqrt(2)
    return Function(V0, np.sqrt(acc) / np.sqrt(2.0), device=device)
