"""The comparison that decides ``correct``: the program's global RT dof
vectors against the plain reference's, as the largest error over every dof
of every checked output relative to the largest reference value.

The program numbers its facets its own way.  Its facet table (each facet's
pair of vertex ids) is read only as the index map of its output vector, and
is held to be a one-to-one map onto the reference's own facets, each in its
canonical (lower, higher) direction: a table that is not makes the check
fail.  Cell dofs share one numbering, the cell order given to both.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.kkt import Reference


def facet_map(port_facet_vertices: np.ndarray, ref: Reference) -> np.ndarray | None:
    """Reference facet id of each program facet, or None where the program's
    table is not a one-to-one map onto the reference's facets."""
    fv = np.asarray(port_facet_vertices, dtype=np.int64)
    topo = ref.topo
    if fv.shape != (topo.num_facets, 2) or not (fv[:, 0] < fv[:, 1]).all():
        return None
    keys = fv[:, 0] * topo.num_vertices + fv[:, 1]
    g = np.searchsorted(topo.facet_keys, keys)
    g = np.minimum(g, topo.num_facets - 1)
    if not (topo.facet_keys[g] == keys).all() or len(np.unique(g)) != len(g):
        return None
    return g


def to_reference_order(x: torch.Tensor, g: np.ndarray, ref: Reference) -> torch.Tensor:
    """The program's dof vectors (L, ndofs) in the reference's numbering."""
    k, nf = ref.k, ref.topo.num_facets
    out = torch.empty_like(x)
    idx = torch.as_tensor(g, device=x.device)
    out[:, :nf * k].view(-1, nf, k)[:, idx] = x[:, :nf * k].view(-1, nf, k)
    out[:, nf * k:] = x[:, nf * k:]
    return out


# stands for an error that is not a number: a missing or non-finite output
NOT_A_NUMBER = 1e308


def max_rel_err(x: torch.Tensor, x_ref: torch.Tensor) -> float:
    """max |x - x_ref| / max |x_ref| over every entry; ``NOT_A_NUMBER``
    where x holds a non-finite value or has the wrong shape."""
    if x.shape != x_ref.shape:
        return NOT_A_NUMBER
    x = x.to(x_ref.device, x_ref.dtype)
    if not bool(torch.isfinite(x).all()):
        return NOT_A_NUMBER
    return float((x - x_ref).abs().max() / x_ref.abs().max())


def row_errors(outputs: torch.Tensor, port_facet_vertices: np.ndarray,
               ref: Reference, x_ref: torch.Tensor) -> list[float]:
    """``max_rel_err`` of each of the program's outputs (L, ndofs), row l
    the answer to data set l, against the reference's ``x_ref``."""
    g = facet_map(port_facet_vertices, ref)
    if g is None or outputs.shape != x_ref.shape:
        return [NOT_A_NUMBER] * x_ref.shape[0]
    x = to_reference_order(outputs.to(x_ref.device), g, ref)
    return [max_rel_err(x[i], x_ref[i]) for i in range(x_ref.shape[0])]
