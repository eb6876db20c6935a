"""Dof-functional interpolation into RT / DRT / P spaces.

Port of the JAX package's ``fem/interpolate.py``.  The RT interpolation
operator is the backbone of the reference's boundary machinery
(``base/KernelData.cpp:190-268`` extracts the per-facet interpolation
matrix M) and of the jump-condition checker
(``check_eqlb_conditions.py:294-359`` compares a function with its RT
interpolant).  Batched over all cells / facets.

Shared P dofs take the value of their last cell in row-major (cell, local)
order, gathered through ``spaces.dof_owner``: the choice the reference's
duplicate-index ``.at[].set`` makes on JAX's CPU backend.
"""

from __future__ import annotations

import numpy as np
import torch

from ..elements.polynomials import legendre_shifted
from ..elements.quadrature import (
    REF_EDGE_ROTT,
    facet_param_points,
    gauss_interval,
    gauss_triangle,
)
from ..elements.lagrange import dubiner_cached
from .spaces import (
    Function, FunctionSpace, _cached, dof_owner, mesh_geometry, space_tables,
)
from .expressions import as_expr, target_device

__all__ = ["interpolate", "project_facet_trace"]


def project_facet_trace(mesh, facets, g, degree: int, quadrature_degree=None):
    """Per-facet L2 projection of ``g(x)`` onto P_{degree-1} along the
    canonical facet direction; returns shifted-Legendre coefficients
    (nfacets, degree) as a host array.  Used to feed *identical* data to the
    primal Neumann load and the flux BCs (cf. the reference's shared UFL
    expression)."""
    facets = np.asarray(facets, dtype=np.int64)
    nq = max(degree + 1, ((quadrature_degree or 2 * degree + 16) + 2) // 2)
    s, w = gauss_interval(nq)
    leg = legendre_shifted(degree - 1)
    legv = np.array([np.polyval(leg[m, ::-1], s) for m in range(degree)])
    lo = mesh.points[mesh.facet_vertices[facets, 0]]
    T = mesh.facet_tangent[facets]
    xq = lo[:, None, :] + np.einsum("q,fa->fqa", s, T)
    gv = np.asarray(g(xq))
    scale = 2.0 * np.arange(degree) + 1.0  # 1 / ||P~_j||^2
    return np.einsum("q,jq,fq,j->fj", w, legv, gv, scale)


def _reference_rt_dofs(V: FunctionSpace, e, nq_facet: int, qdeg_cell: int,
                       device):
    """Per-cell reference dof functionals of the pull-back of expression e.

    Returns (nc, nrt): row layout [facet dofs (3k), div dofs, interior dofs].
    Facet dofs are the *reference* functionals l_{e,m}; the conversion to
    globally-oriented dofs is a sign handled by the caller.
    """
    el = V.element
    k = V.degree
    s, w = gauss_interval(nq_facet)
    leg = legendre_shifted(k - 1)
    legv = np.array([np.polyval(leg[m, ::-1], s) for m in range(k)])  # (k,nq)
    geo = mesh_geometry(V.mesh, device)
    K, det = geo["K"], geo["detJ"]

    def f64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    cols = []
    # facet dofs: vhat = detJ * K v at edge points, dotted with rot(t_e)
    pts_e = facet_param_points(s)  # (3, nq, 2)
    for eidx in range(3):
        v = e.evaluate(pts_e[eidx]).to(device)  # (nc, nq, 2)
        vhat = det[:, None, None] * torch.einsum("cab,cqb->cqa", K, v)
        vn = (
            REF_EDGE_ROTT[eidx, 0] * vhat[..., 0]
            + REF_EDGE_ROTT[eidx, 1] * vhat[..., 1]
        )  # (nc, nq)
        cols.append(torch.einsum("q,mq,cq->cm", f64(w), f64(legv), vn))
    out = [torch.cat(cols, dim=1)]

    if el.ndofs_cell > 0:
        pts, wc = gauss_triangle(qdeg_cell)
        dub = dubiner_cached(k - 1)
        dv = f64(dub.tabulate(np.asarray(pts)))  # (ndg, nq)
        divv = e.evaluate_div(pts)[..., 0].to(device)  # (nc, nq)
        # int_That divhat(vhat) Q_p = int detJ (div v) Q_p
        div_dofs = torch.einsum("q,c,cq,pq->cp", f64(wc), det, divv, dv[1:])
        out.append(div_dofs)
        if el.ndofs_cell_int > 0:
            v = e.evaluate(pts).to(device)
            vhat = det[:, None, None] * torch.einsum("cab,cqb->cqa", K, v)
            monos = []
            for l in range(1, k - 1):
                for m in range(0, k - 1 - l):
                    monos.append(pts[:, 0] ** l * pts[:, 1] ** m)
            mono = f64(np.array(monos))  # (nint, nq)
            out.append(
                torch.einsum("q,cq,pq->cp", f64(wc), vhat[..., 1], mono)
            )
    return torch.cat(out, dim=1)


def interpolate(V: FunctionSpace, data, quadrature_degree=None,
                device=None) -> Function:
    """Interpolate an expression into V by applying V's dof functionals.

    For non-polynomial data the facet/cell quadrature (controlled by
    ``quadrature_degree``) commits a consistent approximation, mirroring the
    reference's expression-kernel evaluation at interpolation points
    (``bcs.py:64-121``).  Runs on ``device``, else the data's, else the
    CUDA card.
    """
    e = as_expr(data, V.mesh)
    dev = target_device([e], device, "interpolate")
    msh = V.mesh

    if V.family == "P":
        vals = e.evaluate(V.element.nodes).to(dev)  # (nc, nnodes, vs)
        owner = dof_owner(V, dev)
        xs = [vals[..., b].reshape(-1)[owner] for b in range(V.block_size)]
        return Function(V, torch.cat(xs))

    if V.family not in ("RT", "DRT"):
        raise ValueError(f"interpolate into {V.family} not supported")

    k = V.degree
    if quadrature_degree is None:
        quadrature_degree = 2 * k + 2
    nq_facet = max(k + 1, (quadrature_degree + 2) // 2)
    dofs_ref = _reference_rt_dofs(V, e, nq_facet, quadrature_degree, dev)
    t = space_tables(V, dev)
    cell_dofs = t["cell_dofs"]

    if V.family == "DRT":
        # cell-wise dofs: unique indices
        x = dofs_ref.new_zeros(V.ndofs)
        x[cell_dofs] = dofs_ref
        return Function(V, x)

    # conforming RT: globally-oriented dof = sign * reference dof, taken from
    # the facet's first adjacent cell (sides agree iff data is in H(div))
    oriented = dofs_ref * t["dof_signs"]  # (nc, nrt): global dof values
    own_cell, own_loc = _cached(msh, "_torch_facet_owner", str(dev), lambda: (
        torch.as_tensor(msh.facet_cells[:, 0].astype(np.int64), device=dev),
        torch.as_tensor(msh.facet_local[:, 0].astype(np.int64), device=dev)))
    # facet f's dof m sits at f * k + m: the facet block is (nf, k)
    cols = own_loc[:, None] * k + torch.arange(k, device=dev)
    x_facets = oriented[own_cell[:, None], cols].reshape(-1)
    if V.element.ndofs_cell == 0:
        return Function(V, x_facets)
    x = oriented.new_zeros(V.ndofs)
    x[: msh.num_facets * k] = x_facets
    x[cell_dofs[:, 3 * k:]] = oriented[:, 3 * k:]
    return Function(V, x)
