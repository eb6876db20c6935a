"""Cell-local L2 projection and local solvers.

Port of the JAX package's ``fem/projection.py`` (the reference's local
solver path, ``cpp/dolfinx_eqlb/base/local_solver.hpp:37-187`` +
``python/dolfinx_eqlb/lsolver``): all cells are solved in one batched op.

* DG targets use the orthonormal Dubiner basis, so projection is a pure
  quadrature moment evaluation — no linear solve at all.
* P / RT / DRT targets solve the per-cell mass systems with one batched
  ``torch.linalg.solve``.  Dofs shared by several cells (P, conforming RT)
  take the value of their last cell in row-major (cell, local) order
  (``spaces.dof_owner``), as the reference's ``.at[cell_dofs].set`` does
  on JAX's CPU backend.
"""

from __future__ import annotations

import torch

from ..elements.quadrature import gauss_triangle
from .spaces import (
    Function, FunctionSpace, dof_owner, mesh_geometry, space_tables,
    tabulation,
)
from .expressions import as_expr, target_device

__all__ = ["local_projection", "local_solver_cholesky", "local_solver_lu",
           "local_solver_cg"]


def _proj_quadrature(V: FunctionSpace, quadrature_degree):
    if quadrature_degree is None:
        quadrature_degree = 2 * V.degree + 2
    return gauss_triangle(quadrature_degree)


def local_projection(V: FunctionSpace, data, quadrature_degree=None,
                     device=None):
    """L2-project each expression in ``data`` into ``V`` cell-locally.

    Mirrors ``local_projection`` (reference ``lsolver/projection.py:46-77``).
    Returns a list of Functions on ``device``, else the data's, else the
    CUDA card.
    """
    exprs = [as_expr(d, V.mesh) for d in data]
    dev = target_device(exprs, device, "local_projection")
    pts, w = _proj_quadrature(V, quadrature_degree)
    w = torch.as_tensor(w, dtype=torch.float64, device=dev)
    msh = V.mesh
    geo = mesh_geometry(msh, dev)

    out = []
    if V.family == "DG":
        tab = tabulation(V, pts, dev)  # (nd, nq)
        for e in exprs:
            vals = e.evaluate(pts).to(dev)  # (nc, nq, vs)
            if e.value_size != V.block_size:
                raise ValueError("value size mismatch")
            # dof_m = sum_q w_q expr Q_m   (detJ cancels: orthonormal basis)
            mom = torch.einsum("q,cqa,dq->acd", w, vals, tab)
            # layout: component-major blocks, cell-major inside
            out.append(Function(V, mom.reshape(-1)))
        return out

    if V.family in ("RT", "DRT"):
        tab = tabulation(V, pts, dev)  # (nd, 2, nq)
        J = geo["J"]
        adet, sdet = geo["detJ"].abs(), torch.sign(geo["detJ"])
        # M_c = (1/|detJ|) (J^T J)_{ab} Mhat_ab
        Mhat = torch.einsum("q,iaq,jbq->abij", w, tab, tab)
        JtJ = torch.einsum("cka,ckb->cab", J, J)
        M = torch.einsum("cab,abij->cij", JtJ, Mhat) / adet[:, None, None]
        sg = space_tables(V, dev)["dof_signs"]
        owner = dof_owner(V, dev)
        if sg is not None:
            M = M * sg[:, :, None] * sg[:, None, :]
        for e in exprs:
            vals = e.evaluate(pts).to(dev)  # (nc, nq, 2)
            rhs = sdet[:, None] * torch.einsum(
                "q,cqa,cab,ibq->ci", w, vals, J, tab)
            if sg is not None:
                rhs = rhs * sg
            sol = torch.linalg.solve(M, rhs[..., None])[..., 0]
            # conforming RT facet dofs are shared: last writer, as for P
            out.append(Function(V, sol.reshape(-1)[owner]))
        return out

    if V.family == "P":
        tab = tabulation(V, pts, dev)  # (nd, nq)
        adet = geo["detJ"].abs()
        Mhat = torch.einsum("q,iq,jq->ij", w, tab, tab)
        M = adet[:, None, None] * Mhat[None]
        owner = dof_owner(V, dev)
        for e in exprs:
            vals = e.evaluate(pts).to(dev)
            xs = []
            for b in range(V.block_size):
                rhs = adet[:, None] * torch.einsum(
                    "q,cq,iq->ci", w, vals[..., b], tab)
                sol = torch.linalg.solve(M, rhs[..., None])[..., 0]
                xs.append(sol.reshape(-1)[owner])
            out.append(Function(V, torch.cat(xs)))
        return out

    raise ValueError(f"local projection into {V.family} not supported")


# reference API parity (wrappers.cpp:52-82 exposes lu/cholesky/cg variants;
# all of them are the same batched dense solve here)
def local_solver_cholesky(V, data, quadrature_degree=None, device=None):
    return local_projection(V, data, quadrature_degree, device)


def local_solver_lu(V, data, quadrature_degree=None, device=None):
    return local_projection(V, data, quadrature_degree, device)


def local_solver_cg(V, data, quadrature_degree=None, device=None):
    return local_projection(V, data, quadrature_degree, device)
