"""Geometric multigrid preconditioning on red-refinement hierarchies.

Port of the JAX package's ``fem/multigrid.py`` (the role of the
reference's PETSc CG + BoomerAMG primal solves,
``python/test/performance/perftest_basics.py:34-160``): a matrix-free
geometric V-cycle.

* The mesh hierarchy comes from ``mesh.refine_uniform``: child cells lie
  in four index blocks of the parent cell count, and the four
  child-to-parent reference maps are mesh-independent constants, so the
  grid transfer is a gather, one product with a fixed ``(4, nd, nd)``
  tabulation tensor and an ``index_add_``.
* Smoothing is Chebyshev-accelerated Jacobi: a fixed-degree polynomial in
  ``D^{-1} A`` applied by batched element products.
* The coarsest level is solved by a dense inverse (one matmul).

The host tables (transfer tensor, element tensors, diagonal, free mask,
owner mask, coarse inverse and the power-iteration estimate of the largest
eigenvalue of ``D^{-1} A``) are NumPy computations copied from the
reference, so they match its arrays; only the power iteration's scatter
runs as ``np.bincount``, which sums in the same order as ``np.add.at``.
The V-cycle runs on the tables' device.  With equal pre- and
post-smoothing it is a fixed symmetric positive definite operator, so it
preconditions CG and MINRES.  On CUDA, ``index_add_`` sums in no fixed
order, so it is symmetric to rounding only.  Dirichlet conditions are
handled by free-dof masking on every level.
"""

from __future__ import annotations

import time
from contextlib import nullcontext

import numpy as np
import torch

from ..elements.lagrange import lagrange_cached
from ..elements.quadrature import gauss_triangle
from ..utils.precision import full_f32_matmul
from .spaces import mesh_space, resolve_device

__all__ = [
    "GeometricMG",
    "mesh_hierarchy",
    "prolongation_tensor",
    "scalar_stiffness_tensors",
    "vector_eps_tensors",
]


def mesh_hierarchy(coarse, nlevels: int):
    """``[coarse, refine_uniform(coarse), ...]``: ``nlevels`` meshes,
    coarse to fine, nested for :class:`GeometricMG` (the finest has
    ``4**(nlevels-1)`` times the coarse cell count)."""
    from ..mesh import refine_uniform

    meshes = [coarse]
    for _ in range(nlevels - 1):
        meshes.append(refine_uniform(meshes[-1]))
    return meshes


# Parent-reference vertex coordinates of the four red children produced by
# mesh.refine_uniform (child b of parent c is fine cell b * nc + c):
#   c0 = (v0, m2, m1), c1 = (v1, m0, m2), c2 = (v2, m1, m0),
#   c3 = (m0, m1, m2)
# with v = reference vertices, m_i = midpoint of the edge opposite v_i.
_CHILD_VERTS = np.array(
    [
        [[0.0, 0.0], [0.5, 0.0], [0.0, 0.5]],
        [[1.0, 0.0], [0.5, 0.5], [0.5, 0.0]],
        [[0.0, 1.0], [0.0, 0.5], [0.5, 0.5]],
        [[0.5, 0.5], [0.0, 0.5], [0.5, 0.0]],
    ]
)


def prolongation_tensor(degree: int) -> np.ndarray:
    """``P[b, i, j]``: coarse basis i at the parent-reference location of
    fine Lagrange node j inside red child b; mesh-independent, so CG_k
    coarse-to-fine interpolation is a single constant tensor."""
    el = lagrange_cached(degree)
    nodes = el.nodes  # (nd, 2) fine-element reference nodes
    P = np.empty((4, el.ndofs, el.ndofs))
    for b in range(4):
        V = _CHILD_VERTS[b]
        mapped = V[0] + np.einsum(
            "ja,ab->jb", nodes, np.stack([V[1] - V[0], V[2] - V[0]])
        )
        P[b] = el.tabulate(mapped)  # (i, j)
    return P


def scalar_stiffness_tensors(msh, degree: int, mass_coeff: float = 0.0,
                             quadrature_degree=None) -> np.ndarray:
    """Element tensors of ``(grad u, grad v) + mass_coeff (u, v)`` on CG_k
    -> ``(nc, nd, nd)`` (the Poisson operator; the Biot ``K_p + M_p``
    pressure block)."""
    el = lagrange_cached(degree)
    pts, w = gauss_triangle(quadrature_degree or 2 * degree)
    tg = el.tabulate_grad(pts)  # (nd, 2, nq)
    g = np.einsum("cba,ibq->ciaq", msh.K, tg)
    adet = np.abs(msh.detJ)
    A = np.einsum("q,ciaq,cjaq,c->cij", w, g, g, adet)
    if mass_coeff:
        t = el.tabulate(pts)
        A += mass_coeff * np.einsum("q,iq,jq,c->cij", w, t, t, adet)
    return A


def vector_eps_tensors(msh, degree: int, quadrature_degree=None,
                       div_coeff: float = 0.0) -> np.ndarray:
    """Element tensors of ``2 (eps(u), eps(v)) + div_coeff (div u, div v)``
    on (CG_k)^2, local index flattened ``i * 2 + a`` ->
    ``(nc, 2 nd, 2 nd)`` (the Biot / elasticity displacement block;
    ``div_coeff = pi_1`` is the operator of ``models.ElasticitySolver``)."""
    el = lagrange_cached(degree)
    pts, w = gauss_triangle(quadrature_degree or 2 * degree)
    tg = el.tabulate_grad(pts)
    g = np.einsum("cba,ibq->ciaq", msh.K, tg)
    adet = np.abs(msh.detJ)
    nd = el.ndofs
    gg = np.einsum("q,ciaq,cjbq->ciajb", w, g, g)
    A = np.zeros((len(msh.K), nd, 2, nd, 2))
    gij = np.einsum("q,cixq,cjxq->cij", w, g, g)
    for a in range(2):
        A[:, :, a, :, a] += gij
    A += np.einsum("ciajb->cibja", gg)
    if div_coeff:
        A += div_coeff * gg
    A *= adet[:, None, None, None, None]
    return A.reshape(len(msh.K), 2 * nd, 2 * nd)


def _boundary_scalar_dofs(msh, space) -> np.ndarray:
    """Scalar CG dofs on the whole domain boundary (vertex and edge dofs of
    the boundary facets)."""
    k = space.degree
    bf = msh.boundary_facets.astype(np.int64)
    dofs = [msh.facet_vertices[bf].ravel().astype(np.int64)]
    if k >= 2:
        nv = msh.num_vertices
        dofs.append(
            (nv + bf[:, None] * (k - 1) + np.arange(k - 1)[None, :]).ravel()
        )
    return np.unique(np.concatenate(dofs))


def _scatter_sum(cd: np.ndarray, vals: np.ndarray, n: int) -> np.ndarray:
    """``np.add.at(zeros(n), cd, vals)`` by ``np.bincount``: both add the
    values in their flat order, so the sums are the same."""
    return np.bincount(cd.ravel(), weights=vals.ravel(), minlength=n)


def _full_f32(dtype):
    """Full-precision f32 products (no TF32) for an f32 V-cycle: a reduced
    precision would change the preconditioner between applications."""
    if dtype != torch.float32:
        return nullcontext()
    return full_f32_matmul()


class GeometricMG:
    """Symmetric V-cycle on a red-refinement hierarchy of CG_k spaces.

    Parameters
    ----------
    meshes : list of TriMesh, coarse to fine, each produced from the
        previous by ``mesh.refine_uniform``.
    degree : CG degree of the preconditioned space.
    elem_tensors_fn : ``msh -> (nc, nd * bs, nd * bs)`` NumPy element
        tensors of the level operator, local index flattened ``i * bs + a``
        with component-major global layout ``dof = scalar_dof + a * nds``.
    bc_dofs_fn : ``(msh, scalar_space) -> constrained scalar dofs`` (applied
        to every component); default the whole boundary.  ``None`` gives a
        pure-Neumann level (the operator must then be nonsingular, e.g.
        carry a mass term).
    block_size : components per scalar dof (1 scalar, 2 a 2D vector).
    smooth_degree : Chebyshev polynomial degree per pre- and post-smooth.
    eig_ratio : smoothing interval [lmax / eig_ratio, lmax].
    dtype : precision of the device tables and the V-cycle (default f64).
    device : the CUDA card by default; ``"cpu"`` for the CPU.

    ``setup_s`` holds the host seconds of each level's set-up: its tables,
    the power iteration, and (level 0) the coarse inverse.
    """

    def __init__(self, meshes, degree: int, elem_tensors_fn,
                 bc_dofs_fn=_boundary_scalar_dofs, block_size: int = 1,
                 smooth_degree: int = 3, eig_ratio: float = 8.0,
                 dtype=torch.float64, device=None):
        if bc_dofs_fn is None:
            bc_dofs_fn = lambda msh, sp: np.empty(0, dtype=np.int64)  # noqa: E731
        self.device = dev = resolve_device(device, "GeometricMG")
        self.dtype = dtype
        self.bs = bs = block_size
        self.degree = degree
        self.m = smooth_degree
        self.eig_ratio = float(eig_ratio)
        self.nlevels = len(meshes)
        for lo, hi in zip(meshes[:-1], meshes[1:]):
            if hi.num_cells != 4 * lo.num_cells:
                raise ValueError(
                    "hierarchy must be consecutive red refinements "
                    f"({hi.num_cells} != 4 * {lo.num_cells})")

        def put(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        Ptab = put(prolongation_tensor(degree))
        self._ops = []
        self._nds = []
        self.setup_s = []
        for l, msh in enumerate(meshes):
            t0 = time.perf_counter()
            sp = mesh_space(msh, "P", degree)
            cds = sp.cell_dofs.astype(np.int64)  # (nc, nd) scalar
            nc, nd = cds.shape
            nds = sp.ndofs_scalar
            Ae = np.asarray(elem_tensors_fn(msh))
            # flattened (i, a) operator dof table, component-major global
            cd = np.concatenate(
                [cds[:, :, None] + a * nds for a in range(bs)], axis=2
            ).reshape(nc, nd * bs)
            free = np.ones(nds * bs, dtype=bool)
            bc = np.asarray(bc_dofs_fn(msh, sp), dtype=np.int64)
            for a in range(bs):
                free[bc + a * nds] = False
            diag = _scatter_sum(cd, np.einsum("cii->ci", Ae), nds * bs)
            Dinv = np.where(free & (np.abs(diag) > 0), 1.0 / diag, 0.0)
            o = dict(
                cd=put(cd, torch.int64),
                Ae=put(Ae),
                Dinv=put(Dinv),
                free=put(free.astype(np.float64)),
            )
            times = {"level": l, "cells": nc}
            if l == 0:
                t1 = time.perf_counter()
                A = np.zeros((nds * bs, nds * bs))
                np.add.at(A, (cd[:, :, None], cd[:, None, :]), Ae)
                fix = ~free
                A[fix, :] = 0.0
                A[:, fix] = 0.0
                A[fix, fix] = 1.0
                Ainv = np.linalg.inv(A)
                Ainv[fix, :] = 0.0
                Ainv[:, fix] = 0.0
                o["Ainv"] = put(Ainv)
                times["coarse_inverse_s"] = time.perf_counter() - t1
            else:
                # transfer tables: fine cells in 4 red blocks of the coarse
                # cell count; the owner mask picks one (cell, local)
                # occurrence per global fine dof, so that restriction is
                # the exact transpose of prolongation
                cds4 = cds.reshape(4, nc // 4, nd)
                flat = cds4.reshape(-1)
                owner = np.zeros(flat.shape, dtype=bool)
                owner[np.unique(flat, return_index=True)[1]] = True
                o["cds_f"] = put(cds4, torch.int64)
                o["owner"] = put(owner.reshape(4, nc // 4, nd)
                                 .astype(np.float64))
                o["Ptab"] = Ptab
                o["cds_c"] = self._ops[l - 1]["cds_scalar"]
            o["cds_scalar"] = put(cds, torch.int64)
            # lmax of Dinv A: power iteration from a deterministic start, on
            # the host arrays; only the scalar is kept
            t1 = time.perf_counter()
            rng = np.random.default_rng(7)
            v = rng.standard_normal(nds * bs)
            lam = 1.0
            for _ in range(20):
                v /= np.linalg.norm(v) + 1e-30
                ve = np.where(free, v, 0.0)[cd]
                y = _scatter_sum(cd, np.einsum("cij,cj->ci", Ae, ve),
                                 nds * bs)
                v = Dinv * np.where(free, y, 0.0)
                lam = np.linalg.norm(v)
            o["lmax"] = float(1.1 * lam)
            times["power_iteration_s"] = time.perf_counter() - t1
            times["total_s"] = time.perf_counter() - t0
            self.setup_s.append(times)
            self._ops.append(o)
            self._nds.append(nds)

    # --- level operations --------------------------------------------------

    def _matvec(self, o, x):
        xe = (x * o["free"])[o["cd"]]
        y = (o["Ae"] * xe[:, None, :]).sum(-1)
        return (torch.zeros_like(x).index_add_(0, o["cd"].reshape(-1),
                                               y.reshape(-1)) * o["free"])

    def _cheb(self, o, r):
        """z ~ A^{-1} r: degree-m Chebyshev on D^{-1}A over
        [lmax / eig_ratio, lmax] from a zero initial guess."""
        lmax = o["lmax"]
        lmin = lmax / self.eig_ratio
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta
        d = (o["Dinv"] * r) / theta
        z = d
        rho = 1.0 / sigma
        for _ in range(self.m - 1):
            r = r - self._matvec(o, d)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (o["Dinv"] * r)
            z = z + d
            rho = rho_new
        return z

    def _prolong(self, o, xc):
        """Coarse level vector (bs * ndc,) -> fine (bs * ndf,)."""
        bs = self.bs
        vc = xc.reshape(bs, -1)[:, o["cds_c"]]  # (bs, ncc, nd)
        # vf[s, b, c, j] = sum_i P[b, i, j] vc[s, c, i]
        vf = torch.matmul(vc[:, None], o["Ptab"][None])  # (bs, 4, ncc, nd)
        ndf = o["Dinv"].shape[0] // bs
        out = xc.new_zeros(bs, ndf).index_add_(
            1, o["cds_f"].reshape(-1), (vf * o["owner"][None]).reshape(bs, -1))
        return out.reshape(-1)

    def _restrict(self, o, rf, ndc):
        """The exact transpose of ``_prolong`` (``ndc`` = coarse scalar
        size)."""
        bs = self.bs
        vf = rf.reshape(bs, -1)[:, o["cds_f"]] * o["owner"][None]
        # vc[s, c, i] = sum_b sum_j P[b, i, j] vf[s, b, c, j]
        vc = torch.matmul(vf, o["Ptab"].transpose(1, 2)[None]).sum(1)
        out = rf.new_zeros(bs, ndc).index_add_(
            1, o["cds_c"].reshape(-1), vc.reshape(bs, -1))
        return out.reshape(-1)

    def apply(self, r, ops=None):
        """One symmetric V-cycle: ``z ~ A^{-1} r`` on the free dofs.
        ``ops`` defaults to ``self.operands()``."""
        ops = self._ops if ops is None else ops
        with _full_f32(r.dtype):
            return self._vcycle(self.nlevels - 1, r * ops[-1]["free"], ops)

    def _vcycle(self, l, r, ops):
        o = ops[l]
        if l == 0:
            return o["Ainv"] @ r
        z = self._cheb(o, r)
        rc = self._restrict(o, r - self._matvec(o, z), self._nds[l - 1])
        rc = rc * ops[l - 1]["free"]
        ec = self._vcycle(l - 1, rc, ops)
        z = z + self._prolong(o, ec) * o["free"]
        z = z + self._cheb(o, r - self._matvec(o, z))
        return z

    def operands(self):
        """Every level's device tables (the reference threads them through
        its jitted Krylov loops; kept for API parity)."""
        return self._ops
