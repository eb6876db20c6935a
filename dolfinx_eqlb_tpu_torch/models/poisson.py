"""Primal Poisson solver: -div(grad u) = f.

Port of the JAX package's ``models/poisson.py`` (the role of the PETSc
CG+BoomerAMG primal solve in the reference demos,
``demo_reconstruction.py:256-344``): a matrix-free Jacobi-preconditioned CG
on the device.  Each cell's element matrix A_c = kappa_c |detJ| (K K^T) :
Shat, with the constant reference tensor Shat_ab[i,j] = int grad_a(phi_i)
grad_b(phi_j), is formed once; the operator action is a gather, a batched
product with A_c and an ``index_add_`` — no global matrix is formed.

The CG is a Python loop with the reference's stopping rule, checked every
iteration (one device-to-host read of the residual norm per iteration),
and the reference's default ``maxiter``.  On CUDA, ``index_add_`` sums in
no fixed order, so results may move at the 1e-16 relative level and the
iteration count by one against a CPU run.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..elements.polynomials import legendre_shifted
from ..elements.quadrature import facet_param_points, gauss_interval, gauss_triangle
from ..fem.spaces import (
    Function, FunctionSpace, mesh_geometry, resolve_device, space_tables,
    tabulation,
)
from ..fem.expressions import _CallableExpr, as_expr
from ..fem.interpolate import interpolate

__all__ = ["PoissonSolver", "locate_dofs_on_facets"]


def locate_dofs_on_facets(V: FunctionSpace, facets: np.ndarray) -> np.ndarray:
    """Scalar dofs of a P space topologically on the given facets
    (the role of ``fem.locate_dofs_topological``, demo_reconstruction.py:320)."""
    if V.family != "P":
        raise ValueError("locate_dofs_on_facets needs a P space")
    msh = V.mesh
    k = V.degree
    facets = np.asarray(facets, dtype=np.int64)
    dofs = [msh.facet_vertices[facets].ravel().astype(np.int64)]
    if k >= 2:
        n_edge = k - 1
        base = msh.num_vertices
        dofs.append(
            (base + facets[:, None] * n_edge + np.arange(n_edge)[None, :]).ravel()
        )
    return np.unique(np.concatenate(dofs))


class PoissonSolver:
    def __init__(self, V: FunctionSpace, quadrature_degree: int | None = None,
                 coefficient=None, device=None):
        """``coefficient``: optional cell-wise diffusion kappa — an array
        (ncells,) or a callable evaluated at cell centroids (the Kellogg
        checkerboard demo, reference ``poisson_adaptive/demo_discont-coeff.py``).
        ``device``: the CUDA card by default; ``"cpu"`` for the CPU."""
        if V.family != "P" or V.block_size != 1:
            raise ValueError("PoissonSolver needs a scalar P space")
        self.V = V
        self.device = dev = resolve_device(device, "PoissonSolver")
        msh = V.mesh
        k = V.degree
        qdeg = quadrature_degree or 2 * k
        pts, w = gauss_triangle(qdeg)
        tabg = V.element.tabulate_grad(pts)  # (nd, 2, nq)
        Shat = np.einsum("q,iaq,jbq->abij", w, tabg, tabg)
        self.Shat = torch.as_tensor(Shat, device=dev)
        if coefficient is None:
            kap = np.ones(msh.num_cells)
        elif callable(coefficient):
            cent = msh.map_points(np.array([[1 / 3, 1 / 3]]))[:, 0]
            kap = np.asarray(coefficient(cent))
        else:
            kap = np.asarray(coefficient)
        self.coefficient = kap
        # gradient chain rule: grad(phi) = K^T grad_ref(phi), so
        # A_c[i,j] = kappa_c |detJ| (K K^T)_{ab} Shat_ab[i,j]
        geo = mesh_geometry(msh, dev)
        K = geo["K"]
        kap_t = torch.as_tensor(kap, dtype=torch.float64, device=dev)
        self.G = (kap_t * geo["detJ"].abs())[:, None, None] * torch.einsum(
            "cax,cbx->cab", K, K)
        # element matrices, once: (nc, nd, nd)
        self.A = torch.einsum("cab,abij->cij", self.G, self.Shat)
        self.cell_dofs = space_tables(V, dev)["cell_dofs"]
        self._flat_dofs = self.cell_dofs.reshape(-1)
        self.ndofs = V.ndofs
        self._qpts, self._qw = pts, w
        self._tab = tabulation(V, pts, dev)  # (nd, nq)
        self.diag = self._scatter(torch.diagonal(self.A, dim1=1, dim2=2))

    def _scatter(self, ve: torch.Tensor) -> torch.Tensor:
        """Sum per-cell values (nc, nd) into a dof vector."""
        return ve.new_zeros(self.ndofs).index_add_(0, self._flat_dofs,
                                                   ve.reshape(-1))

    # --- operator ------------------------------------------------------------

    def matvec(self, x):
        xe = x[self.cell_dofs]  # (nc, nd)
        # a broadcast product and a sum over j: on the H100 at 1M P2 cells
        # faster than torch.bmm, which runs these small products as a
        # batched GEMV
        return self._scatter((self.A * xe[:, None, :]).sum(-1))

    # --- right-hand side -------------------------------------------------------

    def load_vector(self, f_expr, neumann=None):
        """neumann: list of (facets, g) pairs; g is the outward normal flux
        grad(u).n on those facets (demo_reconstruction.py:299-303)."""
        msh = self.V.mesh
        dev = self.device
        f = as_expr(f_expr, msh)
        vals = f.evaluate(self._qpts)[..., 0].to(dev)  # (nc, nq)
        adet = mesh_geometry(msh, dev)["detJ"].abs()
        w = torch.as_tensor(self._qw, device=dev)
        be = adet[:, None] * torch.einsum("q,cq,iq->ci", w, vals, self._tab)
        b = self._scatter(be)
        for facets, g in neumann or []:
            b = b + self._facet_load(facets, g)
        return b

    def _facet_load(self, facets, g_expr):
        """int_F g v ds for boundary facets (g = outward normal flux).

        ``g_expr`` is a callable at physical points, or an array of per-facet
        shifted-Legendre coefficients (nfacets, m) of the trace along the
        canonical facet direction (use ``fem.project_facet_trace``) — the
        latter keeps the primal Neumann load consistent with projected flux
        BCs to machine precision (needed for pure-Neumann equilibration
        patches at flux degree 1).
        """
        V, msh = self.V, self.V.mesh
        dev = self.device
        facets = np.asarray(facets, dtype=np.int64)
        # generous rule: pure-Neumann equilibration patches need the primal
        # Neumann load and the flux-BC moments to agree to ~machine precision
        s, w = gauss_interval(V.degree + 8)
        pts_e = facet_param_points(s)
        tabs = [tabulation(V, pts_e[e], dev) for e in range(3)]
        own = msh.facet_cells[facets, 0].astype(np.int64)
        loc = msh.facet_local[facets, 0].astype(np.int64)
        aligned = msh.edge_aligned[own, loc]
        if isinstance(g_expr, np.ndarray):
            coef = g_expr
            leg = legendre_shifted(coef.shape[1] - 1)
            legv = np.array(
                [np.polyval(leg[m, ::-1], s) for m in range(coef.shape[1])]
            )
            gv = np.einsum("fm,mq->fq", coef, legv)
        else:
            g = as_expr(g_expr, msh)
            # physical points along the canonical facet direction
            lo = msh.points[msh.facet_vertices[facets, 0]]
            T = msh.facet_tangent[facets]
            xq = lo[:, None, :] + np.einsum("q,fa->fqa", s, T)
            if not isinstance(g, _CallableExpr):
                raise NotImplementedError(
                    "Neumann data must be a callable or facet coefficients"
                )
            gv = np.asarray(g.fn(xq))
        gv = torch.as_tensor(gv, dtype=torch.float64, device=dev)
        b = torch.zeros(self.ndofs, dtype=torch.float64, device=dev)
        wj = torch.as_tensor(w, device=dev)
        for e in range(3):
            for al in (True, False):
                m = (loc == e) & (aligned == al)
                if not m.any():
                    continue
                fsel = facets[m]
                csel = torch.as_tensor(own[m], device=dev)
                tab = tabs[e]  # (nd, nq) at local param points
                gq = gv[torch.as_tensor(np.where(m)[0], device=dev)]
                if not al:
                    # local param runs opposite to canonical: flip q axis of
                    # the basis table (Gauss points are symmetric in [0,1])
                    tab = tab.flip(1)
                scale = torch.as_tensor(msh.facet_length[fsel], device=dev)
                be = scale[:, None] * torch.einsum("q,fq,iq->fi", wj, gq, tab)
                b.index_add_(0, self.cell_dofs[csel].reshape(-1),
                             be.reshape(-1))
        return b

    # --- Dirichlet + CG solve ---------------------------------------------------

    def solve(
        self,
        f_expr,
        dirichlet_facets,
        u_d,
        neumann=None,
        rtol=1e-12,
        atol=1e-14,
        maxiter=None,
    ) -> Function:
        V = self.V
        dev = self.device
        bdofs = locate_dofs_on_facets(V, dirichlet_facets)
        free = np.ones(self.ndofs, dtype=bool)
        free[bdofs] = False
        free = torch.as_tensor(free, device=dev)

        # boundary values by nodal interpolation of u_d
        ud_fun = interpolate(V, u_d, device=dev)
        x = torch.where(free, 0.0, ud_fun.x)

        b = self.load_vector(f_expr, neumann)
        r = torch.where(free, b - self.matvec(x), 0.0)
        Minv = torch.where(self.diag > 0, 1.0 / self.diag, 1.0)

        if maxiter is None:
            maxiter = 20 * int(np.sqrt(self.ndofs) + 100)

        z = Minv * r
        p = z
        rz = torch.dot(r, z)
        bf = b * free
        bnorm = torch.sqrt(torch.dot(bf, bf)) + atol
        tol = float(rtol * bnorm + atol)
        it = 0
        while it < maxiter and math.sqrt(float(torch.dot(r, r))) > tol:
            Ap = torch.where(free, self.matvec(p), 0.0)
            alpha = rz / torch.dot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = Minv * r
            rz_new = torch.dot(r, z)
            p = z + (rz_new / rz) * p
            rz = rz_new
            it += 1
        self.last_iterations = it
        self.last_maxiter = maxiter
        self.last_residual = float(torch.linalg.norm(r))
        return Function(V, x)
