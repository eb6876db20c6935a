"""Primal linear-elasticity solvers.

Port of the JAX package's ``models/elasticity.py`` (reference workload
``demo/elasticity/demo_reconstruction.py:271-442``), both formulations with
mu = 1, lambda = pi_1:

* ``ElasticitySolver``: displacement, sigma(u) = 2 eps(u) + pi_1 div(u) I,
  vector P_k; a matrix-free CG, preconditioned by Jacobi or (``mg_meshes``)
  by a geometric V-cycle on the whole operator (``fem.multigrid``);
* ``ElasticitySolverUP``: Herrmann displacement-pressure, Taylor-Hood
  P_{k+1}^2 x P_k, sigma = 2 eps(u) + p I; MINRES (``fem.krylov.minres``)
  on the symmetric quasi-definite system, preconditioned by Jacobi or
  (``mg_meshes``) by a V-cycle on the displacement block and the inverse
  pressure-mass diagonal.

Each cell's element matrices are formed once on the device; the operator
action is a gather, a batched product and an ``index_add_``.  The CG loop
is the port's Poisson CG: a Python loop with the reference's stopping rule
checked every iteration and its ``maxiter``.  On CUDA, ``index_add_`` sums
in no fixed order, so results may move at the 1e-16 relative level and the
iteration count by one against a CPU run.  The multigrid branches need u
essential on the whole boundary and a hierarchy whose finest mesh is the
solver's mesh object.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..elements.quadrature import facet_param_points, gauss_interval, gauss_triangle
from ..fem.expressions import Expr, as_expr
from ..fem.interpolate import interpolate
from ..fem.krylov import minres
from ..fem.spaces import (
    Function, FunctionSpace, mesh_geometry, mesh_space, resolve_device,
    space_tables, tabulation,
)
from .poisson import locate_dofs_on_facets

__all__ = ["ElasticitySolver", "ElasticitySolverUP", "stress_row_expr",
           "stress_row_expr_up", "pressure_mismatch_expr"]


def _whole_boundary(msh, dirichlet_facets):
    if len(np.setdiff1d(msh.boundary_facets, np.asarray(dirichlet_facets))):
        raise ValueError(
            "the MG path assumes u essential on the whole boundary")


class _StressRow(Expr):
    """Row i of sigma(u_h) = 2 eps(u_h) + pi_1 div(u_h) I as an expression
    (optionally scaled), for projecting the stress rows before
    equilibration (reference elasticity demo_reconstruction.py:480-489
    projects the negated rows)."""

    def __init__(self, uh: Function, pi_1: float, row: int, scale: float = 1.0):
        self.uh, self.pi_1, self.row, self.scale = uh, pi_1, row, scale
        self.mesh = uh.space.mesh
        self.value_size = 2
        self.device = uh.device

    def evaluate(self, q):
        g = self.uh.evaluate_grad(q)  # (nc, nq, 2, 2): g[..., comp, deriv]
        eps = 0.5 * (g + g.transpose(-1, -2))
        divu = g[..., 0, 0] + g[..., 1, 1]
        sig_row = 2.0 * eps[..., self.row, :]
        sig_row[..., self.row] += self.pi_1 * divu
        return self.scale * sig_row


def stress_row_expr(uh: Function, pi_1: float, row: int, scale: float = 1.0):
    return _StressRow(uh, pi_1, row, scale)


def _eps_matrices(K, tabg, w, adet, div_coeff):
    """Per-cell 2 eps(u):eps(v) + div_coeff div(u) div(v) matrices of a
    vector P space, (i, a)-flattened: K (nc, 2, 2), tabg (nd, 2, nq)
    reference gradients, w (nq,), adet (nc,).  Also returns the physical
    gradients g[c, i, a, q]."""
    nc, nd = K.shape[0], tabg.shape[0]
    g = torch.einsum("cba,ibq->ciaq", K, tabg)
    # basis function (i, a): eps = 0.5 (e_a g_i^T + g_i e_a^T), so
    # 2 eps(u):eps(v) = (e_a.e_b)(g_i.g_j) + (g_i)_b (g_j)_a
    gg = torch.einsum("q,ciaq,cjbq->ciajb", w, g, g)  # (g_i)_a (g_j)_b
    gij = torch.einsum("q,cixq,cjxq->cij", w, g, g)
    A = gg.permute(0, 1, 4, 3, 2).clone()  # (g_i)_b (g_j)_a at (i,a,j,b)
    for a in range(2):
        A[:, :, a, :, a] += gij
    if div_coeff:
        A += div_coeff * gg
    A *= adet[:, None, None, None, None]
    return A.reshape(nc, 2 * nd, 2 * nd), g


def _ia_dofs(V: FunctionSpace, device) -> torch.Tensor:
    """Cell dof table of a vector P space in (i, a) order: entry i * 2 + a
    is component a of scalar dof i."""
    cd = space_tables(V, device)["cell_dofs"]  # (nc, nd)
    return torch.stack([cd, cd + V.ndofs_scalar], dim=-1).reshape(
        cd.shape[0], -1)


def _boundary_dofs(V: FunctionSpace, facets) -> np.ndarray:
    bscalar = locate_dofs_on_facets(mesh_space(V.mesh, "P", V.degree),
                                    facets)
    return np.concatenate([bscalar + a * V.ndofs_scalar for a in range(2)])


class ElasticitySolver:
    def __init__(self, V: FunctionSpace, pi_1: float, quadrature_degree=None,
                 device=None):
        """``device``: the CUDA card by default; ``"cpu"`` for the CPU."""
        if V.family != "P" or V.block_size != 2:
            raise ValueError("ElasticitySolver needs a vector P space")
        self.V = V
        self.pi_1 = pi_1
        self.device = dev = resolve_device(device, "ElasticitySolver")
        msh = V.mesh
        qdeg = quadrature_degree or 2 * V.degree
        pts, w = gauss_triangle(qdeg)
        geo = mesh_geometry(msh, dev)
        tabg = tabulation(V, pts, dev, "grad")
        wt = torch.as_tensor(w, device=dev)
        self.Ae, _ = _eps_matrices(geo["K"], tabg, wt, geo["detJ"].abs(),
                                   pi_1)
        self.cell_dofs = _ia_dofs(V, dev)
        self._flat_dofs = self.cell_dofs.reshape(-1)
        self.ndofs = V.ndofs
        self._qpts, self._qw = pts, w
        self._tab = tabulation(V, pts, dev)  # (nd, nq)
        self.diag = self._scatter(torch.diagonal(self.Ae, dim1=1, dim2=2))

    def _scatter(self, ve: torch.Tensor) -> torch.Tensor:
        """Sum per-cell values (nc, 2 nd) into a dof vector."""
        return ve.new_zeros(self.ndofs).index_add_(0, self._flat_dofs,
                                                   ve.reshape(-1))

    def matvec(self, x):
        xe = x[self.cell_dofs]
        return self._scatter(torch.einsum("cij,cj->ci", self.Ae, xe))

    def load_vector(self, f_expr, tractions=None):
        """f: body force (value_size 2).  tractions: list of (facets, t)
        with t(x) -> (..., 2) the boundary traction sigma.n, a host
        callable at physical points."""
        msh, dev = self.V.mesh, self.device
        f = as_expr(f_expr, msh)
        vals = f.evaluate(self._qpts).to(dev)  # (nc, nq, 2)
        adet = mesh_geometry(msh, dev)["detJ"].abs()
        w = torch.as_tensor(self._qw, device=dev)
        # be[(i, a)] = int f_a phi_i
        be = adet[:, None, None] * torch.einsum("q,cqa,iq->cia", w, vals,
                                                self._tab)
        b = self._scatter(be.reshape(len(adet), -1))
        for facets, t in tractions or []:
            b = b + self._traction_load(facets, t)
        return b

    def _traction_load(self, facets, t_fn):
        V, msh, dev = self.V, self.V.mesh, self.device
        facets = np.asarray(facets, dtype=np.int64)
        s, w = gauss_interval(V.degree + 8)
        pts_e = facet_param_points(s)
        tabs = [tabulation(V, pts_e[e], dev) for e in range(3)]
        own = msh.facet_cells[facets, 0].astype(np.int64)
        loc = msh.facet_local[facets, 0].astype(np.int64)
        aligned = msh.edge_aligned[own, loc]
        lo = msh.points[msh.facet_vertices[facets, 0]]
        T = msh.facet_tangent[facets]
        xq = lo[:, None, :] + np.einsum("q,fa->fqa", s, T)
        tv = torch.as_tensor(np.asarray(t_fn(xq)), dtype=torch.float64,
                             device=dev)  # (nf, nq, 2)
        b = torch.zeros(self.ndofs, dtype=torch.float64, device=dev)
        wj = torch.as_tensor(w, device=dev)
        for e in range(3):
            for al in (True, False):
                m = (loc == e) & (aligned == al)
                if not m.any():
                    continue
                fsel = facets[m]
                csel = torch.as_tensor(own[m], device=dev)
                # local param runs opposite to canonical: flip the q axis
                tab = tabs[e] if al else tabs[e].flip(1)
                scale = torch.as_tensor(msh.facet_length[fsel], device=dev)
                be = scale[:, None, None] * torch.einsum(
                    "q,fqa,iq->fia", wj,
                    tv[torch.as_tensor(np.where(m)[0], device=dev)], tab)
                b.index_add_(0, self.cell_dofs[csel].reshape(-1),
                             be.reshape(-1))
        return b

    def solve(self, f_expr, dirichlet_facets, u_d, tractions=None,
              rtol=1e-12, atol=1e-14, maxiter=None,
              mg_meshes=None) -> Function:
        """CG, Jacobi-preconditioned; ``maxiter`` defaults to the
        reference's 30 (sqrt(ndofs) + 100).  ``last_iterations``,
        ``last_maxiter`` and ``last_residual`` describe the solve.

        ``mg_meshes``: a nested red-refinement hierarchy (finest = the
        solver's mesh) or a prebuilt ``GeometricMG`` of this operator
        (its pi_1 must match); a geometric V-cycle on the whole
        ``2 eps:eps + pi_1 div div`` operator then preconditions the CG,
        with mesh-independent iteration counts, and ``maxiter`` defaults
        to 200.  Needs u essential on the whole boundary."""
        V, dev = self.V, self.device
        free = np.ones(self.ndofs, dtype=bool)
        free[_boundary_dofs(V, dirichlet_facets)] = False
        free = torch.as_tensor(free, device=dev)

        ud_fun = interpolate(V, u_d, device=dev)
        x = torch.where(free, 0.0, ud_fun.x)
        b = self.load_vector(f_expr, tractions)
        r = torch.where(free, b - self.matvec(x), 0.0)
        if mg_meshes is not None:
            from ..fem.multigrid import GeometricMG, vector_eps_tensors

            _whole_boundary(V.mesh, dirichlet_facets)
            if isinstance(mg_meshes, GeometricMG):
                mg = mg_meshes
            else:
                if mg_meshes[-1] is not V.mesh:
                    raise ValueError(
                        "mg_meshes[-1] must be the solver's mesh")
                k, p1 = V.degree, self.pi_1
                mg = GeometricMG(
                    mg_meshes, k,
                    lambda m: vector_eps_tensors(m, k, div_coeff=p1),
                    block_size=2, device=dev)
            psolve = mg.apply
            if maxiter is None:
                maxiter = 200
        else:
            Minv = torch.where(self.diag > 0, 1.0 / self.diag, 1.0)

            def psolve(r):
                return Minv * r

            if maxiter is None:
                maxiter = 30 * int(np.sqrt(self.ndofs) + 100)

        z = psolve(r)
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
            z = psolve(r)
            rz_new = torch.dot(r, z)
            p = z + (rz_new / rz) * p
            rz = rz_new
            it += 1
        self.last_iterations = it
        self.last_maxiter = maxiter
        self.last_residual = float(torch.linalg.norm(r))
        return Function(V, x)


class _StressRowUP(Expr):
    """Row i of sigma(u_h, p_h) = 2 eps(u_h) + p_h I (Herrmann
    displacement-pressure formulation, reference elasticity
    demo_reconstruction.py:355-377, 436-442), optionally scaled."""

    def __init__(self, uh: Function, ph: Function, row: int, scale: float = 1.0):
        self.uh, self.ph, self.row, self.scale = uh, ph, row, scale
        self.mesh = uh.space.mesh
        self.value_size = 2
        self.device = uh.device

    def evaluate(self, q):
        g = self.uh.evaluate_grad(q)  # (nc, nq, 2, 2)
        eps = 0.5 * (g + g.transpose(-1, -2))
        p = self.ph.evaluate(q)[..., 0]
        sig_row = 2.0 * eps[..., self.row, :]
        sig_row[..., self.row] += p
        return self.scale * sig_row


def stress_row_expr_up(uh: Function, ph: Function, row: int, scale: float = 1.0):
    return _StressRowUP(uh, ph, row, scale)


class _PressureMismatch(Expr):
    """div(u_h) - p_h / pi_1: the Herrmann formulation's constitutive
    mismatch entering the guaranteed bound (reference
    demo_error_estimation.py:113-119)."""

    def __init__(self, uh: Function, ph: Function, pi_1: float):
        self.uh, self.ph, self.pi_1 = uh, ph, pi_1
        self.mesh = uh.space.mesh
        self.value_size = 1
        self.device = uh.device

    def evaluate(self, q):
        g = self.uh.evaluate_grad(q)
        divu = g[..., 0, 0] + g[..., 1, 1]
        p = self.ph.evaluate(q)[..., 0]
        return (divu - p / self.pi_1)[..., None]


def pressure_mismatch_expr(uh: Function, ph: Function, pi_1: float):
    return _PressureMismatch(uh, ph, pi_1)


class ElasticitySolverUP:
    """Herrmann displacement-pressure primal solver: Taylor-Hood
    P_{k+1}^2 x P_k with

        (2 eps(u), eps(v)) + (p, div v) = (f, v)
        (div u, q) - (1/pi_1)(p, q)     = 0

    (reference ``demo/elasticity/demo_reconstruction.py:353-377``), solved
    matrix-free with Jacobi-preconditioned MINRES (the reference uses a
    direct LU; the (1/pi_1) pressure mass block makes the system symmetric
    quasi-definite, so MINRES converges without a pressure nullspace)."""

    def __init__(self, Vu: FunctionSpace, Vp: FunctionSpace, pi_1: float,
                 quadrature_degree=None, device=None):
        """``device``: the CUDA card by default; ``"cpu"`` for the CPU."""
        if Vu.family != "P" or Vu.block_size != 2:
            raise ValueError("Vu must be a vector P space")
        if Vp.family != "P" or Vp.block_size != 1:
            raise ValueError("Vp must be a scalar P space")
        if Vu.degree != Vp.degree + 1:
            raise ValueError("Taylor-Hood pairing: deg(Vu) = deg(Vp) + 1")
        self.Vu, self.Vp, self.pi_1 = Vu, Vp, pi_1
        self.device = dev = resolve_device(device, "ElasticitySolverUP")
        msh = Vu.mesh
        qdeg = quadrature_degree or 2 * Vu.degree
        pts, w = gauss_triangle(qdeg)
        geo = mesh_geometry(msh, dev)
        adet = geo["detJ"].abs()
        wt = torch.as_tensor(w, device=dev)
        nc = msh.num_cells
        # 2 eps(u):eps(v): the displacement solver's matrix without the
        # volumetric term
        self.Ae_uu, gu = _eps_matrices(
            geo["K"], tabulation(Vu, pts, dev, "grad"), wt, adet, 0.0)
        tp = tabulation(Vp, pts, dev)  # (ndp, nq)
        ndp = Vp.element.ndofs
        # B[(j), (i,a)] = int q_j (grad u_i)_a   ((div u, q))
        self.Be = torch.einsum("q,jq,ciaq,c->cjia", wt, tp, gu, adet
                               ).reshape(nc, ndp, -1)
        self.Me_p = torch.einsum("q,iq,jq,c->cij", wt, tp, tp, adet)

        self.cdu = _ia_dofs(Vu, dev)
        self.cdp = space_tables(Vp, dev)["cell_dofs"]
        self.nu, self.np_ = Vu.ndofs, Vp.ndofs
        self._qpts, self._qw = pts, w
        self._tabu = tabulation(Vu, pts, dev)
        du = self._scatter(self.cdu, self.nu,
                           torch.diagonal(self.Ae_uu, dim1=1, dim2=2))
        dp = self._scatter(self.cdp, self.np_,
                           torch.diagonal(self.Me_p, dim1=1, dim2=2)) / pi_1
        self.diag = torch.cat([du, dp])

    @staticmethod
    def _scatter(cd, n, ve):
        return ve.new_zeros(n).index_add_(0, cd.reshape(-1), ve.reshape(-1))

    def matvec(self, x):
        xue = x[: self.nu][self.cdu]
        xpe = x[self.nu:][self.cdp]
        yu = (torch.einsum("cij,cj->ci", self.Ae_uu, xue)
              + torch.einsum("cji,cj->ci", self.Be, xpe))
        yp = (torch.einsum("cij,cj->ci", self.Be, xue)
              - (1.0 / self.pi_1) * torch.einsum("cij,cj->ci", self.Me_p,
                                                 xpe))
        return torch.cat([self._scatter(self.cdu, self.nu, yu),
                          self._scatter(self.cdp, self.np_, yp)])

    def load_vector(self, f_expr):
        msh, dev = self.Vu.mesh, self.device
        f = as_expr(f_expr, msh)
        vals = f.evaluate(self._qpts).to(dev)  # (nc, nq, 2)
        adet = mesh_geometry(msh, dev)["detJ"].abs()
        w = torch.as_tensor(self._qw, device=dev)
        be = adet[:, None, None] * torch.einsum("q,cqa,iq->cia", w, vals,
                                                self._tabu)
        bu = self._scatter(self.cdu, self.nu, be.reshape(len(adet), -1))
        return torch.cat([bu, bu.new_zeros(self.np_)])

    def solve(self, f_expr, dirichlet_facets, u_d, rtol=1e-12, atol=1e-14,
              maxiter=None, mg_meshes=None):
        """Returns (uh, ph).  MINRES, Jacobi-preconditioned on both blocks;
        ``maxiter`` defaults to the reference's 60 (sqrt(ndofs) + 100).
        ``last_iterations``, ``last_maxiter`` and ``last_residual`` (the
        preconditioned residual estimate) describe the solve.

        ``mg_meshes``: a nested red-refinement hierarchy (finest = the
        solver's mesh); a geometric V-cycle then preconditions the
        displacement block and the pressure keeps its inverse mass
        diagonal, the norm-equivalent Herrmann preconditioner
        diag(A_uu, M_p / pi_1), and ``maxiter`` defaults to 400.  Needs u
        essential on the whole boundary."""
        dev = self.device
        free = np.ones(self.nu + self.np_, dtype=bool)
        free[_boundary_dofs(self.Vu, dirichlet_facets)] = False
        free = torch.as_tensor(free, device=dev)

        ud_fun = interpolate(self.Vu, u_d, device=dev)
        x0 = torch.where(free, 0.0, torch.cat([
            ud_fun.x, ud_fun.x.new_zeros(self.np_)]))
        b = self.load_vector(f_expr)
        diag_inv = torch.where(self.diag.abs() > 0, 1.0 / self.diag.abs(),
                               1.0)
        if mg_meshes is not None:
            from ..fem.multigrid import GeometricMG, vector_eps_tensors

            if mg_meshes[-1] is not self.Vu.mesh:
                raise ValueError("mg_meshes[-1] must be the solver's mesh")
            _whole_boundary(self.Vu.mesh, dirichlet_facets)
            ku, nu = self.Vu.degree, self.nu
            mg_u = GeometricMG(mg_meshes, ku,
                               lambda m: vector_eps_tensors(m, ku),
                               block_size=2, device=dev)
            dp_inv = diag_inv[nu:]

            def Minv(r, ops=None):
                return torch.cat([mg_u.apply(r[:nu]), dp_inv * r[nu:]])

            if maxiter is None:
                maxiter = 400
        else:
            Minv = diag_inv
            if maxiter is None:
                maxiter = 60 * int(np.sqrt(self.nu + self.np_) + 100)
        st = minres(self.matvec, b, x0, Minv, free, rtol=rtol, atol=atol,
                    maxiter=maxiter)
        self.last_iterations = st["it"]
        self.last_maxiter = maxiter
        self.last_residual = float(st["phibar"])
        x = st["x"]
        return (Function(self.Vu, x[: self.nu]),
                Function(self.Vp, x[self.nu:]))
