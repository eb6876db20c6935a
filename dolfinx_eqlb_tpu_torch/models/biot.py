"""Primal Biot poro-elasticity solver (3-field u-p-pt formulation).

Port of the JAX package's ``models/biot.py`` (reference workload
``python/test/performance/perftest_basics.py:294-382``, testcase
``Biot_upp``): displacement u in (CG_k)^2, pore pressure p in CG_k, total
pressure pt in CG_{k-1}, coupled by

    (2 eps(u) - pt I, eps(v_u))                  = (f, v_u)
    (div u + pt - p, v_pt)                       = 0
    ((p - pt), v_p) + (grad p, grad v_p)         = (g, v_p)

with u and p essential on the whole boundary.  Negating the p- and
pt-equations makes the block system symmetric:

    [ A_uu      0            -B^T    ] [u ]   [  f ]
    [ 0        -(K_p + M_p)  +M_ppt  ] [p ] = [ -g ]
    [ -B       +M_ppt^T      -M_pt   ] [pt]   [  0 ]

a symmetric indefinite system solved matrix-free by MINRES
(``fem.krylov.minres``), preconditioned by Jacobi or by the block
multigrid ``BiotMG`` (the reference solves it directly, MUMPS / LU).  Each
cell's element matrices are formed once on the device; the operator
action is a gather, batched products and an ``index_add_`` per field.

The three physical fields fed to the equilibrator (reference
``perftest_basics.py:362-373``) are

    rows 0/1:  sigma_h = -2 eps(u_h) + (pt_h - p_h) I   (total stress,
               negated), with divergence data (f - grad p_h)_i
    row 2:     -grad p_h (Darcy flux), with divergence data
               g + pt_h - p_h

so one ``FluxEqlbSE(..., equilibrate_stress=True)`` call equilibrates the
coupled problem's stress rows (weakly symmetric) and flow flux together.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..elements.quadrature import gauss_triangle
from ..fem.expressions import Expr, as_expr, expr_from_callable
from ..fem.krylov import minres
from ..fem.projection import local_projection
from ..fem.spaces import (
    Function, FunctionSpace, mesh_geometry, mesh_space, resolve_device,
    space_tables, tabulation,
)
from .elasticity import _boundary_dofs, _eps_matrices, _ia_dofs
from .poisson import locate_dofs_on_facets

__all__ = ["BiotSolverUPP", "BiotMG", "biot_stress_row_expr",
           "darcy_flux_expr", "biot_flow_rhs_expr", "biot_fields",
           "biot_bench_fields"]


def _mv(A, x):
    """Per-cell A x: (nc, m, n), (nc, n) -> (nc, m), as a broadcast
    product and a sum (faster than a batched GEMV at these sizes)."""
    return (A * x[:, None, :]).sum(-1)


def _mvT(A, x):
    """Per-cell A^T x: (nc, m, n), (nc, m) -> (nc, n)."""
    return (A * x[:, :, None]).sum(1)


def _scatter(cd, n, ve):
    return ve.new_zeros(n).index_add_(0, cd.reshape(-1), ve.reshape(-1))


class BiotMG:
    """Block-diagonal geometric-multigrid preconditioner of the symmetric
    u-p-pt system, the norm-equivalent block operator

        P = diag( A_uu,  K_p + M_p,  M_pt )

    with V-cycles (``fem.multigrid.GeometricMG``) on the two elliptic
    blocks and the inverse absolute diagonal on pt; MINRES then needs a
    mesh-independent number of iterations, where Jacobi's grows like 1/h.

    ``meshes``: a nested red-refinement hierarchy (``fem.multigrid.
    mesh_hierarchy``), coarse to fine, whose finest mesh IS the solver's
    mesh.  Assumes u and p essential on the whole boundary (the reference
    testcase's layout), so that every level masks its own boundary.  The
    tables live on the solver's device in its dtype.
    """

    def __init__(self, solver: "BiotSolverUPP", meshes, smooth_degree=3,
                 eig_ratio=8.0):
        from ..fem.multigrid import (GeometricMG, scalar_stiffness_tensors,
                                     vector_eps_tensors)

        if meshes[-1] is not solver.Vu.mesh:
            raise ValueError("meshes[-1] must be the solver's mesh")
        ku = solver.Vu.degree
        kw = dict(smooth_degree=smooth_degree, eig_ratio=eig_ratio,
                  dtype=solver.dtype, device=solver.device)
        self.nu, self.np_ = solver.nu, solver.np_
        self.mg_u = GeometricMG(
            meshes, ku, lambda m: vector_eps_tensors(m, ku), block_size=2,
            **kw)
        self.mg_p = GeometricMG(
            meshes, ku, lambda m: scalar_stiffness_tensors(m, ku,
                                                           mass_coeff=1.0),
            **kw)
        dpt = solver.diag[solver.nu + solver.np_:]
        self.dpt_inv = torch.where(dpt.abs() > 0, 1.0 / dpt.abs(), 1.0)

    def operands(self):
        """The device tables of both V-cycles and the pt diagonal."""
        return dict(mg_u=self.mg_u.operands(), mg_p=self.mg_p.operands(),
                    dpt_inv=self.dpt_inv)

    def psolve(self, r, ops=None):
        """The block preconditioner applied to ``r``; ``ops`` defaults to
        ``self.operands()``."""
        ops = self.operands() if ops is None else ops
        nu, np_ = self.nu, self.np_
        return torch.cat([
            self.mg_u.apply(r[:nu], ops["mg_u"]),
            self.mg_p.apply(r[nu: nu + np_], ops["mg_p"]),
            ops["dpt_inv"] * r[nu + np_:],
        ])


class BiotSolverUPP:
    """Monolithic u-p-pt solver; ``solve`` returns (uh, ph, pth)."""

    def __init__(self, Vu: FunctionSpace, Vp: FunctionSpace,
                 Vpt: FunctionSpace, quadrature_degree=None,
                 dtype=torch.float64, device=None):
        """``dtype``: precision of the operator tensors and the Krylov loop
        (f64 by default; the bench passes f32 and a matching rtol).
        ``device``: the CUDA card by default; ``"cpu"`` for the CPU."""
        if not (Vu.family == "P" and Vu.block_size == 2):
            raise ValueError("Vu must be a vector P space")
        if not (Vp.family == "P" and Vp.block_size == 1
                and Vpt.family == "P" and Vpt.block_size == 1):
            raise ValueError("Vp and Vpt must be scalar P spaces")
        if Vu.degree != Vp.degree or Vpt.degree != Vu.degree - 1:
            raise ValueError(
                "reference pairing: u, p in CG_k; pt in CG_{k-1}")
        self.Vu, self.Vp, self.Vpt = Vu, Vp, Vpt
        self.dtype = dt = dtype
        self.device = dev = resolve_device(device, "BiotSolverUPP")
        msh = Vu.mesh
        ku = Vu.degree
        pts, w = gauss_triangle(quadrature_degree or 2 * ku)
        geo = mesh_geometry(msh, dev)
        adet = geo["detJ"].abs()
        wt = torch.as_tensor(w, device=dev)
        nc = msh.num_cells

        # 2 eps(u):eps(v), (i, a)-flattened; gu the physical gradients
        Auu, gu = _eps_matrices(geo["K"], tabulation(Vu, pts, dev, "grad"),
                                wt, adet, 0.0)
        self.Ae_uu = Auu.to(dt)
        tp = tabulation(Vp, pts, dev)  # (ndp, nq)
        gp = torch.einsum("cba,ibq->ciaq", geo["K"],
                          tabulation(Vp, pts, dev, "grad"))
        tpt = tabulation(Vpt, pts, dev)  # (ndpt, nq)
        ndpt = Vpt.element.ndofs

        # B[(j_pt), (i, a)] = int pt_j (grad u_i)_a    ((div u, v_pt))
        self.Be = torch.einsum("q,jq,ciaq,c->cjia", wt, tpt, gu, adet
                               ).reshape(nc, ndpt, -1).to(dt)
        self.Me_pt = torch.einsum("q,iq,jq,c->cij", wt, tpt, tpt, adet).to(dt)
        self.Me_ppt = torch.einsum("q,iq,jq,c->cij", wt, tp, tpt,
                                   adet).to(dt)  # (nc, ndp, ndpt)
        Kp = torch.einsum("q,ciaq,cjaq,c->cij", wt, gp, gp, adet)
        Mp = torch.einsum("q,iq,jq,c->cij", wt, tp, tp, adet)
        self.Ke_p = (Kp + Mp).to(dt)  # K_p + M_p act together

        self.cdu = _ia_dofs(Vu, dev)
        self.cdp = space_tables(Vp, dev)["cell_dofs"]
        self.cdpt = space_tables(Vpt, dev)["cell_dofs"]
        self.nu, self.np_, self.npt = Vu.ndofs, Vp.ndofs, Vpt.ndofs
        self._qpts, self._qw = pts, w
        self._tabu = tabulation(Vu, pts, dev)
        self._tabp = tp

        def diag(cd, n, A):
            return _scatter(cd, n, torch.diagonal(A, dim1=1, dim2=2))

        self.diag = torch.cat([diag(self.cdu, self.nu, self.Ae_uu),
                               diag(self.cdp, self.np_, self.Ke_p),
                               diag(self.cdpt, self.npt, self.Me_pt)])

    def _operands(self):
        """The operator's device tensors (the reference threads them into
        its jitted Krylov loop; kept for API parity)."""
        return dict(Ae_uu=self.Ae_uu, Be=self.Be, Me_pt=self.Me_pt,
                    Me_ppt=self.Me_ppt, Ke_p=self.Ke_p, cdu=self.cdu,
                    cdp=self.cdp, cdpt=self.cdpt)

    def matvec(self, x, ops=None):
        o = self._operands() if ops is None else ops
        nu, np_ = self.nu, self.np_
        xue = x[:nu][o["cdu"]]
        xpe = x[nu: nu + np_][o["cdp"]]
        xpte = x[nu + np_:][o["cdpt"]]
        yu = _mv(o["Ae_uu"], xue) - _mvT(o["Be"], xpte)
        yp = _mv(o["Me_ppt"], xpte) - _mv(o["Ke_p"], xpe)
        ypt = (_mvT(o["Me_ppt"], xpe) - _mv(o["Be"], xue)
               - _mv(o["Me_pt"], xpte))
        return torch.cat([_scatter(o["cdu"], self.nu, yu),
                          _scatter(o["cdp"], self.np_, yp),
                          _scatter(o["cdpt"], self.npt, ypt)])

    def load_vector(self, f_expr, g_expr):
        """rhs = [ (f, v_u), -(g, v_p), 0 ] (the p- and pt-rows negated to
        keep the block system symmetric), quadrature in f64."""
        msh, dev, dt = self.Vu.mesh, self.device, self.dtype
        fv = as_expr(f_expr, msh).evaluate(self._qpts).to(
            dev, torch.float64)  # (nc, nq, 2)
        gv = as_expr(g_expr, msh).evaluate(self._qpts)[..., 0].to(
            dev, torch.float64)  # (nc, nq)
        adet = mesh_geometry(msh, dev)["detJ"].abs()
        wj = torch.as_tensor(self._qw, device=dev)
        be = adet[:, None, None] * torch.einsum("q,cqa,iq->cia", wj, fv,
                                                self._tabu)
        bu = _scatter(self.cdu, self.nu, be.reshape(len(adet), -1).to(dt))
        bpe = adet[:, None] * torch.einsum("q,cq,iq->ci", wj, gv, self._tabp)
        bp = _scatter(self.cdp, self.np_, bpe.to(dt))
        return torch.cat([bu, -bp, bu.new_zeros(self.npt)])

    def solve(self, f_expr, g_expr, dirichlet_facets, rtol=1e-12, atol=1e-14,
              maxiter=None, chunk=None, mg=None):
        """Homogeneous essential data u = 0, p = 0 on ``dirichlet_facets``
        (the reference testcase uses zero functions); pt is unconstrained.
        Returns (uh, ph, pth); ``last_iterations``, ``last_maxiter`` and
        ``last_residual`` (the preconditioned residual estimate) describe
        the solve.

        ``mg``: an optional :class:`BiotMG` (or a nested mesh hierarchy to
        build one from): block-multigrid preconditioning with
        mesh-independent iteration counts and ``maxiter`` 400 by default;
        needs ``dirichlet_facets`` to be the whole boundary.  Default:
        Jacobi, ``maxiter`` 90 (sqrt(ndofs) + 100).  ``chunk`` is accepted
        for parity with the reference and ignored (``fem.krylov.minres``)."""
        Vu, Vp, dev = self.Vu, self.Vp, self.device
        free = np.ones(self.nu + self.np_ + self.npt, dtype=bool)
        free[_boundary_dofs(Vu, dirichlet_facets)] = False
        free[self.nu + locate_dofs_on_facets(Vp, dirichlet_facets)] = False
        free = torch.as_tensor(free, device=dev)

        x0 = torch.zeros(self.nu + self.np_ + self.npt, dtype=self.dtype,
                         device=dev)
        b = self.load_vector(f_expr, g_expr)
        if mg is not None:
            if not isinstance(mg, BiotMG):
                mg = BiotMG(self, mg)
            if len(np.setdiff1d(Vu.mesh.boundary_facets,
                                np.asarray(dirichlet_facets))):
                raise ValueError(
                    "BiotMG assumes u/p essential on the whole boundary")
            Minv = mg.psolve
            if maxiter is None:
                maxiter = 400  # mesh-independent with the block V-cycle
        else:
            Minv = torch.where(self.diag.abs() > 0, 1.0 / self.diag.abs(),
                               1.0)
            if maxiter is None:
                maxiter = 90 * int(
                    np.sqrt(self.nu + self.np_ + self.npt) + 100)
        st = minres(self.matvec, b, x0, Minv, free, rtol=rtol, atol=atol,
                    maxiter=maxiter, chunk=chunk)
        self.last_iterations = st["it"]
        self.last_maxiter = maxiter
        self.last_residual = float(st["phibar"])
        x = st["x"]
        return (Function(Vu, x[: self.nu]),
                Function(Vp, x[self.nu: self.nu + self.np_]),
                Function(self.Vpt, x[self.nu + self.np_:]))


class _BiotStressRow(Expr):
    """Row i of sigma_h = -2 eps(u_h) + (pt_h - p_h) I (the negated total
    stress, reference ``perftest_basics.py:362``)."""

    def __init__(self, uh: Function, ph: Function, pth: Function, row: int):
        self.uh, self.ph, self.pth, self.row = uh, ph, pth, row
        self.mesh = uh.space.mesh
        self.value_size = 2
        self.device = uh.device

    def evaluate(self, q):
        g = self.uh.evaluate_grad(q)  # (nc, nq, 2, 2)
        eps = 0.5 * (g + g.transpose(-1, -2))
        p = self.ph.evaluate(q)[..., 0]
        pt = self.pth.evaluate(q)[..., 0]
        sig_row = -2.0 * eps[..., self.row, :]
        sig_row[..., self.row] += pt - p
        return sig_row


def biot_stress_row_expr(uh, ph, pth, row: int) -> Expr:
    return _BiotStressRow(uh, ph, pth, row)


class _DarcyFlux(Expr):
    """-grad p_h (unit mobility, reference ``perftest_basics.py:372``)."""

    def __init__(self, ph: Function):
        self.ph = ph
        self.mesh = ph.space.mesh
        self.value_size = 2
        self.device = ph.device

    def evaluate(self, q):
        return -self.ph.evaluate_grad(q)[..., 0, :]


def darcy_flux_expr(ph) -> Expr:
    return _DarcyFlux(ph)


class _FlowRHS(Expr):
    """g + pt_h - p_h: the divergence of the Darcy flux (mass balance,
    reference ``perftest_basics.py:368``)."""

    def __init__(self, g_expr, ph: Function, pth: Function):
        self.g = as_expr(g_expr, ph.space.mesh)
        self.ph, self.pth = ph, pth
        self.mesh = ph.space.mesh
        self.value_size = 1
        self.device = ph.device

    def evaluate(self, q):
        return (
            self.g.evaluate(q)[..., 0].to(self.device)
            + self.pth.evaluate(q)[..., 0]
            - self.ph.evaluate(q)[..., 0]
        )[..., None]


def biot_flow_rhs_expr(g_expr, ph, pth) -> Expr:
    return _FlowRHS(g_expr, ph, pth)


class _MomentumRHSRow(Expr):
    """(f - grad p_h)_i: divergence data of stress row i (reference
    ``perftest_basics.py:367``)."""

    def __init__(self, f_expr, ph: Function, row: int):
        self.f = as_expr(f_expr, ph.space.mesh)
        self.ph, self.row = ph, row
        self.mesh = ph.space.mesh
        self.value_size = 1
        self.device = ph.device

    def evaluate(self, q):
        fv = self.f.evaluate(q)[..., self.row].to(self.device)
        gp = self.ph.evaluate_grad(q)[..., 0, self.row]
        return (fv - gp)[..., None]


def biot_fields(uh, ph, pth, f_expr, g_expr, degree_eqlb: int):
    """(list_proj_flux, list_rhs): DG_{k-1} projections of the three
    physical fields and their divergence data, on the device of ``uh``,
    ready for ``FluxEqlbSE(degree_eqlb, msh, list_rhs, list_proj_flux,
    equilibrate_stress=True)``."""
    msh = uh.space.mesh
    k = degree_eqlb
    dev = uh.device
    flux_exprs = [
        biot_stress_row_expr(uh, ph, pth, 0),
        biot_stress_row_expr(uh, ph, pth, 1),
        darcy_flux_expr(ph),
    ]
    rhs_exprs = [
        _MomentumRHSRow(f_expr, ph, 0),
        _MomentumRHSRow(f_expr, ph, 1),
        biot_flow_rhs_expr(g_expr, ph, pth),
    ]
    return (local_projection(mesh_space(msh, "DG", k - 1, vs=2), flux_exprs,
                             device=dev),
            local_projection(mesh_space(msh, "DG", k - 1), rhs_exprs,
                             device=dev))


def _bench_f(x):
    return np.stack([
        0.7 * np.sin(1.5 * np.pi * x[..., 0])
        * 1.5 * np.cos(0.7 * np.pi * x[..., 1]),
        0.7 * np.cos(1.5 * np.pi * x[..., 0])
        * 1.5 * np.sin(0.7 * np.pi * x[..., 1]),
    ], axis=-1)


def _bench_g(x):
    return (1.5 * np.sin(0.7 * np.pi * x[..., 0])
            * 1.5 * np.sin(0.7 * np.pi * x[..., 1]))[..., None]


def biot_bench_fields(msh, k: int, rtol=1e-10, maxiter=20000,
                      dtype=torch.float64, chunk=500, mg_meshes=None,
                      device=None, info: dict | None = None):
    """Bench-grade data for the multi-field configuration: solve the Biot
    primal problem on ``msh`` (the reference's RHS family) and return the
    dof tensors (d_proj (3, nc, 2, ndg), d_rhs (3, nc, ndg)), f64 on the
    solver's device, for ``EqlbEngine.equilibrate``.

    f and g are projected into DG_{k-1} before the solve (at quadrature
    degree 2k + 6): the equilibration's patch-ring compatibility then
    follows exactly from Galerkin orthogonality.  ``dtype`` is the solve's
    precision; the fields are evaluated from its dofs in f64.  Everything
    stays on ``device`` (the CUDA card by default).  ``mg_meshes``: a
    nested hierarchy whose finest mesh is ``msh``, for ``BiotMG``.
    ``info``: a dict, filled with the solver, the ``BiotMG``, the projected
    data ``(fe, ge)`` and the seconds of each stage."""
    info = {} if info is None else info
    stage_s = info.setdefault("stages_s", {})
    dev = resolve_device(device, "biot_bench_fields")

    def timed(name, fn):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stage_s[name] = time.perf_counter() - t0
        return out

    Vu = FunctionSpace(msh, "P", k, vs=2)
    Vp = FunctionSpace(msh, "P", k)
    Vpt = FunctionSpace(msh, "P", k - 1)
    solver = timed("solver_setup", lambda: BiotSolverUPP(
        Vu, Vp, Vpt, dtype=dtype, device=dev))
    Vdg2 = mesh_space(msh, "DG", k - 1, vs=2)
    Vdg1 = mesh_space(msh, "DG", k - 1)
    fe, ge = timed("project_data", lambda: (
        local_projection(Vdg2, [expr_from_callable(_bench_f, msh, 2)],
                         quadrature_degree=2 * k + 6, device=dev)[0],
        local_projection(Vdg1, [expr_from_callable(_bench_g, msh, 1)],
                         quadrature_degree=2 * k + 6, device=dev)[0]))
    mg = None
    if mg_meshes is not None:
        mg = timed("mg_setup", lambda: BiotMG(solver, mg_meshes))
    uh, ph, pth = timed("solve", lambda: solver.solve(
        fe, ge, msh.boundary_facets, rtol=rtol, maxiter=maxiter, chunk=chunk,
        mg=mg))
    info.update(solver=solver, mg=mg, data=(fe, ge))

    def f64(f):
        return Function(f.space, f.x.to(torch.float64))

    proj_flux, rhs = timed("biot_fields", lambda: biot_fields(
        f64(uh), f64(ph), f64(pth), fe, ge, k))
    ndg = k * (k + 1) // 2
    nc = msh.num_cells
    d_proj = torch.stack([f.x.reshape(2, nc, -1).permute(1, 0, 2)
                          for f in proj_flux])
    d_rhs = torch.stack([f.x.reshape(nc, -1) for f in rhs])
    if d_proj.shape[-1] < ndg:
        pad = ndg - d_proj.shape[-1]
        d_proj = torch.nn.functional.pad(d_proj, (0, pad))
        d_rhs = torch.nn.functional.pad(d_rhs, (0, ndg - d_rhs.shape[-1]))
    return d_proj, d_rhs
