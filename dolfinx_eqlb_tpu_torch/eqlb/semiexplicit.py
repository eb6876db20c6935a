"""Semi-explicit patch equilibration: explicit step + reduced H(div=0) solve.

Port of ``dolfinx_eqlb_tpu/eqlb/semiexplicit.py``; see its docstring for the
method.  In short, the divergence constraints of a patch problem are solved
explicitly (step 1: divergence cell dofs, then the spoke constant moments
from a closed-form ring recursion), and the remaining minimisation runs over
an explicit divergence-free basis Z:

    col 0           = the d0 "ring" mode (weights = cumalpha)
    per spoke j     = the k-1 hierarchic higher moments (unit cols)
    per cell i      = the (k-1)(k-2)/2 interior dofs  (unit cols)

an SPD system of dimension Dz = 1 + ns(k-1) + n(k-1)(k-2)/2 whose matrix
A_z = Z^T M Z is geometry-only.

The host parts (``_div_structure`` to ``se_host_tables``) are NumPy, copied
unchanged.  The device parts are eager PyTorch on the same batch-last layout
as the reference — tensors are (small dims..., P) with the patch batch last,
and multi-RHS data is FOLDED into that axis (X = n_rhs * P, RHS-major,
x = r * P + p) so the masked boundary systems of every RHS form one batch.
The reference's unrolled broadcast-FMA loops, which dodged TPU tile padding,
are plain ``torch.einsum`` contractions here; every index below is static
per bucket.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..utils.profiling import annotate, span

__all__ = [
    "se_static",
    "se_host_tables",
    "combo_tensors",
    "reduced_basis",
    "solve_bucket_semiexplicit",
]


@lru_cache(maxsize=None)
def _div_structure(k: int):
    """(S (3,), divdiag (ndiv,)): the nonzero divergence moments of the
    hierarchic RT_k basis (see module docstring; asserted dense in tests)."""
    from ..elements.lagrange import dubiner_cached
    from ..elements.quadrature import gauss_triangle
    from ..elements.rt import rt_cached

    rt = rt_cached(k)
    dub = dubiner_cached(k - 1)
    pts, w = gauss_triangle(2 * k + 2)
    Dhat = np.einsum("x,ix,px->ip", w, rt.tabulate_div(pts), dub.tabulate(pts))
    S = Dhat[[0, k, 2 * k], 0].copy()
    ndiv = rt.ndofs_cell_div
    divdiag = np.array([Dhat[3 * k + t, 1 + t] for t in range(ndiv)])
    return S, divdiag


def _perm_q(q: int, k: int):
    """Canonical-order dof permutation of combo q = 2*lnode + orient:
    orient 0 = entry edge is (lnode+1)%3."""
    ln, o = q // 2, q % 2
    e1 = (ln + 1) % 3 if o == 0 else (ln + 2) % 3
    e2 = (ln + 2) % 3 if o == 0 else (ln + 1) % 3
    return ln, np.concatenate(
        [e1 * k + np.arange(k), e2 * k + np.arange(k),
         3 * k + np.arange(k * (k - 1))]
    )


@lru_cache(maxsize=None)
def combo_tensors(k: int):
    """Reference tensors pre-permuted for each of the 6 (lnode, orientation)
    combos — replaces all data-dependent dof-permutation gathers with a
    one-hot contraction."""
    from .engine import reference_tensors, _HAT_GRADS

    ref = reference_tensors(k)
    nkeep = 2 * k + k * (k - 1)
    ndg = k * (k + 1) // 2
    MhatC = np.zeros((6, 2, 2, nkeep, nkeep))
    DhatC = np.zeros((6, nkeep, ndg))
    RhatC = np.zeros((6, ndg, 2, nkeep))
    T3C = np.zeros((6, ndg, ndg))
    hatgC = np.zeros((6, 2))
    for q in range(6):
        ln, pq = _perm_q(q, k)
        MhatC[q] = ref["Mhat"][:, :, pq][:, :, :, pq]
        DhatC[q] = ref["Dhat"][pq]
        RhatC[q] = ref["Rhat"][ln][:, :, pq]
        T3C[q] = ref["T3"][ln]
        hatgC[q] = _HAT_GRADS[ln]
    return dict(MhatC=MhatC, DhatC=DhatC, RhatC=RhatC, T3C=T3C, hatgC=hatgC)


def se_static(bucket, k: int):
    """Static (bucket-shape-only) index maps of the reduced basis.

    Column layout of Z: [d0 | spoke 0 moments 1..k-1 | ... | spoke ns-1 |
    cell 0 interior dofs | ... | cell n-1].
    """
    n, ns = bucket.ncells, bucket.nspokes
    kk1 = k * (k - 1)
    ndiv = k * (k + 1) // 2 - 1
    nint = (k - 1) * (k - 2) // 2
    Dz = 1 + ns * (k - 1) + n * nint

    # canonical slots of cell i that map to unit columns
    uslots = np.concatenate(
        [
            np.arange(1, k),  # entry spoke higher moments
            k + np.arange(1, k),  # exit spoke higher moments
            2 * k + ndiv + np.arange(nint),  # interior cell dofs
        ]
    ).astype(np.int64)

    exit_idx = np.array(
        [(i + 1) % ns if not bucket.is_boundary else i + 1 for i in range(n)],
        dtype=np.int64,
    )
    ucols = np.empty((n, len(uslots)), dtype=np.int64)
    for i in range(n):
        ucols[i] = np.concatenate(
            [
                1 + i * (k - 1) + np.arange(k - 1),
                1 + exit_idx[i] * (k - 1) + np.arange(k - 1),
                1 + ns * (k - 1) + i * nint + np.arange(nint),
            ]
        )

    # patch-dof position of every unit column (cols 1..Dz-1 in order)
    sel = np.concatenate(
        [
            (np.arange(ns)[:, None] * k + np.arange(1, k)[None, :]).reshape(-1),
            (
                ns * k
                + np.arange(n)[:, None] * kk1
                + ndiv
                + np.arange(nint)[None, :]
            ).reshape(-1),
        ]
    ).astype(np.int64)
    assert len(sel) == Dz - 1

    return dict(
        Dz=Dz, uslots=uslots, ucols=ucols, sel=sel, exit_idx=exit_idx,
        ndiv=ndiv, nint=nint,
    )


def se_host_tables(bucket, tables, mesh, k: int):
    """Geometry-dependent host tables of the explicit step.

    The ring recursion sigma0_{j+1} = alpha_j sigma0_j + beta_j Fq0_j has the
    closed form (alpha, beta = +-1, +-1/sqrt2 sign products)

        sigma0_j = cumalpha_j * (s0 + sum_{i<j} gamma_i Fq0_i),
        cumalpha_j = prod_{l<j} alpha_l,   gamma_i = beta_i / cumalpha_{i+1}

    so the device computes it with one cumulative sum.  cumalpha is
    simultaneously the d0 ring-mode weight vector (the homogeneous solution).
    """
    S, divdiag = _div_structure(k)
    n, ns = bucket.ncells, bucket.nspokes
    P = len(tables["signs"])
    sdet = np.sign(mesh.detJ[bucket.cells.astype(np.int64)])  # (P, n)
    signs = tables["signs"]
    b_en = sdet * S[bucket.entry_loc.astype(np.int64)] * signs[:, :, 0]
    b_ex = sdet * S[bucket.exit_loc.astype(np.int64)] * signs[:, :, k]
    alpha = -b_en / b_ex  # (P, n)
    beta = 1.0 / b_ex

    cum = np.ones((P, ns))
    for j in range(1, ns):
        cum[:, j] = cum[:, j - 1] * alpha[:, j - 1]
    if not bucket.is_boundary:
        closure = cum[:, -1] * alpha[:, -1]
        if not np.allclose(closure, 1.0, atol=1e-12):
            raise RuntimeError("interior patch d0 ring mode does not close")
    # gamma_i = beta_i / cumalpha_{i+1}; interior patches have ns == n and
    # cumalpha_n == closure == 1
    cum_next = (
        cum[:, 1:] if bucket.is_boundary
        else np.concatenate([cum[:, 1:], np.ones((P, 1))], axis=1)
    )
    gamma = beta / cum_next[:, :n]

    # combo id of every patch cell: 2*lnode + orientation
    lnode = bucket.lnode.astype(np.int64)
    combo = 2 * lnode + (bucket.entry_loc.astype(np.int64) != (lnode + 1) % 3)
    return dict(
        cumalpha=cum, gamma=gamma, divdiag=divdiag,
        combo=combo.astype(np.int8),
    )


# ---------------------------------------------------------------------------
# device-side solve (batch-last)
# ---------------------------------------------------------------------------


def reduced_basis(se: dict, ncells: int, k: int) -> np.ndarray:
    """Static unit-column part of Z, per cell: E (n, nkeep, Dz) with
    E[i, uslots[a], ucols[i, a]] = 1.  Column 0 (the d0 ring mode) carries
    patch-dependent weights and is handled apart."""
    nkeep = 2 * k + k * (k - 1)
    E = np.zeros((ncells, nkeep, se["Dz"]))
    for i in range(ncells):
        E[i, se["uslots"], se["ucols"][i]] = 1.0
    return E


def _bx(a: torch.Tensor, n_rhs: int) -> torch.Tensor:
    """Broadcast a geometry tensor (..., P) along the folded RHS axis ->
    (..., n_rhs * P), RHS-major (a copy when n_rhs > 1)."""
    if n_rhs == 1:
        return a
    P = a.shape[-1]
    return a.unsqueeze(-2).expand(*a.shape[:-1], n_rhs, P).reshape(
        *a.shape[:-1], n_rhs * P)


def _onehot(combo: torch.Tensor, dtype) -> torch.Tensor:
    """combo (n, X) ids in [0, 6) -> one-hot weights (n, 6, X)."""
    q = torch.arange(6, device=combo.device).view(1, 6, 1)
    return (combo.unsqueeze(1) == q).to(dtype)


def mass_matrices_bl(dv, refd):
    """Geometry-only canonical element mass matrices, batch-last:
    Mc (n, nkeep, nkeep, P).  Call-invariant: the engine caches them."""
    J = dv["J_bl"]  # (n, 2, 2, P)
    adet = dv["detJ_bl"].abs()  # (n, P)
    signs = dv["signs_bl"]  # (n, nkeep, P)
    JtJ = torch.einsum("ckap,ckbp->cabp", J, J)
    W = _onehot(dv["combo_bl"], J.dtype)  # (n, 6, P)
    Mc = torch.einsum("cabp,cqp,qabij->cijp", JtJ, W, refd["MhatC"])
    Mc = Mc / adet[:, None, None]
    return Mc * signs[:, :, None] * signs[:, None, :]


def load_moments_bl(dprT, dv, refd):
    """Data-dependent canonical load moments on the folded lane axis:
    Fv (n, nkeep, X), Fq (n, ndg, X) with X = n_rhs * P.

    dprT (n_rhs, 3, ndg, nc) packs [sigma_proj rows 0/1 | rhs] so one
    index_select over the patch cells fetches all per-cell data."""
    n_rhs, _, ndg, nc = dprT.shape
    cb = dv["cells_bl"]  # (n, P)
    n, P = cb.shape
    dt = dprT.dtype
    J = _bx(dv["J_bl"], n_rhs)  # (n, 2, 2, X)
    K = _bx(dv["K_bl"], n_rhs)
    signs = _bx(dv["signs_bl"], n_rhs)  # (n, nkeep, X)
    detJ = _bx(dv["detJ_bl"], n_rhs)  # (n, X)
    W = _onehot(_bx(dv["combo_bl"], n_rhs), dt)  # (n, 6, X)

    g = dprT.reshape(n_rhs * 3 * ndg, nc).index_select(1, cb.reshape(-1))
    g = g.reshape(n_rhs, 3, ndg, n, P).permute(1, 2, 3, 0, 4).reshape(
        3, ndg, n, n_rhs * P)
    dpg = g[:2]  # (2, ndg, n, X)
    frg = g[2]  # (ndg, n, X)

    dpJ = torch.einsum("amcx,cabx->bmcx", dpg, J)
    Fv = torch.einsum("bmcx,cqx,qmbi->cix", dpJ, W, refd["RhatC"])
    Fq = torch.einsum("mcx,cqx,qmp->cpx", frg, W, refd["T3C"])
    # grad(psi_z)_a = sum_b K[b, a] ghat_b, with ghat picked by the combo
    gpsi = torch.einsum("cbax,cqx,qb->cax", K, W, refd["hatgC"])
    Fv = Fv * torch.sign(detJ)[:, None] * signs
    contr = torch.einsum("apcx,cax->cpx", dpg, gpsi)
    Fq = (Fq + contr) * detJ.abs()[:, None]
    return Fv, Fq


def boundary_ess_bl(engine, facet_kind, bvals, dv, refd):
    """(ess (2, X) bool, hatvals (2, k, X)) for a boundary bucket (folded
    X = n_rhs * P lane axis): essential markers and hat-weighted dof values
    of the two boundary spokes."""
    k = engine.k
    bsp = dv["bspokes"]  # (P, 2)
    n_rhs = facet_kind.shape[0]
    P = bsp.shape[0]
    kind = facet_kind[:, bsp]  # (n_rhs, P, 2)
    z_lo = dv["z_is_lo"]  # (P, 2)
    scale = 2.0 * torch.arange(k, dtype=bvals.dtype, device=bvals.device) + 1.0
    alpha = bvals[:, bsp] * scale  # (n_rhs, P, 2, k)
    Wend = refd["Wend"]  # (2, k, k)
    Wsel = torch.where(z_lo[..., None, None], Wend[0], Wend[1])
    hatvals = torch.einsum("rpej,pejm->emrp", alpha, Wsel).reshape(
        2, k, n_rhs * P)
    ess = (kind == 2).permute(2, 0, 1).reshape(2, n_rhs * P)
    return ess, hatvals


def particular_bl(engine, key, Fq, ess, hatvals, dv):
    """Explicit step on the folded lane axis: (nflux, X) satisfying the
    divergence constraints and the essential boundary dofs
    (Fq (n, ndg, X), ess (2, X), hatvals (2, k, X))."""
    b = engine.buckets[key]
    st = engine.se_static[key]
    k = engine.k
    kk1 = engine.V.element.ndofs_cell
    n, ns = b.ncells, b.nspokes
    ndiv = st["ndiv"]
    X = Fq.shape[-1]
    P = dv["detJ_bl"].shape[-1]
    n_rhs = X // P
    nflux = ns * k + n * kk1

    sdet = _bx(torch.sign(dv["detJ_bl"]), n_rhs)  # (n, X)
    gamma = _bx(dv["gamma_bl"], n_rhs)  # (n, X)
    cum = _bx(dv["cumalpha_bl"], n_rhs)  # (ns, X)
    sp = Fq.new_zeros((nflux, X))

    # step 1a: divergence cell dofs
    if ndiv:
        vals = Fq[:, 1: 1 + ndiv] * (sdet[:, None] / dv["divdiag"][:, None])
        sp[ns * k:].view(n, kk1, X)[:, :ndiv] = vals

    # step 1b: spoke constants via the closed-form recursion
    incl = torch.cumsum(gamma * Fq[:, 0], dim=0)  # (n, X)
    rec = torch.cat([incl.new_zeros((1, X)), incl], dim=0)[:ns] * cum
    if b.is_boundary:
        hv0, hv1 = hatvals[0, 0], hatvals[1, 0]  # (X,)
        ess0, ess1 = ess[0], ess[1]
        s0 = torch.where(
            ess0, hv0, torch.where(ess1, (hv1 - rec[-1]) / cum[-1], 0.0))
        sig0 = rec + cum * s0[None]
        # pure-Neumann patches: both ends pinned; enforce the far pin exactly
        # (the data-compatibility residual lands in the last cell's constant
        # divergence moment, as in the reference's step 1)
        sig0[-1] = torch.where(ess0 & ess1, hv1, sig0[-1])
    else:
        sig0 = rec
    sp[0: ns * k: k] = sig0

    # higher essential moments on the two boundary spokes
    if b.is_boundary and k > 1:
        for e, spj in ((0, 0), (1, ns - 1)):
            sp[spj * k + 1: spj * k + k] = torch.where(
                ess[e][None], hatvals[e, 1:], 0.0)
    return sp


def reduced_system_bl(engine, key, Mc, dv, resid=None, matrix=True):
    """A_z = Z^T M Z (Dz, Dz, P) and, given the canonical per-cell load
    residual ``resid`` (n, nkeep, X) on the folded lane axis,
    b_z = Z^T resid (Dz, X).  ``matrix=False`` skips A_z (the engine serves
    it from its geometry cache).

    Z per cell is the static 0/1 unit-column map E plus column 0, whose
    weights wen / wex (the ring-mode values of the cell's entry and exit
    spokes) sit on canonical slots 0 and k."""
    st = engine.se_static[key]
    k = engine.k
    n = engine.buckets[key].ncells
    P = Mc.shape[-1]
    E = dv["Zunit"]  # (n, nkeep, Dz); E[:, :, 0] == 0
    d0 = dv["cumalpha_bl"]  # (ns, P)
    wen, wex = d0[:n], d0[dv["exit_idx"]]  # (n, P)

    Az = bz = None
    if matrix:
        Mv = Mc[:, :, 0] * wen[:, None] + Mc[:, :, k] * wex[:, None]
        Az = torch.einsum("csd,cstp,cte->dep", E, Mc, E).contiguous()
        a = torch.einsum("csd,csp->dp", E, Mv)
        Az[0] = a
        Az[:, 0] = a
        Az[0, 0] = (wen * Mv[:, 0] + wex * Mv[:, k]).sum(0)
    if resid is not None:
        n_rhs = resid.shape[-1] // P
        bz = torch.einsum("csd,csx->dx", E, resid)
        bz[0] = (_bx(wen, n_rhs) * resid[:, 0]
                 + _bx(wex, n_rhs) * resid[:, k]).sum(0)
    return Az, bz


def z_mask_x(engine, key, ess):
    """ess (2, X) -> (Dz, X) True = column active.  Boundary-spoke columns
    die when that spoke carries essential data; the d0 ring mode dies when
    either does (its start value is then pinned by the explicit step)."""
    st = engine.se_static[key]
    k = engine.k
    free = torch.ones((st["Dz"], ess.shape[-1]), dtype=torch.bool,
                      device=ess.device)
    ess0, ess1 = ess[0], ess[1]  # (X,)
    free[0] = ~(ess0 | ess1)
    if k > 1:
        r1 = 1 + (engine.buckets[key].nspokes - 1) * (k - 1)
        free[1:k] = ~ess0[None]
        free[r1: r1 + k - 1] = ~ess1[None]
    return free


def z_mask_bl(engine, key, ess):
    """Per-RHS variant of :func:`z_mask_x`: ess (n_rhs, 2, P) ->
    (n_rhs, Dz, P) True = column active."""
    n_rhs, _, P = ess.shape
    free = z_mask_x(engine, key, ess.movedim(1, 0).reshape(2, n_rhs * P))
    return free.view(-1, n_rhs, P).movedim(1, 0)


def solve_bucket_semiexplicit(engine, key, dprT, facet_kind, bvals, dv, refd):
    """Full reduced solve of one bucket (batch-last packed input
    dprT (n_rhs, 3, ndg, nc) = [sigma_proj | rhs]) -> (n_rhs, nflux, P)
    patch dofs, batch-last.  The pipeline runs on the folded lane axis
    X = n_rhs * P."""
    b = engine.buckets[key]
    st = engine.se_static[key]
    k = engine.k
    n, ns = b.ncells, b.nspokes
    n_rhs = dprT.shape[0]
    Mc = dv["Mc_bl"]  # (n, nkeep, nkeep, P)
    nkeep, P = Mc.shape[1], Mc.shape[-1]
    X = n_rhs * P
    Dz = st["Dz"]

    with span("se.bucket", key=key, P=P, boundary=b.is_boundary, Dz=Dz):
        with span("se.load_moments"):
            Fv, Fq = load_moments_bl(dprT, dv, refd)
        with span("se.explicit"):
            if b.is_boundary:
                ess, hatvals = boundary_ess_bl(engine, facet_kind, bvals, dv,
                                               refd)
            else:
                ess = hatvals = None
            sp = particular_bl(engine, key, Fq, ess, hatvals, dv)  # (nflux, X)

        with span("se.reduced_rhs"):
            sp_can = sp[dv["patch_idx"]].view(n, nkeep, n_rhs, P)
            msp = torch.einsum("cibp,cbrp->cirp", Mc, sp_can).reshape(
                n, nkeep, X)
            _, bz = reduced_system_bl(engine, key, Mc, dv, resid=Fv - msp,
                                      matrix=False)

        with span("se.reduced_solve"):
            if b.is_boundary:
                free = z_mask_x(engine, key, ess)  # (Dz, X)
                ff = free[:, None] & free[None, :]  # (Dz, Dz, X)
                eye = torch.eye(Dz, dtype=Mc.dtype, device=Mc.device)
                Ar = torch.where(ff, _bx(dv["Az_bl"], n_rhs), 0.0) \
                    + eye[:, :, None] * (~free[None])
                br = torch.where(free, bz, 0.0)
                y = engine._dense_solve_bl(Ar, br[:, None, :])[:, 0]  # (Dz, X)
            else:
                # geometry-only system with a cached explicit inverse
                annotate(route="inverse")
                y = torch.einsum("dep,erp->drp", dv["Ainv_bl"],
                                 bz.view(Dz, n_rhs, P)).reshape(Dz, X)

            sol = sp
            if Dz > 1:
                sol.index_add_(0, dv["sel"], y[1:])
            sol[0: ns * k: k] += y[0][None] * _bx(dv["cumalpha_bl"], n_rhs)
        # unfold X -> (n_rhs, nflux, P)
        return sol.view(-1, n_rhs, P).permute(1, 0, 2)
