"""Weakly symmetric stress equilibration.

Port of the JAX package's ``eqlb/stress.py`` (see its docstring for the
method).  After the row-wise flux equilibration of the first two stress
rows, every patch contribution (sigma_z0, sigma_z1) receives
divergence-free corrections (Delta_0, Delta_1) of least norm under the
patch-local weak-symmetry constraint

    ((sigma_z + Delta)_01 - (sigma_z + Delta)_10, hat_v) = 0
                      for every continuous-P1 hat on the patch,

with a scalar multiplier relaxing the constant-mode constraint (reference
``se/stressmin_kernel.hpp:118-236``).  Two formulations, those the
reference's fused path runs:

* the semi-explicit engine's path, batch-last with geometry caches
  (``build_stress_cache`` once per engine, ``weak_symmetry_bucket_bl`` per
  call): the corrections live in the reduced divergence-free basis Z, so a
  patch system has D = 2 Dz + C + 1 unknowns; interior buckets apply the
  cached constraint columns of its inverse, boundary buckets mask and
  solve per call;
* ``_weak_symmetry_bucket_kkt``, the full KKT system of the KKT mode.

The weak-symmetry systems are indefinite, and symmetric patches (the
8-cell stars of crossed meshes) put a vanishing pivot in the pivot-free
order, so the semi-explicit and KKT paths solve them with pivoting
(``torch.linalg.solve``), as the reference does with XLA's LU.  Every
scatter over positions that cells share goes through ``index_add_``, one
cell at a time, so sums run in the reference's order.
"""

from __future__ import annotations

import numpy as np
import torch

from .semiexplicit import _onehot, _perm_q, reference_tensors, z_mask_bl

__all__ = ["bsym_combo_tensors", "build_stress_cache",
           "weak_symmetry_bucket_bl"]


def _index(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int64).ravel(),
                           device=device)


def _bsym_canonical(engine, key, dv, refd):
    """Weak-symmetry coupling tensor Bsym[p, c, hat_slot, comp, slot] =
    int hat (Phi_slot)_comp dx in canonical per-cell order, batch-major
    (P, n, 3, 2, nkeep).  The reference blends the three hat slots with
    one-hot weights; a gather by ``lv_hats`` gives the same values."""
    J, detJ = dv["J"], dv["detJ"]  # (P, n, 2, 2), (P, n)
    perm, signs = dv["perm"], dv["signs"]  # (P, n, nkeep)
    lv = dv["lv_hats"]  # (P, n, 3) local vertex index per hat slot
    JR = torch.einsum("pcab,lbi->pclai", J, refd["Rlam"])  # (P,n,3,2,nrt)
    Bsym = torch.take_along_dim(JR, lv[:, :, :, None, None], dim=2)
    Bsym = torch.take_along_dim(Bsym, perm[:, :, None, None, :], dim=4)
    sdet = torch.sign(detJ)
    return Bsym * (sdet[..., None, None, None] * signs[:, :, None, None, :])


# ---------------------------------------------------------------------------
# batch-last reduced stress path with geometry caches
# ---------------------------------------------------------------------------


def bsym_combo_tensors(k: int) -> np.ndarray:
    """Per-combo weak-symmetry reference tensors BsymC (6, 3, 2, nkeep):
    hat-slot l of a patch cell (0 = the patch vertex, 1 = entry-spoke end,
    2 = exit-spoke end) maps to a local vertex determined by the combo, and
    the canonical dof permutation is the combo's."""
    from ..elements.quadrature import LOCAL_EDGE_VERTICES as LOC

    Rlam = reference_tensors(k)["Rlam"]  # (3, 2, nrt)
    nkeep = 2 * k + k * (k - 1)
    out = np.zeros((6, 3, 2, nkeep))
    for q in range(6):
        ln, pq = _perm_q(q, k)
        o = q % 2
        e1 = (ln + 1) % 3 if o == 0 else (ln + 2) % 3
        e2 = (ln + 2) % 3 if o == 0 else (ln + 1) % 3
        ends = []
        for e in (e1, e2):
            pair = LOC[e]
            ends.append(pair[1] if pair[0] == ln else pair[0])
        for slot, v in enumerate([ln, ends[0], ends[1]]):
            out[q, slot] = Rlam[v][:, pq]
    return out


def _constraint_positions(engine, key, D, off_rows, off_cols):
    """Flat (D, D) positions, per cell i and stress row, of the coupling
    blocks of the reduced system: the d0 column and the unit columns of Z
    against the cell's three hat rows, and the transposes.  Returns a list
    over cells of (rows, [(d0_pos, d0_posT, u_pos, u_posT) per row],
    hat_pos, hat_posT) as NumPy arrays; ``off_rows`` is the first hat row,
    ``off_cols`` the first Z column of each stress row."""
    t = engine.tables[key]
    st = engine.se_static[key]
    ilc = D - 1
    out = []
    for i in range(engine.buckets[key].ncells):
        rows = off_rows + t["p1_idx"][i]  # (3,) unique per cell
        per_row = []
        for off in off_cols:
            cols = off + st["ucols"][i]
            per_row.append((rows * D + off, off * D + rows,
                            (rows[:, None] * D + cols[None, :]).ravel(),
                            (cols[:, None] * D + rows[None, :]).ravel()))
        out.append((rows, per_row, rows * D + ilc, ilc * D + rows))
    return out


def build_stress_cache(engine, key, dv, refd):
    """Geometry-only stress-system cache for one bucket (batch-last).

    The reduced weak-symmetry KKT matrix

        S = [ A_z        (B1 Z)^T ]      (D = 2 Dz + C + 1)
            [      A_z   (B2 Z)^T ]
            [ B1 Z B2 Z     ch    ]

    depends only on geometry.  Interior buckets cache the constraint
    columns of S^{-1} (the per-call load has entries only in the C
    constraint rows), so a call's correction is one small contraction;
    boundary buckets keep S and re-mask per call.  Returns the dict entries
    ``Bsym_bl`` (n, 3, 2, nkeep, P), ``p1_idx`` (n, 3) (each cell's patch
    hat nodes, on the device for the per-call pass) and ``Sinv_c``
    (2 Dz, C, P) or ``S_stress`` (D, D, P)."""
    b = engine.buckets[key]
    t = engine.tables[key]
    st = engine.se_static[key]
    k = engine.k
    J = dv["J_bl"]  # (n, 2, 2, P)
    P = J.shape[-1]
    dt, devc = J.dtype, J.device
    Dz = st["Dz"]
    C = t["np1"]
    D = 2 * Dz + C + 1

    W = _onehot(dv["combo_bl"], dt)  # (n, 6, P)
    Bsym = torch.einsum("cabp,cqp,qlbi->claip", J, W, refd["BsymC"])
    sdet = torch.sign(dv["detJ_bl"])  # (n, P)
    Bsym = Bsym * (sdet[:, None, None, None] * dv["signs_bl"][:, None, None])

    Az = dv["Az_bl"]
    S = J.new_zeros((D, D, P))
    S[:Dz, :Dz] = Az
    S[Dz: 2 * Dz, Dz: 2 * Dz] = Az
    Sf = S.view(D * D, P)
    U = st["uslots"]
    d0 = dv["cumalpha_bl"]  # (ns, P)
    adet = dv["detJ_bl"].abs()
    pos = _constraint_positions(engine, key, D, 2 * Dz, (0, Dz))
    for i, (_, per_row, hpos, hposT) in enumerate(pos):
        wen, wex = d0[i], d0[st["exit_idx"][i]]
        for (p0, p0T, pu, puT), Bi in zip(per_row, (Bsym[i, :, 1],
                                                     -Bsym[i, :, 0])):
            bi0 = Bi[:, 0] * wen + Bi[:, k] * wex  # (3, P)
            Sf.index_add_(0, _index(p0, devc), bi0)
            Sf.index_add_(0, _index(p0T, devc), bi0)
            if len(U):
                BU = Bi[:, U]  # (3, nu, P)
                Sf.index_add_(0, _index(pu, devc), BU.reshape(-1, P))
                Sf.index_add_(0, _index(puT, devc),
                              BU.transpose(0, 1).reshape(-1, P))
        hi = (adet[i] / 6.0).expand(3, P)
        Sf.index_add_(0, _index(hpos, devc), hi)
        Sf.index_add_(0, _index(hposT, devc), hi)

    out = {"Bsym_bl": Bsym, "p1_idx": _index(t["p1_idx"], devc).view(-1, 3)}
    if not b.is_boundary:
        # constraint columns of S^{-1} restricted to the flux rows; S itself
        # is not needed per call on interior buckets
        E = J.new_zeros((D, C, P))
        ar = torch.arange(C, device=devc)
        E[2 * Dz + ar, ar] = 1.0
        X = engine._dense_solve_pivoted_bl(S, E)  # (D, C, P)
        out["Sinv_c"] = X[: 2 * Dz].contiguous()
    else:
        out["S_stress"] = S
    return out


def _delta_bl(engine, key, y0, y1, dv):
    """(2, nflux, P) patch-dof corrections from the Z coefficients of the
    two stress rows (Dz, P) each."""
    b = engine.buckets[key]
    k = engine.k
    ns = b.nspokes
    Dz, P = y0.shape
    nflux = ns * k + b.ncells * engine.V.element.ndofs_cell
    delta = y0.new_zeros((2, nflux, P))
    cum = dv["cumalpha_bl"]  # (ns, P)
    for row, yr in ((0, y0), (1, y1)):
        if Dz > 1:
            delta[row].index_add_(0, dv["sel"], yr[1:])
        delta[row, 0: ns * k: k] += yr[0][None] * cum
    return delta


def weak_symmetry_bucket_bl(engine, key, sol2_bl, facet_kind2, dv, refd,
                            skip=None, record=None):
    """Batch-last weak-symmetry correction -> (2, nflux, P) deltas.

    sol2_bl (2, nflux, P): the equilibrated stress-row patch dofs.  The
    flux-block load vanishes by optimality of the flux solve, so the only
    data is the constraint residual g_h = -(B1 c0 + B2 c1)_h.  ``skip``
    (P,) bool: grouped patches, whose correction ``eqlb.grouping`` applies
    jointly.  ``record``: a dict that receives, for a boundary bucket, the
    per-patch mask ``sing`` of the rank-1 regularisation below."""
    b = engine.buckets[key]
    t = engine.tables[key]
    st = engine.se_static[key]
    Dz = st["Dz"]
    C = t["np1"]
    D = 2 * Dz + C + 1
    ilc = 2 * Dz + C
    P = sol2_bl.shape[-1]
    dt, devc = sol2_bl.dtype, sol2_bl.device

    Bsym = dv["Bsym_bl"]  # (n, 3, 2, nkeep, P)
    pidx = dv["patch_idx"]  # (n, nkeep)
    c0 = sol2_bl[0][pidx]  # (n, nkeep, P)
    c1 = sol2_bl[1][pidx]
    acc = (torch.einsum("chsp,csp->chp", Bsym[:, :, 1], c0)
           - torch.einsum("chsp,csp->chp", Bsym[:, :, 0], c1))  # (n, 3, P)
    g = sol2_bl.new_zeros((C, P))
    for i in range(b.ncells):
        g.index_add_(0, dv["p1_idx"][i], -acc[i])

    if not b.is_boundary:
        yf = torch.einsum("dhp,hp->dp", dv["Sinv_c"], g)  # (2 Dz, P)
        if skip is not None:
            # grouped patches get their correction jointly (eqlb.grouping)
            yf = torch.where(skip[None], 0.0, yf)
        return _delta_bl(engine, key, yf[:Dz], yf[Dz:], dv)

    # boundary: mask essential flux columns / multiplier, then solve
    S = dv["S_stress"]
    ess = facet_kind2[:, dv["bspokes"]] == 2  # (2, P, 2)
    fr = z_mask_bl(engine, key, ess.movedim(1, -1))  # (2, Dz, P)
    free = torch.ones((D, P), dtype=torch.bool, device=devc)
    free[:Dz] = fr[0]
    free[Dz: 2 * Dz] = fr[1]
    free[ilc] = ess.all(dim=2).all(dim=0)
    if skip is not None:
        # grouped patches: identity system -> zero correction here
        free &= ~skip[None]
    ff = free[:, None] & free[None, :]
    eye = torch.eye(D, dtype=dt, device=devc)
    Sr = torch.where(ff, S, 0.0) + eye[..., None] * (~free)[None]
    # Mixed-row traction patches (one row pure-traction, another with free
    # boundary spokes) can leave the constant constraint mode
    # v = 1/sqrt(C) on the multiplier rows structurally unreachable: the
    # masked system is rank-1 deficient with null vector exactly v (the
    # reference's Eigen LDLT tolerates the consistent singular Schur
    # complement, PatchData.hpp:598-638; exact LU does not).  Detect
    # ||Sr v|| ~ 0 per patch and apply the exact rank-1 regularisation
    # alpha v v^T: on consistent data it selects the solution with zero
    # null component and perturbs nothing else.
    cr = slice(2 * Dz, 2 * Dz + C)
    v = Sr.new_zeros((D, P))
    v[cr] = torch.where(free[cr], float(1.0 / np.sqrt(C)), 0.0)
    Sv = torch.einsum("djp,jp->dp", Sr[:, cr], v[cr])
    diag_scale = torch.diagonal(Sr).abs().sum(-1) / D  # (P,)
    sing = torch.sqrt((Sv * Sv).sum(0)) < 1e-6 * (diag_scale + 1e-30)
    if record is not None:
        record["sing"] = sing
    Sr = Sr + (sing.to(dt) * diag_scale)[None, None] * v[:, None] * v[None]
    rhs = Sr.new_zeros((D, P))
    rhs[cr] = g
    rhs = torch.where(free, rhs, 0.0)
    y = engine._dense_solve_pivoted_bl(Sr, rhs[:, None, :])[:, 0]  # (D, P)
    return _delta_bl(engine, key, y[:Dz], y[Dz: 2 * Dz], dv)


def _assemble_flat(A, positions, values):
    """Add per-cell blocks into the flattened batch-major systems A
    (P, D * D): ``positions`` flat indices (NumPy), ``values`` (P, len)."""
    A.index_add_(1, _index(positions, A.device), values)


def _weak_symmetry_bucket_kkt(engine, key, sol2, facet_kind2, d_proj2, dv,
                              refd):
    """Corrections for the two stress rows of one bucket, KKT mode.

    The objective minimises the *corrector* norm
    || (sigma_z - psi sigma_proj) + Delta || (reference
    ``stressmin_kernel.hpp:186-195``), so the flux load is
    -M c_row + (psi sigma_proj, phi).  The symmetry-constraint data may use
    sigma_z directly: the hat-weighted projected stress is pointwise
    symmetric, so its antisymmetric part vanishes.

    sol2 (2, P, nflux): patch-local flux solutions of stress rows 0, 1;
    facet_kind2 (2, nf); d_proj2 (2, nc, 2, ndg); ``dv`` / ``refd``: the
    engine's KKT-mode tables.  Returns (2, P, nflux) corrections."""
    b = engine.buckets[key]
    t = engine.tables[key]
    k = engine.k
    kk1 = engine.V.element.ndofs_cell
    ndg = k * (k + 1) // 2
    n, ns = b.ncells, b.nspokes
    P = dv["J"].shape[0]
    F = ns * k + n * kk1
    G = n * ndg
    C = t["np1"]
    devc = sol2.device

    zeros2 = torch.zeros_like(d_proj2)
    Mc, Bc, Fv, _ = engine._element_data(d_proj2, zeros2[..., 0, :], dv, refd)
    Bsym = _bsym_canonical(engine, key, dv, refd)  # (P, n, 3, 2, nkeep)
    adet = dv["detJ"].abs()
    cpen = refd["cpen"]

    D = 2 * F + 2 * G + C + 3
    A = Mc.new_zeros((P, D * D))
    rhs = Mc.new_zeros((P, D))
    pidx = t["patch_idx"]
    iuc = 2 * F + 2 * G
    il0, il1, ilc = iuc + C, iuc + C + 1, iuc + C + 2
    c0, c1 = sol2[0], sol2[1]

    for i in range(n):
        ix = pidx[i]
        ixt = _index(ix, devc)
        for row in (0, 1):
            fx = row * F + ix
            qr = 2 * F + row * G + i * ndg + np.arange(ndg)
            lam = il0 if row == 0 else il1
            cpl = adet[:, i, None] * cpen[None, :]  # (P, ndg)
            _assemble_flat(A, np.concatenate([
                (fx[:, None] * D + fx[None, :]).ravel(),
                (qr[:, None] * D + fx[None, :]).ravel(),
                (fx[:, None] * D + qr[None, :]).ravel(),
                qr * D + lam, lam * D + qr]), torch.cat([
                    Mc[:, i].reshape(P, -1),
                    Bc[:, i].transpose(1, 2).reshape(P, -1),
                    -Bc[:, i].reshape(P, -1), cpl, cpl], dim=1))
            # L_flux = -(sigma_z - psi sigma_proj, phi) = -M c_row + Fv_row
            cloc = (c0 if row == 0 else c1)[:, ixt]
            rhs.index_add_(1, _index(fx, devc), Fv[row, :, i] - torch.einsum(
                "pij,pj->pi", Mc[:, i], cloc))
        # symmetry constraint rows: B1 = +y-component, B2 = -x-component
        uc = iuc + t["p1_idx"][i]
        B1 = Bsym[:, i, :, 1, :]  # (P, 3, nkeep)
        B2 = -Bsym[:, i, :, 0, :]
        f0, f1 = ix, F + ix
        hat = (adet[:, i, None] / 6.0).expand(P, 3)
        _assemble_flat(A, np.concatenate([
            (uc[:, None] * D + f0[None, :]).ravel(),
            (uc[:, None] * D + f1[None, :]).ravel(),
            (f0[:, None] * D + uc[None, :]).ravel(),
            (f1[:, None] * D + uc[None, :]).ravel(),
            uc * D + ilc, ilc * D + uc]), torch.cat([
                B1.reshape(P, -1), B2.reshape(P, -1),
                B1.transpose(1, 2).reshape(P, -1),
                B2.transpose(1, 2).reshape(P, -1), hat, hat], dim=1))
        # L_c = -(B1 c0 + B2 c1)
        rhs.index_add_(1, _index(uc, devc),
                       -torch.einsum("phi,pi->ph", B1, c0[:, ixt])
                       - torch.einsum("phi,pi->ph", B2, c1[:, ixt]))

    # --- essential conditions -------------------------------------------------
    mask = torch.zeros((P, D), dtype=torch.bool, device=devc)
    if b.is_boundary:
        ess = facet_kind2[:, dv["bspokes"]] == 2  # (2, P, 2)
        for row in (0, 1):
            for e, sp in enumerate((0, ns - 1)):
                cols = slice(row * F + sp * k, row * F + sp * k + k)
                mask[:, cols] = ess[row, :, e: e + 1]
        lam_rows = {il0: ess[0].all(dim=1), il1: ess[1].all(dim=1),
                    ilc: ess.all(dim=2).all(dim=0)}
    else:
        ones = torch.ones((P,), dtype=torch.bool, device=devc)
        lam_rows = {il0: ones, il1: ones, ilc: ones}
    for lam, on in lam_rows.items():
        mask[:, lam] = ~on

    eye = torch.eye(D, dtype=A.dtype, device=devc)
    Ar = torch.where(mask[..., None], eye, A.view(P, D, D))
    br = torch.where(mask, 0.0, rhs)
    # the weak-symmetry KKT has nested singular Schur blocks: pivoted LU,
    # as in the reference
    sol = torch.linalg.solve(Ar, br[..., None])[..., 0]
    return torch.stack([sol[:, :F], sol[:, F: 2 * F]])
