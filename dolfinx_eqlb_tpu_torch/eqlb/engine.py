"""Batched patch-wise equilibration engine — the fused semi-explicit path.

Port of ``dolfinx_eqlb_tpu/eqlb/engine.py`` (see its docstring for the patch
problem).  Slice 1 carries the path ``bench.py`` times:
``EqlbEngine.equilibrate`` on the fused semi-explicit program, in four
stages:

1. host tables (``__init__``): patch buckets, chunked to at most
   ``max_patches_per_bucket`` patches, their dof and explicit-step tables,
   and the flux-major combine table ``src``;
2. geometry caches, built once (``_device_tables``): element mass
   matrices, reduced H(div=0) matrices A_z and, for interior buckets, their
   inverses through K1 (``ops.patch_solve``);
3. per call, per bucket (``semiexplicit.solve_bucket_semiexplicit``): load
   moments, the explicit step and the reduced solve — a cached-inverse
   product on interior buckets, a masked K1 solve on boundary buckets;
4. the global combine through K2 (``ops.lane_select.combine_gather``).

The engine is a plain class holding device tensors in dicts shaped like the
reference's ``dev`` / ``refd``; it has no parameters.  Everything runs
eagerly.  Left out on purpose, because they only served the TPU: the
fusion fences, the trailing 128-lane NaN-guard pad of every bucket, the
lane-packed / paired / double-single combine layouts and the compile-cache
machinery.  Chunks are not padded, so a bucket's tables hold only real
patches; tables taken from the reference engine (``from_host_tables``) may
carry pad rows, whose ``gdofs == ndofs`` keeps them out of the combine.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import replace
from functools import lru_cache

import numpy as np
import torch

from ..elements.lagrange import dubiner_cached, lagrange_cached
from ..elements.polynomials import legendre_shifted
from ..elements.quadrature import gauss_interval, gauss_triangle
from ..elements.rt import rt_cached
from ..fem.spaces import FunctionSpace
from ..ops.lane_select import combine_gather
from ..ops.patch_solve import batched_kkt_solve_bl
from .patches import PatchBucket, bucket_dof_tables
from .semiexplicit import (
    combo_tensors, mass_matrices_bl, reduced_basis, reduced_system_bl,
    se_host_tables, se_static, solve_bucket_semiexplicit,
)

__all__ = ["EqlbEngine", "reference_tensors"]


_HAT_GRADS = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


@lru_cache(maxsize=None)
def reference_tensors(k: int):
    """Constant reference-cell tensors for RT_k / DG_{k-1} / P1-hat."""
    rt = rt_cached(k)
    dub = dubiner_cached(k - 1)
    hat = lagrange_cached(1)
    pts, w = gauss_triangle(2 * k + 2)
    phi = rt.tabulate(pts)  # (nrt, 2, nq)
    dphi = rt.tabulate_div(pts)  # (nrt, nq)
    q = dub.tabulate(pts)  # (ndg, nq)
    lam = hat.tabulate(pts)  # (3, nq)

    Mhat = np.einsum("x,iax,jbx->abij", w, phi, phi)
    Dhat = np.einsum("x,ix,px->ip", w, dphi, q)
    Rhat = np.einsum("x,lx,mx,iax->lmai", w, lam, q, phi)
    Rlam = np.einsum("x,lx,iax->lai", w, lam, phi)  # weak-symmetry coupling
    T3 = np.einsum("x,lx,mx,px->lmp", w, lam, q, q)
    cpen = np.einsum("x,px->p", w, q)  # only the constant mode is nonzero

    # hat-weighted Legendre products on [0,1] for boundary-spoke dofs:
    # W[end, j, m] = int lin_end(s) P~_j(s) P~_m(s) ds, lin_0 = 1-s, lin_1 = s
    s, ws = gauss_interval(k + 2)
    leg = legendre_shifted(k - 1)
    legv = np.array([np.polyval(leg[m, ::-1], s) for m in range(k)])
    Wend = np.stack(
        [
            np.einsum("x,jx,mx->jm", ws * (1.0 - s), legv, legv),
            np.einsum("x,jx,mx->jm", ws * s, legv, legv),
        ]
    )
    return dict(
        Mhat=Mhat, Dhat=Dhat, Rhat=Rhat, Rlam=Rlam, T3=T3, cpen=cpen, Wend=Wend
    )


@contextmanager
def _full_f32_matmul():
    """Full f32 contractions are load-bearing: a reduced-precision pass put
    a 2.7e-3 relative error on the dofs in the reference.  Pin full f32
    (no TF32) for the duration, and restore the caller's settings."""
    prec = torch.get_float32_matmul_precision()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(prec)


def _chunk_buckets(buckets, C: int):
    """Split every bucket of more than C patches into chunks of at most C
    (keys gain the chunk index); bounds the per-bucket working set."""
    split = {}
    for key, b in buckets.items():
        P = b.npatches
        if P <= C:
            split[key] = b
            continue
        for i in range(-(-P // C)):
            s = slice(i * C, min((i + 1) * C, P))
            split[key + (i,)] = replace(
                b, nodes=b.nodes[s], cells=b.cells[s], lnode=b.lnode[s],
                spokes=b.spokes[s], entry_loc=b.entry_loc[s],
                exit_loc=b.exit_loc[s],
            )
    return split


class EqlbEngine:
    """Per-mesh, per-degree batched equilibration engine (semi-explicit).

    ``solver``: "kernel" (K1, the default) or "torch" (``torch.linalg.solve``)
    for the batch-last patch solves, as the reference's "pallas" / "xla".
    On CPU tensors the kernels' wrappers take their plain versions, so
    "kernel" runs everywhere."""

    def __init__(
        self,
        V_flux: FunctionSpace,
        buckets: dict[tuple, PatchBucket],
        dtype: torch.dtype = torch.float64,
        device="cpu",
        max_patches_per_bucket: int | None = None,
    ):
        """``dtype``: compute precision of the patch solves (f64 default).
        ``max_patches_per_bucket``: split larger buckets into chunks of at
        most this many patches."""
        if V_flux.family != "RT":
            raise ValueError("the flux space must be RT")
        k = V_flux.degree
        if max_patches_per_bucket:
            buckets = _chunk_buckets(buckets, max_patches_per_bucket)
        msh = V_flux.mesh
        # gather per-patch geometry at the compute precision
        np_dt = _NP_DTYPE[dtype]
        J_g = np.ascontiguousarray(msh.J, dtype=np_dt)
        K_g = np.ascontiguousarray(msh.K, dtype=np_dt)
        detJ_g = np.ascontiguousarray(msh.detJ, dtype=np_dt)
        tables, statics = {}, {}
        for key, b in buckets.items():
            t = bucket_dof_tables(b, V_flux)
            statics[key] = se_static(b, k)
            t.update(se_host_tables(b, t, msh, k))
            cells64 = b.cells.astype(np.int64)
            t["J"] = J_g[cells64]  # (P, n, 2, 2)
            t["detJ"] = detJ_g[cells64]
            t["K"] = K_g[cells64]
            # endpoint of each boundary spoke: is z the lower-global-id end?
            if b.is_boundary:
                fv = msh.facet_vertices[b.spokes[:, [0, -1]].astype(np.int64)]
                t["z_is_lo"] = fv[..., 0] == b.nodes[:, None]  # (P, 2)
                t["bspokes"] = b.spokes[:, [0, -1]].astype(np.int64)  # (P, 2)
            tables[key] = t
        self._setup(V_flux, buckets, tables, statics, reference_tensors(k),
                    dtype, device)

    @classmethod
    def from_host_tables(cls, V_flux, buckets, tables, se_static, ref,
                         dtype: torch.dtype = torch.float64, device="cpu"):
        """Engine over given host state — the reference engine's
        ``buckets``, ``tables``, ``se_static`` and ``ref`` (plain NumPy) —
        so a parity failure can be pinned on the host tables or on the
        device stages.  Pad rows in the tables (``gdofs == ndofs``) are
        solved and never combined."""
        eng = cls.__new__(cls)
        eng._setup(V_flux, buckets, tables, se_static, ref, dtype, device)
        return eng

    def _setup(self, V_flux, buckets, tables, statics, ref, dtype, device):
        if dtype not in _NP_DTYPE:
            raise ValueError(f"unsupported dtype {dtype}")
        self.V = V_flux
        self.k = V_flux.degree
        self.mesh = V_flux.mesh
        self.buckets = buckets
        self.tables = tables
        self.se_static = statics
        self.ref = ref
        self.dtype = dtype
        self.device = torch.device(device)
        self.solver = "kernel"
        self._build_combine_table()
        self._dev = None
        self._refd = None

    def _build_combine_table(self):
        """Gather-based global accumulation: every global dof has at most 3
        contributors (2 patches per facet dof, 3 per cell dof).  src[d, c]
        is the flat position of contributor c in the concatenated flux-major
        bucket solutions (position off + f * P + p); absent ones point at
        the zero pad slot ``total`` just past the last bucket."""
        ndofs = self.V.ndofs
        total = sum(int(np.prod(t["gdofs"].shape)) for t in self.tables.values())
        from .. import native

        src = np.full((ndofs, 3), total, dtype=np.int32)
        cur = np.zeros(ndofs, dtype=np.uint8)
        use_native = native.available()
        off = 0
        for key in sorted(self.tables.keys()):
            g = self.tables[key]["gdofs"]  # (P, nflux)
            Ppad, nflux = g.shape
            if use_native:
                native.combine_fill(ndofs, off, g, src, cur)
            else:
                pp, ff = np.nonzero((g >= 0) & (g < ndofs))
                gd = g[pp, ff].astype(np.int64)
                idx = off + ff * Ppad + pp
                # stable (p, f)-order column assignment per dof
                order = np.argsort(gd, kind="stable")
                sg, si = gd[order], idx[order]
                poscol = (
                    np.arange(len(sg))
                    - np.searchsorted(sg, sg, side="left")
                    + cur[sg]
                )
                if len(poscol) and poscol.max() > 2:
                    raise RuntimeError(
                        "dof with more than 3 patch contributions")
                src[sg, poscol] = si
                np.add.at(cur, gd, 1)
            off += Ppad * nflux
        nfk = self.mesh.num_facets * self.k
        if not np.all(src[:nfk, 2] == total):
            raise RuntimeError("facet dof with 3 contributors")
        if (cur[:nfk] != 2).any() or (cur[nfk:] != 3).any():
            raise RuntimeError("dof missing a patch contribution")
        self._flat_len = total
        self._nfk = nfk
        self._src = src

    # --- device-resident tables ----------------------------------------------

    def _device_tables(self):
        """Upload the batch-last bucket tables and build the geometry caches
        (once)."""
        if self._dev is not None:
            return self._dev, self._refd
        dt, devc = self.dtype, self.device
        k = self.k

        def f(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                   device=devc)

        def i64(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int64,
                                   device=devc)

        refd = {name: f(arr) for name, arr in combo_tensors(k).items()}
        refd["Wend"] = f(self.ref["Wend"])
        dev = {}
        with _full_f32_matmul():
            for key in sorted(self.tables.keys()):
                t = self.tables[key]
                b = self.buckets[key]
                st = self.se_static[key]
                cells = t.get("cells", b.cells)
                d = {
                    "divdiag": f(t["divdiag"]),
                    "J_bl": f(np.moveaxis(t["J"], 0, -1)),
                    "K_bl": f(np.moveaxis(t["K"], 0, -1)),
                    "detJ_bl": f(t["detJ"].T),
                    "signs_bl": f(np.moveaxis(t["signs"], 0, -1)),
                    "combo_bl": i64(t["combo"].T),
                    "cells_bl": i64(cells.T),
                    "gamma_bl": f(t["gamma"].T),
                    "cumalpha_bl": f(t["cumalpha"].T),
                    # static per bucket shape
                    "patch_idx": i64(t["patch_idx"]),
                    "sel": i64(st["sel"]),
                    "exit_idx": i64(st["exit_idx"]),
                    "Zunit": f(reduced_basis(st, b.ncells, k)),
                }
                if b.is_boundary:
                    d["bspokes"] = i64(t["bspokes"])
                    d["z_is_lo"] = torch.as_tensor(
                        np.ascontiguousarray(t["z_is_lo"]), device=devc)
                # geometry caches: call-invariant mass and reduced matrices;
                # interior buckets also cache the explicit inverse (boundary
                # buckets mask A_z per RHS before solving)
                d["Mc_bl"] = mass_matrices_bl(d, refd)
                d["Az_bl"], _ = reduced_system_bl(self, key, d["Mc_bl"], d)
                if not b.is_boundary:
                    Dz, _, P = d["Az_bl"].shape
                    eye = torch.eye(Dz, dtype=dt, device=devc)[:, :, None]
                    d["Ainv_bl"] = self._dense_solve_bl(
                        d["Az_bl"], eye.expand(Dz, Dz, P).contiguous())
                dev[key] = d
        refd["src"] = torch.as_tensor(self._src, device=devc)
        self._dev, self._refd = dev, refd
        return dev, refd

    # --- the call --------------------------------------------------------------

    def put_transposed(self, sigma_proj_dofs, rhs_dofs):
        """Host-transpose batch-major dof data to the batch-last layout and
        upload once; pass the result to ``equilibrate`` with
        ``transposed_inputs=True`` to keep repeated calls free of
        host->device transfers."""
        dpT = torch.as_tensor(
            np.ascontiguousarray(np.moveaxis(np.asarray(sigma_proj_dofs), 1, -1)),
            dtype=self.dtype, device=self.device)
        drT = torch.as_tensor(
            np.ascontiguousarray(np.moveaxis(np.asarray(rhs_dofs), 1, -1)),
            dtype=self.dtype, device=self.device)
        return dpT, drT

    def equilibrate(self, sigma_proj_dofs, rhs_dofs, facet_kind, bvals,
                    transposed_inputs=False):
        """Solve all patch problems; returns global RT dof vectors
        (n_rhs, ndofs_flux) on the engine's device.

        Args (leading axis = n_rhs):
          sigma_proj_dofs (n_rhs, nc, 2, ndg): vector-DG dofs of sigma_proj
          rhs_dofs        (n_rhs, nc, ndg):    DG dofs of the projected RHS
          facet_kind      (n_rhs, nf) int:     0 interior/outer, 1 flux-free
                                               (primal Dirichlet), 2 flux-
                                               essential (Neumann data)
          bvals           (n_rhs, nf, k):      facet dof values of the flux BC
          transposed_inputs: the first two come from ``put_transposed``
        """
        if transposed_inputs:
            dpT, drT = sigma_proj_dofs, rhs_dofs
        else:
            dpT, drT = self.put_transposed(sigma_proj_dofs, rhs_dofs)
        fk = torch.as_tensor(facet_kind, device=self.device)
        bv = torch.as_tensor(bvals, dtype=self.dtype, device=self.device)
        with _full_f32_matmul():
            flat = self._bucket_solutions(dpT, drT, fk, bv)
            return self._combine_flat(flat)

    def _bucket_solutions(self, dpT, drT, facet_kind, bvals):
        """Stage 3: every bucket's patch solutions, concatenated flux-major
        into flat (n_rhs, total + 1) with the zero pad slot last.
        dpT (n_rhs, 2, ndg, nc), drT (n_rhs, ndg, nc)."""
        dev, refd = self._device_tables()
        n_rhs = dpT.shape[0]
        dprT = torch.cat([dpT, drT[:, None]], dim=1)  # (n_rhs, 3, ndg, nc)
        flats = []
        for key in sorted(self.buckets.keys()):
            sol_bl = solve_bucket_semiexplicit(
                self, key, dprT, facet_kind, bvals, dev[key], refd)
            flats.append(sol_bl.reshape(n_rhs, -1))
        flats.append(dprT.new_zeros((n_rhs, 1)))
        return torch.cat(flats, dim=1)

    def _combine_flat(self, flat):
        """Stage 4: global accumulation (n_rhs, total + 1) ->
        (n_rhs, ndofs) through K2 — the reference's element-gather
        combine."""
        _, refd = self._device_tables()
        return combine_gather(flat, refd["src"], self._nfk)

    def _dense_solve_bl(self, A, b):
        """Batch-last solve: A (D, D, X), b (D, R, X) -> (D, R, X)."""
        if self.solver == "kernel":
            return batched_kkt_solve_bl(A, b)
        if self.solver != "torch":
            raise ValueError(f"unknown solver {self.solver!r}")
        x = torch.linalg.solve(A.permute(2, 0, 1), b.permute(2, 0, 1))
        return x.permute(1, 2, 0).contiguous()
