"""Batched patch-wise equilibration engine.

Port of ``dolfinx_eqlb_tpu/eqlb/engine.py`` (see its docstring for the patch
problem).  ``EqlbEngine.equilibrate`` runs one of two modes:

* ``mode="semiexplicit"`` (the default; the path ``bench.py`` times), the
  fused semi-explicit program, in four stages:

  1. host tables (``__init__``): patch buckets, chunked to at most
     ``max_patches_per_bucket`` patches, their dof and explicit-step tables,
     and the flux-major combine table ``src``;
  2. geometry caches, built once (``_device_tables``): element mass
     matrices, reduced H(div=0) matrices A_z and, for interior buckets,
     their inverses through K1 (``ops.patch_solve``);
  3. per call, per bucket (``semiexplicit.solve_bucket_semiexplicit``): load
     moments, the explicit step and the reduced solve — a cached-inverse
     product on interior buckets, a masked K1 solve on boundary buckets;
     with ``weak_symmetry=True``, then the weak-symmetry correction of the
     two stress rows (``stress.weak_symmetry_bucket_bl``, from the stress
     caches ``ensure_stress_caches`` builds once, solved with pivoting);
  4. the global combine through K2 (``ops.lane_select.combine_gather``) or,
     with ``combine="ds"``, the double-single K4 (``ds_combine_gather``).

* ``mode="kkt"``, the reference's full saddle-point formulation, kept to
  cross-check the fast path: per bucket, ``_assemble_bucket`` builds one
  dense KKT system per patch from batch-major tables, ``_kkt_solve``
  solves them through K3 (``ops.patch_solve.batched_kkt_solve``) wherever
  a tiled or cluster route of K3 covers the system (``k3_admits``), the
  weak-symmetry correction, if asked for, is the full stress KKT system
  (``stress._weak_symmetry_bucket_kkt``, pivoted), and the flux part of
  the solutions goes through the same combine as above.

``solver="kernel_mixed"`` on an f64 engine factors in f32 on K1 and refines
in f64 (``_dense_solve_bl``), the reference's ``"pallas_mixed"``.

The engine is a plain class holding device tensors in dicts shaped like the
reference's ``dev`` / ``refd``; it has no parameters.  Everything runs
eagerly.  Left out on purpose, because they only served the TPU: the
fusion fences, the trailing 128-lane NaN-guard pad of every bucket, the
lane-packed / paired combine layouts, the [hi | lo] f32 load source of the
double-single route and the compile-cache machinery.  A bucket's tables
hold only real patches unless ``pad_to_multiple`` asks for pad rows (for
an even split over ranks, ``parallel.ShardedEqlbEngine``); tables taken
from the reference engine (``from_host_tables``) may carry pad rows too.
A pad row repeats the last patch with ``gdofs == ndofs``, which keeps it
out of the combine.
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
from ..fem.spaces import FunctionSpace, resolve_device
from ..ops.lane_select import combine_gather, ds_combine_gather
from ..ops.patch_solve import (
    batched_kkt_solve, batched_kkt_solve_bl, k3_admits,
)
from .patches import PatchBucket, bucket_dof_tables
from .semiexplicit import (
    boundary_ess_bl, combo_tensors, mass_matrices_bl, reduced_basis,
    reduced_system_bl, se_host_tables, se_static, solve_bucket_semiexplicit,
)
from .stress import (
    _weak_symmetry_bucket_kkt, bsym_combo_tensors, build_stress_cache,
    weak_symmetry_bucket_bl,
)

__all__ = ["EqlbEngine", "k3_admits", "k3_takes", "reference_tensors"]


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


def k3_takes(D: int) -> bool:
    """The reference's size rule for its batch-major Pallas solve (two
    (D, D, 128) f32 tiles in a 12 MiB budget of the TPU's VMEM: D <= 110).
    ``_dense_solve`` keeps it, for the reduced weak-symmetry systems
    (``stress.weak_symmetry_bucket_reduced``), which are not safe without
    pivoting; the flux KKT stage follows the port's own rule,
    ``ops.patch_solve.k3_admits`` (exported here beside it)."""
    return D * D * 128 * 4 * 2 < 12 * 2**20


# per-patch host tables: the rows that ``_pad_patch_axis`` repeats
_PER_PATCH = ("perm", "signs", "gdofs", "lv_hats", "J", "detJ", "K",
              "z_is_lo", "bspokes", "cells", "lnode", "gamma", "cumalpha",
              "combo")


def _pad_patch_axis(t: dict, b: PatchBucket, m: int, ndofs: int) -> None:
    """Pad bucket ``b``'s per-patch tables ``t`` in place up to the next
    multiple of ``m`` rows, and no further: pad rows repeat the last patch
    and get ``gdofs = ndofs``, so they are solved and never combined (the
    reference's ``pad_to_multiple`` without its 128-row safety tile)."""
    P = b.npatches
    pad = -P % m
    if not pad:
        return
    t["cells"], t["lnode"] = b.cells, b.lnode
    for name in _PER_PATCH:
        if name in t:
            t[name] = np.concatenate(
                [t[name], np.repeat(t[name][-1:], pad, axis=0)])
    t["gdofs"][P:] = ndofs


_MODES = ("semiexplicit", "kkt")
_SOLVERS = ("kernel", "torch", "kernel_mixed")
_COMBINES = ("gather", "ds")


class EqlbEngine:
    """Per-mesh, per-degree batched equilibration engine.

    Options, plain attributes read at every ``equilibrate`` call:

    * ``mode``: "semiexplicit" (default) or "kkt" (see the module
      docstring), as in the reference.
    * ``solver``: "kernel" (default; K1 for the batch-last solves, K3 for
      the KKT systems up to the reference's size rule), "torch"
      (``torch.linalg.solve``) or "kernel_mixed" (f64 engines: K1 in f32
      plus ``mixed_refine_steps`` f64 residual corrections; KKT systems go
      to ``torch.linalg.solve``) — the reference's "pallas" / "xla" /
      "pallas_mixed".
    * ``mixed_refine_steps``: corrections of "kernel_mixed" (default 1).
    * ``combine``: "gather" (K2, default) or "ds" (K4, the double-single
      combine; f64 engines only).

    On CPU tensors the kernels' wrappers take their plain versions, so
    every option runs everywhere."""

    def __init__(
        self,
        V_flux: FunctionSpace,
        buckets: dict[tuple, PatchBucket],
        dtype: torch.dtype = torch.float64,
        device=None,
        max_patches_per_bucket: int | None = None,
        pad_quantize: float | None = None,
        pad_to_multiple: int | None = None,
    ):
        """``dtype``: compute precision of the patch solves (f64 default).
        ``device``: the CUDA card by default; ``"cpu"`` runs the kernels'
        plain versions.  ``max_patches_per_bucket``: split larger buckets
        into chunks of at most this many patches.  ``pad_to_multiple``:
        pad every bucket's (chunk's) patch axis up to the next multiple of
        this, so that it splits evenly over that many ranks
        (``parallel.ShardedEqlbEngine``); pad rows never reach the
        result.  ``pad_quantize`` is
        accepted for parity with the reference's signature and ignored:
        it rounds bucket shapes up so a compile cache recurs, and nothing
        here is compiled per shape."""
        device = resolve_device(device, "EqlbEngine")
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
            if pad_to_multiple:
                _pad_patch_axis(t, b, pad_to_multiple, V_flux.ndofs)
            tables[key] = t
        self._setup(V_flux, buckets, tables, statics, reference_tensors(k),
                    dtype, device)

    @classmethod
    def from_host_tables(cls, V_flux, buckets, tables, se_static, ref,
                         dtype: torch.dtype = torch.float64, device=None,
                         partial: bool = False):
        """Engine over given host state — the reference engine's
        ``buckets``, ``tables``, ``se_static`` and ``ref`` (plain NumPy) —
        so a parity failure can be pinned on the host tables or on the
        device stages.  Pad rows in the tables (``gdofs == ndofs``) are
        solved and never combined; a bucket's first ``npatches`` rows are
        its real patches.  ``partial``: the tables hold only some of the
        mesh's patches (one rank's rows of a sharded engine), so the
        combine gives each dof the sum of the contributors present."""
        device = resolve_device(device, "EqlbEngine")
        eng = cls.__new__(cls)
        eng._setup(V_flux, buckets, tables, se_static, ref, dtype, device,
                   partial)
        return eng

    def _setup(self, V_flux, buckets, tables, statics, ref, dtype, device,
               partial=False):
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
        self.device = device
        self.mode = "semiexplicit"
        self.solver = "kernel"
        self.mixed_refine_steps = 1
        self.combine = "gather"
        self._build_combine_table(partial)
        self._dev = None
        self._refd = None
        self._kdev = None
        self._krefd = None
        self._src_dev = None
        # pivoted (torch.linalg.solve) batch-last solves so far: the stress
        # caches' and the boundary buckets' weak-symmetry systems
        self.pivoted_solves = 0
        # per boundary bucket, the mask of patches whose masked stress
        # system took the rank-1 regularisation in the last weak-symmetry
        # call (``stress.weak_symmetry_bucket_bl``)
        self.ws_sing = {}

    def _build_combine_table(self, partial=False):
        """Gather-based global accumulation: every global dof has at most 3
        contributors (2 patches per facet dof, 3 per cell dof).  src[d, c]
        is the flat position of contributor c in the concatenated flux-major
        bucket solutions (position off + f * P + p); absent ones point at
        the zero pad slot ``total`` just past the last bucket.  Unless
        ``partial`` (the tables hold only some of the mesh's patches, one
        rank's rows), every dof must have all its contributors."""
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
        if not partial and ((cur[:nfk] != 2).any() or (cur[nfk:] != 3).any()):
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
        refd["BsymC"] = f(bsym_combo_tensors(k))
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
        self._dev, self._refd = dev, refd
        return dev, refd

    def _kkt_tables(self):
        """Upload the batch-major tables of the KKT mode (once; the
        reference's ``_ensure_full_tables``) and the per-cell assembly
        positions.  Separate from ``_device_tables``: the KKT mode needs
        none of the semi-explicit geometry caches."""
        if self._kdev is not None:
            return self._kdev, self._krefd
        dt, devc = self.dtype, self.device
        ndg = self.k * (self.k + 1) // 2

        def f(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                   device=devc)

        def i64(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int64,
                                   device=devc)

        krefd = {name: f(self.ref[name]) for name in (
            "Mhat", "Dhat", "Rhat", "Rlam", "T3", "cpen", "Wend")}
        krefd["hat_grads"] = f(_HAT_GRADS)
        kdev = {}
        for key in sorted(self.tables.keys()):
            t = self.tables[key]
            b = self.buckets[key]
            D, nflux = self.kkt_size(key)
            # cell i's flux rows ix and constraint rows q: flat positions of
            # its [M | -B; B^T] blocks in a (D, D) system, and of its load
            # rows; unique within a cell, shared between cells
            asm, rhs = [], []
            for i in range(b.ncells):
                ix = t["patch_idx"][i]
                q = nflux + i * ndg + np.arange(ndg)
                asm.append(np.concatenate([
                    (ix[:, None] * D + ix[None, :]).ravel(),
                    (q[:, None] * D + ix[None, :]).ravel(),
                    (ix[:, None] * D + q[None, :]).ravel()]))
                rhs.append(np.concatenate([ix, q]))
            d = {
                "J": f(t["J"]),
                "detJ": f(t["detJ"]),
                "K": f(t["K"]),
                "perm": i64(t["perm"]),
                "signs": f(t["signs"]),
                "cells": i64(t.get("cells", b.cells)),
                "lnode": i64(t.get("lnode", b.lnode)),
                "lv_hats": i64(t["lv_hats"]),
                "asm_idx": i64(np.stack(asm)),
                "rhs_idx": i64(np.stack(rhs)),
            }
            if b.is_boundary:
                d["bspokes"] = i64(t["bspokes"])
                d["z_is_lo"] = torch.as_tensor(
                    np.ascontiguousarray(t["z_is_lo"]), device=devc)
            kdev[key] = d
        self._kdev, self._krefd = kdev, krefd
        return kdev, krefd

    def ensure_stress_caches(self):
        """Build the geometry-only weak-symmetry caches once per engine
        (``stress.build_stress_cache``: the coupling tensors of every
        bucket, the constraint columns of the stress systems' inverses on
        interior buckets, the stress systems on boundary buckets).  Lazy:
        only stress workloads pay for them."""
        dev, refd = self._device_tables()
        if any("Bsym_bl" in d for d in dev.values()):
            return
        with _full_f32_matmul():
            for key in sorted(self.tables.keys()):
                dev[key].update(build_stress_cache(self, key, dev[key], refd))

    def _combine_src(self) -> torch.Tensor:
        """The combine table ``src`` on the device (uploaded once)."""
        if self._src_dev is None:
            self._src_dev = torch.as_tensor(self._src, device=self.device)
        return self._src_dev

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

    def _input(self, a, dtype=None) -> torch.Tensor:
        """An input on the engine's device: a tensor must already be there
        (it is cast, never copied through the host); anything else is taken
        as host data and uploaded."""
        if isinstance(a, torch.Tensor):
            if a.device != self.device:
                raise ValueError(
                    f"input tensor on {a.device}, the engine runs on "
                    f"{self.device}")
            return a.detach().to(dtype) if dtype is not None else a.detach()
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.device)

    def equilibrate(self, sigma_proj_dofs, rhs_dofs, facet_kind, bvals,
                    weak_symmetry=False, fuse=None, transposed_inputs=False,
                    ws_skip_nodes=None):
        """Solve all patch problems; returns global RT dof vectors
        (n_rhs, ndofs_flux) on the engine's device.

        Inputs may be host arrays or tensors on the engine's device; NumPy
        dof data is transposed to the batch-last layout on the host
        (``put_transposed``), tensors on their device.

        Args (leading axis = n_rhs):
          sigma_proj_dofs (n_rhs, nc, 2, ndg): vector-DG dofs of sigma_proj
          rhs_dofs        (n_rhs, nc, ndg):    DG dofs of the projected RHS
          facet_kind      (n_rhs, nf) int:     0 interior/outer, 1 flux-free
                                               (primal Dirichlet), 2 flux-
                                               essential (Neumann data)
          bvals           (n_rhs, nf, k):      facet dof values of the flux BC
          weak_symmetry:  treat rows 0, 1 as stress rows and apply the
                          patch-wise weak-symmetry correction before the
                          combine (the reference's FluxEqlbSE stress path)
          fuse:           accepted for the reference's signature: there it
                          picks one fused program (True) or one per bucket
                          (False).  Eager PyTorch always dispatches per
                          bucket; ``fuse=False`` keeps the reference's two
                          refusals (``transposed_inputs``,
                          ``ws_skip_nodes``)
          transposed_inputs: the first two come from ``put_transposed``
                             (semi-explicit mode only)
          ws_skip_nodes:  vertices whose patches get no per-patch
                          weak-symmetry correction, because
                          ``eqlb.grouping`` corrects them jointly
                          (semi-explicit mode; the KKT mode, like the
                          reference's, corrects every patch)
        """
        self._check_options()
        if transposed_inputs and self.mode == "kkt":
            raise ValueError(
                "transposed_inputs=True needs mode='semiexplicit': the KKT "
                "mode reads the batch-major data")
        if transposed_inputs and fuse is False:
            raise ValueError(
                "transposed_inputs=True requires the fused semi-explicit "
                "path (mode='semiexplicit', fuse=True): the batch-major "
                "fallback would silently mis-gather batch-last arrays")
        fk = self._input(facet_kind)
        bv = self._input(bvals, self.dtype)
        if weak_symmetry and fk.shape[0] < 2:
            raise ValueError("weak symmetry needs two stress rows")
        ws_skip = None
        if (weak_symmetry and ws_skip_nodes is not None
                and len(ws_skip_nodes)):
            if fuse is False:
                raise ValueError(
                    "fuse=False does not support ws_skip_nodes (grouped "
                    "deficient patches): the unfused path would solve the "
                    "singular per-patch weak-symmetry systems anyway")
            # one entry per table row: pad rows follow the real patches
            ws_skip = {}
            for key, b in self.buckets.items():
                m = np.zeros(self.tables[key]["gdofs"].shape[0], dtype=bool)
                m[:b.npatches] = np.isin(b.nodes, ws_skip_nodes)
                ws_skip[key] = torch.as_tensor(m, device=self.device)
        with _full_f32_matmul():
            if self.mode == "kkt":
                dp = self._input(sigma_proj_dofs, self.dtype)
                dr = self._input(rhs_dofs, self.dtype)
                flat = self._bucket_solutions_kkt(dp, dr, fk, bv,
                                                  weak_symmetry)
            else:
                if transposed_inputs:
                    dpT, drT = sigma_proj_dofs, rhs_dofs
                elif isinstance(sigma_proj_dofs, torch.Tensor):
                    dpT = self._input(sigma_proj_dofs, self.dtype).movedim(
                        1, -1).contiguous()
                    drT = self._input(rhs_dofs, self.dtype).movedim(
                        1, -1).contiguous()
                else:
                    dpT, drT = self.put_transposed(sigma_proj_dofs, rhs_dofs)
                if weak_symmetry:
                    self.ensure_stress_caches()
                flat = self._bucket_solutions(dpT, drT, fk, bv,
                                              weak_symmetry, ws_skip)
            return self._combine_flat(flat)

    def _check_options(self):
        for name, allowed in (("mode", _MODES), ("solver", _SOLVERS),
                              ("combine", _COMBINES)):
            if getattr(self, name) not in allowed:
                raise ValueError(f"unknown {name} {getattr(self, name)!r}; "
                                 f"one of {allowed}")
        if self.combine == "ds" and self.dtype != torch.float64:
            raise ValueError("combine='ds' (double-single) needs an f64 "
                             f"engine, this one is {self.dtype}")

    def _bucket_solutions(self, dpT, drT, facet_kind, bvals,
                          weak_symmetry=False, ws_skip=None):
        """Stage 3: every bucket's patch solutions, concatenated flux-major
        into flat (n_rhs, total + 1) with the zero pad slot last.
        dpT (n_rhs, 2, ndg, nc), drT (n_rhs, ndg, nc)."""
        dev, refd = self._device_tables()
        n_rhs = dpT.shape[0]
        dprT = torch.cat([dpT, drT[:, None]], dim=1)  # (n_rhs, 3, ndg, nc)
        flats = []
        if weak_symmetry:
            self.ws_sing = {}
        for key in sorted(self.buckets.keys()):
            sol_bl = solve_bucket_semiexplicit(
                self, key, dprT, facet_kind, bvals, dev[key], refd)
            if weak_symmetry:
                record = {}
                sol_bl[:2] += weak_symmetry_bucket_bl(
                    self, key, sol_bl[:2], facet_kind[:2], dev[key], refd,
                    skip=None if ws_skip is None else ws_skip[key],
                    record=record)
                if "sing" in record:
                    self.ws_sing[key] = record["sing"]
            flats.append(sol_bl.reshape(n_rhs, -1))
        flats.append(dprT.new_zeros((n_rhs, 1)))
        return torch.cat(flats, dim=1)

    def _bucket_solutions_kkt(self, d_proj, d_rhs, facet_kind, bvals,
                              weak_symmetry=False):
        """KKT mode's stage 3: the flux part of every bucket's KKT
        solutions in the semi-explicit path's flat layout (position
        off + f * P + p, zero pad slot last), so the same combine serves
        both modes.  The reference scatter-adds the bucket solutions
        instead (same sums); the gather needs no sink for pad rows and no
        atomics.  d_proj (n_rhs, nc, 2, ndg), d_rhs (n_rhs, nc, ndg)."""
        kdev, krefd = self._kkt_tables()
        n_rhs = d_proj.shape[0]
        flats = []
        for key in sorted(self.buckets.keys()):
            Ar, br, nflux = self._assemble_bucket(
                key, d_proj, d_rhs, facet_kind, bvals, kdev[key], krefd)
            sol = self._kkt_solve(Ar, br[..., None])[..., :nflux, 0]
            if weak_symmetry:
                sol[:2] += _weak_symmetry_bucket_kkt(
                    self, key, sol[:2], facet_kind[:2], d_proj[:2],
                    kdev[key], krefd)
            flats.append(sol.transpose(1, 2).reshape(n_rhs, -1))
            del Ar, br, sol
        flats.append(d_proj.new_zeros((n_rhs, 1)))
        return torch.cat(flats, dim=1)

    def _combine_flat(self, flat):
        """Stage 4: global accumulation (n_rhs, total + 1) ->
        (n_rhs, ndofs) through K2 — the reference's element-gather
        combine — or, with ``combine="ds"``, through K4, the reference's
        double-single combine (``_ds_combine``)."""
        fn = ds_combine_gather if self.combine == "ds" else combine_gather
        return fn(flat, self._combine_src(), self._nfk)

    def _dense_solve_bl(self, A, b):
        """Batch-last solve: A (D, D, X), b (D, R, X) -> (D, R, X).

        ``solver="kernel_mixed"`` on f64 operands: K1 in f32, then
        ``mixed_refine_steps`` f64 residual corrections, each a plain f64
        r = b - A y and a K1 f32 solve of r added to y.  The cached bucket
        inverses are built through this routine, so the per-call path
        inherits their accuracy."""
        if self.solver == "torch":
            x = torch.linalg.solve(A.permute(2, 0, 1), b.permute(2, 0, 1))
            return x.permute(1, 2, 0).contiguous()
        if self.solver == "kernel_mixed" and A.dtype == torch.float64:
            A32 = A.float()
            y = batched_kkt_solve_bl(A32, b.float()).double()
            for _ in range(self.mixed_refine_steps):
                r = b - torch.einsum("ijx,jcx->icx", A, y)
                y = y + batched_kkt_solve_bl(A32, r.float()).double()
            return y
        return batched_kkt_solve_bl(A, b)

    def _dense_solve_pivoted_bl(self, A, b):
        """Batch-last PIVOTED solve: A (D, D, X), b (D, R, X) -> (D, R, X),
        ``torch.linalg.solve`` on the batch-major view.  For the indefinite
        weak-symmetry systems: symmetric patches (the 8-cell stars of
        crossed meshes) put an exactly vanishing pivot in the pivot-free
        order although the matrix is well conditioned (a 3e-19 pivot at
        cond 5e5 in the reference), so neither K1 nor K3 takes them."""
        self.pivoted_solves += 1
        x = torch.linalg.solve(A.permute(2, 0, 1), b.permute(2, 0, 1))
        return x.permute(1, 2, 0)

    def _dense_solve(self, A, b):
        """Batch-major solve by the reference's size rule: A (..., P, D, D),
        b (..., P, D, R).  ``solver="kernel"`` takes K3 for the sizes
        ``k3_takes`` admits; the rest go to ``torch.linalg.solve``, as in
        the reference."""
        if self.solver == "kernel" and k3_takes(A.shape[-1]):
            return batched_kkt_solve(A, b)
        return torch.linalg.solve(A, b)

    def _kkt_solve(self, A, b):
        """Batch-major solve of the flux KKT systems by the port's size
        rule: ``solver="kernel"`` takes K3 for the shapes ``k3_admits``
        admits (D + R <= 256: RT3's D = 120 / 135 / 150 and RT4's up to
        D = 234, past the reference's rule); the rest go to the pivoted
        ``torch.linalg.solve``, as in the reference."""
        if self.solver == "kernel" and k3_admits(A.shape[-1], b.shape[-1]):
            return batched_kkt_solve(A, b)
        return torch.linalg.solve(A, b)

    def kkt_size(self, key) -> tuple[int, int]:
        """(D, nflux) of bucket ``key``'s KKT systems: its flux dofs, then
        one DG_{k-1} constraint block per cell."""
        b = self.buckets[key]
        k = self.k
        nflux = b.nspokes * k + b.ncells * self.V.element.ndofs_cell
        return nflux + b.ncells * k * (k + 1) // 2, nflux

    # --- KKT mode ---------------------------------------------------------------

    def _element_data(self, d_proj, d_rhs, dv, refd):
        """Canonical per-cell element tensors of one bucket:
        Mc (P, n, nkeep, nkeep), Bc (P, n, nkeep, ndg),
        Fv (n_rhs, P, n, nkeep), Fq (n_rhs, P, n, ndg).  The hat-function
        slot lnode picks its reference slice by a gather; the reference
        blends the three with one-hot weights to spare the TPU's tiling,
        which gives the same values."""
        J, detJ, K = dv["J"], dv["detJ"], dv["K"]  # (P, n, 2, 2), (P, n)
        adet, sdet = detJ.abs(), torch.sign(detJ)
        perm, signs = dv["perm"], dv["signs"]  # (P, n, nkeep)
        cells, lnode = dv["cells"], dv["lnode"]  # (P, n)
        P, n, nkeep = perm.shape
        n_rhs = d_proj.shape[0]

        JtJ = torch.einsum("pcka,pckb->pcab", J, J)
        Mgeo = torch.einsum("pcab,abij->pcij", JtJ, refd["Mhat"])
        Mgeo = Mgeo / adet[..., None, None]
        nrt = Mgeo.shape[-1]
        Mc = torch.gather(Mgeo, 2, perm[..., None].expand(P, n, nkeep, nrt))
        Mc = torch.gather(Mc, 3, perm[:, :, None, :].expand(P, n, nkeep, nkeep))
        Mc = Mc * signs[..., :, None] * signs[..., None, :]
        Bc = sdet[..., None, None] * refd["Dhat"][perm] * signs[..., None]

        dp = d_proj[:, cells]  # (n_rhs, P, n, 2, ndg)
        fr = d_rhs[:, cells]  # (n_rhs, P, n, ndg)
        pick = lnode[None, :, :, None, None]  # hat slot l of each cell
        dpJ = torch.einsum("rpcam,pcab->rpcbm", dp, J)
        Fv_full = torch.take_along_dim(
            torch.einsum("rpcbm,lmbi->rpcli", dpJ, refd["Rhat"]), pick,
            dim=3)[:, :, :, 0]
        Fq = torch.take_along_dim(
            torch.einsum("rpcm,lmq->rpclq", fr, refd["T3"]), pick,
            dim=3)[:, :, :, 0]
        # grad(psi)_a = K_{ba} ghat_b
        gpsi = torch.einsum("pcba,pcb->pca", K, refd["hat_grads"][lnode])
        Fq = Fq + torch.einsum("pca,rpcaq->rpcq", gpsi, dp)
        Fv_full = Fv_full * sdet[None, ..., None]
        Fq = Fq * adet[None, ..., None]
        Fv = torch.gather(Fv_full, 3, perm[None].expand(n_rhs, P, n, nkeep))
        return Mc, Bc, Fv * signs[None], Fq

    def _boundary_ess(self, facet_kind, bvals, dv, refd):
        """Essential-spoke markers and hat-weighted dof values of a boundary
        bucket, batch-major: (ess (n_rhs, P, 2) bool,
        hatvals (n_rhs, P, 2, k)) — ``boundary_ess_bl`` unfolded."""
        n_rhs, P = facet_kind.shape[0], dv["bspokes"].shape[0]
        ess, hatvals = boundary_ess_bl(self, facet_kind, bvals, dv, refd)
        return (ess.view(2, n_rhs, P).permute(1, 2, 0),
                hatvals.view(2, self.k, n_rhs, P).permute(2, 3, 0, 1))

    def _assemble_bucket(self, key, d_proj, d_rhs, facet_kind, bvals, dv,
                         refd):
        """The dense KKT systems of one bucket, ordered [sigma | r]:
        Ar (n_rhs, P, D, D), br (n_rhs, P, D) and the flux size nflux.

        The mean-value multiplier enters as the reference's exact rank-1
        regularisation beta c c^T of the r-block on interior and
        pure-Neumann patches (sigma is unchanged, since B^T c = 0, and
        every pivot of the pivot-free order is nonzero); essential flux
        dofs become identity rows.  Cells share spoke rows, so the blocks
        are added cell by cell with ``index_add_`` — unique positions per
        cell, so the sums are deterministic and in the reference's order."""
        b = self.buckets[key]
        k = self.k
        n, ns = b.ncells, b.nspokes
        D, nflux = self.kkt_size(key)
        P = dv["J"].shape[0]
        n_rhs = d_proj.shape[0]
        Mc, Bc, Fv, Fq = self._element_data(d_proj, d_rhs, dv, refd)

        A = Mc.new_zeros((P, D * D))
        bvec = Mc.new_zeros((n_rhs, P, D))
        for i in range(n):
            blocks = torch.cat([Mc[:, i].reshape(P, -1),
                                Bc[:, i].transpose(1, 2).reshape(P, -1),
                                -Bc[:, i].reshape(P, -1)], dim=1)
            A.index_add_(1, dv["asm_idx"][i], blocks)
            bvec.index_add_(2, dv["rhs_idx"][i],
                            torch.cat([Fv[:, :, i], Fq[:, :, i]], dim=2))
        del Mc, Bc, Fv, Fq
        # constraint mean-mode vector; its per-cell blocks are disjoint
        cvec = (dv["detJ"].abs()[:, :, None] * refd["cpen"]).reshape(P, -1)
        R1 = cvec[:, :, None] * cvec[:, None, :] / (
            (cvec * cvec).sum(1)[:, None, None])

        if b.is_boundary:
            ess, hatvals = self._boundary_ess(facet_kind, bvals, dv, refd)
            mask = torch.zeros((n_rhs, P, D), dtype=torch.bool,
                               device=A.device)
            values = bvec.new_zeros((n_rhs, P, D))
            for e, sp in enumerate((0, ns - 1)):
                cols = slice(sp * k, sp * k + k)
                mask[:, :, cols] = ess[:, :, e:e + 1]
                values[:, :, cols] = torch.where(ess[:, :, e:e + 1],
                                                 hatvals[:, :, e], 0.0)
            # the multiplier is active only if both spokes are essential
            lam_on = ess[:, :, 0] & ess[:, :, 1]
        else:
            lam_on = torch.ones((n_rhs, P), dtype=torch.bool,
                                device=A.device)

        # n_rhs = 1 takes A itself, with no copy
        Ar = A.view(1, P, D, D).expand(n_rhs, P, D, D).contiguous()
        del A
        Ar[:, :, nflux:, nflux:] += torch.where(lam_on[..., None, None],
                                                R1[None], 0.0)
        if not b.is_boundary:
            return Ar, bvec, nflux
        eye = torch.eye(D, dtype=Ar.dtype, device=Ar.device)
        Ar = torch.where(mask[..., None], eye, Ar)
        return Ar, torch.where(mask, values, bvec), nflux

