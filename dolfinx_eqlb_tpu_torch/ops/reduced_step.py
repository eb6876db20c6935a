"""The semi-explicit stage's reduced step in one pass a lane: K6.

``reduced_step`` takes a bucket's particular solution sp (nflux, X) and
load moments Fv (n, nkeep, X) on the folded lane axis X = n_rhs * P and
forms the canonical load residual Fv - Mc sp, its reduced right-hand side
b_z = Z^T resid (Dz, X) through the unit-column map E and the d0 ring
mode, and, on an interior bucket (``Ainv`` given), the bucket's solution
sp + Z Ainv b_z in place in sp.  The CUDA kernel is in
``csrc/reduced_step.cu``; its notes say what bounds it on the card (memory
traffic: the cached Mc, Fv and the inverse) and how the design answers
(one thread per lane, Mc streamed in the engine's batch-last cache, E by
its nonzeros, b_z in shared memory, the solution written in place).

It replaces no TPU kernel: the JAX package's ``eqlb/semiexplicit.py::
reduced_system_bl`` and its interior inverse product are plain jnp that
XLA fuses.  ``reduced_step_plain`` is the port's einsum form of them, which
the wrapper takes for CPU tensors; for CUDA tensors it launches the kernel
or raises.  The kernel sums in another order than the einsums, so the two
agree to rounding, not bitwise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils import profiling
from . import _build
from .load_moments import fold_rhs

__all__ = ["kernel_uslots", "reduced_step", "reduced_step_plain",
           "K6_EPILOGUES"]

_FUNCS = {torch.float32: "eqlb_reduced_step_f32",
          torch.float64: "eqlb_reduced_step_f64"}
# the kernel's epilogues: an interior bucket's cached inverse applied in
# place, or a boundary bucket's reduced right-hand side written out
K6_EPILOGUES = ("inverse", "rhs")
_build.count_launches("K6", K6_EPILOGUES)


def kernel_uslots(k: int) -> np.ndarray:
    """The canonical cell slots of E's unit columns as the kernel fixes them
    for degree k: the entry spoke's moments 1..k-1, the exit spoke's
    k+1..2k-1, the interior dofs (``semiexplicit.se_static``'s uslots)."""
    ndiv = k * (k + 1) // 2 - 1
    nint = (k - 1) * (k - 2) // 2
    return np.concatenate([np.arange(1, k), k + np.arange(1, k),
                           2 * k + ndiv + np.arange(nint)]).astype(np.int64)


def _degree(nkeep: int) -> int:
    k = (math.isqrt(1 + 4 * nkeep) - 1) // 2
    if k < 1 or k * (k + 1) != nkeep:
        raise ValueError(f"nkeep = {nkeep} is no RT degree's k (k + 1)")
    return k


def reduced_step_plain(sp, Fv, Mc, patch_idx, Zunit, ucols, exit_idx,
                       cumalpha, sel, Ainv=None):
    """The reduced step as einsums over the dense unit-column map Zunit
    (see ``reduced_step`` for the arguments; ``ucols`` is the kernel's form
    of Zunit and is not read here)."""
    n, nkeep, _, P = Mc.shape
    k = _degree(nkeep)
    X = sp.shape[-1]
    n_rhs = X // P
    ns = cumalpha.shape[0]
    Dz = Zunit.shape[-1]

    sp_can = sp[patch_idx].view(n, nkeep, n_rhs, P)
    msp = torch.einsum("cibp,cbrp->cirp", Mc, sp_can).reshape(n, nkeep, X)
    resid = Fv - msp
    # Z per cell is the static 0/1 unit-column map E plus column 0, whose
    # weights wen / wex (the ring-mode values of the cell's entry and exit
    # spokes) sit on canonical slots 0 and k
    wen, wex = cumalpha[:n], cumalpha[exit_idx]  # (n, P)
    bz = torch.einsum("csd,csx->dx", Zunit, resid)
    bz[0] = (fold_rhs(wen, n_rhs) * resid[:, 0]
             + fold_rhs(wex, n_rhs) * resid[:, k]).sum(0)
    if Ainv is None:
        return bz
    y = torch.einsum("dep,erp->drp", Ainv, bz.view(Dz, n_rhs, P)).reshape(
        Dz, X)
    if Dz > 1:
        sp.index_add_(0, sel, y[1:])
    sp[0: ns * k: k] += y[0][None] * fold_rhs(cumalpha, n_rhs)
    return sp


def _check(sp, Fv, Mc, patch_idx, Zunit, ucols, exit_idx, cumalpha, sel,
           Ainv):
    if Mc.dim() != 4 or sp.dim() != 2 or Zunit.dim() != 3:
        raise ValueError(
            f"need Mc (n, nkeep, nkeep, P), sp (nflux, X) and Zunit "
            f"(n, nkeep, Dz), got {tuple(Mc.shape)}, {tuple(sp.shape)} and "
            f"{tuple(Zunit.shape)}")
    n, nkeep, _, P = Mc.shape
    k = _degree(nkeep)
    nflux, X = sp.shape
    Dz = Zunit.shape[-1]
    ns = cumalpha.shape[0] if cumalpha.dim() == 2 else -1
    if P == 0 or X % P or ns < n or nflux < ns * k:
        raise ValueError(
            f"sp {tuple(sp.shape)}, Mc {tuple(Mc.shape)} and cumalpha "
            f"{tuple(cumalpha.shape)} do not fit one bucket")
    nint = (k - 1) * (k - 2) // 2
    want = {"Mc": (Mc, (n, nkeep, nkeep, P)), "Fv": (Fv, (n, nkeep, X)),
            "patch_idx": (patch_idx, (n, nkeep)),
            "Zunit": (Zunit, (n, nkeep, Dz)),
            "ucols": (ucols, (n, 2 * (k - 1) + nint)),
            "exit_idx": (exit_idx, (n,)), "cumalpha": (cumalpha, (ns, P)),
            "sel": (sel, (Dz - 1,))}
    if Ainv is not None:
        want["Ainv"] = (Ainv, (Dz, Dz, P))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if sp.dtype not in _FUNCS:
        raise ValueError(f"unsupported dtype {sp.dtype}")
    floats = [sp, Fv, Mc, Zunit, cumalpha] + ([] if Ainv is None else [Ainv])
    if any(t.dtype != sp.dtype for t in floats):
        raise ValueError("sp, Fv, the geometry caches and Zunit must share a "
                         "dtype")
    ints = (patch_idx, ucols, exit_idx, sel)
    if any(t.dtype != torch.int64 for t in ints):
        raise ValueError("patch_idx, ucols, exit_idx and sel must be int64")
    if any(t.device != sp.device for t in (*floats, *ints)):
        raise ValueError("all inputs must share a device")
    # Mc may keep its (c, i, b) axes in any order (the engine's einsum
    # leaves them as (i, b, c)), as long as the patch axis is the fastest
    if Mc.stride(-1) != 1 and P > 1:
        raise ValueError(f"Mc's patch axis must be its fastest, strides "
                         f"{Mc.stride()}")
    if not all(t.is_contiguous() for t in (*floats, *ints) if t is not Mc):
        raise ValueError("all inputs but Mc must be contiguous")
    if sp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {sp.device}")
    return k, n, ns, Dz, X // P, P


def reduced_step(sp, Fv, Mc, patch_idx, Zunit, ucols, exit_idx, cumalpha,
                 sel, Ainv=None):
    """One bucket's reduced step on the folded lane axis X = n_rhs * P.

    sp (nflux, X): the explicit step's particular solution; Fv
    (n, nkeep, X): the load moments; Mc (n, nkeep, nkeep, P): the cached
    canonical mass matrices (any strides with the patch axis fastest);
    patch_idx (n, nkeep) int64: each canonical slot's row of sp; Zunit
    (n, nkeep, Dz): the unit-column map E with Zunit[c, uslots[a],
    ucols[c, a]] = 1 and column 0 empty, and ucols (n, len(uslots)) int64
    its nonzeros (``semiexplicit.se_static``; the kernel takes uslots as
    ``kernel_uslots(k)``); exit_idx (n,) int64: each
    cell's exit spoke; cumalpha (ns, P): the d0 ring-mode weights; sel
    (Dz - 1,) int64: the row of sp of each unit column; Ainv (Dz, Dz, P):
    an interior bucket's cached inverse of A_z, or None on a boundary
    bucket.

    Returns b_z (Dz, X) without ``Ainv``, else sp with the solution added in
    place.  CPU tensors take the plain version; CUDA tensors launch the K6
    kernel (k in ``_build.SE_KERNEL_DEGREES``, else ValueError; counted as
    "K6" by epilogue, ``K6_EPILOGUES``, in ``ops.launches``).  The kernel
    does not check the index tables' ranges (that would cost a device sync
    per call): the engine builds them on the host."""
    k, n, ns, Dz, n_rhs, P = _check(sp, Fv, Mc, patch_idx, Zunit, ucols,
                                     exit_idx, cumalpha, sel, Ainv)
    if sp.device.type == "cpu":
        profiling.annotate(route="plain")
        return reduced_step_plain(sp, Fv, Mc, patch_idx, Zunit, ucols,
                                  exit_idx, cumalpha, sel, Ainv)
    _build.check_se_degree(k, "the reduced-step kernel (K6)")
    profiling.annotate(route="kernel")
    bz = None if Ainv is not None else torch.empty(
        (Dz, n_rhs * P), dtype=sp.dtype, device=sp.device)
    _build.launch("K6", _FUNCS[sp.dtype], sp.device, *(t.data_ptr() for t in (
        sp, Fv, Mc, patch_idx, ucols, exit_idx, cumalpha, sel)),
        None if Ainv is None else Ainv.data_ptr(),
        None if bz is None else bz.data_ptr(),
        k, n, ns, Dz, n_rhs, P, *Mc.stride()[:3],
        split="inverse" if bz is None else "rhs")
    return sp if bz is None else bz
