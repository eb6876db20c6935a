"""The semi-explicit stage's canonical load moments in one pass: K5.

``load_moments`` computes, for every cell slot c of a bucket's patches and
every folded lane x = r * P + p (RHS r, patch p), the moments Fv (n, nkeep,
X) of the projected flux and Fq (n, ndg, X) of the right-hand side and the
gradient term, from the per-cell dofs gathered out of dprT.  The CUDA
kernel is in ``csrc/load_moments.cu``; its notes say what bounds it on the
card (memory traffic: the gather and the batch-last tables) and how the
design answers (one thread per (c, x), the combo indexing the reference
tensors in place of a one-hot, the RHS fold as an index computation).

It replaces no TPU kernel: the JAX package's ``eqlb/semiexplicit.py::
load_moments_bl`` is plain jnp that XLA fuses.  ``load_moments_plain`` is
the port's einsum form of it, which the wrapper takes for CPU tensors; for
CUDA tensors it launches the kernel or raises.  The kernel sums in another
order than the einsums, so the two agree to rounding, not bitwise.
"""

from __future__ import annotations

import math

import torch

from ..utils import profiling
from . import _build

__all__ = ["fold_rhs", "load_moments", "load_moments_plain"]

_FUNCS = {torch.float32: "eqlb_load_moments_f32",
          torch.float64: "eqlb_load_moments_f64"}
_build.count_launches("K5")


def fold_rhs(a: torch.Tensor, n_rhs: int) -> torch.Tensor:
    """Broadcast a per-patch tensor (..., P) along the folded RHS axis ->
    (..., n_rhs * P), RHS-major (a copy when n_rhs > 1)."""
    if n_rhs == 1:
        return a
    P = a.shape[-1]
    return a.unsqueeze(-2).expand(*a.shape[:-1], n_rhs, P).reshape(
        *a.shape[:-1], n_rhs * P)


def _kernel_degree(ndg: int) -> int:
    """The RT degree k of ndg = k (k + 1) / 2 DG moments, if the kernel is
    built for it (``_build.SE_KERNEL_DEGREES``); else ValueError."""
    k = (math.isqrt(1 + 8 * ndg) - 1) // 2
    if k * (k + 1) // 2 != ndg:
        raise ValueError(f"ndg = {ndg} is no RT degree's k (k + 1) / 2")
    _build.check_se_degree(k, "the load-moments kernel (K5)")
    return k


def load_moments_plain(dprT, cells, combo, J, K, signs, detJ, RhatC, T3C,
                       hatgC):
    """The moments as one-hot einsums over the six combos (see
    ``load_moments`` for the arguments)."""
    n_rhs, _, ndg, nc = dprT.shape
    n, P = cells.shape
    dt = dprT.dtype

    J = fold_rhs(J, n_rhs)  # (n, 2, 2, X)
    K = fold_rhs(K, n_rhs)
    signs = fold_rhs(signs, n_rhs)  # (n, nkeep, X)
    detJ = fold_rhs(detJ, n_rhs)  # (n, X)
    W = (fold_rhs(combo, n_rhs).unsqueeze(1) == torch.arange(
        6, device=combo.device).view(1, 6, 1)).to(dt)  # one-hot (n, 6, X)

    g = dprT.reshape(n_rhs * 3 * ndg, nc).index_select(1, cells.reshape(-1))
    g = g.reshape(n_rhs, 3, ndg, n, P).permute(1, 2, 3, 0, 4).reshape(
        3, ndg, n, n_rhs * P)
    dpg = g[:2]  # (2, ndg, n, X)
    frg = g[2]  # (ndg, n, X)

    dpJ = torch.einsum("amcx,cabx->bmcx", dpg, J)
    Fv = torch.einsum("bmcx,cqx,qmbi->cix", dpJ, W, RhatC)
    Fq = torch.einsum("mcx,cqx,qmp->cpx", frg, W, T3C)
    # grad(psi_z)_a = sum_b K[b, a] ghat_b, with ghat picked by the combo
    gpsi = torch.einsum("cbax,cqx,qb->cax", K, W, hatgC)
    Fv = Fv * torch.sign(detJ)[:, None] * signs
    contr = torch.einsum("apcx,cax->cpx", dpg, gpsi)
    Fq = (Fq + contr) * detJ.abs()[:, None]
    # the kernel's layout, which the reduced step (K6) takes
    return Fv.contiguous(), Fq.contiguous()


def _check(dprT, cells, combo, J, K, signs, detJ, RhatC, T3C, hatgC):
    if dprT.dim() != 4 or dprT.shape[1] != 3 or cells.dim() != 2:
        raise ValueError(
            f"need dprT (n_rhs, 3, ndg, nc) and cells (n, P), got "
            f"{tuple(dprT.shape)} and {tuple(cells.shape)}")
    _, _, ndg, _ = dprT.shape
    n, P = cells.shape
    nkeep = 2 * ndg
    want = {"combo": (combo, (n, P)), "J": (J, (n, 2, 2, P)),
            "K": (K, (n, 2, 2, P)), "signs": (signs, (n, nkeep, P)),
            "detJ": (detJ, (n, P)), "RhatC": (RhatC, (6, ndg, 2, nkeep)),
            "T3C": (T3C, (6, ndg, ndg)), "hatgC": (hatgC, (6, 2))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if dprT.dtype not in _FUNCS:
        raise ValueError(f"unsupported dtype {dprT.dtype}")
    floats = (dprT, J, K, signs, detJ, RhatC, T3C, hatgC)
    if any(t.dtype != dprT.dtype for t in floats):
        raise ValueError("dprT, the geometry and the reference tensors must "
                         "share a dtype")
    if cells.dtype != torch.int64 or combo.dtype != torch.int64:
        raise ValueError("cells and combo must be int64")
    if any(t.device != dprT.device for t in (cells, combo, *floats)):
        raise ValueError("all inputs must share a device")
    if not all(t.is_contiguous() for t in (cells, combo, *floats)):
        raise ValueError("all inputs must be contiguous")
    if dprT.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dprT.device}")


def load_moments(dprT, cells, combo, J, K, signs, detJ, RhatC, T3C, hatgC):
    """Canonical load moments of one bucket on the folded lane axis:
    Fv (n, nkeep, X), Fq (n, ndg, X), X = n_rhs * P.

    dprT (n_rhs, 3, ndg, nc) packs [sigma_proj rows 0/1 | rhs] per cell;
    cells, combo (n, P) int64: each patch cell's mesh cell and combo
    2 * lnode + orientation in [0, 6); J, K (n, 2, 2, P), signs
    (n, nkeep, P), detJ (n, P): the batch-last geometry; RhatC
    (6, ndg, 2, nkeep), T3C (6, ndg, ndg), hatgC (6, 2): the reference
    tensors by combo (``semiexplicit.combo_tensors``).

    CPU tensors take the plain version; CUDA tensors launch the K5 kernel
    (k in ``_build.SE_KERNEL_DEGREES``, else ValueError; counted as "K5",
    ``ops.launches``).  The kernel does not check the cell and combo ranges
    (that would cost a device sync per call): the engine builds both on the
    host."""
    _check(dprT, cells, combo, J, K, signs, detJ, RhatC, T3C, hatgC)
    if dprT.device.type == "cpu":
        profiling.annotate(route="plain")
        return load_moments_plain(dprT, cells, combo, J, K, signs, detJ,
                                  RhatC, T3C, hatgC)
    n_rhs, _, ndg, nc = dprT.shape
    k = _kernel_degree(ndg)
    n, P = cells.shape
    profiling.annotate(route="kernel")
    X = n_rhs * P
    Fv = torch.empty((n, 2 * ndg, X), dtype=dprT.dtype, device=dprT.device)
    Fq = torch.empty((n, ndg, X), dtype=dprT.dtype, device=dprT.device)
    if n == 0 or X == 0:
        return Fv, Fq
    _build.launch("K5", _FUNCS[dprT.dtype], dprT.device, *(
        t.data_ptr() for t in (dprT, cells, combo, J, K, signs, detJ, RhatC,
                               T3C, hatgC, Fv, Fq)), k, n_rhs, nc, n, P)
    return Fv, Fq
