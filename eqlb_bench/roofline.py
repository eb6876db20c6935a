"""Peaks of the card and the least time a piece of work could take on it.

``HBM_BYTES_PER_S``, ``PEAK_FLOPS``, ``bound``, ``lu_flops`` and
``lu_bound`` are a frozen copy of ``chip_smoke.py``'s.  The peaks are
NVIDIA's data sheet for the H100 SXM at its full 700 W: 3.35 TB/s of HBM3,
67 TFLOP/s in f32 outside the tensor cores and in f64 on them (DMMA).  A
card set below 700 W reaches less; every result names the card and its
power limit.

``solve_work`` counts what the problem needs, from the patch sizes the
plain reference finds: one pivot-free solve per patch (one field a
call), each input read once and each output written once.  It does not
depend on how the program chunks, pads or routes the solves.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    """Least time (ms) the card could take: the larger of the bytes over
    the HBM rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lu_flops(D: int, R: int) -> int:
    """Operations of one pivot-free solve: per elimination step, a division
    and the trailing multiply-adds of A and b; per back-substitution step,
    R dot products and divisions."""
    fwd = sum(m * (1 + 2 * m + 2 * R) for m in range(D))
    back = sum(R * (2 * m + 1) for m in range(D))
    return fwd + back


def lu_bound(D: int, R: int, X: int, dtype) -> tuple[float, str]:
    size = torch.tensor([], dtype=dtype).element_size()
    return bound((D * D + 2 * D * R) * X * size, lu_flops(D, R) * X, dtype)


def solve_work(patch_sizes, k: int, family: str,
               dtype) -> tuple[float, float]:
    """(bytes, operations) of one call's patch solves of ``family``:

    * ``"kkt"``: every patch's saddle-point system, D = nflux + n k(k+1)/2;
    * ``"reduced"``: the semi-explicit mode's solves per call, one on each
      boundary patch over its divergence-free flux space, of dimension
      D = nflux - n k(k+1)/2 (primal Dirichlet boundary: every constraint
      independent).  Interior patches apply an inverse built at set-up.

    ``patch_sizes``: (cells n, on the boundary, patches, nflux, D_kkt) per
    group, as ``Reference.patch_sizes`` gives them; R = 1, X = patches."""
    size = torch.tensor([], dtype=dtype).element_size()
    ndg = k * (k + 1) // 2
    nbytes = flops = 0
    for n, bnd, P, nflux, D_kkt in patch_sizes:
        if family == "kkt":
            D = D_kkt
        elif family == "reduced":
            if not bnd:
                continue
            D = nflux - n * ndg
        else:
            raise ValueError(f"unknown solve family {family!r}")
        nbytes += (D * D + 2 * D) * P * size
        flops += lu_flops(D, 1) * P
    return float(nbytes), float(flops)
