"""K2: the global dof combine as one fused gather.

Replaces the Pallas TPU kernel ``dolfinx_eqlb_tpu/ops/lane_select.py::_kernel``
(driver ``_run``) and the 128-lane row gather that fed it
(``eqlb/engine.py::_row_gather_select``): together they gave each global dof
the sum of its 2-3 patch contributions.  The CUDA kernel is
``csrc/lane_select.cu``; its header says what bounds it on the card (memory
traffic: scattered element reads) and how the design answers (read the
elements directly, one thread per output; the TPU's whole-row fetch is
wasted traffic on a GPU).

``combine_gather`` takes the plain PyTorch version below only for CPU
tensors; for CUDA tensors it launches the kernel or raises.  Both keep the
reference's summation order, so they agree bitwise.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["combine_gather", "combine_gather_plain"]

_FUNCS = {torch.float32: "eqlb_combine_gather_f32",
          torch.float64: "eqlb_combine_gather_f64"}


def combine_gather_plain(flat: torch.Tensor, src: torch.Tensor,
                         nfk: int) -> torch.Tensor:
    """out[r, d] = (flat[r, src[d, 0]] + flat[r, src[d, 1]])
    + flat[r, src[d, 2]], the third term only for d >= nfk."""
    x = flat.index_select(1, src[:, 0]) + flat.index_select(1, src[:, 1])
    x[:, nfk:] += flat.index_select(1, src[nfk:, 2])
    return x


def combine_gather(flat: torch.Tensor, src: torch.Tensor,
                   nfk: int) -> torch.Tensor:
    """flat (R, L) float, src (ndofs, 3) int32 flat positions in [0, L)
    (absent contributors point at a slot that holds zero), nfk = number of
    facet dofs (2 contributors; the rest have 3) -> out (R, ndofs).

    CPU tensors take the plain version; CUDA tensors launch the K2 kernel
    (``combine_gather.launches`` counts the launches).  The kernel does not
    check the index range (that would cost a device sync per call): callers
    build ``src`` on the host and check it there."""
    if flat.dim() != 2 or src.dim() != 2 or src.shape[1] != 3:
        raise ValueError(
            f"need flat (R, L) and src (ndofs, 3), got {tuple(flat.shape)} "
            f"and {tuple(src.shape)}")
    if src.dtype != torch.int32:
        raise ValueError(f"src must be int32, got {src.dtype}")
    if flat.device != src.device:
        raise ValueError("flat and src must share a device")
    ndofs = src.shape[0]
    if not 0 <= nfk <= ndofs:
        raise ValueError(f"nfk={nfk} outside [0, {ndofs}]")
    if flat.dtype not in _FUNCS:
        raise ValueError(f"unsupported dtype {flat.dtype}")
    if not (flat.is_contiguous() and src.is_contiguous()):
        raise ValueError("flat and src must be contiguous")
    if flat.device.type == "cpu":
        return combine_gather_plain(flat, src, nfk)
    if flat.device.type != "cuda":
        raise ValueError(f"unsupported device {flat.device}")
    R, L = flat.shape
    out = torch.empty((R, ndofs), dtype=flat.dtype, device=flat.device)
    if R == 0 or ndofs == 0:
        return out
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = getattr(_build.library(), _FUNCS[flat.dtype])
        _build.check(fn(flat.data_ptr(), src.data_ptr(), out.data_ptr(),
                        R, L, ndofs, nfk, stream), _FUNCS[flat.dtype])
    combine_gather.launches += 1
    return out


combine_gather.launches = 0
