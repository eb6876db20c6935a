"""K1: batched pivot-free dense solve of the per-patch systems, batch-last.

Replaces the Pallas TPU kernel ``dolfinx_eqlb_tpu/ops/patch_solve.py::_kernel``
(driver ``_solve_padded``, entry ``batched_kkt_solve_bl``).  The CUDA kernel
is ``csrc/patch_solve.cu``; its header says what bounds it on the card (memory
traffic: O(D^3) work on O(D^2) values per system) and how the design answers
(one thread per system, batch-last so every access coalesces).

Pivot-free LU is the contract, and it is sound for the callers' systems:
the semi-explicit engine's reduced matrices are SPD, with identity rows on
masked columns.  The weakly-symmetric stress systems need pivoting and do
not come here.

``batched_kkt_solve_bl`` takes the plain PyTorch version below only for CPU
tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["batched_kkt_solve_bl", "batched_kkt_solve_bl_plain"]

_FUNCS = {torch.float32: "eqlb_lu_solve_bl_f32",
          torch.float64: "eqlb_lu_solve_bl_f64"}


def batched_kkt_solve_bl_plain(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's pivot-free loop on tensors: A (D, D, X), b (D, R, X) ->
    x (D, R, X).  Forward substitution is fused into the elimination, then
    back substitution follows."""
    D = A.shape[0]
    A = A.clone()
    x = b.clone()
    for j in range(D):
        lcol = A[j + 1:, j] / A[j, j]  # (D-j-1, X)
        A[j + 1:, j + 1:] -= lcol[:, None] * A[j, None, j + 1:]
        x[j + 1:] -= lcol[:, None] * x[j, None]
    for j in reversed(range(D)):
        acc = (A[j, j + 1:, None] * x[j + 1:]).sum(0)  # (R, X)
        x[j] = (x[j] - acc) / A[j, j]
    return x


def batched_kkt_solve_bl(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batch-last solve: A (D, D, X), b (D, R, X) -> x (D, R, X), pivot-free.

    CPU tensors take the plain version; CUDA tensors launch the K1 kernel
    (``batched_kkt_solve_bl.launches`` counts the launches)."""
    if A.dim() != 3 or b.dim() != 3 or A.shape[0] != A.shape[1] \
            or b.shape[0] != A.shape[0] or b.shape[2] != A.shape[2]:
        raise ValueError(
            f"need A (D, D, X) and b (D, R, X), got {tuple(A.shape)} and "
            f"{tuple(b.shape)}")
    if A.dtype != b.dtype or A.device != b.device:
        raise ValueError("A and b must share dtype and device")
    if A.dtype not in _FUNCS:
        raise ValueError(f"unsupported dtype {A.dtype}")
    if not (A.is_contiguous() and b.is_contiguous()):
        raise ValueError("A and b must be contiguous")
    if A.device.type == "cpu":
        return batched_kkt_solve_bl_plain(A, b)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    D, R, X = b.shape
    x = torch.empty_like(b)
    if X == 0 or D == 0 or R == 0:
        return x
    scratch = torch.empty_like(A)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = getattr(_build.library(), _FUNCS[A.dtype])
        _build.check(fn(A.data_ptr(), b.data_ptr(), scratch.data_ptr(),
                        x.data_ptr(), D, R, X, stream), _FUNCS[A.dtype])
    batched_kkt_solve_bl.launches += 1
    return x


batched_kkt_solve_bl.launches = 0
