"""The f32 matmul precision that the engine and the multigrid V-cycle pin."""

from __future__ import annotations

from contextlib import contextmanager

import torch

__all__ = ["full_f32_matmul"]


@contextmanager
def full_f32_matmul():
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
