"""The global dof combine as one fused gather: K2 and K4.

* K2, ``combine_gather``, replaces the Pallas TPU kernel
  ``dolfinx_eqlb_tpu/ops/lane_select.py::_kernel`` (driver ``_run``) and the
  128-lane row gather that fed it (``eqlb/engine.py::_row_gather_select``):
  together they gave each global dof the sum of its 2-3 patch
  contributions.
* K4, ``ds_combine_gather``, replaces the double-single variant
  ``_kernel_ds`` (driver ``_run_ds``) with its row gather and the f64
  reconstruction around it (``eqlb/engine.py::_ds_combine``): the same sum
  for f64 solutions, taken over (hi, lo) f32 splits with a 2Sum-compensated
  hi sum.

The CUDA kernels are in ``csrc/lane_select.cu``; its notes say what bounds
them on the card (memory traffic: scattered element reads) and how the
design answers (read the elements directly, one thread per output; the
TPU's whole-row fetch and its f32 lane-pair packing of f64 values are
wasted traffic on a GPU).

Each wrapper takes its plain PyTorch version below only for CPU tensors;
for CUDA tensors it launches its kernel or raises.  Kernel and plain
version do the same operations in the same order, so they agree bitwise.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["combine_gather", "combine_gather_plain", "ds_combine_gather",
           "ds_combine_gather_plain"]

_FUNCS = {torch.float32: "eqlb_combine_gather_f32",
          torch.float64: "eqlb_combine_gather_f64"}
_build.count_launches("K2")
_build.count_launches("K4")


def combine_gather_plain(flat: torch.Tensor, src: torch.Tensor,
                         nfk: int) -> torch.Tensor:
    """out[r, d] = (flat[r, src[d, 0]] + flat[r, src[d, 1]])
    + flat[r, src[d, 2]], the third term only for d >= nfk."""
    x = flat.index_select(1, src[:, 0]) + flat.index_select(1, src[:, 1])
    x[:, nfk:] += flat.index_select(1, src[nfk:, 2])
    return x


def _check_tables(flat, src, nfk, dtypes):
    if flat.dim() != 2 or src.dim() != 2 or src.shape[1] != 3:
        raise ValueError(
            f"need flat (R, L) and src (ndofs, 3), got {tuple(flat.shape)} "
            f"and {tuple(src.shape)}")
    if src.dtype != torch.int32:
        raise ValueError(f"src must be int32, got {src.dtype}")
    if flat.device != src.device:
        raise ValueError("flat and src must share a device")
    if not 0 <= nfk <= src.shape[0]:
        raise ValueError(f"nfk={nfk} outside [0, {src.shape[0]}]")
    if flat.dtype not in dtypes:
        raise ValueError(f"unsupported dtype {flat.dtype}")
    if not (flat.is_contiguous() and src.is_contiguous()):
        raise ValueError("flat and src must be contiguous")
    if flat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {flat.device}")


def _launch(kernel, name, flat, src, nfk):
    R, L = flat.shape
    ndofs = src.shape[0]
    out = torch.empty((R, ndofs), dtype=flat.dtype, device=flat.device)
    if R == 0 or ndofs == 0:
        return out
    _build.launch(kernel, name, flat.device, flat.data_ptr(), src.data_ptr(),
                  out.data_ptr(), R, L, ndofs, nfk)
    return out


def combine_gather(flat: torch.Tensor, src: torch.Tensor,
                   nfk: int) -> torch.Tensor:
    """flat (R, L) float, src (ndofs, 3) int32 flat positions in [0, L)
    (absent contributors point at a slot that holds zero), nfk = number of
    facet dofs (2 contributors; the rest have 3) -> out (R, ndofs).

    CPU tensors take the plain version; CUDA tensors launch the K2 kernel
    (counted as "K2", ``ops.launches``).  The kernel does not check the
    index range (that would cost a device sync per call): callers build
    ``src`` on the host and check it there."""
    _check_tables(flat, src, nfk, _FUNCS)
    if flat.device.type == "cpu":
        return combine_gather_plain(flat, src, nfk)
    return _launch("K2", _FUNCS[flat.dtype], flat, src, nfk)


def _split_ds(v: torch.Tensor):
    """f64 -> (hi, lo) f32 with hi = f32(v), lo = f32(v - hi)."""
    hi = v.float()
    return hi, (v - hi.double()).float()


def ds_combine_gather_plain(flat: torch.Tensor, src: torch.Tensor,
                            nfk: int) -> torch.Tensor:
    """The double-single combine on tensors, f64 flat (R, L) -> (R, ndofs):
    the 2Sum-compensated f32 sum of contributors 0 and 1, reconstructed in
    f64, plus a cell dof's third contributor added in f64."""
    h0, l0 = _split_ds(flat.index_select(1, src[:, 0]))
    h1, l1 = _split_ds(flat.index_select(1, src[:, 1]))
    s = h0 + h1  # Knuth 2Sum: s + err == h0 + h1 exactly
    bb = s - h0
    err = (h0 - (s - bb)) + (h1 - bb)
    lo = (l0 + l1) + err
    x = s.double() + lo.double()
    h2, l2 = _split_ds(flat.index_select(1, src[nfk:, 2]))
    x[:, nfk:] += h2.double() + l2.double()
    return x


def ds_combine_gather(flat: torch.Tensor, src: torch.Tensor,
                      nfk: int) -> torch.Tensor:
    """Double-single combine: ``combine_gather``'s contract for f64 flat,
    with the contributor sum taken as the reference's double-single route
    takes it (see ``ds_combine_gather_plain``).

    CPU tensors take the plain version; CUDA tensors launch the K4 kernel
    (counted as "K4", ``ops.launches``)."""
    _check_tables(flat, src, nfk, (torch.float64,))
    if flat.device.type == "cpu":
        return ds_combine_gather_plain(flat, src, nfk)
    return _launch("K4", "eqlb_ds_combine_gather_f64", flat, src, nfk)
