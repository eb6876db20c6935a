"""nvcc build and ctypes loader for the hand-written CUDA kernels in ``csrc/``.

Every ``csrc/*.cu`` file is compiled for Hopper (``sm_90a``), one nvcc per
source, all started together, and the objects are linked into ONE shared
library with a plain C interface, at first use, into the package's
git-ignored ``_build/`` directory.  The library name carries a hash of the
sources and flags, so an edit rebuilds and a stale library is never loaded.
Nothing here runs at import time: the CPU test-suite imports every module
on a machine without nvcc or a card.

Each C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()`` as an int; :func:`check` raises on a
non-zero code.  The wrappers launch through :func:`launch`, which also
counts each launch by kernel (``K1``-``K6``) and, where a kernel has them,
by route or epilogue: a wrapper registers its kernel at import
(:func:`count_launches`), and :func:`launches` / :func:`reset_launches`
read and zero every count at once.  A captured CUDA graph launches its
kernels without a call to :func:`launch`: its capture takes the counts of
the block it captured (:func:`launch_counts`), and each replay adds them
again (:func:`add_launches`).  ``SE_KERNEL_DEGREES`` is the one rule
for the RT degrees the semi-explicit stage's kernels take.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

__all__ = ["library", "build_info", "check", "launch", "count_launches",
           "launches", "reset_launches", "launch_counts", "add_launches",
           "SE_KERNEL_DEGREES", "check_se_degree"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
_info: dict = {}
# symbol name -> its ctypes function, filled when the library loads
_symbols: dict = {}
# kernel ("K1".."K6") -> its launches by split: K1's and K3's routes, K6's
# epilogues, or the one split None of a kernel counted whole
_launches: dict[str, dict] = {}

# the RT degrees the semi-explicit stage's kernels (K5, K6) are built for:
# past k = 4 K5's reference tensors outgrow a block's static shared
# memory.  The degree switches of csrc/load_moments.cu and
# csrc/reduced_step.cu instantiate the same k.
SE_KERNEL_DEGREES = (1, 2, 3, 4)

_P = ctypes.c_void_p
_I = ctypes.c_int64
# name -> argtypes; a float and a double instantiation of each kernel but
# the double-single combine, which exists for f64 only
_SIGNATURES = {
    # (A, b, As scratch, x, D, R, X, stream)
    "eqlb_lu_solve_bl_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
    "eqlb_lu_solve_bl_f64": [_P, _P, _P, _P, _I, _I, _I, _P],
    # (A, b, x, D, R, X, nt, stream): K1's tile route, nt systems a block
    "eqlb_lu_solve_bl_tile_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    "eqlb_lu_solve_bl_tile_f64": [_P, _P, _P, _I, _I, _I, _I, _P],
    # (out, cap): the tile route's built tiles, BYTES0, DMAX0, NT0, ...
    "eqlb_lu_solve_bl_tiles": [_P, _I],
    # (A, b, x, D, R, X, threads, stream): K1's block route, a block of
    # threads per system
    "eqlb_lu_solve_bl_block_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    "eqlb_lu_solve_bl_block_f64": [_P, _P, _P, _I, _I, _I, _I, _P],
    # (flat, src, out, R, L, ndofs, nfk, stream)
    "eqlb_combine_gather_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    "eqlb_combine_gather_f64": [_P, _P, _P, _I, _I, _I, _I, _P],
    # (A, b, x, N, D, R, stream)
    "eqlb_lu_solve_bm_f32": [_P, _P, _P, _I, _I, _I, _P],
    "eqlb_lu_solve_bm_f64": [_P, _P, _P, _I, _I, _I, _P],
    # (A, b, x, N, D, R, MR, MC, stream): K3's register route, tile MR x MC
    "eqlb_lu_solve_bm_reg_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "eqlb_lu_solve_bm_reg_f64": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # (out, cap): the register route's built tiles, MR0, MC0, MR1, ...
    "eqlb_lu_solve_bm_reg_tiles": [_P, _I],
    # (A, b, x, N, D, R, MR, MC, stream): K3's wide route (16 x 16 threads)
    "eqlb_lu_solve_bm_wide_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "eqlb_lu_solve_bm_wide_f64": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # (out, cap): the wide route's built tiles, MR0, MC0, MR1, ...
    "eqlb_lu_solve_bm_wide_tiles": [_P, _I],
    # (A, b, x, N, D, R, C, MR, MC, stream): K3's cluster route, C CTAs a
    # system (f32: MR x MC values a thread; f64: MR row blocks, 16 MC
    # columns)
    "eqlb_lu_solve_bm_cluster_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "eqlb_lu_solve_bm_cluster_f64": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # (out, cap): the cluster route's built tiles, BYTES0, C0, MR0, MC0,
    # BYTES1, ...
    "eqlb_lu_solve_bm_cluster_tiles": [_P, _I],
    # (flat, src, out, R, L, ndofs, nfk, stream); f64 only
    "eqlb_ds_combine_gather_f64": [_P, _P, _P, _I, _I, _I, _I, _P],
    # (dprT, cells, combo, J, K, signs, detJ, RhatC, T3C, hatgC, Fv, Fq,
    #  k, n_rhs, nc, n, P, stream)
    "eqlb_load_moments_f32": [*[_P] * 12, _I, _I, _I, _I, _I, _P],
    "eqlb_load_moments_f64": [*[_P] * 12, _I, _I, _I, _I, _I, _P],
    # (sp, Fv, Mc, patch_idx, ucols, exit_idx, cumalpha, sel, Ainv, bz,
    #  k, n, ns, Dz, n_rhs, P, Mc's c / i / b strides, stream)
    "eqlb_reduced_step_f32": [*[_P] * 10, *[_I] * 9, _P],
    "eqlb_reduced_step_f64": [*[_P] * 10, *[_I] * 9, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[str]:
    srcs = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources in {_CSRC}")
    return srcs


def _library_path(srcs: list[str]) -> str:
    h = hashlib.sha1(" ".join(_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD, f"libeqlbkernels-{h.hexdigest()[:12]}.so")


def _compile(srcs: list[str], path: str) -> str:
    """Compile every source with its own nvcc process, all at once, link
    the objects into ``path`` (atomic rename) and return the compilers'
    output."""
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs = [f"{tmp}.{i}.o" for i in range(len(srcs))]
    try:
        procs = [subprocess.Popen([nvcc, *_FLAGS, "-c", "-o", obj, src],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(srcs, objs)]
        outs = [proc.communicate()[0] for proc in procs]
        for src, proc, out in zip(srcs, procs, outs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{out}")
        res = subprocess.run([nvcc, *_ARCH, "-shared", "-o", tmp, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + res.stdout + res.stderr)
        os.replace(tmp, path)
        return "".join(outs) + res.stdout + res.stderr
    finally:
        for name in (tmp, *objs):
            if os.path.exists(name):
                os.remove(name)


def library():
    """The loaded kernel library (built on first call); raises if nvcc is
    missing or the build fails — there is no fallback."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        path = _library_path(srcs)
        t0 = time.perf_counter()
        built = not os.path.exists(path)
        log = _compile(srcs, path) if built else ""
        lib = ctypes.CDLL(path)
        symbols = {}
        for name, argtypes in _SIGNATURES.items():
            fn = symbols[name] = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _symbols.update(symbols)
        _info.update(path=path, built=built,
                     seconds=time.perf_counter() - t0, log=log)
        _lib = lib
        return _lib


def build_info() -> dict:
    """Path, whether this process compiled it, seconds and the compiler's
    (ptxas -v) output of the last :func:`library` load."""
    return dict(_info)


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def launch(kernel: str, symbol: str, device, *args, split=None) -> None:
    """Call the library's ``symbol`` with ``args`` and the current stream of
    ``device`` appended, raise on a non-zero code, and count one launch of
    ``kernel`` (under ``split``, its route or epilogue)."""
    if not _symbols:
        library()
    with torch.cuda.device(device):
        code = _symbols[symbol](*args, torch.cuda.current_stream().cuda_stream)
    check(code, symbol)
    _launches[kernel][split] += 1


def count_launches(kernel: str, splits=(None,)) -> None:
    """Register ``kernel``'s launch count, split by ``splits`` (routes or
    epilogues; a kernel counted whole has none)."""
    _launches[kernel] = dict.fromkeys(splits, 0)


def launches(split: bool = False) -> dict:
    """Every registered kernel's launches since the last reset: kernel ->
    total; with ``split``, kernel -> {split: launches} for the kernels
    counted by route or epilogue."""
    counts = sorted(_launches.items())
    if split:
        return {k: dict(c) for k, c in counts if None not in c}
    return {k: sum(c.values()) for k, c in counts}


def reset_launches() -> None:
    """Zero every registered kernel's launch counts."""
    for counts in _launches.values():
        for s in counts:
            counts[s] = 0


def launch_counts(since: dict | None = None) -> dict:
    """Every registered kernel's counts by split, kernel -> {split: n}: as
    they stand, or those added since the counts ``since`` were taken."""
    return {k: {s: n - (since[k][s] if since else 0) for s, n in c.items()}
            for k, c in _launches.items()}


def add_launches(counts: dict) -> None:
    """Add ``counts`` (as :func:`launch_counts` gives them) to the
    registry: the launches of one replay of a captured block."""
    for k, c in counts.items():
        for s, n in c.items():
            _launches[k][s] += n


def check_se_degree(k: int, what: str, hint: str = "") -> None:
    """Raise ValueError unless ``SE_KERNEL_DEGREES`` holds RT degree ``k``;
    the message names ``what`` refuses it, then ``hint``."""
    if k not in SE_KERNEL_DEGREES:
        raise ValueError(f"{what} takes RT degree {SE_KERNEL_DEGREES[0]}-"
                         f"{SE_KERNEL_DEGREES[-1]}, not {k}{hint}")
