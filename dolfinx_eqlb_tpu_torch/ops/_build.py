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
non-zero code.
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

__all__ = ["library", "build_info", "check"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
_info: dict = {}

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
    # (flat, src, out, R, L, ndofs, nfk, stream); f64 only
    "eqlb_ds_combine_gather_f64": [_P, _P, _P, _I, _I, _I, _I, _P],
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
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
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
