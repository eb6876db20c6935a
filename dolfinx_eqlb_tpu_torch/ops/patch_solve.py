"""Batched pivot-free dense solves of the per-patch systems: K1 and K3.

Both replace the Pallas TPU kernel ``dolfinx_eqlb_tpu/ops/patch_solve.py::
_kernel`` (driver ``_solve_padded``), one per entry of it; the CUDA kernels
are in ``csrc/patch_solve.cu``, whose notes say what bounds each on the card
and how its design answers.

* K1, ``batched_kkt_solve_bl`` (entry ``batched_kkt_solve_bl``): batch-last
  A (D, D, X), the semi-explicit engine's reduced systems, by one of three
  routes that ``k1_plan`` picks from the shape.  The tile route (one
  thread per system, each block's systems staged in shared memory,
  factored once, the right-hand sides swept a column at a time in
  registers) takes D up to ``K1_TILE_MAX_D`` (``K1_TILE_MAX_D_R1`` at
  R = 1) in batches of at least ``K1_TILE_MIN_X``, large enough to fill
  the card, and the smallest boundary solves (R = 1, D up to
  ``K1_TILE_SMALL_D``) in any batch.  The block route (one thread block per system, [A | b]
  eliminated in shared memory by the whole block, one barrier a step)
  takes the rest while [A | b] fits in a block's shared memory
  (``k1_block_fits``); the global route (one thread per system,
  elimination in place in a global scratch, any D) takes what is left.
* K3, ``batched_kkt_solve`` (entry ``batched_kkt_solve``): batch-major
  A (..., P, D, D), the KKT mode's full patch systems, D + R up to 256; by
  one of four routes that ``k3_plan`` picks from the shape: for D <= 64
  the register route (each thread of a block of 8 x 16 holds a tile of
  [A | b] in registers, one barrier per elimination step), for
  D + R <= 128 the wide route (the same kernel on 16 x 16 threads), for
  D + R <= 256 the cluster route (a cluster of 2 or 4 blocks of 16 x 16
  threads holds one system in the registers of as many SMs, row j sent
  to the peers through distributed shared memory), and for what none
  covers the shared-memory route ([A | b] staged in one block's shared
  memory).  ``k3_admits``, the shapes a tiled or cluster route covers, is
  the port's size rule for the flux KKT systems.

Pivot-free LU is the contract, and it is sound for the callers' systems:
the semi-explicit engine's reduced matrices are SPD, with identity rows on
masked columns, and the KKT systems are regularised so that no pivot of
the [sigma | r] order vanishes (see ``eqlb.engine``).  The weakly-symmetric
stress systems need pivoting and do not come here.  The TPU kernel's pad of
D to a multiple of 8 and of the batch to its tile with identity systems
served Mosaic only and is not carried over.

Each wrapper takes its plain PyTorch version below only for CPU tensors;
for CUDA tensors it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import profiling
from . import _build

__all__ = ["batched_kkt_solve_bl", "batched_kkt_solve_bl_plain", "k1_plan",
           "k1_tile_threads", "k1_block_fits", "k1_block_threads",
           "K1_ROUTES", "K1_TILES", "K1_TILE_MAX_D", "K1_TILE_MAX_D_R1",
           "K1_TILE_MIN_X", "K1_TILE_SMALL_D",
           "batched_kkt_solve", "batched_kkt_solve_plain", "k3_plan",
           "k3_admits",
           "K3_REG_TILES", "K3_WIDE_TILES", "K3_CLUSTER_TILES",
           "K3_ROUTES"]

_FUNCS = {torch.float32: "eqlb_lu_solve_bl_f32",
          torch.float64: "eqlb_lu_solve_bl_f64"}
_FUNCS_BL_TILE = {torch.float32: "eqlb_lu_solve_bl_tile_f32",
                  torch.float64: "eqlb_lu_solve_bl_tile_f64"}
_FUNCS_BL_BLOCK = {torch.float32: "eqlb_lu_solve_bl_block_f32",
                   torch.float64: "eqlb_lu_solve_bl_block_f64"}
_FUNCS_BM = {torch.float32: "eqlb_lu_solve_bm_f32",
             torch.float64: "eqlb_lu_solve_bm_f64"}
_FUNCS_BM_REG = {torch.float32: "eqlb_lu_solve_bm_reg_f32",
                 torch.float64: "eqlb_lu_solve_bm_reg_f64"}
_FUNCS_BM_WIDE = {torch.float32: "eqlb_lu_solve_bm_wide_f32",
                  torch.float64: "eqlb_lu_solve_bm_wide_f64"}
_FUNCS_BM_CLUSTER = {torch.float32: "eqlb_lu_solve_bm_cluster_f32",
                     torch.float64: "eqlb_lu_solve_bm_cluster_f64"}
# dynamic shared memory one thread block can hold: D (D + R) values of
# K3's shared route, D^2 nt values of K1's tile route, D (D + R) of K1's
# block route
SMEM_LIMIT = 232448
# K1's routes: "tile" (a thread per system, systems staged in shared
# memory, the column in registers), "block" (a thread block per system,
# [A | b] in shared memory) and "global" (a thread per system, elimination
# in place in a global scratch)
K1_ROUTES = ("tile", "block", "global")
# shared memory of one H100 SM that blocks can share, what the hardware
# reserves of it per block (CUDA occupancy rules), and the SMs
_SM_SMEM, _SMEM_PER_BLOCK, _SMS = 233472, 1024, 132
# K1's tile route: dtype -> its tiles (DMAX, NT), DMAX ascending.  A
# system of D <= DMAX holds its right-hand-side column in DMAX registers,
# and a block holds NT systems (one thread each), so shared memory is
# D^2 NT values a block; a launch takes the first tile with D <= DMAX.  NT
# is set so that several blocks share an SM at the tile's smaller D.  The
# same list is EQLB_K1_TILES in csrc/patch_solve.cu; the first launch
# checks that the library was built with it.
K1_TILES = {torch.float32: ((8, 128), (16, 64), (32, 32)),
            torch.float64: ((8, 64), (16, 32), (32, 32))}
# the split: the largest D the tile route takes, by dtype, for R > 1 (the
# interior inverse builds, R = D) and for R = 1 (the boundary solves), in
# batches of at least K1_TILE_MIN_X; at R = 1 it also takes D up to
# K1_TILE_SMALL_D in a batch of any size.  The block route takes the rest.
# On the H100 (``chip_smoke.py --k1-sweep`` and phase 4, PERF.md) the tile
# route is ahead at R = D up to D = 17 in f32 and 13 in f64, at R = 1 up
# to 25 and 15, and only at X >= 16384 (measured at 1024, 4096, 16384,
# 65536 and 131072): it fills the card only with many systems, one thread
# each, while a smaller batch leaves each thread a long serial
# elimination.  At R = 1 and D <= 6 that chain is short, and the tile
# route is ahead or level at every X measured (4-131072).
K1_TILE_MAX_D = {torch.float32: 17, torch.float64: 13}
K1_TILE_MAX_D_R1 = {torch.float32: 25, torch.float64: 15}
K1_TILE_MIN_X = 16384
K1_TILE_SMALL_D = 6
# K3's register route: route name -> (MR, MC), the register tile of each
# thread of a block laid out 8 x 16 over [A | b]; a tile covers D <= 8 MR
# rows and W = D + R <= 16 MC columns.  Smallest first: k3_plan takes the
# first that covers the system.  The KKT shapes (R = 1) map 4 x 2 to
# D <= 31, 7 x 4 to D = 32-56 and 8 x 5 to D = 57-64.  The same list is
# EQLB_K3_REG_TILES in csrc/patch_solve.cu; the first launch checks that
# the library was built with it.
K3_REG_TILES = {"reg4x2": (4, 2), "reg7x4": (7, 4), "reg8x5": (8, 5)}
# K3's wide route: the same kernel on 16 x 16 threads, tiles (MR, MC)
# covering D <= 16 MR rows and W <= 16 MC columns, for the systems past
# the register tiles: at R <= 2 every D of 65-126 (the KKT systems of RT3
# on unstructured meshes, D = 75 / 90 / 105 / 120, take 5 x 5, 6 x 6,
# 7 x 7 and 8 x 8).  The same list is EQLB_K3_WIDE_TILES in
# csrc/patch_solve.cu, checked at the first launch like the register
# tiles.
K3_WIDE_TILES = {"wide5x5": (5, 5), "wide6x6": (6, 6), "wide7x7": (7, 7),
                 "wide8x8": (8, 8)}
# K3's cluster route: tiles (C, MR, MC), a cluster of C blocks of 16 x 16
# threads a system, so 16 C thread rows: a tile covers D <= 16 C MR rows
# and W <= 16 MC columns, for the systems past every block's tile
# (128 < D + R <= 256): at R = 1 the 2 x (5 x 10) tile takes D = 128-159
# (RT4's D = 130 / 156, RT3's 9- and 10-cell patches' D = 135 / 150),
# 4 x (3 x 12) D = 160-191 (RT4's 182) and 4 x (4 x 16) D = 192-255 (RT4's
# 208 / 234).  The same list is EQLB_K3_CLUSTER_TILES in
# csrc/patch_solve_cluster.cu, checked at the first launch like the others.
K3_CLUSTER_TILES = {"cluster2x5x10": (2, 5, 10), "cluster4x3x12": (4, 3, 12),
                    "cluster4x4x16": (4, 4, 16)}
K3_ROUTES = (*K3_REG_TILES, *K3_WIDE_TILES, *K3_CLUSTER_TILES, "shared")
# every tiled route, smallest first, as (thread rows a system, MR, MC): 16
# thread columns in all of them
_K3_TILES = {**{rt: (8, *t) for rt, t in K3_REG_TILES.items()},
             **{rt: (16, *t) for rt, t in K3_WIDE_TILES.items()},
             **{rt: (16 * c, mr, mc)
                for rt, (c, mr, mc) in K3_CLUSTER_TILES.items()}}


def _tile_covers(route: str, D: int, R: int) -> bool:
    rows, mr, mc = _K3_TILES[route]
    return D <= rows * mr and D + R <= 16 * mc


def k3_admits(D: int, R: int) -> bool:
    """The port's size rule for K3, which the engine's flux KKT stage
    follows: whether a tiled route (register, wide or cluster) covers
    D x D systems with R right-hand sides, that is D + R <= 256.  It owes
    nothing to the TPU's VMEM, unlike the reference's rule
    (``eqlb.engine.k3_takes``)."""
    return any(_tile_covers(route, D, R) for route in _K3_TILES)


def _shared_fits(D: int, R: int, dtype: torch.dtype) -> bool:
    return D * (D + R) * dtype.itemsize <= SMEM_LIMIT


def k3_plan(D: int, R: int, dtype: torch.dtype) -> str:
    """K3's route for D x D systems with R right-hand sides: the smallest
    register tile that covers [A | b] (``K3_REG_TILES``), else the
    smallest wide tile (``K3_WIDE_TILES``), else the smallest cluster tile
    (``K3_CLUSTER_TILES``), else ``"shared"`` (the shared-memory kernel, up
    to ``SMEM_LIMIT`` bytes of [A | b]); raises if none takes the
    system."""
    for route in _K3_TILES:
        if _tile_covers(route, D, R):
            return route
    if _shared_fits(D, R, dtype):
        return "shared"
    raise ValueError(
        f"D={D}, R={R} needs {D * (D + R) * dtype.itemsize} bytes of shared "
        f"memory per system, more than the {SMEM_LIMIT} a thread block can "
        f"hold, and no cluster tile covers D + R > 256")


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


def k1_tile_threads(D: int, dtype: torch.dtype) -> int | None:
    """Systems a block of K1's tile route holds for D x D systems: the NT
    of the first tile of ``K1_TILES[dtype]`` with D <= DMAX; None when no
    tile covers D or the block's D^2 NT values exceed a block's shared
    memory."""
    for dmax, nt in K1_TILES[dtype]:
        if D <= dmax:
            return nt if D * D * nt * dtype.itemsize <= SMEM_LIMIT else None
    return None


def k1_block_fits(D: int, R: int, dtype: torch.dtype) -> bool:
    """Whether a block of K1's block route holds the system's [A | b],
    D (D + R) values, in its shared memory."""
    return _shared_fits(D, R, dtype)


def k1_block_threads(D: int, R: int, X: int, dtype: torch.dtype) -> int:
    """Threads a block of K1's block route for X systems D x D with R
    right-hand sides: about 1,280 threads an SM shared by the blocks that
    sit on it at once (by shared memory, and no more than X spreads over
    the SMs), 128 to 512 a block (the best of 64-512 within ~10 % at every
    shape of ``chip_smoke.py --k1-sweep`` on the H100, PERF.md)."""
    tile = D * (D + R) * dtype.itemsize
    blocks = min(32, _SM_SMEM // (tile + _SMEM_PER_BLOCK),
                 -(-max(X, 1) // _SMS))
    return 32 * max(4, min(16, 40 // max(blocks, 1)))


def k1_plan(D: int, R: int, dtype: torch.dtype, X: int | None = None) -> str:
    """K1's route for X systems D x D with R right-hand sides: ``"tile"``
    up to the split (``K1_TILE_MAX_D[dtype]``, ``K1_TILE_MAX_D_R1`` at
    R = 1) at X >= ``K1_TILE_MIN_X`` (or X not given), and at R = 1 up to
    ``K1_TILE_SMALL_D`` at any X; else ``"block"`` while [A | b] fits in a
    block's shared memory (``k1_block_fits``); else ``"global"``."""
    cap = (K1_TILE_MAX_D_R1 if R == 1 else K1_TILE_MAX_D)[dtype]
    if D <= cap and (X is None or X >= K1_TILE_MIN_X) \
            or R == 1 and D <= K1_TILE_SMALL_D:
        return "tile"
    return "block" if k1_block_fits(D, R, dtype) else "global"


def batched_kkt_solve_bl(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batch-last solve: A (D, D, X), b (D, R, X) -> x (D, R, X), pivot-free.

    CPU tensors take the plain version; CUDA tensors launch the K1 kernel
    of the route ``k1_plan(D, R, dtype, X=X)`` picks.
    ``batched_kkt_solve_bl.launches`` counts the launches,
    ``batched_kkt_solve_bl.launches_by_route`` splits them."""
    return _solve_route_bl(A, b, None)


def _check_tiles(lib) -> None:
    """Raise unless the library's tile-route tiles are ``K1_TILES``."""
    global _tiles_checked
    planned = [(dtype.itemsize, dmax, nt)
               for dtype, tiles in K1_TILES.items() for dmax, nt in tiles]
    buf = (ctypes.c_int64 * (3 * len(planned) + 3))()
    n = lib.eqlb_lu_solve_bl_tiles(ctypes.addressof(buf), len(buf))
    built = [tuple(buf[3 * e:3 * e + 3]) for e in range(min(n, len(buf) // 3))]
    if n != len(planned) or built != planned:
        raise RuntimeError(
            f"the kernel library was built with tiles {built} ({n}), the "
            f"wrapper plans {planned} (bytes, DMAX, NT)")
    _tiles_checked = True


_tiles_checked = False


def _solve_route_bl(A: torch.Tensor, b: torch.Tensor, route: str | None,
                    threads: int | None = None) -> torch.Tensor:
    """``batched_kkt_solve_bl`` by ``route`` (one of ``K1_ROUTES`` that
    takes the shape; None: ``k1_plan``'s), for comparing the routes on one
    batch; ``threads`` overrides the block route's ``k1_block_threads``.
    Only the global route allocates a scratch."""
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
    D, R, X = b.shape
    if route is None:
        route = k1_plan(D, R, A.dtype, X=X)
    elif route not in K1_ROUTES:
        raise ValueError(f"unknown K1 route {route!r}; one of {K1_ROUTES}")
    elif route == "tile" and k1_tile_threads(D, A.dtype) is None:
        raise ValueError(f"K1 route 'tile' does not take D={D} in {A.dtype}")
    elif route == "block" and not k1_block_fits(D, R, A.dtype):
        raise ValueError(f"K1 route 'block' does not take D={D}, R={R} in "
                         f"{A.dtype}")
    profiling.annotate(route=route)
    if A.device.type == "cpu":
        return batched_kkt_solve_bl_plain(A, b)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    x = torch.empty_like(b)
    if X == 0 or D == 0 or R == 0:
        return x
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        lib = _build.library()
        if route == "tile":
            if not _tiles_checked:
                _check_tiles(lib)
            name = _FUNCS_BL_TILE[A.dtype]
            code = getattr(lib, name)(A.data_ptr(), b.data_ptr(),
                                      x.data_ptr(), D, R, X,
                                      k1_tile_threads(D, A.dtype), stream)
        elif route == "block":
            name = _FUNCS_BL_BLOCK[A.dtype]
            code = getattr(lib, name)(
                A.data_ptr(), b.data_ptr(), x.data_ptr(), D, R, X,
                threads or k1_block_threads(D, R, X, A.dtype), stream)
        else:
            scratch = torch.empty_like(A)
            name = _FUNCS[A.dtype]
            code = getattr(lib, name)(A.data_ptr(), b.data_ptr(),
                                      scratch.data_ptr(), x.data_ptr(),
                                      D, R, X, stream)
        _build.check(code, name)
    batched_kkt_solve_bl.launches += 1
    batched_kkt_solve_bl.launches_by_route[route] += 1
    return x


batched_kkt_solve_bl.launches = 0
batched_kkt_solve_bl.launches_by_route = dict.fromkeys(K1_ROUTES, 0)


def batched_kkt_solve_plain(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The pivot-free loop on batch-major tensors: A (..., P, D, D),
    b (..., P, D, R) -> x (..., P, D, R), leading axes folded.  Forward
    substitution is fused into the elimination, then back substitution
    follows."""
    D, R = A.shape[-1], b.shape[-1]
    A2 = A.reshape(-1, D, D).clone()
    x = b.reshape(-1, D, R).clone()
    for j in range(D):
        lcol = A2[:, j + 1:, j] / A2[:, j, j, None]  # (N, D-j-1)
        A2[:, j + 1:, j + 1:] -= lcol[:, :, None] * A2[:, j, None, j + 1:]
        x[:, j + 1:] -= lcol[:, :, None] * x[:, j, None]
    for j in reversed(range(D)):
        acc = (A2[:, j, j + 1:, None] * x[:, j + 1:]).sum(1)  # (N, R)
        x[:, j] = (x[:, j] - acc) / A2[:, j, j, None]
    return x.reshape(b.shape)


def batched_kkt_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batch-major solve: A (..., P, D, D), b (..., P, D, R) ->
    x (..., P, D, R), pivot-free; the leading axes are folded into one
    batch.

    CPU tensors take the plain version; CUDA tensors launch the K3 kernel
    of the route ``k3_plan(D, R, dtype)`` picks.
    ``batched_kkt_solve.launches`` counts the launches,
    ``batched_kkt_solve.launches_by_route`` splits them."""
    return _solve_route(A, b, None)


def _check_tile_list(query, planned: dict, what: str) -> None:
    """Raise unless ``query`` (the library's tile list of a tiled route,
    the values of each tile in a row: MR0, MC0, MR1, ... or C0, MR0, MC0,
    C1, ...) reports the tiles of ``planned``, in order."""
    tiles = list(planned.values())
    width = len(tiles[0])
    buf = (ctypes.c_int64 * (width * len(tiles) + width))()
    n = query(ctypes.addressof(buf), len(buf))
    built = [tuple(buf[width * e:width * e + width])
             for e in range(min(n, len(buf) // width))]
    if n != len(tiles) or built != tiles:
        raise RuntimeError(
            f"the kernel library was built with {what} tiles {built} "
            f"({n}), the wrapper plans {tiles}")
    _tiles_checked_k3.add(what)


def _check_reg_tiles(lib) -> None:
    """Raise unless the library's register tiles are ``K3_REG_TILES``."""
    _check_tile_list(lib.eqlb_lu_solve_bm_reg_tiles, K3_REG_TILES, "register")


def _check_wide_tiles(lib) -> None:
    """Raise unless the library's wide tiles are ``K3_WIDE_TILES``."""
    _check_tile_list(lib.eqlb_lu_solve_bm_wide_tiles, K3_WIDE_TILES, "wide")


def _check_cluster_tiles(lib) -> None:
    """Raise unless the library's cluster tiles are ``K3_CLUSTER_TILES``."""
    _check_tile_list(lib.eqlb_lu_solve_bm_cluster_tiles, K3_CLUSTER_TILES,
                     "cluster")


# the tiled routes whose tile list was held against the library
_tiles_checked_k3: set = set()


def _solve_route(A: torch.Tensor, b: torch.Tensor,
                 route: str | None) -> torch.Tensor:
    """``batched_kkt_solve`` by ``route`` (one of ``K3_ROUTES`` that takes
    the shape; None: ``k3_plan``'s), for comparing the routes on one
    batch."""
    if A.dim() < 3 or A.dim() != b.dim() or A.shape[-1] != A.shape[-2] \
            or A.shape[:-1] != b.shape[:-1]:
        raise ValueError(
            f"need A (..., P, D, D) and b (..., P, D, R), got "
            f"{tuple(A.shape)} and {tuple(b.shape)}")
    if A.dtype != b.dtype or A.device != b.device:
        raise ValueError("A and b must share dtype and device")
    if A.dtype not in _FUNCS_BM:
        raise ValueError(f"unsupported dtype {A.dtype}")
    if not (A.is_contiguous() and b.is_contiguous()):
        raise ValueError("A and b must be contiguous")
    D, R = b.shape[-2], b.shape[-1]
    if route is None:
        route = k3_plan(D, R, A.dtype)
    elif route not in K3_ROUTES:
        raise ValueError(f"unknown K3 route {route!r}; one of {K3_ROUTES}")
    elif not (_shared_fits(D, R, A.dtype) if route == "shared"
              else _tile_covers(route, D, R)):
        raise ValueError(f"K3 route {route!r} does not take D={D}, R={R}")
    profiling.annotate(route=route)
    if A.device.type == "cpu":
        return batched_kkt_solve_plain(A, b)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    N = b.numel() // max(D * R, 1)
    x = torch.empty_like(b)
    if N == 0 or D == 0 or R == 0:
        return x
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        lib = _build.library()
        if route == "shared":
            name = _FUNCS_BM[A.dtype]
            code = getattr(lib, name)(A.data_ptr(), b.data_ptr(),
                                      x.data_ptr(), N, D, R, stream)
        elif route in K3_REG_TILES:
            if "register" not in _tiles_checked_k3:
                _check_reg_tiles(lib)
            name = _FUNCS_BM_REG[A.dtype]
            code = getattr(lib, name)(A.data_ptr(), b.data_ptr(),
                                      x.data_ptr(), N, D, R,
                                      *K3_REG_TILES[route], stream)
        elif route in K3_WIDE_TILES:
            if "wide" not in _tiles_checked_k3:
                _check_wide_tiles(lib)
            name = _FUNCS_BM_WIDE[A.dtype]
            code = getattr(lib, name)(A.data_ptr(), b.data_ptr(),
                                      x.data_ptr(), N, D, R,
                                      *K3_WIDE_TILES[route], stream)
        else:
            if "cluster" not in _tiles_checked_k3:
                _check_cluster_tiles(lib)
            name = _FUNCS_BM_CLUSTER[A.dtype]
            code = getattr(lib, name)(A.data_ptr(), b.data_ptr(),
                                      x.data_ptr(), N, D, R,
                                      *K3_CLUSTER_TILES[route], stream)
        _build.check(code, name)
    batched_kkt_solve.launches += 1
    batched_kkt_solve.launches_by_route[route] += 1
    return x


batched_kkt_solve.launches = 0
batched_kkt_solve.launches_by_route = dict.fromkeys(K3_ROUTES, 0)
