"""Plain versions of the port's kernels against the JAX package's Pallas
kernels (run in interpret mode off the TPU, as the JAX package's own tests
run them): K1 and K3, the batch-last and batch-major pivot-free solves, and
K2 and K4, the dof combine and its double-single variant; and the route
plans of K1 and K3, with the checks of the tables they share with C.  The CUDA kernels
themselves run only on the card; ``chip_smoke.py`` holds them against these
plain versions there."""

import ctypes
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dolfinx_eqlb_tpu.eqlb.engine import EqlbEngine as JaxEngine
from dolfinx_eqlb_tpu.eqlb.patches import build_patches as jax_patches
from dolfinx_eqlb_tpu.fem import FunctionSpace as JaxSpace
from dolfinx_eqlb_tpu.mesh import unit_square as jax_unit_square
from dolfinx_eqlb_tpu.ops.patch_solve import batched_kkt_solve as jax_k3
from dolfinx_eqlb_tpu.ops.patch_solve import batched_kkt_solve_bl as jax_k1

from dolfinx_eqlb_tpu_torch.ops.lane_select import (
    combine_gather, combine_gather_plain, ds_combine_gather,
    ds_combine_gather_plain,
)
import dolfinx_eqlb_tpu_torch.eqlb.engine as port_engine
from dolfinx_eqlb_tpu_torch.eqlb.engine import EqlbEngine, k3_admits, k3_takes
from dolfinx_eqlb_tpu_torch.eqlb.patches import build_patches
from dolfinx_eqlb_tpu_torch.fem import FunctionSpace
from dolfinx_eqlb_tpu_torch.mesh import unit_square, unit_square_unstructured
from dolfinx_eqlb_tpu_torch.ops.patch_solve import (
    K1_ROUTES, K1_TILE_MAX_D, K1_TILE_MAX_D_R1, K1_TILE_MIN_X,
    K1_TILE_SMALL_D, K1_TILES,
    K3_REG_TILES, K3_WIDE_TILES, SMEM_LIMIT, _check_reg_tiles, _check_tiles,
    _check_wide_tiles, _solve_route,
    _solve_route_bl, batched_kkt_solve, batched_kkt_solve_bl,
    batched_kkt_solve_bl_plain, batched_kkt_solve_plain, k1_block_fits,
    k1_block_threads, k1_plan, k1_tile_threads, k3_plan,
)

torch.set_num_threads(2)


def _spd_batch(D, R, X, seed):
    """Random SPD systems, batch-last: A (D, D, X), b (D, R, X)."""
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(X, D, D))
    A = B @ np.swapaxes(B, 1, 2) + D * np.eye(D)
    b = rng.normal(size=(X, D, R))
    return (np.ascontiguousarray(np.moveaxis(A, 0, -1)),
            np.ascontiguousarray(np.moveaxis(b, 0, -1)))


@pytest.mark.parametrize("D", [4, 6, 9, 13, 15, 25, 28, 37, 49])
@pytest.mark.parametrize("rhs", ["one", "square"])
def test_k1_plain_matches_pallas_and_linalg(D, rhs):
    """D = 4-9 are RT2's system sizes, 13, 15 and 25 RT3's, 28, 37 and 49
    RT4's (the block route's); R = D is the interior inverse build, R = 1
    a boundary solve."""
    R = 1 if rhs == "one" else D
    A, b = _spd_batch(D, R, 200 if D <= 25 else 64, seed=D * 10 + R)
    x_jax = np.asarray(jax_k1(jnp.asarray(A, jnp.float64),
                              jnp.asarray(b, jnp.float64)))
    At = torch.tensor(A, dtype=torch.float64)
    bt = torch.tensor(b, dtype=torch.float64)
    x_plain = batched_kkt_solve_bl_plain(At, bt).numpy()
    x_lin = torch.linalg.solve(At.permute(2, 0, 1),
                               bt.permute(2, 0, 1)).permute(1, 2, 0).numpy()
    scale = np.abs(x_jax).max()
    assert np.abs(x_plain - x_jax).max() <= 1e-12 * scale
    assert np.abs(x_plain - x_lin).max() <= 1e-12 * scale


def test_k1_wrapper_on_cpu_is_the_plain_version():
    A, b = _spd_batch(5, 5, 64, seed=1)
    At, bt = torch.tensor(A), torch.tensor(b)
    before = batched_kkt_solve_bl.launches
    torch.testing.assert_close(batched_kkt_solve_bl(At, bt),
                               batched_kkt_solve_bl_plain(At, bt),
                               rtol=0, atol=0)
    assert batched_kkt_solve_bl.launches == before  # no kernel launch on CPU


def test_k1_wrapper_rejects_bad_shapes():
    A = torch.zeros(4, 4, 8, dtype=torch.float64)
    with pytest.raises(ValueError):
        batched_kkt_solve_bl(A, torch.zeros(3, 1, 8, dtype=torch.float64))
    with pytest.raises(ValueError):
        batched_kkt_solve_bl(A, torch.zeros(4, 1, 8, dtype=torch.float32))
    with pytest.raises(ValueError):  # the kernel needs contiguous operands
        batched_kkt_solve_bl(A.transpose(0, 1),
                             torch.zeros(4, 1, 8, dtype=torch.float64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rhs", ["one", "square"])
def test_k1_plan_covers_every_size(rhs, dtype):
    """Every D from 1 to 128, at a large batch (X = 131072, or X not
    given) and a small one, has a route: "tile" exactly up to the split
    (``K1_TILE_MAX_D``, ``K1_TILE_MAX_D_R1`` at R = 1) at X >=
    ``K1_TILE_MIN_X`` and at R = 1 up to ``K1_TILE_SMALL_D`` at any X,
    "block" exactly where the tile route does not take
    the system and [A | b] fits in a block's shared memory, "global" only
    beyond that.  The tile of D is the first of ``K1_TILES`` whose DMAX
    covers D, its NT a multiple of 32, and a block of NT systems fits in
    shared memory; the block route's threads are 128-512, whole warps."""
    split = (K1_TILE_MAX_D_R1 if rhs == "one" else K1_TILE_MAX_D)[dtype]
    assert split <= K1_TILES[dtype][-1][0]
    for D in range(1, 129):
        R = 1 if rhs == "one" else D
        fits = D * (D + R) * dtype.itemsize <= SMEM_LIMIT
        assert k1_block_fits(D, R, dtype) == fits
        for X in (None, 131072, K1_TILE_MIN_X, K1_TILE_MIN_X - 1, 70):
            route = k1_plan(D, R, dtype, X=X)
            assert route in K1_ROUTES
            tile = (D <= split and (X is None or X >= K1_TILE_MIN_X)
                    or R == 1 and D <= K1_TILE_SMALL_D)
            assert (route == "tile") == tile, (D, X, route)
            assert (route == "block") == (not tile and fits), (D, X, route)
            assert (route == "global") == (not tile and not fits)
            if route == "tile":
                dmax, nt = next(t for t in K1_TILES[dtype] if D <= t[0])
                assert k1_tile_threads(D, dtype) == nt
                assert nt % 32 == 0 and 32 <= nt <= 256
                assert D * D * nt * dtype.itemsize <= SMEM_LIMIT
            if route == "block":
                threads = k1_block_threads(D, R, X or 131072, dtype)
                assert threads % 32 == 0 and 128 <= threads <= 512
        # the callers' form, without X, plans as a large batch
        assert k1_plan(D, R, dtype) == k1_plan(D, R, dtype, X=131072)
    # the block route's shared-memory limit: R = D up to 120 in f64 and
    # 170 in f32, R = 1 up to 169 and 240
    top = {torch.float32: (170, 240), torch.float64: (120, 169)}[dtype]
    D = top[0] if rhs == "square" else top[1]
    R = D if rhs == "square" else 1
    assert k1_plan(D, R, dtype) == "block"
    assert k1_plan(D + 1, R + (rhs == "square"), dtype) == "global"


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("mesh", ["crossed", "unstructured"])
def test_k1_plan_takes_engine_shapes(mesh, k):
    """The K1 shapes of the engine's buckets on the engine tests' meshes
    (interior inverse builds R = D, boundary solves R = 1) map as the plan
    says, in f32 and f64: every one of RT1-RT3 (D <= 25) to the tile route
    in a large batch where it is under the split, every one of RT4 (D up
    to 49) above the split to the block route; and at the meshes' own
    small batches every one to the block route but the smallest boundary
    solves (R = 1, D <= ``K1_TILE_SMALL_D``), which keep the tile route."""
    msh = unit_square(3) if mesh == "crossed" else unit_square_unstructured(4)
    eng = EqlbEngine(FunctionSpace(msh, "RT", k), build_patches(msh),
                     dtype=torch.float64, device="cpu")
    shapes = {(eng.se_static[key]["Dz"],
               1 if b.is_boundary else eng.se_static[key]["Dz"],
               eng.tables[key]["gdofs"].shape[0])
              for key, b in eng.buckets.items()}
    assert max(D for D, _, _ in shapes) == {1: 1, 2: 9, 3: 25, 4: 49}[k]
    for D, R, X in shapes:
        assert X < K1_TILE_MIN_X
        for dtype in (torch.float32, torch.float64):
            split = (K1_TILE_MAX_D_R1 if R == 1 else K1_TILE_MAX_D)[dtype]
            want = "tile" if D <= split else "block"
            assert k1_plan(D, R, dtype) == want, (D, R, dtype)
            small = "tile" if R == 1 and D <= K1_TILE_SMALL_D else "block"
            assert k1_plan(D, R, dtype, X=X) == small, (D, R, X, dtype)
    if k == 4:
        assert (49, 49) in {(D, R) for D, R, _ in shapes}


def test_k1_wrapper_routes_on_cpu():
    """On CPU tensors every route that takes the shape is the plain
    version, bitwise, and launches nothing; a route that cannot take the
    shape, or an unknown one, raises."""
    A, b = _spd_batch(7, 3, 40, seed=6)
    At, bt = torch.tensor(A), torch.tensor(b)
    before = dict(batched_kkt_solve_bl.launches_by_route)
    ref = batched_kkt_solve_bl_plain(At, bt)
    for route in (*K1_ROUTES, None):
        torch.testing.assert_close(_solve_route_bl(At, bt, route), ref,
                                   rtol=0, atol=0)
    for threads in (128, 512):  # the block route's threads do not matter
        torch.testing.assert_close(_solve_route_bl(At, bt, "block", threads),
                                   ref, rtol=0, atol=0)
    for dtype in (torch.float32, torch.float64):
        # above the tile split: block, by plan; past the block route's
        # shared memory: global
        for D, R, plan in ((K1_TILE_MAX_D_R1[dtype] + 1, 1, "block"),
                           ({torch.float32: 171,
                             torch.float64: 121}[dtype], None, "global")):
            R = R or D
            Ab = torch.eye(D, dtype=dtype)[:, :, None].repeat(1, 1, 3)
            bb = torch.ones(D, R, 3, dtype=dtype)
            assert k1_plan(D, R, dtype) == plan
            routes = [rt for rt in K1_ROUTES
                      if (rt != "tile" or k1_tile_threads(D, dtype))
                      and (rt != "block" or k1_block_fits(D, R, dtype))]
            assert plan in routes
            for route in (*routes, None):
                torch.testing.assert_close(_solve_route_bl(Ab, bb, route), bb,
                                           rtol=0, atol=0)
    assert batched_kkt_solve_bl.launches_by_route == before
    # no tile covers D = 33; at D = 31 a block of 32 f64 systems exceeds
    # a block's shared memory
    for D, dtype in ((33, torch.float32), (31, torch.float64)):
        assert k1_tile_threads(D, dtype) is None
        with pytest.raises(ValueError):
            _solve_route_bl(torch.eye(D, dtype=dtype)[:, :, None],
                            torch.ones(D, 1, 1, dtype=dtype), "tile")
    # [A | b] of D = 121, R = D in f64 exceeds a block's shared memory
    with pytest.raises(ValueError):
        _solve_route_bl(torch.eye(121, dtype=torch.float64)[:, :, None],
                        torch.ones(121, 121, 1, dtype=torch.float64), "block")
    with pytest.raises(ValueError):
        _solve_route_bl(At, bt, "shared")


class _K1TileLib:
    """Stands in for the kernel library's tile-route table query."""

    def __init__(self, tiles):
        self.tiles = tiles

    def eqlb_lu_solve_bl_tiles(self, addr, cap):
        flat = [v for tile in self.tiles for v in tile]
        out = (ctypes.c_int64 * cap).from_address(addr)
        for e, v in enumerate(flat[:cap]):
            out[e] = v
        return len(self.tiles)


_K1_BUILT = [(dtype.itemsize, dmax, nt)
             for dtype, tiles in K1_TILES.items() for dmax, nt in tiles]


@pytest.mark.parametrize("tiles,ok", [
    (_K1_BUILT, True),
    ([(4, 8, 256)] + _K1_BUILT[1:], False),  # another NT
    (_K1_BUILT[:-1], False),  # a tile the plan names is not built
    (_K1_BUILT + [(8, 64, 32)], False),  # a tile the plan lacks
    (_K1_BUILT[3:] + _K1_BUILT[:3], False),  # another order
])
def test_k1_tile_check(tiles, ok):
    """The tile route's first launch holds the library's built tiles
    against ``K1_TILES`` and raises on any difference."""
    if ok:
        _check_tiles(_K1TileLib(tiles))
    else:
        with pytest.raises(RuntimeError):
            _check_tiles(_K1TileLib(tiles))


def test_k2_plain_matches_pallas_combine(monkeypatch):
    """The JAX engine's n_rhs = 1 combine through the interpret-mode Pallas
    lane select, on the engine's own combine tables and a random flat
    vector, against the port's plain combine_gather on the same tables."""
    monkeypatch.setitem(os.environ, "EQLB_FORCE_LANE_SELECT", "1")
    monkeypatch.setitem(os.environ, "EQLB_NO_DS_COMBINE", "1")
    msh = jax_unit_square(3)
    eng = JaxEngine(JaxSpace(msh, "RT", 2), jax_patches(msh))
    assert not eng._use_elem_combine(1) and not eng._use_ds_combine(1)
    _, refd = eng._device_tables()
    cm = eng._combine
    total = cm["total"]
    rng = np.random.default_rng(7)
    flat = rng.normal(size=(1, eng._flat_len))
    x_jax = np.asarray(eng._combine_flat(jnp.asarray(flat), refd))

    ndofs, nfk = eng.V.ndofs, cm["nfk"]
    src = np.full((ndofs, 3), total, dtype=np.int32)
    src[:, :2] = cm["src01"]
    src[nfk:, 2] = cm["src2"][:, 0]
    flat_pad = np.concatenate([flat, np.zeros((1, total + 1 - flat.shape[1]))],
                              axis=1)
    x_port = combine_gather_plain(torch.tensor(flat_pad), torch.tensor(src),
                                  nfk).numpy()
    assert x_port.shape == x_jax.shape
    assert np.abs(x_port - x_jax).max() <= 1e-14 * np.abs(x_jax).max()


def test_k2_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(3)
    flat = torch.tensor(rng.normal(size=(2, 41)))
    flat[:, -1] = 0.0
    src = torch.tensor(rng.integers(0, 41, size=(17, 3)), dtype=torch.int32)
    before = combine_gather.launches
    out = combine_gather(flat, src, 6)
    torch.testing.assert_close(out, combine_gather_plain(flat, src, 6),
                               rtol=0, atol=0)
    ref = flat[:, src[:, 0].long()] + flat[:, src[:, 1].long()]
    ref[:, 6:] += flat[:, src[6:, 2].long()]
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert combine_gather.launches == before


def test_k2_wrapper_rejects_bad_tables():
    flat = torch.zeros(1, 10, dtype=torch.float64)
    with pytest.raises(ValueError):
        combine_gather(flat, torch.zeros(4, 3, dtype=torch.int64), 0)
    with pytest.raises(ValueError):
        combine_gather(flat, torch.zeros(4, 2, dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        combine_gather(flat, torch.zeros(4, 3, dtype=torch.int32), 5)
    with pytest.raises(ValueError):
        combine_gather(torch.zeros(10, 2, dtype=torch.float64).t(),
                       torch.zeros(4, 3, dtype=torch.int32), 0)


def _spd_batch_bm(lead, D, R, seed):
    """Random SPD systems, batch-major: A (*lead, D, D), b (*lead, D, R)."""
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(*lead, D, D))
    A = B @ np.swapaxes(B, -1, -2) + D * np.eye(D)
    return A, rng.normal(size=(*lead, D, R))


@pytest.mark.parametrize("D", [16, 28, 32, 33, 56, 64, 65, 75, 90, 104, 105,
                               108, 110, 120, 127])
def test_k3_plain_matches_pallas_and_linalg(D):
    """Leading axes (2, P) are folded, as the KKT mode's (n_rhs, P).  D = 32,
    33, 64 and 65 sit on the boundaries of K3's register tiles and of its
    register route; 75, 90, 105 and 120 are the KKT sizes of RT3 on
    unstructured meshes, 104 and 108 those of RT4, 110 the last D of the
    reference's size rule and 127 the last of the port's at R = 1, all on
    the wide route."""
    A, b = _spd_batch_bm((2, 9), D, 1, seed=D)
    x_jax = np.asarray(jax_k3(jnp.asarray(A, jnp.float64),
                              jnp.asarray(b, jnp.float64)))
    At, bt = torch.tensor(A), torch.tensor(b)
    x_plain = batched_kkt_solve_plain(At, bt).numpy()
    x_lin = torch.linalg.solve(At, bt).numpy()
    assert x_plain.shape == x_jax.shape == b.shape
    scale = np.abs(x_jax).max()
    assert np.abs(x_plain - x_jax).max() <= 1e-12 * scale
    assert np.abs(x_plain - x_lin).max() <= 1e-12 * scale


def test_k3_wrapper_on_cpu_is_the_plain_version():
    A, b = _spd_batch_bm((2, 5), 12, 3, seed=2)
    At, bt = torch.tensor(A), torch.tensor(b)
    before = batched_kkt_solve.launches
    torch.testing.assert_close(batched_kkt_solve(At, bt),
                               batched_kkt_solve_plain(At, bt),
                               rtol=0, atol=0)
    assert batched_kkt_solve.launches == before  # no kernel launch on CPU


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("R", [1, 2])
def test_k3_plan_covers_every_size(R, dtype):
    """Every D of the port's size rule (``k3_admits``: D + R <= 128, so
    every D of the reference's rule, D <= 110) has a tiled route: for
    D <= 64 a register tile of at most 40 values a thread covering all D
    rows and D + R columns of the 8 x 16 thread layout, the smallest that
    does; for D = 65 ... 128 - R a wide tile of at most 64 values a thread
    covering them on 16 x 16 threads, the smallest that does.  The
    shared-memory route takes none of them."""
    assert all(k3_admits(D, R) for D in range(1, 129 - R))
    for D in range(1, 129 - R):
        route = k3_plan(D, R, dtype)
        layout, rows = ((K3_REG_TILES, 8) if D <= 64
                        else (K3_WIDE_TILES, 16))
        assert route in layout, (D, route)
        tiles = list(layout.values())
        assert all(mr * mc <= (40 if rows == 8 else 64) for mr, mc in tiles)
        mr, mc = layout[route]
        assert D <= rows * mr and D + R <= 16 * mc, (D, route)
        smaller = tiles[:tiles.index((mr, mc))]
        assert not any(D <= rows * a and D + R <= 16 * c for a, c in smaller)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k3_plan_shared_only_past_wide(dtype):
    """The shared-memory route takes a shape only where no wide tile covers
    it (D > 128 or D + R > 128) and [A | b] fits a block; past that k3_plan
    raises."""
    biggest = max(K3_WIDE_TILES.values())
    for D in range(100, 170):
        for R in (1, 2, 8):
            covered = D <= 16 * biggest[0] and D + R <= 16 * biggest[1]
            fits = D * (D + R) * dtype.itemsize <= SMEM_LIMIT
            if covered:
                assert k3_plan(D, R, dtype) in K3_WIDE_TILES, (D, R)
            elif fits:
                assert k3_plan(D, R, dtype) == "shared", (D, R)
            else:
                with pytest.raises(ValueError):
                    k3_plan(D, R, dtype)


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("mesh", ["crossed", "unstructured"])
def test_k3_plan_takes_kkt_shapes_on_registers(mesh, k):
    """The KKT systems of the KKT tests' meshes that K3 takes (the port's
    rule, ``k3_admits``: D = 120 at RT3 on the unstructured mesh too) go
    to a register tile whenever D <= 64 and to a wide tile above; none to
    the shared-memory route."""
    msh = unit_square(3) if mesh == "crossed" else unit_square_unstructured(4)
    eng = EqlbEngine(FunctionSpace(msh, "RT", k), build_patches(msh),
                     dtype=torch.float64, device="cpu")
    sizes = {eng.kkt_size(key)[0] for key in eng.buckets}
    taken = [D for D in sorted(sizes) if k3_admits(D, 1)]
    assert taken
    for D in taken:
        for dtype in (torch.float32, torch.float64):
            route = k3_plan(D, 1, dtype)
            assert route in (K3_REG_TILES if D <= 64 else K3_WIDE_TILES), \
                (D, route)


def test_k3_wrapper_routes_on_cpu():
    """On CPU tensors every route the shape admits is the plain version; a
    route that cannot take the shape, or an unknown one, raises."""
    A, b = _spd_batch_bm((3,), 20, 2, seed=4)
    At, bt = torch.tensor(A), torch.tensor(b)
    before = dict(batched_kkt_solve.launches_by_route)
    ref = batched_kkt_solve_plain(At, bt)
    for route in ("reg4x2", "reg8x5", "wide5x5", "wide7x7", "shared"):
        torch.testing.assert_close(_solve_route(At, bt, route),
                                   ref, rtol=0, atol=0)
    A, b = _spd_batch_bm((3,), 90, 1, seed=5)  # D = 90, R = 1: wide6x6
    At, bt = torch.tensor(A), torch.tensor(b)
    assert k3_plan(90, 1, torch.float64) == "wide6x6"
    torch.testing.assert_close(batched_kkt_solve(At, bt),
                               batched_kkt_solve_plain(At, bt),
                               rtol=0, atol=0)
    assert batched_kkt_solve.launches_by_route == before
    with pytest.raises(ValueError):  # 16 + 17 columns exceed the 4 x 2 tile
        _solve_route(At[..., :16, :16].contiguous(),
                     torch.zeros(3, 16, 17, dtype=torch.float64), "reg4x2")
    with pytest.raises(ValueError):  # 90 rows exceed the 5 x 5 wide tile
        _solve_route(At, bt, "wide5x5")
    with pytest.raises(ValueError):
        _solve_route(At, bt, "reg9x9")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k3_plan_wide8x8_edges(dtype):
    """The 8 x 8 wide tile takes the shapes past 7 x 7 up to D + R = 128
    (D = 120 at RT3 on unstructured meshes, the 24,662 interior 8-cell
    patches of the 1M-cell mesh); 7 x 7 keeps its own edge, the
    shared-memory route takes what comes after."""
    for D, R in ((112, 1), (111, 2), (113, 1), (120, 1), (120, 2),
                 (127, 1), (126, 2)):
        assert k3_plan(D, R, dtype) == "wide8x8", (D, R)
    for D, R in ((111, 1), (110, 2)):
        assert k3_plan(D, R, dtype) == "wide7x7", (D, R)
    for D, R in ((128, 1), (127, 2), (129, 1), (135, 1), (150, 1)):
        assert k3_plan(D, R, dtype) == "shared", (D, R)


def test_k3_size_rules():
    """The port's rule (``k3_admits``, the engine's flux KKT stage) admits
    every shape a tiled route covers: RT3's D = 120, not D = 135 / 150 or
    RT4's D = 208; the reference's rule (``k3_takes``, kept by the reduced
    weak-symmetry systems) stops at D = 110 as before."""
    assert port_engine.k3_admits is k3_admits
    assert all(k3_admits(D, 1) for D in (33, 75, 90, 105, 110, 120, 127))
    assert k3_admits(126, 2) and not k3_admits(127, 2)
    assert not any(k3_admits(D, 1) for D in (128, 135, 150, 208))
    assert [D for D in range(1, 300) if k3_takes(D)] == list(range(1, 111))


def test_weak_symmetry_reduced_keeps_reference_rule(monkeypatch):
    """``stress.weak_symmetry_bucket_reduced`` solves through
    ``_dense_solve`` by the reference's rule (its systems are not safe
    without pivoting): ``k3_takes`` decides, ``k3_admits`` is never asked,
    and K3 (its plain version here) takes each system ``k3_takes``
    admits."""
    from dolfinx_eqlb_tpu_torch.eqlb import stress as tstress

    msh = unit_square_unstructured(4, seed=1)
    eng = EqlbEngine(FunctionSpace(msh, "RT", 2), build_patches(msh),
                     dtype=torch.float64, device="cpu")
    asked, solved = [], []
    takes, k3 = port_engine.k3_takes, port_engine.batched_kkt_solve
    monkeypatch.setattr(port_engine, "k3_takes",
                        lambda D: asked.append(D) or takes(D))
    monkeypatch.setattr(port_engine, "k3_admits", lambda D, R: pytest.fail(
        "the reduced formulation asked the port's rule"))
    monkeypatch.setattr(port_engine, "batched_kkt_solve",
                        lambda A, b: solved.append(A.shape[-1]) or k3(A, b))
    rng = np.random.default_rng(7)
    key = max(eng.buckets, key=lambda k: eng.buckets[k].npatches)
    P, nflux = eng.tables[key]["gdofs"].shape[0], eng.kkt_size(key)[1]
    sol = torch.tensor(rng.normal(size=(2, P, nflux)))
    fk = torch.zeros((2, msh.num_facets), dtype=torch.int8)
    d_proj = torch.tensor(rng.normal(size=(2, msh.num_cells, 2, 3)))
    y = tstress.weak_symmetry_bucket_reduced(eng, key, sol, fk, d_proj)
    assert y.shape == (2, P, nflux) and asked
    assert solved == [D for D in asked if takes(D)]


class _TileLib:
    """Stands in for the kernel library's register-tile query."""

    def __init__(self, tiles):
        self.tiles = tiles

    def eqlb_lu_solve_bm_reg_tiles(self, addr, cap):
        flat = [v for tile in self.tiles for v in tile]
        out = (ctypes.c_int64 * cap).from_address(addr)
        for e, v in enumerate(flat[:cap]):
            out[e] = v
        return len(self.tiles)


@pytest.mark.parametrize("tiles,ok", [
    (list(K3_REG_TILES.values()), True),
    ([(4, 2), (4, 3), (7, 4), (8, 5)], False),  # a tile the plan lacks
    ([(4, 2), (8, 5)], False),  # a tile the plan names is not built
    ([(7, 4), (4, 2), (8, 5)], False),  # another order
])
def test_k3_reg_tile_check(tiles, ok):
    """The register route's first launch holds the library's built tiles
    against ``K3_REG_TILES`` and raises on any difference."""
    if ok:
        _check_reg_tiles(_TileLib(tiles))
    else:
        with pytest.raises(RuntimeError):
            _check_reg_tiles(_TileLib(tiles))


class _WideTileLib(_TileLib):
    """Stands in for the kernel library's wide-tile query."""

    def eqlb_lu_solve_bm_wide_tiles(self, addr, cap):
        return self.eqlb_lu_solve_bm_reg_tiles(addr, cap)


@pytest.mark.parametrize("tiles,ok", [
    (list(K3_WIDE_TILES.values()), True),
    ([(5, 5), (6, 6), (7, 7), (8, 8), (9, 9)], False),  # a tile the plan lacks
    ([(5, 5), (7, 7), (8, 8)], False),  # a tile the plan names is not built
    ([(6, 6), (5, 5), (7, 7), (8, 8)], False),  # another order
    (list(K3_REG_TILES.values()), False),  # the register route's list
])
def test_k3_wide_tile_check(tiles, ok):
    """The wide route's first launch holds the library's built tiles
    against ``K3_WIDE_TILES`` and raises on any difference."""
    if ok:
        _check_wide_tiles(_WideTileLib(tiles))
    else:
        with pytest.raises(RuntimeError):
            _check_wide_tiles(_WideTileLib(tiles))


def test_k3_wrapper_rejects_bad_args():
    A = torch.zeros(3, 6, 6, dtype=torch.float64)
    b = torch.zeros(3, 6, 1, dtype=torch.float64)
    with pytest.raises(ValueError):  # A and b disagree on the batch
        batched_kkt_solve(A, torch.zeros(2, 6, 1, dtype=torch.float64))
    with pytest.raises(ValueError):  # A not square
        batched_kkt_solve(torch.zeros(3, 6, 5, dtype=torch.float64), b)
    with pytest.raises(ValueError):
        batched_kkt_solve(A, b.float())
    with pytest.raises(ValueError):  # the kernel needs contiguous operands
        batched_kkt_solve(A.transpose(1, 2), b)
    with pytest.raises(ValueError):  # [A | b] exceeds a block's shared memory
        batched_kkt_solve(torch.zeros(1, 200, 200, dtype=torch.float64),
                          torch.zeros(1, 200, 1, dtype=torch.float64))


def test_k4_plain_matches_pallas_ds_combine(monkeypatch):
    """The JAX engine's double-single combine (interpret-mode Pallas
    ``lane_select_ds`` on its paired tables) on a random f64 flat vector,
    against the port's plain ds_combine_gather on the same contributor
    columns: the same f32 operations in the same order."""
    monkeypatch.setitem(os.environ, "EQLB_FORCE_LANE_SELECT", "1")
    msh = jax_unit_square(3)
    eng = JaxEngine(JaxSpace(msh, "RT", 2), jax_patches(msh))
    assert eng._use_ds_combine(1)
    eng._ensure_combine_tables(1)
    _, refd = eng._device_tables()
    cm = eng._combine
    rng = np.random.default_rng(5)
    flat = rng.normal(size=(1, eng._flat_len)) * 10.0 ** rng.integers(
        -3, 4, size=(1, eng._flat_len))
    x_jax = np.asarray(eng._ds_combine(jnp.asarray(flat), refd))

    ndofs, nfk, total = eng.V.ndofs, cm["nfk"], cm["total"]
    src = np.full((ndofs, 3), total, dtype=np.int32)
    src[:, :2] = cm["src01"]
    src[nfk:, 2] = cm["src2"][:, 0]
    flat_pad = np.concatenate([flat, np.zeros((1, total + 1 - flat.shape[1]))],
                              axis=1)
    x_port = ds_combine_gather_plain(torch.tensor(flat_pad),
                                     torch.tensor(src), nfk).numpy()
    np.testing.assert_array_equal(x_port, x_jax)
    # and the double-single sum is the f64 sum to ~2^-48
    x64 = combine_gather_plain(torch.tensor(flat_pad), torch.tensor(src),
                               nfk).numpy()
    assert np.abs(x_port - x64).max() <= 1e-14 * np.abs(x64).max()


def test_k4_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(4)
    flat = torch.tensor(rng.normal(size=(2, 41)))
    flat[:, -1] = 0.0
    src = torch.tensor(rng.integers(0, 41, size=(17, 3)), dtype=torch.int32)
    before = ds_combine_gather.launches
    out = ds_combine_gather(flat, src, 6)
    torch.testing.assert_close(out, ds_combine_gather_plain(flat, src, 6),
                               rtol=0, atol=0)
    x64 = combine_gather_plain(flat, src, 6)
    assert (out - x64).abs().max() <= 1e-14 * x64.abs().max()
    assert ds_combine_gather.launches == before


def test_k4_wrapper_rejects_bad_tables():
    src = torch.zeros(4, 3, dtype=torch.int32)
    with pytest.raises(ValueError):  # double-single needs f64 data
        ds_combine_gather(torch.zeros(1, 10, dtype=torch.float32), src, 0)
    with pytest.raises(ValueError):
        ds_combine_gather(torch.zeros(1, 10, dtype=torch.float64),
                          src.long(), 0)
    with pytest.raises(ValueError):
        ds_combine_gather(torch.zeros(1, 10, dtype=torch.float64), src, 5)
