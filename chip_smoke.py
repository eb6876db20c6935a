#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--n 500] [--profile]

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (nvcc).  It builds the port's CUDA kernels from ``csrc/`` for
``sm_90a``, holds each kernel against its plain PyTorch version at the
main path's shapes, then drives the main path — semi-explicit RT2 flux
equilibration of random DG data on the crossed ``unit_square(n)``
(4 n^2 cells; n = 500 is the 1M-cell headline configuration of
``bench.py``), one field, f32 — and checks that it went through both
kernels and agrees with the plain route.  Phases, one line each:

  1. the card's name and power limit (``nvidia-smi``);
  2. the nvcc build and its time;
  3. the host precompute: mesh, patches, engine tables;
  4. K1 (batched pivot-free solve) against its plain version, f32 and f64;
  5. K2 (dof combine) against its plain version, bitwise;
  6. the main path: first call, 5 strict calls, 3 x 8 pipelined calls,
     launch counts, output checks, and a stage breakdown;
  7. f64 parity on ``unit_square(64)``: card (kernels) against the CPU
     (plain versions).

Any failure exits non-zero; nothing falls back to the CPU.  The line before
the last is a JSON object with every kernel's launches, error and times;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

K1_SOURCE = "dolfinx_eqlb_tpu_torch/csrc/patch_solve.cu"
K1_REPLACES = "dolfinx_eqlb_tpu/ops/patch_solve.py:42"
K2_SOURCE = "dolfinx_eqlb_tpu_torch/csrc/lane_select.cu"
K2_REPLACES = "dolfinx_eqlb_tpu/ops/lane_select.py:30"
# max_patches_per_bucket of the main path: the chunk size bench.py's
# headline configuration uses; it fixes the K1 shapes checked in phase 4.
CHUNK = 131072


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(device) -> None:
    torch.cuda.synchronize(device)


def time_ms(fn, device, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over reps launches (CUDA events on the
    current stream), after warm-up."""
    for _ in range(warmup):
        fn()
    sync(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def make_data(msh, k: int, n_rhs: int, seed: int, np_dtype, kinds=False):
    """bench.py's data: random DG dofs, every boundary facet primal-
    Dirichlet (kind 1), zero flux data; ``kinds`` splits the boundary at
    random into kinds 1 and 2, with random flux data on kind 2."""
    rng = np.random.default_rng(seed)
    nc, nf, ndg = msh.num_cells, msh.num_facets, k * (k + 1) // 2
    d_proj = rng.normal(size=(n_rhs, nc, 2, ndg))
    d_rhs = rng.normal(size=(n_rhs, nc, ndg))
    fk = np.where(msh.is_boundary_facet, 1, 0).astype(np.int8)[None].repeat(
        n_rhs, 0)
    bv = np.zeros((n_rhs, nf, k))
    if kinds:
        bf = msh.boundary_facets
        fk[:, bf] = rng.integers(1, 3, size=(n_rhs, len(bf)))
        bv[:, bf] = rng.normal(size=(n_rhs, len(bf), k))
        bv[fk != 2] = 0.0
    return (d_proj.astype(np_dtype), d_rhs.astype(np_dtype), fk,
            bv.astype(np_dtype))


def solve_shapes(engine):
    """(D, R, X) of every K1 call the main path makes: the interior
    buckets' inverse builds (R = D) and the boundary buckets' masked
    solves (R = 1)."""
    shapes = []
    for key in sorted(engine.buckets):
        b = engine.buckets[key]
        D = engine.se_static[key]["Dz"]
        X = engine.tables[key]["gdofs"].shape[0]
        shape = (D, 1 if b.is_boundary else D, X)
        if shape not in shapes:
            shapes.append(shape)
    return shapes


def phase_k1(shapes, device):
    """K1 against its plain version on random SPD batches."""
    from dolfinx_eqlb_tpu_torch.ops.patch_solve import (
        batched_kkt_solve_bl, batched_kkt_solve_bl_plain,
    )

    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-12)):
        for D, R, X in shapes:
            B = torch.randn((X, D, D), generator=gen, device=device,
                            dtype=dtype)
            eye = torch.eye(D, dtype=dtype, device=device)
            A = (B @ B.transpose(1, 2) + D * eye).permute(1, 2, 0).contiguous()
            b = torch.randn((D, R, X), generator=gen, device=device,
                            dtype=dtype)
            x = batched_kkt_solve_bl(A, b)
            xp = batched_kkt_solve_bl_plain(A, b)
            sync(device)
            err = float((x - xp).abs().max())
            rel = err / float(xp.abs().max())
            ms = time_ms(lambda: batched_kkt_solve_bl(A, b), device)
            plain_ms = time_ms(lambda: batched_kkt_solve_bl_plain(A, b),
                               device, reps=3, warmup=1)
            ok = bool(torch.isfinite(x).all()) and rel <= tol
            rows.append(dict(dtype=str(dtype).split(".")[-1], D=D, R=R, X=X,
                             max_abs_err=err, max_rel_err=rel, ms=ms,
                             plain_ms=plain_ms, ok=ok))
            log(f"    K1 {rows[-1]['dtype']} D={D} R={R} X={X}: "
                f"max_rel_err={rel:.3e} (limit {tol:g}) "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
                f"{'' if ok else '  FAILED'}")
    return rows


def phase_k2(engine, device):
    """K2 against its plain version on the engine's combine tables."""
    from dolfinx_eqlb_tpu_torch.ops.lane_select import (
        combine_gather, combine_gather_plain,
    )

    src = torch.as_tensor(engine._src, device=device)
    nfk = engine._nfk
    gen = torch.Generator(device=device).manual_seed(1)
    rows = []
    for dtype in (torch.float32, torch.float64):
        flat = torch.randn((1, engine._flat_len + 1), generator=gen,
                           device=device, dtype=dtype)
        flat[:, -1] = 0.0  # the zero pad slot
        out = combine_gather(flat, src, nfk)
        ref = combine_gather_plain(flat, src, nfk)
        sync(device)
        equal = bool(torch.equal(out, ref))
        err = float((out - ref).abs().max())
        ms = time_ms(lambda: combine_gather(flat, src, nfk), device)
        plain_ms = time_ms(lambda: combine_gather_plain(flat, src, nfk),
                           device)
        rows.append(dict(dtype=str(dtype).split(".")[-1], ndofs=src.shape[0],
                         L=flat.shape[1], bitwise=equal, max_abs_err=err,
                         ms=ms, plain_ms=plain_ms))
        log(f"    K2 {rows[-1]['dtype']} ndofs={src.shape[0]} "
            f"L={flat.shape[1]}: bitwise_equal={equal} kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms{'' if equal else '  FAILED'}")
    return rows


def phase_main(engine, data, device, profile=False):
    """The main path through both kernels: counts, timings, checks."""
    from dolfinx_eqlb_tpu_torch.eqlb.engine import EqlbEngine
    from dolfinx_eqlb_tpu_torch.eqlb.semiexplicit import (
        solve_bucket_semiexplicit,
    )
    from dolfinx_eqlb_tpu_torch.ops.lane_select import (
        combine_gather, combine_gather_plain,
    )
    from dolfinx_eqlb_tpu_torch.ops.patch_solve import batched_kkt_solve_bl

    d_proj, d_rhs, facet_kind, bvals = data
    npatches = sum(b.npatches for b in engine.buckets.values())
    res = {}

    t0 = time.perf_counter()
    dpT, drT = engine.put_transposed(d_proj, d_rhs)
    fk = torch.as_tensor(facet_kind, device=device)
    bv = torch.as_tensor(bvals, dtype=engine.dtype, device=device)
    sync(device)
    res["upload_s"] = time.perf_counter() - t0

    def call():
        return engine.equilibrate(dpT, drT, fk, bv, transposed_inputs=True)

    batched_kkt_solve_bl.launches = 0
    combine_gather.launches = 0
    t0 = time.perf_counter()
    engine._device_tables()
    sync(device)
    res["geometry_caches_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    x = call()
    sync(device)
    res["first_call_s"] = time.perf_counter() - t0
    strict = []
    for _ in range(5):
        t0 = time.perf_counter()
        x = call()
        sync(device)
        strict.append((time.perf_counter() - t0) * 1e3)
    pipelined = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(8):
            x = call()
        sync(device)
        pipelined.append((time.perf_counter() - t0) * 1e3 / 8)
    res["launches"] = {"K1": batched_kkt_solve_bl.launches,
                       "K2": combine_gather.launches}
    res["strict_ms"] = strict
    res["pipelined_ms"] = pipelined
    res["strict_ms_median"] = float(np.median(strict))
    res["pipelined_ms_min"] = min(pipelined)
    res["patches"] = npatches
    res["patches_per_s_strict"] = npatches / (res["strict_ms_median"] / 1e3)
    res["patches_per_s_pipelined"] = npatches / (res["pipelined_ms_min"] / 1e3)
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated(device) / 2**30

    # output checks: shape, finiteness, and the plain route on the same
    # host tables (torch.linalg.solve + the plain combine)
    res["shape_ok"] = tuple(x.shape) == (1, engine.V.ndofs)
    res["finite"] = bool(torch.isfinite(x).all())
    ref = EqlbEngine.from_host_tables(
        engine.V, engine.buckets, engine.tables, engine.se_static, engine.ref,
        dtype=engine.dtype, device=device)
    ref.solver = "torch"
    _, ref_refd = ref._device_tables()
    x_ref = combine_gather_plain(ref._bucket_solutions(dpT, drT, fk, bv),
                                 ref_refd["src"], ref._nfk)
    scale = float(x_ref.abs().max())
    res["max_abs_err_vs_plain"] = float((x - x_ref).abs().max())
    res["err_limit"] = 1e-4 * scale
    del ref

    # stage breakdown (host clock around synchronised stages)
    stages = {"bucket_solves_ms": [], "combine_ms": []}
    per_bucket = {str(key): [] for key in sorted(engine.buckets)}
    dev, refd = engine._device_tables()
    dprT = torch.cat([dpT, drT[:, None]], dim=1)
    for _ in range(3):
        t0 = time.perf_counter()
        flat = engine._bucket_solutions(dpT, drT, fk, bv)
        sync(device)
        stages["bucket_solves_ms"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        engine._combine_flat(flat)
        sync(device)
        stages["combine_ms"].append((time.perf_counter() - t0) * 1e3)
        for key in sorted(engine.buckets):
            t0 = time.perf_counter()
            solve_bucket_semiexplicit(engine, key, dprT, fk, bv, dev[key],
                                      refd)
            sync(device)
            per_bucket[str(key)].append((time.perf_counter() - t0) * 1e3)
    res["stages_ms"] = {name: min(v) for name, v in stages.items()}
    res["per_bucket_ms"] = {
        name: [engine.buckets[key].npatches, min(per_bucket[name])]
        for name, key in ((str(key), key) for key in sorted(engine.buckets))}

    if profile:
        from torch.profiler import (
            ProfilerActivity, profile as tprofile, record_function,
        )

        call()
        sync(device)
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            with record_function("strict_window"):
                call()
                sync(device)
            with record_function("pipelined_window"):
                for _ in range(8):
                    call()
                sync(device)
        res["device_idle"] = {
            name: device_idle(prof.events(), name)
            for name in ("strict_window", "pipelined_window")}
        table = prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=25)
        res["profile_table"] = table
    return x, res


def device_idle(events, window: str) -> dict:
    """Device busy time and idle share inside the profiler range named
    ``window``: the union of the card's kernel, copy and memset intervals,
    clipped to the range, against the range's host-clock length.  The
    profiler also mirrors every ``record_function`` range onto the device
    timeline as a user annotation spanning its kernels; those are not work
    and are left out."""
    win = next(e for e in events
               if e.name == window and not str(e.device_type).endswith("CUDA"))
    w0, w1 = win.time_range.start, win.time_range.end
    spans = sorted(
        (max(e.time_range.start, w0), min(e.time_range.end, w1))
        for e in events
        if str(e.device_type).endswith("CUDA")
        and not getattr(e, "is_user_annotation", False)
        and not e.name.endswith("_window")
        and e.time_range.end > w0 and e.time_range.start < w1)
    busy, end = 0.0, w0
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return {"window_ms": (w1 - w0) / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / (w1 - w0), "device_events": len(spans)}


def phase_f64_parity(device, n: int = 64):
    """unit_square(n), RT2, two RHS with facet kinds 0/1/2, f64: the card
    (kernels) against the CPU (plain versions)."""
    from dolfinx_eqlb_tpu_torch.eqlb.engine import EqlbEngine
    from dolfinx_eqlb_tpu_torch.eqlb.patches import build_patches
    from dolfinx_eqlb_tpu_torch.fem import FunctionSpace
    from dolfinx_eqlb_tpu_torch.mesh import unit_square

    msh = unit_square(n)
    V = FunctionSpace(msh, "RT", 2)
    buckets = build_patches(msh)
    dp, dr, fk, bv = make_data(msh, 2, 2, seed=2, np_dtype=np.float64,
                               kinds=True)
    x_card = EqlbEngine(V, buckets, dtype=torch.float64, device=device,
                        max_patches_per_bucket=4096).equilibrate(dp, dr, fk, bv)
    x_cpu = EqlbEngine(V, buckets, dtype=torch.float64,
                       device="cpu").equilibrate(dp, dr, fk, bv)
    x_card = x_card.cpu()
    err = float((x_card - x_cpu).abs().max())
    limit = 1e-11 * max(1.0, float(x_cpu.abs().max()))
    return dict(n=n, cells=msh.num_cells, max_abs_err=err, limit=limit,
                ok=bool(torch.isfinite(x_card).all()) and err <= limit)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=500,
                    help="crossed unit square with 4 n^2 cells (default 500)")
    ap.add_argument("--profile", action="store_true",
                    help="also print a torch.profiler table of one call")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    from dolfinx_eqlb_tpu_torch import native
    from dolfinx_eqlb_tpu_torch.eqlb.engine import EqlbEngine
    from dolfinx_eqlb_tpu_torch.eqlb.patches import build_patches
    from dolfinx_eqlb_tpu_torch.fem import FunctionSpace
    from dolfinx_eqlb_tpu_torch.mesh import unit_square
    from dolfinx_eqlb_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    failures = []

    card = card_line()
    log(card)
    log(f"[1/7] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")

    _build.library()
    info = _build.build_info()
    log(f"[2/7] nvcc build: {info['seconds']:.2f} s "
        f"({'compiled' if info['built'] else 'cached'}) -> {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"    ptxas: {line.strip()}")

    k = 2
    t0 = time.perf_counter()
    msh = unit_square(args.n)
    t_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    buckets = build_patches(msh)
    t_patches = time.perf_counter() - t0
    t0 = time.perf_counter()
    V = FunctionSpace(msh, "RT", k)
    engine = EqlbEngine(V, buckets, dtype=torch.float32, device=device,
                        max_patches_per_bucket=CHUNK)
    t_tables = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = make_data(msh, k, 1, seed=0, np_dtype=np.float32)
    t_data = time.perf_counter() - t0
    npatches = sum(b.npatches for b in buckets.values())
    log(f"[3/7] host precompute: mesh {msh.num_cells} cells {t_mesh:.2f} s; "
        f"patches {npatches} in {len(buckets)} buckets {t_patches:.2f} s; "
        f"engine tables ({len(engine.buckets)} chunks, {V.ndofs} dofs) "
        f"{t_tables:.2f} s; data {t_data:.2f} s; native library loaded: "
        f"{native.available()}")

    shapes = solve_shapes(engine)
    log(f"[4/7] K1 vs plain at the main path's shapes {shapes}:")
    k1 = phase_k1(shapes, device)
    if not all(r["ok"] for r in k1):
        failures.append("K1 disagrees with its plain version")

    log("[5/7] K2 vs plain on the engine's combine tables:")
    k2 = phase_k2(engine, device)
    if not all(r["bitwise"] for r in k2):
        failures.append("K2 is not bitwise equal to its plain version")

    x, main_res = phase_main(engine, data, device, profile=args.profile)
    launches = main_res["launches"]
    log(f"[6/7] main path unit_square({args.n}) RT2 f32 1 field, "
        f"{main_res['patches']} patches: first call "
        f"{main_res['first_call_s']:.3f} s (geometry caches "
        f"{main_res['geometry_caches_s']:.3f} s before it); strict "
        f"{main_res['strict_ms_median']:.3f} ms median "
        f"({main_res['patches_per_s_strict']:.4g} patches/s), pipelined "
        f"{main_res['pipelined_ms_min']:.3f} ms "
        f"({main_res['patches_per_s_pipelined']:.4g} patches/s); launches "
        f"{launches}; finite {main_res['finite']}; max|x - plain| "
        f"{main_res['max_abs_err_vs_plain']:.3e} (limit "
        f"{main_res['err_limit']:.3e})")
    log("    detail: " + json.dumps(
        {key: val for key, val in main_res.items() if key != "profile_table"}))
    if "profile_table" in main_res:
        log(main_res["profile_table"])
        for name, idle in main_res["device_idle"].items():
            log(f"    profiler {name}: {idle['window_ms']:.3f} ms, device "
                f"busy {idle['device_busy_ms']:.3f} ms, idle share "
                f"{idle['idle_share']:.4f} ({idle['device_events']} device "
                f"events)")
    if launches["K1"] <= 0 or launches["K2"] <= 0:
        failures.append(f"main path skipped a kernel: {launches}")
    if not (main_res["shape_ok"] and main_res["finite"]):
        failures.append("main path output has a wrong shape or non-finite")
    if not main_res["max_abs_err_vs_plain"] <= main_res["err_limit"]:
        failures.append("main path disagrees with the plain route")

    par = phase_f64_parity(device)
    log(f"[7/7] f64 parity unit_square({par['n']}) ({par['cells']} cells), "
        f"card vs CPU: max_abs_err {par['max_abs_err']:.3e} "
        f"(limit {par['limit']:.3e}){'' if par['ok'] else '  FAILED'}")
    if not par["ok"]:
        failures.append("f64 card result disagrees with the CPU")

    if failures:
        for f in failures:
            print(f"chip_smoke: FAILED: {f}", file=sys.stderr)
        return 1

    k1_main = max((r for r in k1 if r["dtype"] == "float32"),
                  key=lambda r: r["D"] * r["D"] * r["R"] * r["X"])
    k2_main = next(r for r in k2 if r["dtype"] == "float32")
    print(json.dumps({"kernels": [
        {"name": "K1 batched_kkt_solve_bl", "route": "cuda",
         "source": K1_SOURCE, "replaces": K1_REPLACES,
         "launches": launches["K1"],
         "max_abs_err": max(r["max_abs_err"] for r in k1),
         "ms": k1_main["ms"], "plain_ms": k1_main["plain_ms"]},
        {"name": "K2 combine_gather", "route": "cuda",
         "source": K2_SOURCE, "replaces": K2_REPLACES,
         "launches": launches["K2"],
         "max_abs_err": max(r["max_abs_err"] for r in k2),
         "ms": k2_main["ms"], "plain_ms": k2_main["plain_ms"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
