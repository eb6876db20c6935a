#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--n 500] [--profile] [--k1-sweep] [--phase22]
                          [--phase23] [--phase24] [--phase25] [--phase26]

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (nvcc).  It builds the port's CUDA kernels from ``csrc/`` for
``sm_90a``, holds each kernel against its plain PyTorch version at the
shapes its path gives it, and drives three paths of
``EqlbEngine.equilibrate`` on random DG data on the crossed
``unit_square(n)`` (4 n^2 cells; n = 500 is the 1M-cell headline
configuration of ``bench.py``), RT2, one field, checking that each went
through its kernels and agrees with the plain route:

* the semi-explicit main path, f32 (K1, K2);
* the KKT cross-check path, f64 and f32 (K3, K2);
* the mixed-precision path, f64 data, f32 factorisations with an f64
  correction and the double-single combine (K1, K4);

then the flux user API end to end in f64 (K1, K2 in both equilibrators):
``demos/demo_reconstruction.py``'s flow with P2 primal and RT2 flux; then
error estimation and the adaptive loops in f64 (K1 by its tile and block
routes, K2):
the port's ``demos.lshape_adaptive``, ``demos.error_estimation`` and
``demos.discont_coeff``, held to the JAX package's committed runs; then
weakly symmetric stress equilibration (K1, K2 and K3 on its operands):
the stress engine, the elasticity user flow and its committed runs, the
KKT mode, and the adaptive Cook loop; then
geometric multigrid and Biot poro-elasticity (K1, K2 on the Biot path's
operands): ``bench.py 500 3 --biot``'s data and engine calls, the Biot
demo's flow, and the multigrid solvers and perftest series; then patch
sharding over ``torch.distributed`` (K1, K2 on every rank), Gmsh import
and the ParaView output; then the port's bench, ``bench.py``'s
counterpart, in its four modes (K1, K2, K4); then the KKT cross-check path
at RT3 on a 1M-cell unstructured mesh (K3's wide and cluster routes, K2)
and at RT4 on a 250k-cell one (K3's cluster route, K2).

Phases, one line each:

   1. the card's name and power limit (``nvidia-smi``);
   2. the nvcc build and its time;
   3. the host precompute: mesh, patches, engine tables;
   4. K1 (batch-last pivot-free solve) by every route that takes the
      shape, "tile", "block" and "global", on the same batch, timed in
      turns, against its plain version and ``torch.linalg.solve``, at the
      main path's shapes, the mixed path's chunk, RT3's, the tile route's
      split, the P4/RT4 L-shape's last step and RT4 / RT5 at the chunk;
      then each route once on each side of each split of ``k1_plan``;
   5. K2 (dof combine) against its plain version, bitwise, and timed
      beside the one-call library sum ``embedding_bag(mode="sum")`` (held
      to K2 within 4 ulp of max|out|);
   6. the semi-explicit main path: first call, 5 strict calls, 3 x 8
      pipelined calls, launch counts (K1's by route), the stage graph's
      captures and replays (one capture, then a replay every call after
      the first; the launch counts hold on replayed calls), output checks,
      a stage breakdown, the interior inverse build alone by each K1
      route;
   7. f64 parity on ``unit_square(64)``: card (kernels) against the CPU
      (plain versions);
   8. K3 (batch-major pivot-free solve) against its plain version, by the
      route ``k3_plan`` picks (the register route at D <= 64, the wide
      route to D + R = 128, the cluster route to 256) and on the same
      batch by the shared-memory route (beside a register or wide tile)
      or by the dtype's other cluster tiles that cover the shape (f64:
      the blocked kernel's, f32: the scalar-step kernel's), timed in turns,
      at the KKT path's shapes, at D = 75, 90, 105 (the wide route's,
      phase 24) at X = 131072 and D = 120 at phase 24's X = 24662, and at
      D = 130, 156, 182, 208 (the cluster route's) at phase 25's bucket
      sizes, past D + R = 128 against ``torch.linalg.solve`` too; then
      every route once at a small batch, on each side of each split;
   9. the KKT path, f64 and f32, against the f64 plain route, with K3's
      launches split by route, and K2 against its plain version on one
      more call's combine input;
  10. K4 (double-single combine) against its plain version, bitwise;
  11. the mixed-precision path against the f64 plain route (K1's
      launches by route), and the native-f64 kernel route on the same
      tables;
  12. the flux user API on ``unit_square(n)``, u = sin(2 pi x) cos(2 pi y),
      in two BC cases ("dirichlet"; "neumann_inhom", Neumann on x in
      {0, 1}): the projected RHS, ``PoissonSolver.solve`` (rtol 1e-13,
      CG iterations), the projected flux, ``FluxEqlbSE`` and
      ``FluxEqlbEV`` (construct, set the BCs, equilibrate twice, K1's
      launches by route and K2's per equilibrator; then K1 and K2 against
      their plain versions on the equilibrator's own operands, at its
      unchunked shapes), the divergence, jump (SE) and boundary
      (Neumann) checks, each run once, max|SE - EV| at fixed points,
      seconds per stage and peak device memory; then the "dirichlet"
      flow on ``unit_square(64)`` on the card and on the CPU, the SE and
      EV dofs compared;
  13. the adaptive L-shape (``demos.lshape_adaptive``): P3/RT3 SE,
      theta 0.6, to eta <= 1e-6 (at most 90 iterations), the configuration
      of ``artifacts/AdaptiveLShape_p3_e3.csv``, one line per step (cells,
      CG iterations, eta, err_H1, I_eff, stage seconds, K1's launches by
      route with the step's K1 shapes, device memory); rows 0-9 held to the
      CSV (cells identical, eta and err_H1 within 1e-8 relative).  Its
      patch systems stay at D <= 25, so the same loop runs at P4/RT4 (D up
      to 49, K1's block route), its first 8 rows held to the port on the
      CPU.  On each run's last step K1 (timed, beside its plain version,
      ``torch.linalg.solve`` and its bound) and K2 against their plain
      versions on the step's own operands;
  14. ``demos.error_estimation.run`` (P1/RT1, "dirichlet") for SE and EV
      at n = 2 ... 512 (up to 1,048,576 cells): SE's rows n = 2, 4, 8 held
      to ``ConvStudyFluxEqlb-SE_porder-1_eorder-1.csv`` and both series'
      rows up to n = 32 to the port on the CPU (1e-10 relative); then the
      Kellogg loop (``demos.discont_coeff``, 12 iterations) on the card and
      on the CPU (cells identical, eta within 1e-9 relative);
  15. the stress engine at ``bench.py --stress``'s headline (the crossed
      ``unit_square(n)``, RT2, two stress rows of f32 random DG data,
      chunk 131072, ``weak_symmetry=True``): the same engine without weak
      symmetry, the stress caches, strict and pipelined times, launches
      (K1's by route), ``torch.linalg.solve`` calls per call, peak memory,
      the result against the plain route, K1 and K2 against their plain
      versions on the call's operands; then f64 on ``unit_square(64)``
      with compatible data (the exact polynomial stress; a linear stress
      with mixed traction rows), card against CPU within 1e-11 with the
      regularisation masks compared;
  16. the elasticity user flow (``demos.elasticity.run``: u formulation,
      P2 primal, RT2, weak symmetry, Korn constants,
      ``estimate_elasticity``) on ``unit_square(n)``, f64: stage seconds,
      CG iterations against ``maxiter``, the checks, eta and its parts,
      I_eff, launches, peak memory, K1 and K2 on the equilibrator's
      operands; then the rows of the four committed
      ``artifacts/ConvStudyElasticity-*.csv`` (n = 4 ... 32; u-p runs
      MINRES) within 1e-8 relative;
  17. the same flow on ``unit_square(64)`` in the KKT mode against the
      semi-explicit mode (1e-9), K3's launches by route and K3 on the
      call's operands;
  18. the adaptive Cook loop (``demos.cook_adaptive``: P2 primal, RT3,
      theta 0.5, ``cook_membrane(2, 2)``): the demo's 6 iterations and
      overkill reference, the first 10 iterations against the CPU, the
      loop run on to 50,000 cells (one line per step), and 2 iterations at
      RT2, where the corner patches are grouped;
  19. ``bench.py 500 3 --biot``'s headline: ``mesh_hierarchy(
      unit_square(16), 6)`` (1,048,576 cells), ``biot_bench_fields`` (f32
      block-MG MINRES, rtol 1e-6): the set-up seconds of ``BiotMG`` by
      level (tables, power iteration, coarse inverse), MINRES iterations,
      residual and ms an iteration, the V-cycles' ms by level; then the
      engine (RT2, f32, 3 rows, chunk 131072) without and with weak
      symmetry on rows 0/1: strict and pipelined ms, launches (K1's by
      route), peak memory, the output against the plain route, K1 and K2
      on each call's operands;
  20. ``demos.biot.run`` (``demo_biot``'s configuration, P2/RT2, f64,
      MINRES to 1e-12) at n = 256: stage seconds, iterations, the
      divergence and jump checks of the three fields and the weak-symmetry
      check, K1 and K2 on the equilibrator's operands; at n = 16 card
      against CPU (1e-11 relative, iterations within one);
  21. multigrid: the P2 Poisson V-cycle MINRES for 2-6 levels from
      ``unit_square(4)``, the V-cycle's symmetry in f64 (block sizes 1 and
      2), the MG elasticity CG (P2) on the hierarchy of ``unit_square(8)``
      to 1,048,576 cells and the Herrmann MINRES (P3 x P2) on its first 6
      levels (262,144 cells), and
      ``run_perftest`` for "elasticity" and "biot" (orders 2-4, n0 = 8,
      nrefs = 4: to 16,384 cells), its structural columns held row for
      row to ``artifacts/Perftest_*.csv``;
  22. patch sharding and I/O (``parallel.ShardedEqlbEngine``, K1 and K2 on
      every rank): (a) ``entry.dryrun_multichip``'s four cases, f64, on 2
      gloo ranks spawned on the one card, each against the single-device
      engine, with every rank's K1 launches by route and K2 launches, and
      K1 and K2 against their plain versions on rank 0's operands; (b)
      phase 15's stress headline split over the same 2 ranks: host set-up
      and cache seconds, strict ms split into the rank-local solve, the
      partial combine and the all-reduce, peak memory per rank, the result
      against phase 15's call, K1 and K2 against their plain versions on
      rank 0's operands; (c) a one-rank NCCL group, bitwise equal to the
      single-device engine; (d) ``mesh.read_msh`` on the v2 and v4 texts of
      ``tests/test_msh_io.py`` with the equilibration on the imported mesh,
      card against CPU, and the reconstruction flow at n = 64 with its XDMF
      and VTU written to a temporary directory (the XDMF parsed, its
      inline data numeric);
  23. the port's bench (``python -m dolfinx_eqlb_tpu_torch.bench``), one
      process per mode: ``n`` (the headline: RT2, f32, one field),
      ``n --stress``, ``n --mixed`` (f64 curl-field data, K1 in f32 with an
      f64 correction, K4; the divergence residual re-checked in f64 on the
      CPU, relative residual <= 1e-12) and ``128 3 --biot`` (65,536
      cells): each must print its two JSON lines, strict first, without
      an error, with value > 0, vs_baseline null, this card, and the
      launches per timed call of ``BENCH_MODES``; then K1 and K2 against
      their plain versions on the ``128 3 --biot`` engine's own operands,
      built in this process by ``bench.setup`` (the other modes' shapes
      are those of phases 6, 10 and 15);
  24. the KKT path, f64 and f32, at RT3 on ``unit_square_unstructured(m)``,
      m = ceil(sqrt(2) n) (708 at n = 500: ~1,002,528 cells, the
      headline's size; what Gmsh users bring), one
      field, every boundary facet kind 1: host set-up seconds, patches by
      system size (D = 75, 90, 105 and 120 for most, on K3's wide route,
      D = 135 / 150 on its cluster route, by the port's size rule
      ``k3_admits``), strict and pipelined ms, the
      assembly / solve split (``torch.linalg.solve``'s by D, and the
      systems it took: none of K3's rule), peak memory, K3's launches by
      route (none on the shared route), the result against the f64 plain
      route, and K3 and
      K2 against their plain versions on every solve and the combine of
      one more call's own operands, K3 past the reference's size rule
      (D > 110) against ``torch.linalg.solve`` too, with the pivots of
      its pivot-free order on the f64 operands there (smallest
      |u_jj| / max|A|, which must stay above 1e-8, and against its own
      row of A; the growth);
  25. the same at RT4 on ``unit_square_unstructured(ceil(n / sqrt(2)))``
      (354 at n = 500: 250,636 cells, 126,027 patches), chunk 32768: D =
      130, 156, 182 and 208 for most, on K3's cluster route;
  26. K5 (the semi-explicit load moments) and K6 (the reduced step)
      alone at the shapes of the benchmark's semi-explicit cells: the
      engine on ``unit_square(n)``, RT2, chunk ``CHUNK``, in f32 (the main
      path's precision) and f64 (the cells'), one field and three folded
      into the lane axis; on each chunk each kernel's and its plain
      einsums' times on the same operands (K6's: K5's moments and the
      explicit step's particular solution), the byte bound and the error
      against the plain version (1e-6 relative in f32, 1e-13 in f64);
      then one f64 ``equilibrate``'s K5 and K6 launches (one a chunk, K6's
      split by epilogue into the interior chunks' "inverse" and the
      boundary chunks' "rhs") and its spans' routes.  Every semi-explicit
      path above counts K5 and K6 among its launches (phase 6 exactly one
      a chunk a call), every KKT path none.

Kernel times are CUDA-event means of single launches, each after a write
of 256 MB that leaves the 50 MB L2 cold.  ``--k1-sweep`` only builds the
kernels and times K1's tile route against its block route (several
thread counts) over D and X, the measurement ``k1_plan``'s split rests
on.  ``--phase22`` only builds the kernels and runs phase 22, ``--phase23``
phase 23, ``--phase24`` phase 8's rows at the wide route's shapes and
phase 24, ``--phase25`` phase 8's rows at the cluster route's shapes and
phase 25, ``--phase26`` phase 26.
``--profile`` writes its trace through ``utils.profiling.trace`` to
``smoke_out/profile``.  Any failure exits non-zero; nothing falls back to
the CPU.  The line before the last is a JSON object
with every kernel's launches, error, times and bound; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from dolfinx_eqlb_tpu_torch.ops import launches as read_launches
from dolfinx_eqlb_tpu_torch.ops import reset_launches

K1_SOURCE = "dolfinx_eqlb_tpu_torch/csrc/patch_solve.cu"
K1_REPLACES = "dolfinx_eqlb_tpu/ops/patch_solve.py:42"
K2_SOURCE = "dolfinx_eqlb_tpu_torch/csrc/lane_select.cu"
K2_REPLACES = "dolfinx_eqlb_tpu/ops/lane_select.py:30"
K3_SOURCE = K1_SOURCE
K3_CLUSTER_SOURCE = "dolfinx_eqlb_tpu_torch/csrc/patch_solve_cluster.cu"
K3_REPLACES = "dolfinx_eqlb_tpu/ops/patch_solve.py:170"
K4_SOURCE = K2_SOURCE
K4_REPLACES = "dolfinx_eqlb_tpu/ops/lane_select.py:90"
K5_SOURCE = "dolfinx_eqlb_tpu_torch/csrc/load_moments.cu"
# no TPU kernel: the JAX package's load moments are plain jnp
K5_REPLACES = "none (dolfinx_eqlb_tpu/eqlb/semiexplicit.py:267, plain jnp)"
K6_SOURCE = "dolfinx_eqlb_tpu_torch/csrc/reduced_step.cu"
# no TPU kernel: the reduced right-hand side and the inverse product are
# plain jnp there too
K6_REPLACES = ("none (dolfinx_eqlb_tpu/eqlb/semiexplicit.py "
               "reduced_system_bl and the interior inverse product, "
               "plain jnp)")
# max_patches_per_bucket of the main and KKT paths: the chunk size
# bench.py's headline configuration uses; it fixes the K1 and K3 shapes
# checked in phases 4 and 8
CHUNK = 131072
# max_patches_per_bucket of the mixed-precision path, bench.py --mixed
CHUNK_MIXED = 65536
# the boundary data's host-to-device bytes a call may take at 1M cells
# (the main path uploads the boundary facets' rows only: 2,000 at n = 500)
INPUT_BYTES_LIMIT = 64 * 1024
# H100 SXM (NVIDIA's data sheet): HBM3 bytes/s, and the card's peak
# FLOP/s for each type: f32 outside the tensor cores (TF32 would round the
# operands), f64 on the tensor cores (DMMA), the f64 peak a solve could
# reach, though the kernels here use no tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(device) -> None:
    torch.cuda.synchronize(device)


def dname(dtype) -> str:
    return str(dtype).split(".")[-1]


class Timer:
    """Device time of single calls by CUDA events, each call after a write
    of 256 MB so it starts with a cold L2, as the paths find their
    operands."""

    def __init__(self, device):
        self.device = device
        self.flush = torch.empty(64 * 2**20, dtype=torch.float32,
                                 device=device)

    def ms(self, fn, reps: int = 10, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        events = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        sync(self.device)
        return sum(s.elapsed_time(e) for s, e in events) / reps

    def fit(self, fn, budget_ms: float = 100.0, most: int = 5) -> float:
        """``ms`` after one warm-up launch, with as many repetitions (1 to
        ``most``) as fit in about ``budget_ms`` by the first timed one."""
        once = self.ms(fn, reps=1, warmup=1)
        reps = max(1, min(most, int(budget_ms / max(once, 1e-3))))
        return self.ms(fn, reps=reps, warmup=0) if reps > 1 else once


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    """Least time (ms) the card could take: the larger of the bytes over
    the HBM rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lu_flops(D: int, R: int) -> int:
    """Operations of one pivot-free solve as K1 and K3 do it: per
    elimination step, a division and the trailing multiply-adds of A and
    b; per back-substitution step, R dot products and divisions."""
    fwd = sum(m * (1 + 2 * m + 2 * R) for m in range(D))
    back = sum(R * (2 * m + 1) for m in range(D))
    return fwd + back


def lu_bound(D: int, R: int, X: int, dtype) -> tuple[float, str]:
    size = torch.tensor([], dtype=dtype).element_size()
    return bound((D * D + 2 * D * R) * X * size, lu_flops(D, R) * X, dtype)


def combine_bound(src: np.ndarray, nfk: int, R: int, dtype,
                  flops_per_dof: tuple[int, int]) -> tuple[float, str]:
    """Bytes of the combine: the index entries this run reads (2 per facet
    dof, 3 per cell dof), each contributor value once, each output once;
    ``flops_per_dof`` (facet, cell)."""
    ndofs = src.shape[0]
    ncell = ndofs - nfk
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * nfk + 3 * ncell) * (4 + R * size) + R * ndofs * size
    flops = R * (flops_per_dof[0] * nfk + flops_per_dof[1] * ncell)
    return bound(nbytes, flops, dtype)


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


def drive(call, device, strict: int = 5, rounds: int = 3,
          per_round: int = 8):
    """First call, ``strict`` calls with a sync after each (host clock),
    ``rounds`` of ``per_round`` calls in flight; returns the last output
    and the timings."""
    res = {}
    t0 = time.perf_counter()
    x = call()
    sync(device)
    res["first_call_s"] = time.perf_counter() - t0
    times = []
    for _ in range(strict):
        t0 = time.perf_counter()
        x = call()
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    pipelined = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(per_round):
            x = call()
        sync(device)
        pipelined.append((time.perf_counter() - t0) * 1e3 / per_round)
    res["strict_ms"] = times
    res["pipelined_ms"] = pipelined
    res["strict_ms_median"] = float(np.median(times))
    res["pipelined_ms_min"] = min(pipelined)
    return x, res


def spd_batch(X, D, R, dtype, device, gen):
    """Random SPD systems, batch-major: A (X, D, D), b (X, D, R)."""
    B = torch.randn((X, D, D), generator=gen, device=device, dtype=dtype)
    A = B @ B.transpose(1, 2) + D * torch.eye(D, dtype=dtype, device=device)
    del B
    return A, torch.randn((X, D, R), generator=gen, device=device,
                          dtype=dtype)


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


# K1 at the P4/RT4 adaptive L-shape's last step (phase 13), as the loop
# ran before the block route:
# the interior inverse builds (R = D) and a boundary solve (R = 1)
K1_RT4_SHAPES = [(49, 49, 1073), (43, 43, 70), (37, 37, 190), (31, 31, 274),
                 (28, 1, 132), (25, 25, 1022)]
# K1 about the tile route's split at R = D (13 in f64, 17 in f32)
K1_SPLIT_SHAPES = [(15, 15, CHUNK), (17, 17, CHUNK), (19, 19, CHUNK)]
# K1 at RT4's and RT5's interior size at the main path's chunk: the size of
# an RT4 / RT5 run on the crossed 1M-cell mesh
K1_LARGE_SHAPES = [(49, 49, CHUNK), (81, 81, CHUNK)]


def k1_shape_sets(engine, k3_shapes):
    """The shapes phase 4 takes K1 through, (set, D, R, X): the main path's
    (``solve_shapes``), the mixed path's chunk (its interior shapes at
    X = ``CHUNK_MIXED``), RT3's (``k3_shapes``, the D and R of an RT3
    engine's buckets at the main path's chunk), the tile route's split,
    the P4/RT4 L-shape's last step and RT4 / RT5 at the chunk."""
    main = solve_shapes(engine)
    mixed = [(D, R, CHUNK_MIXED) for D, R, X in main
             if R > 1 and X >= CHUNK_MIXED]
    return ([("main", *s) for s in main]
            + [("mixed", *s) for s in dict.fromkeys(mixed)]
            + [("rt3", D, R, CHUNK) for D, R in k3_shapes]
            + [("split", *s) for s in K1_SPLIT_SHAPES]
            + [("rt4", *s) for s in K1_RT4_SHAPES]
            + [("large", *s) for s in K1_LARGE_SHAPES])


def rt3_solve_sizes(device):
    """(D, R) of every K1 call an RT3 engine's main path makes, from its
    ``se_static`` on a small crossed mesh (the sizes do not grow with the
    mesh)."""
    from dolfinx_eqlb_tpu_torch.eqlb.engine import EqlbEngine
    from dolfinx_eqlb_tpu_torch.eqlb.patches import build_patches
    from dolfinx_eqlb_tpu_torch.fem import FunctionSpace
    from dolfinx_eqlb_tpu_torch.mesh import unit_square

    msh = unit_square(4)
    eng = EqlbEngine(FunctionSpace(msh, "RT", 3), build_patches(msh),
                     dtype=torch.float32, device=device)
    return sorted({(eng.se_static[key]["Dz"],
                    1 if b.is_boundary else eng.se_static[key]["Dz"])
                   for key, b in eng.buckets.items()}, reverse=True)


def k1_routes_taking(D, R, dtype) -> list:
    """K1's routes that take the shape, in ``K1_ROUTES`` order."""
    from dolfinx_eqlb_tpu_torch.ops.patch_solve import (
        K1_ROUTES, k1_block_fits, k1_tile_threads,
    )

    takes = {"tile": k1_tile_threads(D, dtype) is not None,
             "block": k1_block_fits(D, R, dtype), "global": True}
    return [rt for rt in K1_ROUTES if takes[rt]]


def k1_batch(X, D, R, dtype, device, gen):
    """A random SPD batch, batch-last: A (D, D, X), b (D, R, X)."""
    Abm, bbm = spd_batch(X, D, R, dtype, device, gen)
    A = Abm.permute(1, 2, 0).contiguous()
    del Abm
    b = bbm.permute(1, 2, 0).contiguous()
    return A, b


def k1_check(A, b, xp, route, tol, threads=None):
    """One launch of K1 by ``route`` against the plain result ``xp``:
    (max abs error, max error relative to max|xp|, ok)."""
    from dolfinx_eqlb_tpu_torch.ops.patch_solve import _solve_route_bl

    x = _solve_route_bl(A, b, route, threads)
    sync(A.device)
    err = float((x - xp).abs().max())
    rel = err / float(xp.abs().max())
    return err, rel, bool(torch.isfinite(x).all()) and rel <= tol


def phase_k1(shape_sets, device, timer):
    """K1's A/B/C: at every shape, every route that takes it ("tile",
    "block", "global") on the same random SPD batch, checked against the
    plain version and timed in turns (the routes, then the same in reverse
    order), beside the plain version, the library call (torch.linalg.solve
    on the same batch) and the bound.  Then every route that takes it once
    on each side of each split, checked and not timed: the tile route's
    ``K1_TILE_MAX_D`` (R = D) and ``K1_TILE_MAX_D_R1`` (R = 1) at the chunk,
    its ``K1_TILE_MIN_X`` at D = 9, its ``K1_TILE_SMALL_D`` at R = 1 and
    the main path's boundary X = 1996, and the block route's shared-memory
    limit (R = D, X = 64)."""
    from dolfinx_eqlb_tpu_torch.ops.patch_solve import (
        K1_TILE_MAX_D, K1_TILE_MAX_D_R1, K1_TILE_MIN_X, K1_TILE_SMALL_D,
        _solve_route_bl,
        batched_kkt_solve_bl_plain, k1_block_fits, k1_block_threads,
        k1_plan, k1_tile_threads,
    )

    gen = torch.Generator(device=device).manual_seed(0)
    rows, edges = [], []
    for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-12)):
        for name, D, R, X in shape_sets:
            A, b = k1_batch(X, D, R, dtype, device, gen)
            xp = batched_kkt_solve_bl_plain(A, b)
            route = k1_plan(D, R, dtype, X=X)
            routes = k1_routes_taking(D, R, dtype)
            row = dict(set=name, dtype=dname(dtype), D=D, R=R, X=X,
                       route=route, routes=routes, ok=True)
            for rt in routes:
                err, rel, ok = k1_check(A, b, xp, rt, tol)
                row[f"{rt}_max_abs_err"], row[f"{rt}_max_rel_err"] = err, rel
                row["ok"] &= ok
            del xp
            t = {rt: [] for rt in routes}
            for rt in routes + routes[::-1]:
                t[rt].append(timer.fit(lambda: _solve_route_bl(A, b, rt)))
            for rt in routes:
                row[f"{rt}_ms"] = sum(t[rt]) / 2
            row["ms"] = row[f"{route}_ms"]
            row["max_abs_err"] = row[f"{route}_max_abs_err"]
            row["plain_ms"] = timer.fit(
                lambda: batched_kkt_solve_bl_plain(A, b), 300.0, 3)
            row["library_ms"] = timer.fit(
                lambda: torch.linalg.solve(A.permute(2, 0, 1),
                                           b.permute(2, 0, 1)), 300.0, 3)
            row["bound_ms"], row["bound_by"] = lu_bound(D, R, X, dtype)
            row["tile_threads"] = k1_tile_threads(D, dtype)
            row["block_threads"] = k1_block_threads(D, R, X, dtype)
            rows.append(row)
            log(f"    K1 {name} {dname(dtype)} D={D} R={R} X={X}: "
                + ", ".join(f"{rt} {row[f'{rt}_ms']:.4f} ms (max_rel_err "
                            f"{row[f'{rt}_max_rel_err']:.3e})"
                            for rt in routes)
                + f", limit {tol:g}; plan {route} (tile "
                f"{row['tile_threads']} systems a block, block "
                f"{row['block_threads']} threads); plain "
                f"{row['plain_ms']:.4f} ms, torch.linalg.solve "
                f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
                f"({row['bound_by']}), share "
                f"{row['bound_ms'] / row['ms']:.4f}, library/plan "
                f"{row['library_ms'] / row['ms']:.2f}x"
                f"{'' if row['ok'] else '  FAILED'}")
            del A, b
            torch.cuda.empty_cache()
        split, split1 = K1_TILE_MAX_D[dtype], K1_TILE_MAX_D_R1[dtype]
        top = max(D for D in range(1, 400) if k1_block_fits(D, D, dtype))
        for D, R, X in ((split, split, CHUNK), (split + 1, split + 1, CHUNK),
                        (split1, 1, CHUNK), (split1 + 1, 1, CHUNK),
                        (9, 9, K1_TILE_MIN_X - 1), (9, 9, K1_TILE_MIN_X),
                        (K1_TILE_SMALL_D, 1, 1996),
                        (K1_TILE_SMALL_D + 1, 1, 1996),
                        (top, top, 64), (top + 1, top + 1, 64)):
            A, b = k1_batch(X, D, R, dtype, device, gen)
            xp = batched_kkt_solve_bl_plain(A, b)
            plan = k1_plan(D, R, dtype, X=X)
            for rt in k1_routes_taking(D, R, dtype):
                _, rel, ok = k1_check(A, b, xp, rt, tol)
                edges.append(dict(dtype=dname(dtype), D=D, R=R, X=X,
                                  route=rt, plan=plan, max_rel_err=rel,
                                  ok=ok))
                log(f"    K1 split check {dname(dtype)} D={D} R={R} X={X}: "
                    f"{rt} (plan {plan}) max_rel_err={rel:.3e} (limit "
                    f"{tol:g}){'' if ok else '  FAILED'}")
            del A, b, xp
    return rows, edges


def phase_k1_sweep(device, timer):
    """The tile route against the block route (its planned threads and
    128, 256, 512), each checked against the plain version and timed, over
    D and X where the plan chooses between them; then the block route's
    threads at the P4/RT4 L-shape's shapes and RT4 / RT5 at the chunk."""
    from dolfinx_eqlb_tpu_torch.ops.patch_solve import (
        _solve_route_bl, batched_kkt_solve_bl_plain, k1_block_threads,
        k1_plan, k1_tile_threads,
    )

    shapes = ([(D, D, X) for D in (5, 9, 13, 15, 17, 19, 21, 23, 25)
               for X in (1024, 4096, 16384, 65536, CHUNK)]
              + [(D, 1, X) for D in (5, 9, 15, 25)
                 for X in (1024, 16384, CHUNK)]
              + K1_RT4_SHAPES + [(49, 49, CHUNK), (81, 81, CHUNK // 4)])
    gen = torch.Generator(device=device).manual_seed(3)
    rows = []
    for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-12)):
        for D, R, X in shapes:
            A, b = k1_batch(X, D, R, dtype, device, gen)
            xp = batched_kkt_solve_bl_plain(A, b)
            planned = k1_block_threads(D, R, X, dtype)
            variants = [("tile", None)] if k1_tile_threads(D, dtype) else []
            variants += [("block", nt) for nt in
                         dict.fromkeys((planned, 128, 256, 512))]
            row = dict(dtype=dname(dtype), D=D, R=R, X=X,
                       plan=k1_plan(D, R, dtype, X=X), threads=planned,
                       ok=True, ms={})
            for rt, nt in variants:
                _, rel, ok = k1_check(A, b, xp, rt, tol, nt)
                key = rt if nt is None else f"block_t{nt}"
                row["ms"][key] = timer.fit(
                    lambda: _solve_route_bl(A, b, rt, nt), 40.0)
                row["ok"] &= ok
                if not ok:
                    row.setdefault("failed", []).append((key, rel))
            rows.append(row)
            best = min(row["ms"], key=row["ms"].get)
            log(f"    K1 sweep {row['dtype']} D={D} R={R} X={X}: plan "
                f"{row['plan']} (block {planned} threads); best {best} "
                f"{row['ms'][best]:.4f} ms; " + ", ".join(
                    f"{k} {v:.4f}" for k, v in row["ms"].items())
                + ("" if row["ok"] else f"  FAILED {row['failed']}"))
            del A, b, xp
            torch.cuda.empty_cache()
    return rows


def k1_plan_two_routes(D, R, dtype, X=None) -> str:
    """K1's plan before the block route: tile up to D = 25, else global."""
    return "tile" if D <= 25 else "global"


def phase_k1_loop_plans(device) -> dict:
    """The P4/RT4 adaptive L-shape by K1's plan before the block route
    (``k1_plan_two_routes``) and by ``k1_plan``, in turns: the loop's and the last
    step's equilibration seconds and K1's device time by route."""
    out = {}
    for name, plan in (("two_routes", k1_plan_two_routes), ("plan", None),
                       ("plan_again", None), ("two_routes_again", k1_plan_two_routes)):
        r = lshape_loop(4, device, label=f"P4/RT4 {name}", plan=plan)
        out[name] = {"seconds": r["seconds"], "iterations": r["iterations"],
                     "equilibrate_s": r["stage_totals_s"]["equilibrate"],
                     "last_equilibrate_s":
                         r["steps"][-1]["stages_s"]["equilibrate"],
                     "k1_launches_by_route": r["k1_launches_by_route"],
                     "k1_ms_by_route": r["k1_ms_by_route"]}
        log(f"    P4/RT4 loop by {name}: {json.dumps(out[name])}")
    return out


def check_k1_routes(path, by_route, shapes, dtype, failures):
    """Fail on a K1 launch by a route that ``k1_plan`` does not pick for
    the path's shapes."""
    from dolfinx_eqlb_tpu_torch.ops.patch_solve import k1_plan

    planned = {k1_plan(D, R, dtype, X=X) for D, R, X in shapes}
    stray = {rt: n for rt, n in by_route.items() if n and rt not in planned}
    if stray:
        failures.append(f"{path} launched K1 routes its shapes do not plan "
                        f"({planned}): {stray}")


def inverse_build_ms(engine, device, route=None) -> float:
    """The interior buckets' inverse build alone, as ``_device_tables``
    makes it (K1 with R = D on the cached A_z), host clock around
    synchronised builds, best of 3; ``route`` forces a K1 route."""
    from dolfinx_eqlb_tpu_torch.ops.patch_solve import _solve_route_bl

    dev, _ = engine._device_tables()
    best = float("inf")
    for _ in range(3):
        sync(device)
        t0 = time.perf_counter()
        for key in sorted(engine.buckets):
            if engine.buckets[key].is_boundary:
                continue
            Az = dev[key]["Az_bl"]
            Dz, _, P = Az.shape
            eye = torch.eye(Dz, dtype=Az.dtype, device=device)[:, :, None]
            eye = eye.expand(Dz, Dz, P).contiguous()
            if route is None:
                engine._dense_solve_bl(Az, eye)
            else:
                _solve_route_bl(Az, eye, route)
        sync(device)
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def phase_combine(name, src_np, nfk, L, dtypes, device, timer, seed):
    """K2 (``name="K2"``) or K4 (``"K4"``) against its plain version on a
    random flat vector over the engine's combine tables; K4 also against
    K2 in f64."""
    from dolfinx_eqlb_tpu_torch.ops.lane_select import (
        combine_gather, combine_gather_plain, ds_combine_gather,
        ds_combine_gather_plain,
    )

    kernel, plain = ((combine_gather, combine_gather_plain) if name == "K2"
                     else (ds_combine_gather, ds_combine_gather_plain))
    # operations per facet / cell dof: K2 adds; K4 splits (3 each), 2Sum
    # (6), the lo sum (2), the reconstruction (1) and the third term (5)
    flops_per_dof = (1, 2) if name == "K2" else (15, 20)
    src = torch.as_tensor(src_np, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = []
    for dtype in dtypes:
        flat = torch.randn((1, L), generator=gen, device=device, dtype=dtype)
        flat[:, -1] = 0.0  # the zero pad slot
        out = kernel(flat, src, nfk)
        ref = plain(flat, src, nfk)
        sync(device)
        equal = bool(torch.equal(out, ref))
        err = float((out - ref).abs().max())
        row = dict(dtype=dname(dtype), ndofs=src.shape[0], L=L,
                   bitwise=equal, max_abs_err=err)
        if name == "K4":
            x64 = combine_gather(flat, src, nfk)
            scale = float(x64.abs().max())
            row["vs_K2_f64"] = float((out - x64).abs().max())
            row["vs_K2_limit"] = 1e-12 * scale
            row["ok"] = equal and row["vs_K2_f64"] <= row["vs_K2_limit"]
        else:
            row["ok"] = equal
        row["ms"] = timer.ms(lambda: kernel(flat, src, nfk))
        row["plain_ms"] = timer.ms(lambda: plain(flat, src, nfk))
        row["bound_ms"], row["bound_by"] = combine_bound(
            src_np, nfk, 1, dtype, flops_per_dof)
        library = ""
        if name == "K2":
            # the one-call library sum: a bag of 3 rows of flat^T per dof
            # (an absent third contributor reads the zero slot); the layout
            # conversions stay outside the timed call
            idx, weight = src.long(), flat.T.contiguous()
            lib = torch.nn.functional.embedding_bag(idx, weight, mode="sum")
            row["library_max_abs_err"] = float((lib.T - out).abs().max())
            row["library_limit"] = 4 * torch.finfo(dtype).eps * float(
                out.abs().max())
            row["ok"] = row["ok"] and (row["library_max_abs_err"]
                                       <= row["library_limit"])
            row["library_ms"] = timer.ms(lambda: torch.nn.functional
                                         .embedding_bag(idx, weight,
                                                        mode="sum"))
            library = (f", embedding_bag {row['library_ms']:.4f} ms (max|lib"
                       f" - K2| {row['library_max_abs_err']:.3e}, limit "
                       f"{row['library_limit']:.3e})")
        rows.append(row)
        extra = (f", vs K2 {row['vs_K2_f64']:.3e} (limit "
                 f"{row['vs_K2_limit']:.3e})" if name == "K4" else "")
        log(f"    {name} {row['dtype']} ndofs={src.shape[0]} L={L}: "
            f"bitwise_equal={equal}{extra}; kernel {row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms{library}, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})"
            f"{'' if row['ok'] else '  FAILED'}")
    return rows


def phase_main(engine, data, device, profile=False):
    """The main path through both kernels: counts, timings, checks."""
    from dolfinx_eqlb_tpu_torch.eqlb.engine import EqlbEngine
    from dolfinx_eqlb_tpu_torch.eqlb.semiexplicit import (
        solve_bucket_semiexplicit,
    )
    from dolfinx_eqlb_tpu_torch.ops.lane_select import combine_gather_plain

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

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.perf_counter()
    engine._device_tables()
    sync(device)
    res["geometry_caches_s"] = time.perf_counter() - t0
    x, timing = drive(call, device)
    res["launches"] = read_launches()
    res["k1_launches_by_route"] = read_launches(split=True)["K1"]
    res["k6_launches_by_epilogue"] = read_launches(split=True)["K6"]
    # stage 3 runs eagerly on the first call, as a captured graph after
    res["graph_captures"] = engine.graph_captures
    res["graph_replays"] = engine.graph_replays
    res.update(timing)
    # one more call on the boundary data's host arrays, as ``_solve`` hands
    # them: only the boundary facets' rows go up, and the output is the
    # device-tensor call's bit for bit
    uploads = engine.input_uploads
    x_host = engine.equilibrate(dpT, drT, facet_kind, bvals,
                                transposed_inputs=True)
    sync(device)
    res["input_bytes"] = engine.input_bytes
    res["input_uploads"] = engine.input_uploads - uploads
    res["host_bc_bitwise"] = bool(torch.equal(x_host, x))
    del x_host
    res["calls"] = (1 + len(timing["strict_ms"])
                    + 8 * len(timing["pipelined_ms"]))
    res["chunks"] = len(engine.buckets)
    res["k5_launches_per_call"] = res["launches"]["K5"] / res["calls"]
    res["k6_launches_per_call"] = res["launches"]["K6"] / res["calls"]
    res["interior_chunks"] = sum(not b.is_boundary
                                 for b in engine.buckets.values())
    res["inverse_build_ms"] = inverse_build_ms(engine, device)
    res["inverse_build_ms_by_route"] = {
        rt: inverse_build_ms(engine, device, rt)
        for rt in read_launches(split=True)["K1"]}
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
    x_ref = combine_gather_plain(
        ref._bucket_solutions(ref._pack_dofs(dpT, drT, True), fk, bv),
        ref._combine_src(), ref._nfk)
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
        flat = engine._bucket_solutions(dprT, fk, bv)
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
        from torch.profiler import record_function

        from dolfinx_eqlb_tpu_torch.utils import trace

        call()
        sync(device)
        with trace("smoke_out/profile") as prof:
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
        res["chrome_trace"] = prof.chrome_trace
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


def kkt_shapes(engine):
    """(D, R, X) of every K3 call the KKT path makes with one RHS (the
    port's size rule, ``k3_admits``)."""
    from dolfinx_eqlb_tpu_torch.eqlb.engine import k3_admits

    shapes = []
    for key in sorted(engine.buckets):
        D, _ = engine.kkt_size(key)
        shape = (D, 1, engine.tables[key]["gdofs"].shape[0])
        if k3_admits(D, 1) and shape not in shapes:
            shapes.append(shape)
    return shapes


# K3 at the wide route's KKT sizes (RT3 on an unstructured mesh: D = 75,
# 90 and 105, phase 24) at the main path's chunk, and at D = 120 at the
# size of phase 24's D = 120 bucket (24,662 interior 8-cell patches at
# n = 500)
K3_WIDE_SHAPES = [(75, 1, CHUNK), (90, 1, CHUNK), (105, 1, CHUNK),
                  (120, 1, 24662)]
# max_patches_per_bucket of phase 25 (the KKT path at RT4): its f64 plain
# route (torch.linalg.solve) and K3's checks on the call's operands hold
# about four copies of a bucket's systems, 6.4 GB each at D = 156
CHUNK_RT4 = 32768
# K3 at the cluster route's KKT sizes, phase 25's buckets (RT4 on
# unit_square_unstructured(354) at chunk CHUNK_RT4: 33,458 / 51,730 /
# 29,072 / 6,142 interior patches of 5-8 cells at D = 130 / 156 / 182 /
# 208)
K3_CLUSTER_SHAPES = [(130, 1, CHUNK_RT4), (156, 1, CHUNK_RT4),
                     (182, 1, 29072), (208, 1, 6142)]
# (D, R) of phase 8's untimed checks at a small batch: the register tiles
# 7 x 4 and 8 x 5 at their edges (32, 33, 64), every wide tile at its
# edges (65 ... 127, R = 2 at the 7 x 7 and 8 x 8 tiles' last columns;
# 112 the first 8 x 8 shape at R = 1), every cluster tile at its edges
# (D + R = 129, 160 / 161, 192 / 193 and 256, R = 2 at 2 x (5 x 10) and
# 4 x (4 x 16)) and at RT3's 9- and 10-cell patches and RT4's 9-cell ones
# (D = 135, 150, 234)
K3_EDGE_CHECKS = [(32, 1), (33, 1), (64, 1), (65, 1), (79, 1), (80, 1),
                  (95, 1), (96, 1), (110, 1), (110, 2), (112, 1), (120, 1),
                  (127, 1), (126, 2), (128, 1), (135, 1), (150, 1),
                  (159, 1), (158, 2), (160, 1), (191, 1), (192, 1),
                  (234, 1), (255, 1), (254, 2)]


def phase_k3(shapes, device, timer, edges=K3_EDGE_CHECKS):
    """K3 against its plain version on random SPD batch-major systems, by
    the route ``k3_plan`` picks and, on the same batch, by the routes it is
    held against (timed in turns): the shared-memory route beside a
    register or wide tile, every other cluster tile that covers the shape
    beside a cluster tile.  The library call is torch.linalg.solve on the
    same batch; past the wide tiles (D + R > 128), where the reference
    pivots, the planned route is held to it too.  Then the route
    ``k3_plan`` picks once at a small batch, checked and not timed, at each
    (D, R) of ``edges``, so that every route is launched and checked."""
    from dolfinx_eqlb_tpu_torch.ops.patch_solve import (
        K3_CLUSTER_TILES, _solve_route, _tile_covers, batched_kkt_solve,
        batched_kkt_solve_plain, k3_plan,
    )

    def beside(D, R, route, dtype):
        tiles = K3_CLUSTER_TILES[dtype]
        if route in tiles:
            return [rt for rt in tiles
                    if rt != route and _tile_covers(rt, D, R)]
        return ["shared"]

    def linalg_rel(A, b, x):
        xl = torch.linalg.solve(A, b)
        return float((x - xl).abs().max()) / float(xl.abs().max())

    gen = torch.Generator(device=device).manual_seed(3)
    rows, tiles = [], []
    for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-12)):
        for D, R, X in shapes:
            A, b = spd_batch(X, D, R, dtype, device, gen)
            xp = batched_kkt_solve_plain(A, b)
            scale = float(xp.abs().max())
            route = k3_plan(D, R, dtype)
            alts = beside(D, R, route, dtype)
            row = dict(dtype=dname(dtype), D=D, R=R, X=X, route=route,
                       beside=alts)
            for name, rt in (("", route), *((f"{a}_", a) for a in alts)):
                x = _solve_route(A, b, rt)
                sync(device)
                err = float((x - xp).abs().max())
                row[f"{name}max_abs_err"] = err
                row[f"{name}max_rel_err"] = err / scale
                row[f"{name}ok"] = (bool(torch.isfinite(x).all())
                                    and err / scale <= tol)
                if not name and D + R > 128:
                    row["linalg_max_rel_err"] = linalg_rel(A, b, x)
                    row["ok"] = row["ok"] and row["linalg_max_rel_err"] <= tol
                del x
            del xp
            # routes in turns: planned, the others, the others, planned;
            # up to 5 launches a turn, as many as fit in ~150 ms
            t = {rt: [] for rt in (route, *alts)}
            for rt in (route, *alts, *alts, route):
                t[rt].append(timer.fit(
                    lambda: _solve_route(A, b, rt), budget_ms=150.0))
            row["ms"] = sum(t[route]) / 2
            for a in alts:
                row[f"{a}_ms"] = sum(t[a]) / 2
            row["plain_ms"] = timer.ms(lambda: batched_kkt_solve_plain(A, b),
                                       reps=1, warmup=0)
            row["library_ms"] = timer.ms(lambda: torch.linalg.solve(A, b),
                                         reps=2, warmup=1)
            row["bound_ms"], row["bound_by"] = lu_bound(D, R, X, dtype)
            row["ok"] = row["ok"] and all(row[f"{a}_ok"] for a in alts)
            rows.append(row)
            log(f"    K3 {dname(dtype)} D={D} R={R} X={X}: {route} "
                f"{row['ms']:.4f} ms (max_rel_err {row['max_rel_err']:.3e}"
                + (f", vs torch.linalg.solve {row['linalg_max_rel_err']:.3e}"
                   if "linalg_max_rel_err" in row else "") + "), "
                + "".join(f"{a} {row[f'{a}_ms']:.4f} ms (max_rel_err "
                          f"{row[f'{a}_max_rel_err']:.3e}), " for a in alts)
                + f"limit {tol:g}; plain {row['plain_ms']:.4f} ms, "
                f"torch.linalg.solve {row['library_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}), share "
                f"{row['bound_ms'] / row['ms']:.3f}"
                f"{'' if row['ok'] else '  FAILED'}")
            del A, b
        for D, R in edges:
            A, b = spd_batch(4096, D, R, dtype, device, gen)
            xp = batched_kkt_solve_plain(A, b)
            route = k3_plan(D, R, dtype)
            x = batched_kkt_solve(A, b)
            sync(device)
            rel = float((x - xp).abs().max()) / float(xp.abs().max())
            ok = bool(torch.isfinite(x).all()) and rel <= tol
            tile = dict(dtype=dname(dtype), D=D, R=R, X=4096, route=route,
                        max_rel_err=rel)
            if D + R > 128:
                tile["linalg_max_rel_err"] = linalg_rel(A, b, x)
                ok = ok and tile["linalg_max_rel_err"] <= tol
            tile["ok"] = ok
            tiles.append(tile)
            log(f"    K3 tile check {dname(dtype)} D={D} R={R} X=4096: {route} "
                f"max_rel_err={rel:.3e}"
                + (f", vs torch.linalg.solve {tile['linalg_max_rel_err']:.3e}"
                   if "linalg_max_rel_err" in tile else "")
                + f" (limit {tol:g}){'' if ok else '  FAILED'}")
            del A, b, x, xp
    return rows, tiles


def kkt_stages(eng, args, device) -> tuple[dict, dict]:
    """Where a KKT call's time goes: the assembly and the solves of every
    bucket, the solves split into K3's and the pivoted
    ``torch.linalg.solve``'s (in all and by D), each solve classed by
    whether K3's launch count moved; host clock around synchronised
    stages, best of 2 calls.  Returns the stages and the systems
    ``torch.linalg.solve`` took, by D."""
    dp, dr, fk, bv = args
    kdev, krefd = eng._kkt_tables()
    best, pivoted = {}, {}
    for _ in range(2):
        stages = {"assembly_ms": 0.0, "solve_k3_ms": 0.0,
                  "solve_linalg_ms": 0.0}
        pivoted = {}
        for key in sorted(eng.buckets):
            t0 = time.perf_counter()
            Ar, br, _ = eng._assemble_bucket(key, dp, dr, fk, bv, kdev[key],
                                             krefd)
            sync(device)
            t1 = time.perf_counter()
            before = read_launches()["K3"]
            eng._kkt_solve(Ar, br[..., None])
            sync(device)
            ms = (time.perf_counter() - t1) * 1e3
            stages["assembly_ms"] += (t1 - t0) * 1e3
            if read_launches()["K3"] > before:
                stages["solve_k3_ms"] += ms
            else:
                D = Ar.shape[-1]
                stages["solve_linalg_ms"] += ms
                name = f"solve_linalg_D{D}_ms"
                stages[name] = stages.get(name, 0.0) + ms
                pivoted[D] = pivoted.get(D, 0) + Ar.numel() // (D * D)
            del Ar, br
        best = {name: min(val, best.get(name, val))
                for name, val in stages.items()}
    return best, dict(sorted(pivoted.items()))


def phase_kkt(eng64, msh, device, operand_checks=False):
    """The KKT path at full width, f64 and f32 (K3 and K2), each against
    the f64 plain route: solver "torch" and the plain combine; then K2
    against its plain version on one more call's combine input and, with
    ``operand_checks``, K3 on every solve of that call's own operands
    (``capture_dense_solves(check=True)``)."""
    from dolfinx_eqlb_tpu_torch.eqlb.engine import EqlbEngine
    from dolfinx_eqlb_tpu_torch.ops.lane_select import combine_gather_plain

    def engine(dtype, solver):
        eng = EqlbEngine.from_host_tables(
            eng64.V, eng64.buckets, eng64.tables, eng64.se_static, eng64.ref,
            dtype=dtype, device=device)
        eng.mode = "kkt"
        eng.solver = solver
        return eng

    dp, dr, fk, bv = make_data(msh, eng64.k, 1, seed=4, np_dtype=np.float64)
    fk = torch.as_tensor(fk, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    ref = engine(torch.float64, "torch")
    dp64 = torch.as_tensor(dp, device=device)
    dr64 = torch.as_tensor(dr, device=device)
    bv64 = torch.as_tensor(bv, device=device)
    x_ref = combine_gather_plain(
        ref._bucket_solutions_kkt(dp64, dr64, fk, bv64), ref._combine_src(),
        ref._nfk)
    del ref
    ref_peak = torch.cuda.max_memory_allocated(device) / 2**30
    scale = float(x_ref.abs().max())
    out = {}
    for dtype in (torch.float64, torch.float32):
        eng = engine(dtype, "kernel")
        args = [t.to(dtype) for t in (dp64, dr64)] + [fk, bv64.to(dtype)]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        reset_launches()
        x, res = drive(lambda: eng.equilibrate(*args), device, strict=3,
                       rounds=1, per_round=4)
        res["launches"] = read_launches()
        res["k3_launches_by_route"] = read_launches(split=True)["K3"]
        res["peak_mem_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        res["stages_ms"], res["pivoted_systems_by_D"] = kkt_stages(
            eng, args, device)
        flats, combine = [], eng._combine_flat
        eng._combine_flat = lambda flat: flats.append(flat) or combine(flat)
        try:
            if operand_checks:
                res["k3_checks"] = capture_dense_solves(
                    lambda: eng.equilibrate(*args), check=True)[1]
            else:
                eng.equilibrate(*args)
        finally:
            del eng._combine_flat
        res["k2_check"] = k2_operand_check(eng, flats[0])
        del flats
        # the peak of the f64 plain route, and of this dtype's calls with
        # the checks on their operands
        res["ref_peak_gib"] = ref_peak
        res["checks_peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        res["finite"] = bool(torch.isfinite(x).all())
        res["shape_ok"] = tuple(x.shape) == tuple(x_ref.shape)
        res["max_abs_err_vs_plain_f64"] = float(
            (x.double() - x_ref).abs().max())
        res["err_limit"] = (1e-11 * max(1.0, scale)
                            if dtype == torch.float64 else 1e-3 * scale)
        res["ok"] = (res["finite"] and res["shape_ok"]
                     and res["max_abs_err_vs_plain_f64"] <= res["err_limit"])
        out[dname(dtype)] = res
        del eng, x
    return out


def unstructured_n(n: int) -> int:
    """Phase 24's size m: ``unit_square_unstructured(m)`` has about 2 m^2
    cells, as many as the crossed ``unit_square(n)``'s 4 n^2 (m = 708 at
    the headline's n = 500)."""
    return math.ceil(n * math.sqrt(2))


def unstructured_n_rt4(n: int) -> int:
    """Phase 25's size m: ``unit_square_unstructured(m)`` with a quarter
    of the headline's cells (m = 354 at n = 500: 250,636 cells, 126,027
    patches), since an RT4 KKT system holds 26 dofs a cell against RT3's
    15: ~25 GB of f64 systems a call, a little below phase 24's ~32 GB."""
    return math.ceil(n / math.sqrt(2))


def kkt_patches_by_size(engine) -> dict:
    """Patches of the KKT path by system size D (every bucket, the sizes
    past K3's rule included)."""
    sizes = {}
    for key in engine.buckets:
        D, _ = engine.kkt_size(key)
        sizes[D] = sizes.get(D, 0) + engine.tables[key]["gdofs"].shape[0]
    return dict(sorted(sizes.items()))


def phase_kkt_unstructured(device, n: int, k: int = 3,
                           chunk: int = CHUNK) -> dict:
    """Phases 24 and 25: the KKT cross-check path at RT ``k`` on
    ``unit_square_unstructured(n)`` (what Gmsh users bring), one field,
    ``make_data``'s random data with every boundary facet kind 1: at RT3
    most of its patch systems have D = 75, 90, 105 or 120 and take K3's
    wide route, D = 135 / 150 its cluster route; at RT4 most have D = 130,
    156, 182 or 208 and take the cluster route.  ``phase_kkt`` on an f64
    engine of the mesh (chunk ``chunk``), with K3 held against its plain
    version (and past D = 110 against ``torch.linalg.solve``) on every
    solve of one more call's own operands; the host set-up seconds beside
    it."""
    from dolfinx_eqlb_tpu_torch.eqlb.engine import EqlbEngine
    from dolfinx_eqlb_tpu_torch.eqlb.patches import build_patches
    from dolfinx_eqlb_tpu_torch.fem import FunctionSpace
    from dolfinx_eqlb_tpu_torch.mesh import unit_square_unstructured

    t_start = time.perf_counter()
    setup = {}
    t0 = time.perf_counter()
    msh = unit_square_unstructured(n)
    setup["mesh_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    buckets = build_patches(msh)
    setup["patches_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng64 = EqlbEngine(FunctionSpace(msh, "RT", k), buckets,
                       dtype=torch.float64, device=device,
                       max_patches_per_bucket=chunk)
    setup["tables_s"] = time.perf_counter() - t0
    res = dict(n=n, k=k, chunk=chunk, cells=msh.num_cells,
               patches=sum(b.npatches for b in buckets.values()),
               patches_by_D=kkt_patches_by_size(eng64),
               shapes=kkt_shapes(eng64), setup=setup)
    t0 = time.perf_counter()
    res["paths"] = phase_kkt(eng64, msh, device, operand_checks=True)
    # the whole run's peak: the f64 plain route and the checks on the
    # call's operands included
    res["run_peak_gib"] = max(max(p["ref_peak_gib"], p["checks_peak_gib"])
                              for p in res["paths"].values())
    res["run_s"] = time.perf_counter() - t0
    res["seconds"] = time.perf_counter() - t_start
    return res


def report_kkt(kkt: dict, label: str, shapes, nph: int, failures: list,
               nph_this: int) -> None:
    """Print a KKT phase (9, 24 or 25) and add its failures: a path off
    the f64 plain route, a kernel skipped, a K3 route launched that no
    shape of the path plans, K2 off its plain version on the call's
    combine input, K3 off its plain version on the call's operands where
    they were checked, and a system of K3's rule that torch.linalg.solve
    took."""
    from dolfinx_eqlb_tpu_torch.eqlb.engine import k3_admits
    from dolfinx_eqlb_tpu_torch.ops.patch_solve import k3_plan

    for dt, r in kkt.items():
        checks, k2 = r.get("k3_checks"), r["k2_check"]
        on_operands = (
            f"; K2 vs plain on its operands: ndofs={k2['ndofs']} "
            f"L={k2['L']} bitwise {k2['bitwise']}")
        on_operands += "" if checks is None else (
            "; K3 vs plain on its operands: " + "; ".join(
                f"D={c['D']} X={c['X']} {c['route']} max_rel_err "
                f"{c['max_rel_err']:.3e}" + (
                    f", vs torch.linalg.solve {c['linalg_max_rel_err']:.3e}"
                    if "linalg_max_rel_err" in c else "")
                + (f", pivot-free order's smallest |u_jj|/max|A| "
                   f"{c['pivot_ratio']:.3e} (step {c['pivot_step']}, floor "
                   f"{PIVOT_FLOOR:g}), |u_jj|/max|row j of A| "
                   f"{c['pivot_row_ratio']:.3e}, growth {c['growth']:.3f}"
                   if "pivot_ratio" in c else "")
                + f" (limit {c['limit']:g})" for c in checks))
        log(f"[{nph_this}/{nph}] KKT path {label} {dt} 1 field: "
            f"first call {r['first_call_s']:.3f} s; strict "
            f"{r['strict_ms_median']:.3f} ms median, pipelined "
            f"{r['pipelined_ms_min']:.3f} ms ({r['stages_ms']}; systems "
            f"torch.linalg.solve took, by D: {r['pivoted_systems_by_D']}); peak "
            f"{r['peak_mem_gib']:.2f} GiB; launches {r['launches']}, K3 by "
            f"route {r['k3_launches_by_route']}; max|x - plain f64| "
            f"{r['max_abs_err_vs_plain_f64']:.3e} (limit "
            f"{r['err_limit']:.3e}){on_operands}"
            f"{'' if r['ok'] else '  FAILED'}")
        log("    detail: " + json.dumps(r))
        if not r["ok"]:
            failures.append(f"KKT path {label} {dt} disagrees with the "
                            f"plain route")
        if (r["launches"]["K3"] <= 0 or r["launches"]["K2"] <= 0
                or r["launches"]["K5"] or r["launches"]["K6"]):
            failures.append(f"KKT path {label} {dt} skipped a kernel: "
                            f"{r['launches']}")
        planned = {k3_plan(D, R, getattr(torch, dt)) for D, R, _ in shapes}
        stray = {rt: n for rt, n in r["k3_launches_by_route"].items()
                 if n and rt not in planned}
        skipped = {rt for rt in planned if not r["k3_launches_by_route"][rt]}
        if stray or skipped:
            failures.append(f"KKT path {label} {dt} launched K3 routes its "
                            f"shapes do not plan ({planned}): {stray}, or "
                            f"skipped planned ones: {skipped}")
        if not k2["ok"]:
            failures.append(f"KKT path {label} {dt}: K2 disagrees with its "
                            f"plain version on the call's operands")
        if checks is not None and not (checks
                                       and all(c["ok"] for c in checks)):
            failures.append(f"KKT path {label} {dt}: K3 disagrees with its "
                            f"plain version or torch.linalg.solve on the "
                            f"call's operands, or a pivot of the pivot-free "
                            f"order fell to {PIVOT_FLOOR:g} of max|A|")
        admitted = [D for D in r["pivoted_systems_by_D"] if k3_admits(D, 1)]
        if admitted:
            failures.append(f"KKT path {label} {dt}: torch.linalg.solve took "
                            f"systems K3's rule admits, D = {admitted}")


def report_kkt_unstructured(r: dict, nph: int, failures: list,
                            nph_this: int = 24) -> None:
    s = r["setup"]
    label = f"unit_square_unstructured({r['n']}) RT{r['k']}"
    log(f"[{nph_this}/{nph}] KKT path {label}: "
        f"{r['cells']} cells, {r['patches']} patches (chunk {r['chunk']}), "
        f"by KKT size D {r['patches_by_D']}; K3 shapes (D, R, X) "
        f"{r['shapes']}; host set-up mesh {s['mesh_s']:.2f} s, patches "
        f"{s['patches_s']:.2f} s, engine tables {s['tables_s']:.2f} s; run "
        f"{r['run_s']:.1f} s (peak {r['run_peak_gib']:.2f} GiB with the f64 "
        f"plain route and the operand checks), phase {r['seconds']:.1f} s")
    report_kkt(r["paths"], label, r["shapes"], nph, failures, nph_this)
    for dt, p in r["paths"].items():
        if p["k3_launches_by_route"]["shared"]:
            failures.append(f"KKT path {label} {dt}: K3's shared route "
                            f"launched at the tiled routes' shapes")


def phase_mixed(V, buckets, msh, device):
    """The mixed-precision path at full width (bench.py --mixed: f64 data,
    chunk 65536): solver "kernel_mixed" (K1 in f32 plus an f64
    correction), combine "ds" (K4), against the f64 plain route; then the
    native-f64 kernel route and "kernel_mixed" with the K2 combine on the
    same host tables, for their times."""
    from dolfinx_eqlb_tpu_torch.eqlb.engine import EqlbEngine
    from dolfinx_eqlb_tpu_torch.ops.lane_select import combine_gather_plain

    t0 = time.perf_counter()
    engm = EqlbEngine(V, buckets, dtype=torch.float64, device=device,
                      max_patches_per_bucket=CHUNK_MIXED)
    res = {"engine_tables_s": time.perf_counter() - t0}
    dp, dr, fk, bv = make_data(msh, engm.k, 1, seed=5, np_dtype=np.float64)
    dpT, drT = engm.put_transposed(dp, dr)
    fk = torch.as_tensor(fk, device=device)
    bv = torch.as_tensor(bv, device=device)

    host = (engm.V, engm.buckets, engm.tables, engm.se_static, engm.ref)

    def engine(solver, combine):
        eng = EqlbEngine.from_host_tables(*host, dtype=torch.float64,
                                          device=device)
        eng.solver, eng.combine = solver, combine
        return eng

    ref = engine("torch", "gather")
    x_ref = combine_gather_plain(
        ref._bucket_solutions(ref._pack_dofs(dpT, drT, True), fk, bv),
        ref._combine_src(), ref._nfk)
    del ref
    engm.solver, engm.combine = "kernel_mixed", "ds"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.perf_counter()
    engm._device_tables()
    sync(device)
    res["geometry_caches_s"] = time.perf_counter() - t0
    x, timing = drive(
        lambda: engm.equilibrate(dpT, drT, fk, bv, transposed_inputs=True),
        device)
    res["launches"] = read_launches()
    res["k1_launches_by_route"] = read_launches(split=True)["K1"]
    res["k1_shapes"] = solve_shapes(engm)
    res.update(timing)
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    res["chunks"] = len(engm.buckets)
    res["finite"] = bool(torch.isfinite(x).all())
    res["shape_ok"] = tuple(x.shape) == tuple(x_ref.shape)
    res["max_abs_err_vs_plain_f64"] = float((x - x_ref).abs().max())
    res["err_limit"] = 1e-9 * max(1.0, float(x_ref.abs().max()))
    res["ok"] = (res["finite"] and res["shape_ok"]
                 and res["max_abs_err_vs_plain_f64"] <= res["err_limit"])
    del engm, x
    for solver, combine in (("kernel", "gather"), ("kernel_mixed", "gather")):
        eng = engine(solver, combine)
        torch.cuda.empty_cache()
        eng._device_tables()
        x, timing = drive(
            lambda: eng.equilibrate(dpT, drT, fk, bv, transposed_inputs=True),
            device)
        timing["max_abs_err_vs_plain_f64"] = float((x - x_ref).abs().max())
        res[f"route_{solver}_{combine}"] = {
            key: timing[key] for key in ("strict_ms_median",
                                         "pipelined_ms_min",
                                         "max_abs_err_vs_plain_f64")}
        del eng, x
    return res


def flux_kernel_checks(eq, timer=None) -> dict:
    """K1 and K2 against their plain versions on an equilibrator's own
    operands (``engine_kernel_checks`` of one more ``equilibrate_fluxes``
    call)."""
    return engine_kernel_checks(eq.engine, eq.equilibrate_fluxes, timer)


def engine_kernel_checks(eng, call, timer=None) -> dict:
    """K1 and K2 against their plain versions on an engine's own operands,
    at the shapes its buckets give them: every K1 solve of one more
    ``call()`` (the boundary buckets' masked systems, R = 1), the interior
    buckets' inverse builds from the cached A_z (R = D), and the call's
    combine.  K1 within 1e-12 of the plain solve relative to its largest
    entry in f64 (1e-4 in f32); K2 bitwise.  With a ``timer``, each K1
    operand set is also timed by the route ``k1_plan`` picks, beside its
    plain version, ``torch.linalg.solve`` and its bound.  Run after the
    path's launches are read."""
    from dolfinx_eqlb_tpu_torch.ops.patch_solve import (
        batched_kkt_solve_bl, batched_kkt_solve_bl_plain, k1_plan,
    )

    solves, flats = [], []
    solve, combine = eng._dense_solve_bl, eng._combine_flat
    eng._dense_solve_bl = lambda A, b: solves.append((A, b)) or solve(A, b)
    eng._combine_flat = lambda flat: flats.append(flat) or combine(flat)
    try:
        call()
    finally:
        del eng._dense_solve_bl, eng._combine_flat
    dev, _ = eng._device_tables()
    for key in sorted(eng.buckets):
        if not eng.buckets[key].is_boundary:
            Az = dev[key]["Az_bl"]
            Dz, _, P = Az.shape
            eye = torch.eye(Dz, dtype=Az.dtype, device=Az.device)[:, :, None]
            solves.append((Az, eye.expand(Dz, Dz, P).contiguous()))
    k1 = []
    for A, b in solves:
        x = batched_kkt_solve_bl(A, b)
        xp = batched_kkt_solve_bl_plain(A, b)
        err = float((x - xp).abs().max())
        rel = err / float(xp.abs().max())
        D, R, X = b.shape
        tol = 1e-12 if A.dtype == torch.float64 else 1e-4
        row = dict(dtype=dname(A.dtype), D=D, R=R, X=X, max_abs_err=err,
                   max_rel_err=rel, route=k1_plan(D, R, A.dtype, X=X),
                   ok=bool(torch.isfinite(x).all()) and rel <= tol)
        if timer is not None:
            row["ms"] = timer.ms(lambda: batched_kkt_solve_bl(A, b), reps=5)
            row["plain_ms"] = timer.ms(
                lambda: batched_kkt_solve_bl_plain(A, b), reps=3, warmup=1)
            row["library_ms"] = timer.ms(
                lambda: torch.linalg.solve(A.permute(2, 0, 1),
                                           b.permute(2, 0, 1)),
                reps=3, warmup=1)
            row["bound_ms"], row["bound_by"] = lu_bound(D, R, X, A.dtype)
        k1.append(row)
        del x, xp
    return {"K1": k1, "K2": k2_operand_check(eng, flats[0])}


def k2_operand_check(eng, flat) -> dict:
    """K2 against its plain version on an engine's captured combine input
    (the argument of one ``_combine_flat`` call), bitwise."""
    from dolfinx_eqlb_tpu_torch.ops.lane_select import (
        combine_gather, combine_gather_plain,
    )

    src = eng._combine_src()
    out = combine_gather(flat, src, eng._nfk)
    ref = combine_gather_plain(flat, src, eng._nfk)
    k2 = dict(dtype=dname(out.dtype), ndofs=out.shape[1], L=flat.shape[1],
              bitwise=bool(torch.equal(out, ref)),
              max_abs_err=float((out - ref).abs().max()))
    k2["ok"] = k2["bitwise"]
    del out, ref
    return k2


def flux_flow(msh, bc: str, device, degree: int = 2) -> dict:
    """``demos/demo_reconstruction.py``'s flow with the port, P2 primal and
    RT2 flux (``degree``), f64, one field: the projected RHS, the primal
    Poisson solve (rtol 1e-13), the projected flux -grad(uh), then
    ``FluxEqlbSE`` and ``FluxEqlbEV`` (construct, set the BCs, equilibrate
    twice) and the condition checks at the JAX package's default
    tolerances.  ``bc``: "dirichlet" (every boundary facet primal
    Dirichlet) or "neumann_inhom" (Neumann on x in {0, 1}, the projected
    trace shared by the primal load and the flux BCs).  Kernel launches
    are counted from just before each equilibrator's first call to just
    after its second."""
    from dolfinx_eqlb_tpu_torch.eqlb import FluxEqlbEV, FluxEqlbSE, fluxbc
    from dolfinx_eqlb_tpu_torch.eqlb import checks
    from dolfinx_eqlb_tpu_torch.fem import (
        FunctionSpace, grad, local_projection, project_facet_trace,
    )
    from dolfinx_eqlb_tpu_torch.demos._stages import Stages
    from dolfinx_eqlb_tpu_torch.demos.reconstruction import (
        exact_solution as exact_u, rhs as exact_f, ux as exact_ux,
    )
    from dolfinx_eqlb_tpu_torch.models import PoissonSolver

    k = degree
    st = Stages(device)
    V, Vr, Vf = st("spaces", lambda: (
        FunctionSpace(msh, "P", k), FunctionSpace(msh, "DG", k - 1),
        FunctionSpace(msh, "DG", k - 1, vs=2)))
    rhs_proj = st("project_rhs", lambda: local_projection(
        Vr, [exact_f], quadrature_degree=2 * k + 8, device=device))
    if bc == "dirichlet":
        prime, bcs, neumann = msh.boundary_facets, [], None
    else:
        left, right, bot, top = (msh.locate_boundary_facets(
            lambda x, a=a, v=v: np.isclose(x[..., a], v))
            for a, v in ((0, 0.0), (0, 1.0), (1, 0.0), (1, 1.0)))
        prime = np.concatenate([bot, top])
        gl = project_facet_trace(msh, left, lambda x: -exact_ux(x), k)
        gr = project_facet_trace(msh, right, exact_ux, k)
        neumann = [(left, gl), (right, gr)]
        bcs = [fluxbc(-gl, left), fluxbc(-gr, right)]
    solver = st("poisson_setup", lambda: PoissonSolver(V, device=device))
    uh = st("poisson_solve", lambda: solver.solve(
        rhs_proj[0], prime, exact_u, neumann=neumann, rtol=1e-13))
    sigma_proj = st("project_flux", lambda: local_projection(
        Vf, [-1.0 * grad(uh)]))
    res = {"cells": msh.num_cells, "bc": bc,
           "cg_iterations": solver.last_iterations,
           "cg_residual": solver.last_residual,
           "uh_finite": bool(torch.isfinite(uh.x).all()),
           "uh": uh.x, "checks": {}, "errors": {}, "launches": {},
           "k1_launches_by_route": {}, "k1_shapes": {}, "flux": {},
           "kernel_checks": {}}
    pts = np.array([[0.25, 0.25], [0.1, 0.6], [0.4, 0.55]])
    values = {}
    for name, Eqlb in (("SE", FluxEqlbSE), ("EV", FluxEqlbEV)):
        eq = st(f"{name}_construct", lambda: Eqlb(k, msh, rhs_proj,
                                                  sigma_proj))
        st(f"{name}_set_bcs", lambda: eq.set_boundary_conditions(
            [prime], [bcs]))
        reset_launches()
        st(f"{name}_equilibrate_1", eq.equilibrate_fluxes)
        st(f"{name}_equilibrate_2", eq.equilibrate_fluxes)
        res["launches"][name] = read_launches()
        res["k1_launches_by_route"][name] = read_launches(split=True)["K1"]
        res["k1_shapes"][name] = solve_shapes(eq.engine)
        if torch.device(device).type == "cuda":
            res["kernel_checks"][name] = flux_kernel_checks(eq)
        sig = eq.list_flux[0]
        res["flux"][name] = sig.x
        args = (sig, sigma_proj[0])
        # each check once: its error, and the verdict of the check's own
        # default tolerance on it
        ck, errs = res["checks"], res["errors"]
        err, scale = st(f"{name}_check_divergence",
                        lambda: checks.divergence_error(*args, rhs_proj[0]))
        ck[f"{name}_divergence"] = err < checks.DIVERGENCE_ATOL * scale
        errs[f"{name}_divergence"] = err
        if name == "SE":
            err = st("SE_check_jump", lambda: checks.jump_error(*args))
            ck["SE_jump"] = err < checks.JUMP_ATOL
            errs["SE_jump"] = err
        if bc != "dirichlet":
            bf = np.where(eq.boundary_data.facet_kind[0] == 2)[0]
            ck[f"{name}_boundary"] = st(
                f"{name}_check_boundary",
                lambda: checks.check_boundary_conditions(
                    *args, eq.list_bfunctions[0], bf))
        values[name] = checks.reconstructed_flux_expr(*args).evaluate(pts)
        del eq
    # EV and SE solve the same minimisation (tests/test_eqlb_conditions.py)
    res["se_ev_max_abs"] = float((values["SE"] - values["EV"]).abs().max())
    res["se_ev_limit"] = 1e-9 * max(1.0, float(values["EV"].abs().max()))
    res["stages_s"] = st.s
    return res


def phase_flux_api(n: int, device) -> dict:
    """The flux user API end to end on the crossed ``unit_square(n)``, both
    BC cases (``flux_flow``), each with its peak device memory; then the
    ``dirichlet`` flow on ``unit_square(64)`` on the card and on the CPU
    (plain versions), the SE and EV dof vectors compared."""
    from dolfinx_eqlb_tpu_torch.mesh import unit_square

    t0 = time.perf_counter()
    msh = unit_square(n)
    out = {"n": n, "mesh_s": time.perf_counter() - t0, "cases": {}}
    for bc in ("dirichlet", "neumann_inhom"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        res = flux_flow(msh, bc, device)
        res["peak_mem_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        for key in ("uh", "flux"):
            res.pop(key)
        out["cases"][bc] = res
    del msh
    torch.cuda.empty_cache()
    small = unit_square(64)
    card = flux_flow(small, "dirichlet", device)
    cpu = flux_flow(unit_square(64), "dirichlet", "cpu")
    par = {"n": 64, "cells": small.num_cells,
           "cg_iterations": [card["cg_iterations"], cpu["cg_iterations"]],
           "uh_max_abs_err": float((card["uh"].cpu() - cpu["uh"]).abs().max())}
    ok = True
    for name in ("SE", "EV"):
        x_card, x_cpu = card["flux"][name].cpu(), cpu["flux"][name]
        err = float((x_card - x_cpu).abs().max())
        limit = 1e-11 * max(1.0, float(x_cpu.abs().max()))
        par[f"{name}_max_abs_err"], par[f"{name}_limit"] = err, limit
        ok &= bool(torch.isfinite(x_card).all()) and err <= limit
    par["kernels_ok"] = all(
        all(c["ok"] for c in kc["K1"]) and kc["K2"]["ok"]
        for kc in card["kernel_checks"].values())
    par["ok"] = ok and par["kernels_ok"]
    out["parity"] = par
    return out


def report_flux_api(api: dict, nph: int, failures: list) -> None:
    """Print phase 12 and add its failures: a check false, SE and EV
    apart, a kernel not launched or K1 on a route its shapes do not
    plan, the card and the CPU apart."""
    for bc, r in api["cases"].items():
        log(f"[12/{nph}] flux user API unit_square({api['n']}) "
            f"({r['cells']} cells) P2/RT2 f64 {bc}: mesh "
            f"{api['mesh_s']:.2f} s; stages (s) "
            + ", ".join(f"{key} {val:.3f}" for key, val in
                        r["stages_s"].items())
            + f"; CG {r['cg_iterations']} iterations (residual "
            f"{r['cg_residual']:.3e}); peak {r['peak_mem_gib']:.2f} GiB; "
            f"launches SE {r['launches']['SE']} EV {r['launches']['EV']}, "
            f"K1 by route {r['k1_launches_by_route']}; checks "
            f"{r['checks']}; divergence error / jump residual "
            f"{r['errors']}; max|SE - EV| {r['se_ev_max_abs']:.3e} (limit "
            f"{r['se_ev_limit']:.3e})")
        log("    detail: " + json.dumps(r))
        if not all(r["checks"].values()):
            failures.append(f"flux user API {bc}: a check failed: "
                            f"{r['checks']}")
        if not r["uh_finite"]:
            failures.append(f"flux user API {bc}: the primal solution is "
                            "not finite")
        if not r["se_ev_max_abs"] <= r["se_ev_limit"]:
            failures.append(f"flux user API {bc}: SE and EV disagree")
        for name in ("SE", "EV"):
            if (r["launches"][name]["K1"] <= 0
                    or r["launches"][name]["K2"] <= 0
                    or r["launches"][name]["K5"] <= 0
                    or r["launches"][name]["K6"] <= 0):
                failures.append(f"flux user API {bc} {name} skipped a "
                                f"kernel: {r['launches'][name]}")
            check_k1_routes(f"flux user API {bc} {name}",
                            r["k1_launches_by_route"][name],
                            r["k1_shapes"][name], torch.float64, failures)
            kc = r["kernel_checks"][name]
            log(f"    {bc} {name} kernels vs plain at the path's shapes: K1 "
                + "; ".join(f"D={c['D']} R={c['R']} X={c['X']} max_rel_err "
                            f"{c['max_rel_err']:.3e}" for c in kc["K1"])
                + f" (limit 1e-12); K2 ndofs={kc['K2']['ndofs']} bitwise "
                f"{kc['K2']['bitwise']}")
            if not all(c["ok"] for c in kc["K1"]) or not kc["K2"]["ok"]:
                failures.append(f"flux user API {bc} {name}: a kernel "
                                "disagrees with its plain version")
    par = api["parity"]
    log(f"[12/{nph}] flux user API parity unit_square({par['n']}) "
        f"dirichlet, card vs CPU: CG iterations {par['cg_iterations']}, "
        f"max|uh| err {par['uh_max_abs_err']:.3e}; SE "
        f"{par['SE_max_abs_err']:.3e} (limit {par['SE_limit']:.3e}), EV "
        f"{par['EV_max_abs_err']:.3e} (limit {par['EV_limit']:.3e}); "
        f"kernels vs plain {par['kernels_ok']}"
        f"{'' if par['ok'] else '  FAILED'}")
    if not par["ok"]:
        failures.append("flux user API: card and CPU disagree, or a kernel "
                        "and its plain version at unit_square(64)")


# the JAX package's committed runs that phases 13 and 14 are held to
LSHAPE_CSV = "artifacts/AdaptiveLShape_p3_e3.csv"
CONV_CSV = "ConvStudyFluxEqlb-SE_porder-1_eorder-1.csv"
# the artifact's run: P3/RT3, theta 0.6, tol 1e-6, 59 iterations to
# 108,196 cells (README.md)
LSHAPE_ARTIFACT = {"iterations": 59, "cells": 108196}


def repo_file(name: str):
    from pathlib import Path

    return Path(__file__).resolve().parent / name


def max_rel(got, want) -> float:
    """Largest |got - want| / |want| over arrays; an entry where ``want`` is
    0 must be 0."""
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    d, scale = np.abs(got - want), np.abs(want)
    rel = np.where(scale > 0, d / np.where(scale > 0, scale, 1.0),
                   np.where(d > 0, np.inf, 0.0))
    return float(rel.max()) if rel.size else 0.0


class K1Clock:
    """Device time of every K1 call by route while open: CUDA events around
    each call of ``ops.patch_solve._solve_route_bl`` on a card tensor, read
    once after the run (launch overhead between the events included).
    ``plan(D, R, X, dtype)``, if given, replaces ``k1_plan`` for the calls
    that do not name a route."""

    def __init__(self, plan=None):
        self.plan, self.events = plan, []

    def __enter__(self):
        from dolfinx_eqlb_tpu_torch.ops import patch_solve

        self.module, self.orig = patch_solve, patch_solve._solve_route_bl

        def timed(A, b, route, threads=None):
            if A.device.type != "cuda":
                return self.orig(A, b, route, threads)
            route = route or (self.plan or patch_solve.k1_plan)(
                *b.shape[:2], A.dtype, X=b.shape[2])
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            x = self.orig(A, b, route, threads)
            end.record()
            self.events.append((route, start, end))
            return x

        patch_solve._solve_route_bl = timed
        return self

    def __exit__(self, *exc):
        self.module._solve_route_bl = self.orig

    def ms_by_route(self) -> dict:
        if self.events:
            self.events[-1][2].synchronize()
        out = {}
        for route, start, end in self.events:
            out[route] = out.get(route, 0.0) + start.elapsed_time(end)
        return out


def lshape_loop(order: int, device, max_iter: int = 90, timer=None,
                label: str = "", plan=None) -> dict:
    """``demos.lshape_adaptive.adaptive_loop`` on ``device``, P``order`` /
    RT``order`` SE, f64, from ``lshape(2)``, theta 0.6, until eta <= 1e-6
    or ``max_iter`` iterations, one line per step: cells, CG
    iterations against ``maxiter``, eta, err_H1, I_eff, seconds per stage,
    K1's launches by route with the (D, R, X) of every K1 call of the
    step's engine, K2's launches, device memory held at the step's end and
    the step's peak.  Launches are counted, and K1's device time by route
    clocked (``K1Clock``; ``plan`` replaces ``k1_plan``), from just before
    the loop to just after it.  Then K1 and K2 against their plain versions
    on the last step's own operands (``flux_kernel_checks``, K1 timed with
    ``timer``), and the device memory left once the loop's objects are
    gone."""
    import gc

    from dolfinx_eqlb_tpu_torch.demos import lshape_adaptive

    theta, tol = 0.6, 1e-6
    cuda = torch.device(device).type == "cuda"
    steps, last = [], {}
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    def k1_k2():
        return {"route": read_launches(split=True)["K1"],
                "K2": read_launches()["K2"]}

    prev = k1_k2()

    def hook(step):
        now = k1_k2()
        route = {rt: n - prev["route"][rt] for rt, n in now["route"].items()}
        k2_step = now["K2"] - prev["K2"]
        prev.update(now)
        solver = step["solver"]
        row = dict(it=step["it"], cells=step["mesh"].num_cells,
                   cg_iterations=solver.last_iterations,
                   cg_maxiter=solver.last_maxiter,
                   eta=step["eta"], err_h1=step["err_h1"],
                   i_eff=step["eta"] / step["err_h1"],
                   stages_s=dict(step["stages_s"]), k1_by_route=route,
                   k1_shapes=solve_shapes(step["eq"].engine), k2=k2_step)
        row["cg_hit_maxiter"] = row["cg_iterations"] >= row["cg_maxiter"]
        if cuda:
            row["mem_gib"] = (torch.cuda.memory_allocated(device) - base) / 2**30
            row["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
            torch.cuda.reset_peak_memory_stats(device)
        steps.append(row)
        last["eq"] = step["eq"]
        log(f"    {label} step {row['it']}: {row['cells']} cells, CG "
            f"{row['cg_iterations']}/{row['cg_maxiter']}"
            f"{' (maxiter hit)' if row['cg_hit_maxiter'] else ''}, eta "
            f"{row['eta']:.6e}, err_H1 {row['err_h1']:.6e}, I_eff "
            f"{row['i_eff']:.4f}; s: "
            + " ".join(f"{key} {val:.3f}" for key, val in
                       row["stages_s"].items())
            + f"; K1 {route} at {row['k1_shapes']}"
            + (f"; mem {row['mem_gib']:.3f} GiB, peak {row['peak_gib']:.3f}"
               if cuda else ""))

    t0 = time.perf_counter()
    with K1Clock(plan) as clock:
        msh, _ = lshape_adaptive.adaptive_loop(
            order, order, theta, tol, max_iter, verbose=False, device=device,
            step_hook=hook)
    res = {"order": order, "theta": theta, "tol": tol, "max_iter": max_iter,
           "seconds": time.perf_counter() - t0,
           "k1_ms_by_route": clock.ms_by_route(),
           "launches": read_launches(),
           "k1_launches_by_route": read_launches(split=True)["K1"],
           "steps": steps, "iterations": len(steps),
           "final_cells": msh.num_cells, "final_eta": steps[-1]["eta"],
           "k1_shapes": sorted({s for row in steps for s in row["k1_shapes"]}),
           "max_D": max(D for row in steps for D, _, _ in row["k1_shapes"])}
    for key in ("cg_iterations", "cg_hit_maxiter"):
        res[key] = [row[key] for row in steps]
    res["stage_totals_s"] = {
        key: sum(row["stages_s"].get(key, 0.0) for row in steps)
        for key in dict.fromkeys(k for row in steps for k in row["stages_s"])}
    if cuda:
        res["kernel_checks"] = flux_kernel_checks(last["eq"], timer)
        res["peak_gib"] = max(row["peak_gib"] for row in steps)
        del last["eq"], msh
        gc.collect()
        torch.cuda.empty_cache()
        res["mem_left_gib"] = (torch.cuda.memory_allocated(device)
                               - base) / 2**30
    return res


def phase_lshape(device, timer) -> dict:
    """The adaptive L-shape at the artifact's configuration (P3/RT3, theta
    0.6, tol 1e-6, at most 90 iterations), held to ``LSHAPE_CSV``; then
    the same loop at P4/RT4, whose patch systems pass K1's tile split, its
    first rows held to the port on the CPU."""
    import csv

    with open(repo_file(LSHAPE_CSV)) as f:
        ref = list(csv.DictReader(f))
    out = {"rt3": lshape_loop(3, device, timer=timer, label="P3/RT3")}
    r3 = out["rt3"]
    rows = r3["steps"]
    n = min(10, len(rows), len(ref))
    r3["rows_checked"] = n
    r3["cells_match_0_9"] = n == 10 and all(
        rows[i]["cells"] == int(ref[i]["ncells"]) for i in range(n))
    r3["eta_rel_0_9"] = max_rel([r["eta"] for r in rows[:n]],
                                [float(r["eta"]) for r in ref[:n]])
    r3["err_rel_0_9"] = max_rel([r["err_h1"] for r in rows[:n]],
                                [float(r["err_h1"]) for r in ref[:n]])
    r3["first_cells_differ"] = next(
        (i for i in range(min(len(rows), len(ref)))
         if rows[i]["cells"] != int(ref[i]["ncells"])), None)
    same = min(len(rows), len(ref)) if r3["first_cells_differ"] is None \
        else r3["first_cells_differ"]
    r3["eta_rel_while_same"] = max_rel(
        [r["eta"] for r in rows[:same]], [float(r["eta"]) for r in ref[:same]])
    r3["artifact"] = dict(LSHAPE_ARTIFACT)

    out["rt4"] = r4 = lshape_loop(4, device, timer=timer, label="P4/RT4")
    ncpu = 8
    cpu = lshape_loop(4, "cpu", max_iter=ncpu, label="P4/RT4 CPU")
    r4["cpu_rows"] = ncpu
    r4["cells_match_cpu"] = [r["cells"] for r in r4["steps"][:ncpu]] == [
        r["cells"] for r in cpu["steps"]]
    r4["eta_rel_cpu"] = max_rel([r["eta"] for r in r4["steps"][:ncpu]],
                                [r["eta"] for r in cpu["steps"]])
    return out


def report_lshape(ls: dict, nph: int, failures: list) -> None:
    """Print phase 13 and add its failures."""
    for name, r in ls.items():
        kc = r["kernel_checks"]
        log(f"[13/{nph}] adaptive L-shape P{r['order']}/RT{r['order']} SE f64 "
            f"theta {r['theta']} tol {r['tol']:g}: {r['iterations']} "
            f"iterations to {r['final_cells']} cells, eta "
            f"{r['final_eta']:.6e}, {r['seconds']:.1f} s; stage totals (s) "
            + ", ".join(f"{key} {val:.2f}" for key, val in
                        r["stage_totals_s"].items())
            + f"; CG maxiter hit on {sum(r['cg_hit_maxiter'])} steps; "
            f"launches {r['launches']}, K1 by route "
            f"{r['k1_launches_by_route']} taking (ms, CUDA events) "
            + ", ".join(f"{rt} {ms:.2f}" for rt, ms in
                        r["k1_ms_by_route"].items())
            + f"; largest K1 system D = "
            f"{r['max_D']}; peak {r['peak_gib']:.3f} GiB, left after the "
            f"loop {r['mem_left_gib']:.4f} GiB")
        if name == "rt3":
            log(f"    vs {LSHAPE_CSV}: rows 0-9 cells identical "
                f"{r['cells_match_0_9']}, eta max rel {r['eta_rel_0_9']:.3e}, "
                f"err_H1 max rel {r['err_rel_0_9']:.3e} (limit 1e-8); first "
                f"row whose cells differ: {r['first_cells_differ']}; eta max "
                f"rel while the meshes agree {r['eta_rel_while_same']:.3e}; "
                f"iterations {r['iterations']} / final cells "
                f"{r['final_cells']} (artifact {r['artifact']['iterations']}"
                f" / {r['artifact']['cells']})")
            if not (r["cells_match_0_9"] and r["eta_rel_0_9"] <= 1e-8
                    and r["err_rel_0_9"] <= 1e-8):
                failures.append("L-shape P3/RT3 rows 0-9 disagree with "
                                f"{LSHAPE_CSV}")
        else:
            log(f"    vs the port on the CPU, rows 0-{r['cpu_rows'] - 1}: "
                f"cells identical {r['cells_match_cpu']}, eta max rel "
                f"{r['eta_rel_cpu']:.3e} (limit 1e-9)")
            if not (r["cells_match_cpu"] and r["eta_rel_cpu"] <= 1e-9):
                failures.append("L-shape P4/RT4 card and CPU disagree")
        if not r["final_eta"] <= r["tol"]:
            failures.append(f"L-shape {name} did not reach eta <= "
                            f"{r['tol']:g} in {r['max_iter']} iterations")
        if min(r["launches"][kn] for kn in
               ("K1", "K2", "K5", "K6")) <= 0:
            failures.append(f"L-shape {name} skipped a kernel: "
                            f"{r['launches']}")
        check_k1_routes(f"L-shape {name}", r["k1_launches_by_route"],
                        r["k1_shapes"], torch.float64, failures)
        log(f"    last step's kernels vs plain: K1 "
            + "; ".join(f"D={c['D']} R={c['R']} X={c['X']} {c['route']} "
                        f"max_rel_err {c['max_rel_err']:.3e}, "
                        f"{c['ms']:.4f} ms (plain {c['plain_ms']:.4f}, "
                        f"torch.linalg.solve {c['library_ms']:.4f}, bound "
                        f"{c['bound_ms']:.5f} {c['bound_by']})"
                        for c in kc["K1"])
            + f" (limit 1e-12); K2 ndofs={kc['K2']['ndofs']} bitwise "
            f"{kc['K2']['bitwise']}")
        if not all(c["ok"] for c in kc["K1"]) or not kc["K2"]["ok"]:
            failures.append(f"L-shape {name}: a kernel disagrees with its "
                            "plain version at the last step's shapes")
        log("    detail: " + json.dumps(
            {key: val for key, val in r.items() if key != "steps"}))
    r4 = ls["rt4"]
    if r4["k1_launches_by_route"]["block"] <= 0:
        failures.append("the P4/RT4 L-shape never launched K1's block route")
    if not any(c["route"] == "block" for c in r4["kernel_checks"]["K1"]):
        failures.append("K1's block route was not held against its plain "
                        "version at a P4/RT4 L-shape shape")


def phase_uniform(device, nref: int = 9, ncpu: int = 5) -> dict:
    """``demos.error_estimation.run`` (P1/RT1, "dirichlet") for SE and EV on
    ``device`` at n = 2 * 2^i, i < ``nref`` (n = 512: 1,048,576 cells),
    launches counted around each series; SE's first rows held to
    ``CONV_CSV``, both series' first ``ncpu`` rows to the port on the CPU;
    then the Kellogg loop (``demos.discont_coeff``, its defaults) on
    ``device`` and on the CPU."""
    from dolfinx_eqlb_tpu_torch.demos import discont_coeff, error_estimation
    from dolfinx_eqlb_tpu_torch.eqlb import FluxEqlbEV, FluxEqlbSE

    want = np.loadtxt(repo_file(CONV_CSV), delimiter=",")
    out = {}
    for name, Eqlb in (("SE", FluxEqlbSE), ("EV", FluxEqlbEV)):
        stats = []
        reset_launches()
        t0 = time.perf_counter()
        rows = error_estimation.run(Eqlb, 1, 1, "dirichlet", nref,
                                    device=device, stats=stats)
        res = {"seconds": time.perf_counter() - t0,
               "launches": read_launches(),
               "k1_launches_by_route": read_launches(split=True)["K1"],
               "rows": rows.tolist(), "stats": stats}
        cpu = error_estimation.run(Eqlb, 1, 1, "dirichlet", ncpu,
                                   device="cpu")
        res["cpu_rows"] = ncpu
        res["rel_vs_cpu"] = max_rel(rows[:ncpu], cpu)
        if name == "SE":
            res["csv_rows"] = len(want)
            res["rel_vs_csv"] = max_rel(rows[:len(want)], want)
        out[name] = res
    stats = []
    reset_launches()
    t0 = time.perf_counter()
    card = discont_coeff.adaptive_loop(max_iter=12, verbose=False,
                                       device=device, stats=stats)
    kel = {"seconds": time.perf_counter() - t0, "launches": read_launches(),
           "k1_launches_by_route": read_launches(split=True)["K1"],
           "history": card, "stats": stats}
    cpu = discont_coeff.adaptive_loop(max_iter=12, verbose=False,
                                      device="cpu")
    kel["cells_match_cpu"] = [h[0] for h in card] == [h[0] for h in cpu]
    kel["eta_rel_cpu"] = max_rel([h[1] for h in card], [h[1] for h in cpu])
    out["kellogg"] = kel
    return out


def report_uniform(un: dict, nph: int, failures: list) -> None:
    """Print phase 14 and add its failures."""
    cols = ("h", "cells", "err_H1", "rate", "eta", "eta_sig", "eta_osc",
            "I_eff")
    for name in ("SE", "EV"):
        r = un[name]
        log(f"[14/{nph}] uniform series {name} P1/RT1 dirichlet f64, "
            f"{len(r['rows'])} meshes: {r['seconds']:.1f} s; launches "
            f"{r['launches']}, K1 by route {r['k1_launches_by_route']}; vs "
            f"the CPU port (rows 0-{r['cpu_rows'] - 1}) max rel "
            f"{r['rel_vs_cpu']:.3e}"
            + (f"; vs {CONV_CSV} (rows 0-{r['csv_rows'] - 1}) max rel "
               f"{r['rel_vs_csv']:.3e}" if name == "SE" else "")
            + " (limit 1e-10)")
        for row, st in zip(r["rows"], r["stats"]):
            log(f"    n={st['n']}: " + ", ".join(
                f"{c} {v:.6g}" for c, v in zip(cols, row))
                + f"; CG {st['cg_iterations']}; {st['seconds']:.2f} s")
        if not r["rel_vs_cpu"] <= 1e-10:
            failures.append(f"uniform series {name}: card and CPU disagree")
        if name == "SE" and not r["rel_vs_csv"] <= 1e-10:
            failures.append(f"uniform series SE disagrees with {CONV_CSV}")
        if not all(np.isfinite(r["rows"]).ravel()):
            failures.append(f"uniform series {name}: a value is not finite")
        if min(r["launches"][kn] for kn in
               ("K1", "K2", "K5", "K6")) <= 0:
            failures.append(f"uniform series {name} skipped a kernel: "
                            f"{r['launches']}")
    kel = un["kellogg"]
    log(f"[14/{nph}] Kellogg loop P1/RT1 SE f64, 12 iterations: "
        f"{kel['seconds']:.1f} s; cells {[h[0] for h in kel['history']]}; "
        f"eta {[float(f'{h[1]:.6e}') for h in kel['history']]}; CG "
        f"{[s['cg_iterations'] for s in kel['stats']]}; launches "
        f"{kel['launches']}, K1 by route {kel['k1_launches_by_route']}; vs "
        f"the CPU port: cells identical {kel['cells_match_cpu']}, eta max rel "
        f"{kel['eta_rel_cpu']:.3e} (limit 1e-9)")
    if not (kel["cells_match_cpu"] and kel["eta_rel_cpu"] <= 1e-9):
        failures.append("Kellogg loop: card and CPU disagree")
    if min(kel["launches"][kn] for kn in ("K1", "K2", "K5", "K6")) <= 0:
        failures.append(f"Kellogg loop skipped a kernel: {kel['launches']}")


# --- slice 4: weakly symmetric stress ------------------------------------------------

# the committed elasticity runs that phase 16 is held to: (formulation,
# primal order, equilibration degree); u-p runs MINRES
ELASTICITY_CSVS = [("u", 2, 2), ("u", 2, 3), ("up", 2, 3), ("up", 2, 4)]
# their limits, on each column against max(|value|, eta): CG (u) runs agree
# to 1e-11; MINRES (u-p) stops at rtol 1e-12 after a count of iterations
# that the order of its sums moves by one or two, and that residual reaches
# eta_osc: at RT4, n = 32 the port moves eta by 1.1e-8 and eta_osc by
# 2.3e-5 of itself on the CPU and on the card alike
ELASTICITY_CSV_LIMIT = {"u": 1e-8, "up": 1e-7}


def poly_stress(deg: int):
    """tests/test_stress.py's exact symmetric polynomial stress
    sigma = [[x^d + 2y, xy], [xy, y^d - x]]: its rows and divergences."""
    d = deg
    rows = (lambda x: np.stack([x[..., 0] ** d + 2 * x[..., 1],
                                x[..., 0] * x[..., 1]], -1),
            lambda x: np.stack([x[..., 0] * x[..., 1],
                                x[..., 1] ** d - x[..., 0]], -1))
    fs = (lambda x: d * x[..., 0] ** (d - 1) + x[..., 0],
          lambda x: x[..., 1] + d * x[..., 1] ** (d - 1))
    return rows, fs


# tests/test_stress_bc_layouts.py's linear stress sigma = [[x, y], [y, 2 - x]]
LINEAR_STRESS = ((lambda x: np.stack([x[..., 0], x[..., 1]], -1),
                  lambda x: np.stack([x[..., 1], 2.0 - x[..., 0]], -1)),
                 (lambda x: 2.0 * np.ones(x.shape[:-1]),
                  lambda x: np.zeros(x.shape[:-1])))


def stress_flow(msh, deg, device, data, traction=False, mode="semiexplicit"):
    """FluxEqlbSE with stress and Korn constants on projected ``data``
    (rows, divergences), f64: all boundary facets primal-Dirichlet, or
    with ``traction`` the layout of tests/test_stress_bc_layouts.py's
    layout 9 (row 0 traction on x = 0 and y = 0, row 1 on y = 0), which
    mixes traction rows on the corner patches.  Returns the equilibrator,
    the projections and the check verdicts."""
    from dolfinx_eqlb_tpu_torch.eqlb import FluxEqlbSE, checks, fluxbc
    from dolfinx_eqlb_tpu_torch.fem import (
        FunctionSpace, expr_from_callable, local_projection,
    )

    rows, fs = data
    rhs = local_projection(FunctionSpace(msh, "DG", deg - 1), list(fs),
                           quadrature_degree=8, device=device)
    proj = local_projection(
        FunctionSpace(msh, "DG", deg - 1, vs=2),
        [expr_from_callable(r, msh, value_size=2) for r in rows],
        quadrature_degree=8, device=device)
    eq = FluxEqlbSE(deg, msh, rhs, proj, equilibrate_stress=True,
                    estimate_korn_constant=True)
    eq.engine.mode = mode
    if traction:
        left, bot, right, top = (msh.locate_boundary_facets(
            lambda x, a=a, v=v: np.isclose(x[..., a], v))
            for a, v in ((0, 0.0), (1, 0.0), (0, 1.0), (1, 1.0)))
        normal = {"left": np.array([-1.0, 0.0]), "bot": np.array([0.0, -1.0])}
        prime = [np.concatenate([right, top]),
                 np.concatenate([right, top, left])]
        bcs = [[fluxbc(lambda x: rows[0](x) @ normal["left"], left, None),
                fluxbc(lambda x: rows[0](x) @ normal["bot"], bot, None)],
               [fluxbc(lambda x: rows[1](x) @ normal["bot"], bot, None)]]
        eq.set_boundary_conditions(prime, bcs)
    else:
        eq.set_boundary_conditions([msh.boundary_facets] * 2, [[], []])
    eq.equilibrate_fluxes()
    verdicts = {}
    for i in range(2):
        verdicts[f"divergence_{i}"] = checks.check_divergence_condition(
            eq.list_flux[i], proj[i], rhs[i])
        verdicts[f"jump_{i}"] = checks.check_jump_condition(
            eq.list_flux[i], proj[i])
    verdicts["weak_symmetry"] = checks.check_weak_symmetry_condition(
        eq.list_flux, proj)
    return {"eq": eq, "proj": proj, "rhs": rhs, "checks": verdicts}


def sing_counts(engine) -> dict:
    """Patches per boundary bucket whose masked stress system took the
    rank-1 regularisation in the engine's last weak-symmetry call."""
    return {str(key): int(v.sum()) for key, v in engine.ws_sing.items()}


def stress_pass_ms(eng, dpT, drT, fk, bv, device) -> dict:
    """The weak-symmetry pass alone (``weak_symmetry_bucket_bl``) of every
    bucket, host clock around a synchronised call, best of 3:
    {bucket: [patches, ms]}."""
    from dolfinx_eqlb_tpu_torch.eqlb.semiexplicit import (
        solve_bucket_semiexplicit,
    )
    from dolfinx_eqlb_tpu_torch.eqlb.stress import weak_symmetry_bucket_bl

    dev, refd = eng._device_tables()
    dprT = torch.cat([dpT, drT[:, None]], dim=1)
    out = {}
    for key in sorted(eng.buckets):
        sol = solve_bucket_semiexplicit(eng, key, dprT, fk, bv, dev[key],
                                        refd)[:2].contiguous()
        times = []
        for _ in range(3):
            sync(device)
            t0 = time.perf_counter()
            weak_symmetry_bucket_bl(eng, key, sol, fk[:2], dev[key], refd)
            sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
        out[str(key)] = [eng.buckets[key].npatches, min(times)]
    return out


def phase_stress(V, buckets, msh, device) -> dict:
    """Phase 15: the stress engine at bench.py's ``--stress`` headline: the
    crossed mesh, RT2, two stress rows of f32 random DG data (bench.py's
    data with stress=True), chunk ``CHUNK``, ``weak_symmetry=True``.  The
    same engine without weak symmetry first, for its times; then the
    stress caches, the stress path's strict and pipelined times, launches
    (K1's by route), ``torch.linalg.solve`` calls per call, peak memory,
    the result against the plain route (solver "torch", plain combine) and
    K1 and K2 against their plain versions on the call's own operands.
    Then f64 on ``unit_square(64)`` with compatible data (the exact
    polynomial stress, all-Dirichlet; the linear stress with mixed traction
    rows): card against the CPU, the regularisation masks compared."""
    from dolfinx_eqlb_tpu_torch.eqlb.engine import EqlbEngine
    from dolfinx_eqlb_tpu_torch.mesh import unit_square
    from dolfinx_eqlb_tpu_torch.ops.lane_select import combine_gather_plain

    t0 = time.perf_counter()
    eng = EqlbEngine(V, buckets, dtype=torch.float32, device=device,
                     max_patches_per_bucket=CHUNK)
    res = {"engine_tables_s": time.perf_counter() - t0}
    dp, dr, fk, bv = make_data(msh, 2, 2, seed=0, np_dtype=np.float32)
    dpT, drT = eng.put_transposed(dp, dr)
    fk = torch.as_tensor(fk, device=device)
    bv = torch.as_tensor(bv, device=device)
    eng._device_tables()
    sync(device)

    def flux_call():
        return eng.equilibrate(dpT, drT, fk, bv, transposed_inputs=True)

    def call():
        return eng.equilibrate(dpT, drT, fk, bv, weak_symmetry=True,
                               transposed_inputs=True)

    reset_launches()
    _, flux = drive(flux_call, device)
    flux["launches"] = read_launches()
    res["flux_only"] = flux
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    eng.pivoted_solves = 0
    t0 = time.perf_counter()
    eng.ensure_stress_caches()
    sync(device)
    res["stress_cache_s"] = time.perf_counter() - t0
    res["stress_cache_pivoted_solves"] = eng.pivoted_solves
    eng.pivoted_solves = 0
    reset_launches()
    x, timing = drive(call, device)
    res["launches"] = read_launches()
    res["k1_launches_by_route"] = read_launches(split=True)["K1"]
    res.update(timing)
    ncalls = 1 + len(timing["strict_ms"]) + 8 * len(timing["pipelined_ms"])
    res["calls"] = ncalls
    res["pivoted_solves_per_call"] = eng.pivoted_solves / ncalls
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    res["k1_shapes"] = solve_shapes(eng)
    res["sing_patches"] = sing_counts(eng)
    res["shape_ok"] = tuple(x.shape) == (2, eng.V.ndofs)
    res["finite"] = bool(torch.isfinite(x).all())
    res["ws_per_bucket_ms"] = stress_pass_ms(eng, dpT, drT, fk, bv, device)
    ref = EqlbEngine.from_host_tables(
        eng.V, eng.buckets, eng.tables, eng.se_static, eng.ref,
        dtype=eng.dtype, device=device)
    ref.solver = "torch"
    ref.ensure_stress_caches()
    x_ref = combine_gather_plain(
        ref._bucket_solutions(ref._pack_dofs(dpT, drT, True), fk, bv,
                              weak_symmetry=True),
        ref._combine_src(), ref._nfk)
    del ref
    scale = float(x_ref.abs().max())
    res["max_abs_err_vs_plain"] = float((x - x_ref).abs().max())
    res["err_limit"] = 1e-3 * scale
    del x, x_ref
    torch.cuda.empty_cache()
    res["kernel_checks"] = engine_kernel_checks(eng, call)
    del eng
    torch.cuda.empty_cache()

    # f64, compatible data: card against the CPU
    par = {"n": 64, "cases": {}}
    for name, data, traction in (("poly_dirichlet", poly_stress(2), False),
                                 ("linear_traction", LINEAR_STRESS, True)):
        out = {dv: stress_flow(unit_square(64), 2, dv, data, traction)
               for dv in (device, "cpu")}
        card, cpu = out[device], out["cpu"]
        err = max(float((a.x.cpu() - b.x).abs().max())
                  for a, b in zip(card["eq"].list_flux, cpu["eq"].list_flux))
        scale = max(float(b.x.abs().max()) for b in cpu["eq"].list_flux)
        limit = 1e-11 * max(1.0, scale)
        sing_same = all(
            torch.equal(card["eq"].engine.ws_sing[key].cpu(), val)
            for key, val in cpu["eq"].engine.ws_sing.items())
        c = dict(max_abs_err=err, limit=limit, checks=card["checks"],
                 sing_patches=sing_counts(card["eq"].engine),
                 sing_identical=sing_same)
        c["ok"] = (err <= limit and sing_same
                   and all(card["checks"].values())
                   and card["checks"] == cpu["checks"])
        par["cases"][name] = c
    res["f64_parity"] = par
    return res


def report_stress(r: dict, nph: int, failures: list) -> None:
    f = r["flux_only"]
    log(f"[15/{nph}] stress engine (bench.py --stress) RT2 f32 2 rows: "
        f"without weak symmetry strict {f['strict_ms_median']:.3f} ms, "
        f"pipelined {f['pipelined_ms_min']:.3f} ms; stress caches "
        f"{r['stress_cache_s']:.3f} s ({r['stress_cache_pivoted_solves']} "
        f"torch.linalg.solve calls); with weak symmetry first call "
        f"{r['first_call_s']:.3f} s, strict {r['strict_ms_median']:.3f} ms "
        f"median, pipelined {r['pipelined_ms_min']:.3f} ms; launches "
        f"{r['launches']} over {r['calls']} calls, K1 by route "
        f"{r['k1_launches_by_route']}; torch.linalg.solve "
        f"{r['pivoted_solves_per_call']:g} per call; the weak-symmetry "
        f"pass alone {sum(v[1] for v in r['ws_per_bucket_ms'].values()):.3f}"
        f" ms; regularised patches "
        f"{r['sing_patches']}; peak {r['peak_mem_gib']:.2f} GiB; max|x - "
        f"plain| {r['max_abs_err_vs_plain']:.3e} (limit "
        f"{r['err_limit']:.3e})")
    kc = r["kernel_checks"]
    log("    kernels vs plain on the call's operands: K1 "
        + "; ".join(f"{c['dtype']} D={c['D']} R={c['R']} X={c['X']} "
                    f"max_rel_err {c['max_rel_err']:.3e}" for c in kc["K1"])
        + f"; K2 ndofs={kc['K2']['ndofs']} bitwise {kc['K2']['bitwise']}")
    log("    detail: " + json.dumps(
        {key: val for key, val in r.items()
         if key != "kernel_checks"}))
    if min(r["launches"][kn] for kn in ("K1", "K2", "K5", "K6")) <= 0:
        failures.append(f"stress path skipped a kernel: {r['launches']}")
    check_k1_routes("stress path", r["k1_launches_by_route"],
                    r["k1_shapes"], torch.float32, failures)
    if not (r["shape_ok"] and r["finite"]):
        failures.append("stress path output has a wrong shape or "
                        "non-finite values")
    if not r["max_abs_err_vs_plain"] <= r["err_limit"]:
        failures.append("stress path disagrees with the plain route")
    if not all(c["ok"] for c in kc["K1"]) or not kc["K2"]["ok"]:
        failures.append("stress path: a kernel disagrees with its plain "
                        "version")
    for name, c in r["f64_parity"]["cases"].items():
        log(f"[15/{nph}] stress f64 unit_square(64) {name}, card vs CPU: "
            f"max_abs_err {c['max_abs_err']:.3e} (limit {c['limit']:.3e}); "
            f"checks {c['checks']}; regularised patches "
            f"{c['sing_patches']}, masks identical {c['sing_identical']}"
            f"{'' if c['ok'] else '  FAILED'}")
        if not c["ok"]:
            failures.append(f"stress f64 {name}: card and CPU disagree or "
                            "a check failed")


def phase_elasticity(n: int, device) -> dict:
    """Phase 16: ``demos.elasticity.run``'s flow (u formulation, P2 primal,
    RT2, weak symmetry, Korn constants, ``estimate_elasticity``) on
    ``unit_square(n)``, f64: stage seconds, CG iterations against
    ``maxiter``, the checks, eta and its components, I_eff, launches (K1's
    by route), peak memory, K1 and K2 against their plain versions on the
    equilibrator's own operands.  Then the rows of the four committed
    ``artifacts/ConvStudyElasticity-*.csv`` on the card (n = 4 ... 32)."""
    import csv

    from dolfinx_eqlb_tpu_torch.demos import elasticity as demo

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    info = {}
    res = {"n": n}
    reset_launches()
    t0 = time.perf_counter()
    try:
        eta, comps, err = demo.run(n, 2, 2, check=True, formulation="u",
                                   device=device, verbose=False, info=info)
        res.update(eta=eta, eta_sig=comps[0], eta_wsym=comps[1],
                   eta_osc=comps[2], energy_error=err, I_eff=eta / err)
    except AssertionError:
        res["failed"] = True
    res["seconds"] = time.perf_counter() - t0
    res["launches"] = read_launches()
    res["k1_launches_by_route"] = read_launches(split=True)["K1"]
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    res["checks"] = info.get("checks", {})
    for key in ("stages_s", "iterations", "maxiter", "cells"):
        res[key] = info.get(key)
    eq = info.get("eq")
    if eq is not None:
        res["k1_shapes"] = solve_shapes(eq.engine)
        res["sing_patches"] = sing_counts(eq.engine)
        res["kernel_checks"] = flux_kernel_checks(eq)
    del info, eq
    torch.cuda.empty_cache()

    rows = []
    for form, order, degree in ELASTICITY_CSVS:
        name = (f"ConvStudyElasticity-{form}_porder-{order}_eorder-"
                f"{degree}.csv")
        with open(repo_file("artifacts") / name) as f:
            want = [{k: float(v) for k, v in row.items()}
                    for row in csv.DictReader(f)]
        got = []
        for w in want:
            t0 = time.perf_counter()
            e, c, er = demo.run(int(w["n"]), order, degree, check=False,
                                formulation=form, device=device,
                                verbose=False)
            got.append(dict(n=int(w["n"]), eta=e, eta_sig=c[0],
                            eta_wsym=c[1], eta_osc=c[2], energy_error=er,
                            I_eff=e / er, s=time.perf_counter() - t0))
        keys = ("eta", "eta_sig", "eta_wsym", "eta_osc", "energy_error",
                "I_eff")
        rel = max_rel([[g[k] for k in keys] for g in got],
                      [[w[k] for k in keys] for w in want])
        # each column against max(|its value|, eta): eta_osc sits at the
        # primal solve's algebraic residual (rtol 1e-12), far below eta
        rel_eta = max(abs(g[k] - w[k]) / max(abs(w[k]), w["eta"])
                      for g, w in zip(got, want) for k in keys)
        limit = ELASTICITY_CSV_LIMIT[form]
        rows.append(dict(csv=name, rows=len(got), max_rel_err=rel,
                         max_err_rel_eta=rel_eta, limit=limit,
                         ok=rel_eta <= limit,
                         seconds=sum(g["s"] for g in got)))
    res["csvs"] = rows
    return res


def report_elasticity(r: dict, nph: int, failures: list) -> None:
    log(f"[16/{nph}] elasticity user flow unit_square({r['n']}) "
        f"({r['cells']} cells) P2/RT2 f64 u formulation: {r['seconds']:.1f} "
        f"s; stages (s) " + ", ".join(
            f"{key} {val:.3f}" for key, val in (r["stages_s"] or {}).items())
        + f"; CG {r['iterations']} iterations of maxiter {r['maxiter']}; "
        f"checks {r['checks']}; eta {r.get('eta', float('nan')):.6e} "
        f"(sig {r.get('eta_sig', float('nan')):.4e}, wsym "
        f"{r.get('eta_wsym', float('nan')):.4e}, osc "
        f"{r.get('eta_osc', float('nan')):.4e}), energy error "
        f"{r.get('energy_error', float('nan')):.6e}, I_eff "
        f"{r.get('I_eff', float('nan')):.4f}; launches {r['launches']}, K1 "
        f"by route {r['k1_launches_by_route']}; peak "
        f"{r['peak_mem_gib']:.2f} GiB")
    log("    detail: " + json.dumps(
        {key: val for key, val in r.items() if key != "kernel_checks"}))
    if r.get("failed") or not r["checks"] or not all(r["checks"].values()):
        failures.append(f"elasticity flow: a check failed: {r['checks']}")
    if min(r["launches"][kn] for kn in ("K1", "K2", "K5", "K6")) <= 0:
        failures.append(f"elasticity flow skipped a kernel: "
                        f"{r['launches']}")
    if "k1_shapes" in r:
        check_k1_routes("elasticity flow", r["k1_launches_by_route"],
                        r["k1_shapes"], torch.float64, failures)
    kc = r.get("kernel_checks")
    if kc is not None:
        log("    kernels vs plain on the equilibrator's operands: K1 "
            + "; ".join(f"D={c['D']} R={c['R']} X={c['X']} max_rel_err "
                        f"{c['max_rel_err']:.3e}" for c in kc["K1"])
            + f" (limit 1e-12); K2 ndofs={kc['K2']['ndofs']} bitwise "
            f"{kc['K2']['bitwise']}")
        if not all(c["ok"] for c in kc["K1"]) or not kc["K2"]["ok"]:
            failures.append("elasticity flow: a kernel disagrees with its "
                            "plain version")
    for c in r["csvs"]:
        log(f"[16/{nph}] {c['csv']} on the card: {c['rows']} rows, max "
            f"err against max(|value|, eta) {c['max_err_rel_eta']:.3e} "
            f"(limit {c['limit']:g}), max rel err {c['max_rel_err']:.3e}, "
            f"{c['seconds']:.1f} s{'' if c['ok'] else '  FAILED'}")
        if not c["ok"]:
            failures.append(f"{c['csv']} not reproduced")


# the smallest |u_jj| / max|A| that the pivot-free order may meet on the
# systems the reference pivots (the bar of tests/test_torch_kkt.py)
PIVOT_FLOOR = 1e-8
# the largest D the reference solves without pivoting (its TPU kernel's
# VMEM budget); the port's K3 takes the KKT systems past it, which
# ``k3_operand_checks`` holds to a pivoted solve
REFERENCE_PIVOTS_PAST_D = 110


def lu_pivot_stats(A, chunk: int = 4096) -> dict:
    """The pivots u_jj of the pivot-free LU of the systems A (..., D, D),
    in K3's elimination order, computed in f64 on chunks of ``chunk``
    systems: the smallest |u_jj| / max|A| of a system, the step j where it
    falls, the smallest |u_jj| against the largest entry of its own row of
    A (free of the system's scale), and the growth max|U| / max|A|."""
    D = A.shape[-1]
    A = A.reshape(-1, D, D)
    out = dict(pivot_ratio=math.inf, pivot_step=-1,
               pivot_row_ratio=math.inf, growth=0.0)
    for s in range(0, A.shape[0], chunk):
        a = A[s:s + chunk].to(torch.float64, copy=True)
        amax = a.abs().amax((-1, -2))
        rowmax = a.abs().amax(-1)
        piv = a.new_empty(a.shape[:2])
        umax = a.new_zeros(a.shape[0])
        for j in range(D):
            u = a[:, j, j:]
            piv[:, j] = u[:, 0]
            umax = torch.maximum(umax, u.abs().amax(-1))
            if j + 1 < D:
                lcol = a[:, j + 1:, j] / u[:, :1]
                a[:, j + 1:, j + 1:] -= lcol[:, :, None] * u[:, None, 1:]
        ratio = piv.abs() / amax[:, None]
        worst = int(ratio.min(1).values.argmin())
        if float(ratio[worst].min()) < out["pivot_ratio"]:
            out["pivot_ratio"] = float(ratio[worst].min())
            out["pivot_step"] = int(ratio[worst].argmin())
        out["pivot_row_ratio"] = min(out["pivot_row_ratio"],
                                     float((piv.abs() / rowmax).min()))
        out["growth"] = max(out["growth"], float((umax / amax).max()))
        del a, piv
    return out


def k3_operand_checks(solves) -> list:
    """K3 against its plain version on captured batch-major operands, one
    row per operand set: within 1e-12 (f64) or 1e-4 (f32) of the plain
    solve relative to its largest entry.  Past ``REFERENCE_PIVOTS_PAST_D``,
    where the reference pivots, K3 is also held to the pivoted
    ``torch.linalg.solve`` at the same bar, since the plain version shares
    K3's pivot-free order, and, on f64 operands, no pivot of that order
    may fall to ``PIVOT_FLOOR`` of max|A| (``lu_pivot_stats``)."""
    from dolfinx_eqlb_tpu_torch.ops.patch_solve import (
        batched_kkt_solve, batched_kkt_solve_plain, k3_plan,
    )

    rows = []
    for A, b in solves:
        x = batched_kkt_solve(A, b)
        xp = batched_kkt_solve_plain(A, b)
        err = float((x - xp).abs().max())
        rel = err / float(xp.abs().max())
        D, R = A.shape[-1], b.shape[-1]
        tol = 1e-12 if A.dtype == torch.float64 else 1e-4
        row = dict(dtype=dname(A.dtype), D=D, R=R,
                   X=int(np.prod(A.shape[:-2])),
                   route=k3_plan(D, R, A.dtype), max_abs_err=err,
                   max_rel_err=rel, limit=tol,
                   ok=bool(torch.isfinite(x).all()) and rel <= tol)
        del xp
        if D > REFERENCE_PIVOTS_PAST_D:
            xl = torch.linalg.solve(A, b)
            row["linalg_max_rel_err"] = (float((x - xl).abs().max())
                                         / float(xl.abs().max()))
            row["ok"] = row["ok"] and row["linalg_max_rel_err"] <= tol
            del xl
            if A.dtype == torch.float64:  # f32 operands are these rounded
                row.update(lu_pivot_stats(A))
                row["ok"] = row["ok"] and row["pivot_ratio"] > PIVOT_FLOOR
        rows.append(row)
        del x
    return rows


def capture_dense_solves(call, check=False):
    """Run ``call()`` with the engine's batch-major K3 solves recorded
    (the engine module's ``batched_kkt_solve``, which the flux KKT stage
    calls under ``k3_admits``): returns (call's
    result, [(A, b), ...] of the systems K3 took); with ``check``, each is
    held against its plain version as it comes (``k3_operand_checks``) and
    the check rows are returned instead, so that no operand outlives its
    solve (one call's operands at 1M cells and RT3 would hold ~30 GB in
    f64)."""
    from dolfinx_eqlb_tpu_torch.eqlb import engine

    solves = []
    solve = engine.batched_kkt_solve

    def record(A, b):
        solves.extend(k3_operand_checks([(A, b)]) if check else [(A, b)])
        return solve(A, b)

    engine.batched_kkt_solve = record
    try:
        out = call()
    finally:
        engine.batched_kkt_solve = solve
    return out, solves


def phase_stress_kkt(device, n: int = 64) -> dict:
    """Phase 17: the elasticity flow of phase 16 on ``unit_square(n)`` in
    the KKT mode (the flux KKT systems through K3, the full stress KKT
    systems through ``torch.linalg.solve``) against the semi-explicit mode,
    both rows within 1e-9; K3's launches by route, and K3 against its
    plain version on the call's own operands."""
    from dolfinx_eqlb_tpu_torch.demos import elasticity as demo

    res = {"n": n}
    info_se, info_kkt = {}, {}
    demo.run(n, 2, 2, check=True, device=device, verbose=False,
             info=info_se)
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.perf_counter()
    demo.run(n, 2, 2, check=True, device=device, verbose=False,
             info=info_kkt, mode="kkt")
    res["seconds"] = time.perf_counter() - t0
    res["launches"] = read_launches()
    res["k3_launches_by_route"] = read_launches(split=True)["K3"]
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    res["stages_s"] = info_kkt["stages_s"]
    res["checks"] = info_kkt["checks"]
    se, kkt = info_se["eq"], info_kkt["eq"]
    res["max_abs_err_vs_se"] = max(
        float((a.x - b.x).abs().max())
        for a, b in zip(kkt.list_flux, se.list_flux))
    res["limit"] = 1e-9 * max(1.0, max(float(b.x.abs().max())
                                        for b in se.list_flux))
    _, solves = capture_dense_solves(kkt.equilibrate_fluxes)
    res["k3_checks"] = k3_operand_checks(solves)
    del info_se, info_kkt, se, kkt, solves
    torch.cuda.empty_cache()
    return res


def report_stress_kkt(r: dict, nph: int, failures: list) -> None:
    log(f"[17/{nph}] KKT-mode stress, elasticity flow unit_square({r['n']}) "
        f"P2/RT2 f64: {r['seconds']:.1f} s; stages (s) " + ", ".join(
            f"{key} {val:.3f}" for key, val in r["stages_s"].items())
        + f"; checks {r['checks']}; max|KKT - SE| "
        f"{r['max_abs_err_vs_se']:.3e} (limit {r['limit']:.3e}); launches "
        f"{r['launches']}, K3 by route {r['k3_launches_by_route']}; K3 vs "
        "plain: " + "; ".join(
            f"D={c['D']} X={c['X']} {c['route']} max_rel_err "
            f"{c['max_rel_err']:.3e}" for c in r["k3_checks"])
        + f" (limit 1e-12); peak {r['peak_mem_gib']:.2f} GiB")
    log("    detail: " + json.dumps(r))
    if not all(r["checks"].values()):
        failures.append(f"KKT-mode stress: a check failed: {r['checks']}")
    if not r["max_abs_err_vs_se"] <= r["limit"]:
        failures.append("KKT-mode stress disagrees with the semi-explicit "
                        "mode")
    if (r["launches"]["K3"] <= 0 or r["launches"]["K2"] <= 0
            or r["launches"]["K5"] or r["launches"]["K6"]):
        failures.append(f"KKT-mode stress skipped a kernel: {r['launches']}")
    if not r["k3_checks"] or not all(c["ok"] for c in r["k3_checks"]):
        failures.append("KKT-mode stress: K3 disagrees with its plain "
                        "version")


def cook_steps(device, **kw) -> tuple[list, list]:
    """``demos.cook_adaptive.run`` with one line per step: cells, CG
    iterations against maxiter, eta and its components, L(u_h), stage
    seconds, the number of patch groups and the weak-symmetry check.
    Returns (rows, steps)."""
    from dolfinx_eqlb_tpu_torch.demos import cook_adaptive
    from dolfinx_eqlb_tpu_torch.eqlb import check_weak_symmetry_condition
    from dolfinx_eqlb_tpu_torch.eqlb.grouping import build_groups

    steps = []

    def hook(step):
        eq = step["eq"]
        groups, _ = build_groups(eq.engine, eq.boundary_data.facet_kind[:2])
        steps.append(dict(
            it=step["it"], cells=step["mesh"].num_cells,
            regularised=sum(int(v.sum())
                            for v in eq.engine.ws_sing.values()),
            cg=step["solver"].last_iterations,
            maxiter=step["solver"].last_maxiter, eta=step["eta"],
            comps=step["comps"], L_h=step["L_h"],
            groups=len(groups) if eq.degree_flux == 2 else 0,
            weak_symmetry=check_weak_symmetry_condition(
                eq.list_flux, step["sigma_proj"]),
            stages_s=dict(step["stages_s"]),
            step_s=sum(step["stages_s"].values())))

    rows = cook_adaptive.run(device=device, step_hook=hook, verbose=False,
                             **kw)
    return rows, steps


def phase_cook(device, max_cells: int = 50_000) -> dict:
    """Phase 18: ``demos.cook_adaptive`` (Cook's membrane, P2 primal, RT3,
    theta 0.5, from ``cook_membrane(2, 2)``): the demo's configuration
    (6 iterations and the overkill reference), its first 10 iterations
    held against the port on the CPU (cells identical, eta within 1e-9
    relative or non-finite on both); the same loop run on until the mesh
    has ``max_cells`` cells; then at RT2 (2 iterations), where the
    deficient corner patches are grouped, with the groups and the
    weak-symmetry check after ``grouped_weak_symmetry``."""
    res = {}
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.perf_counter()
    rows, steps = cook_steps(device, max_iter=6)
    res["demo"] = {"rows": rows, "steps": steps,
                   "seconds": time.perf_counter() - t0,
                   "launches": read_launches(),
                   "k1_launches_by_route": read_launches(split=True)["K1"]}
    _, card = cook_steps(device, max_iter=10, overkill=False)
    _, cpu = cook_steps("cpu", max_iter=10, overkill=False)
    res["cpu_parity"] = dict(
        steps=len(cpu),
        cells_identical=[s["cells"] for s in card] == [s["cells"]
                                                       for s in cpu],
        eta_max_rel=max_rel([s["eta"] for s in card if
                             np.isfinite(s["eta"])],
                            [s["eta"] for s in cpu if np.isfinite(s["eta"])]),
        nonfinite_same=[np.isfinite(s["eta"]) for s in card]
        == [np.isfinite(s["eta"]) for s in cpu])
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.perf_counter()
    _, long = cook_steps(device, max_iter=400, overkill=False,
                         max_cells=max_cells)
    res["long"] = {"steps": long, "seconds": time.perf_counter() - t0,
                   "launches": read_launches(),
                   "peak_mem_gib":
                   torch.cuda.max_memory_allocated(device) / 2**30}
    reset_launches()
    _, grouped = cook_steps(device, degree=2, max_iter=2, overkill=False)
    res["grouped"] = {"steps": grouped, "launches": read_launches()}
    return res


def report_cook(r: dict, nph: int, failures: list) -> None:
    def line(name, s):
        c = s["comps"]
        log(f"    {name} it {s['it']}: cells {s['cells']}, CG {s['cg']} of "
            f"{s['maxiter']}, eta {s['eta']:.6e} (sig {c[0]:.3e}, wsym "
            f"{c[1]:.3e}, osc {c[2]:.3e}), L(u_h) {s['L_h']:.10e}, groups "
            f"{s['groups']}, regularised patches {s['regularised']}, weak "
            f"symmetry {s['weak_symmetry']}, "
            f"{s['step_s']:.3f} s (" + ", ".join(
                f"{k} {v:.3f}" for k, v in s["stages_s"].items()) + ")")

    d = r["demo"]
    log(f"[18/{nph}] Cook's membrane P2/RT3 theta 0.5, the demo's "
        f"configuration: {len(d['steps'])} iterations in "
        f"{d['seconds']:.1f} s; launches {d['launches']}, K1 by route "
        f"{d['k1_launches_by_route']}")
    for s in d["steps"]:
        line("demo", s)
    for cells, eta, err, ieff, *c in d["rows"]:
        log(f"    demo: cells {cells}, eta {eta:.6e}, err {err:.6e}, I_eff "
            f"{ieff:.4f}")
    p = r["cpu_parity"]
    p["ok"] = (p["cells_identical"] and p["nonfinite_same"]
               and p["eta_max_rel"] <= 1e-9)
    log(f"[18/{nph}] Cook loop card vs CPU, first {p['steps']} iterations: "
        f"cells identical {p['cells_identical']}, eta max rel err "
        f"{p['eta_max_rel']:.3e} (limit 1e-9), non-finite eta on the same "
        f"steps {p['nonfinite_same']}{'' if p['ok'] else '  FAILED'}")
    lg = r["long"]
    bad = [s["it"] for s in lg["steps"] if not np.isfinite(s["eta"])]
    missed = [s["it"] for s in lg["steps"] if not s["weak_symmetry"]]
    log(f"[18/{nph}] Cook loop to {lg['steps'][-1]['cells']} cells: "
        f"{len(lg['steps'])} iterations in {lg['seconds']:.1f} s; launches "
        f"{lg['launches']}; peak {lg['peak_mem_gib']:.2f} GiB; steps with a "
        f"non-finite eta (a Korn angle of 0) {bad}; steps missing weak "
        f"symmetry {missed}, all with regularised patches")
    for s in lg["steps"]:
        line("long", s)
    g = r["grouped"]
    log(f"[18/{nph}] Cook loop at RT2 (patch grouping): launches "
        f"{g['launches']}")
    for s in g["steps"]:
        line("rt2", s)
    if not p["ok"]:
        failures.append("Cook loop: card and CPU disagree")
    for name in ("demo", "long", "grouped"):
        # a step whose masked stress systems took the rank-1
        # regularisation (mixed-row traction corners of the refined mesh)
        # may miss weak symmetry by ~1e-8, as the JAX package does on the
        # same mesh; every other step must hold it
        steps = r[name]["steps"]
        if not all(s["weak_symmetry"] for s in steps
                   if s["regularised"] == 0):
            failures.append(f"Cook loop {name}: weak symmetry fails on a "
                            "step without regularised patches")
        if min(r[name]["launches"][kn] for kn in
               ("K1", "K2", "K5", "K6")) <= 0:
            failures.append(f"Cook loop {name} skipped a kernel: "
                            f"{r[name]['launches']}")
    if not all(np.isfinite(row[1]) for row in d["rows"]):
        failures.append("Cook loop: the demo's configuration gave a "
                        "non-finite eta")
    if not all(s["groups"] > 0 for s in g["steps"]):
        failures.append("Cook loop at RT2: no patch groups")


# --- slice 5: multigrid and Biot poro-elasticity ---------------------------------

BIOT_COARSE, BIOT_LEVELS = 16, 6  # bench.py --biot: 1,048,576 cells
# Jacobi CG iterations of the elasticity flow at n = 500 (phase 16, PERF.md
# section 5), beside the multigrid counts of phase 21
JACOBI_CG_ITS_N500 = 6194


def vcycle_ms(mg, timer, seed: int = 0) -> dict:
    """Device ms of one V-cycle of ``mg`` (CUDA events, cold L2): the cycle
    from each level down, and each level's own share (its cycle less the
    one below it)."""
    from dolfinx_eqlb_tpu_torch.utils.precision import full_f32_matmul

    ops = mg.operands()
    gen = torch.Generator(device=mg.device).manual_seed(seed)
    down = []
    for lvl in range(mg.nlevels):
        o = ops[lvl]
        r = torch.randn(o["Dinv"].shape[0], generator=gen, device=mg.device,
                        dtype=mg.dtype) * o["free"]
        with full_f32_matmul():
            down.append(timer.ms(lambda: mg._vcycle(lvl, r, ops), reps=5))
    own = [down[0]] + [b - a for a, b in zip(down, down[1:])]
    return {"apply_ms": down[-1], "cycle_from_level_ms": down,
            "level_own_ms": own}


def mg_setup_rows(mg) -> list:
    return [{key: (round(v, 4) if isinstance(v, float) else v)
             for key, v in row.items()} for row in mg.setup_s]


def engine_call_checks(eng, call, weak_symmetry, dpT, drT, fk, bv, device,
                       limit_rel) -> dict:
    """Drive ``call`` (first, strict and pipelined), read its launches (K1's
    by route), its output against the plain route (solver "torch", plain
    combine, same tables) and K1 and K2 against their plain versions on
    its own operands."""
    from dolfinx_eqlb_tpu_torch.eqlb.engine import EqlbEngine
    from dolfinx_eqlb_tpu_torch.ops.lane_select import combine_gather_plain

    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    x, res = drive(call, device)
    res["launches"] = read_launches()
    res["k1_launches_by_route"] = read_launches(split=True)["K1"]
    res["calls"] = 1 + len(res["strict_ms"]) + 8 * len(res["pipelined_ms"])
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    res["shape_ok"] = tuple(x.shape) == (dpT.shape[0], eng.V.ndofs)
    res["finite"] = bool(torch.isfinite(x).all())
    ref = EqlbEngine.from_host_tables(
        eng.V, eng.buckets, eng.tables, eng.se_static, eng.ref,
        dtype=eng.dtype, device=device)
    ref.solver = "torch"
    if weak_symmetry:
        ref.ensure_stress_caches()
    x_ref = combine_gather_plain(
        ref._bucket_solutions(ref._pack_dofs(dpT, drT, True), fk, bv,
                              weak_symmetry=weak_symmetry),
        ref._combine_src(), ref._nfk)
    del ref
    res["max_abs_err_vs_plain"] = float((x - x_ref).abs().max())
    res["err_limit"] = limit_rel * float(x_ref.abs().max())
    del x, x_ref
    torch.cuda.empty_cache()
    res["kernel_checks"] = engine_kernel_checks(eng, call)
    return res


def phase_biot_bench(device, timer, coarse: int = BIOT_COARSE,
                     nlevels: int = BIOT_LEVELS) -> dict:
    """Phase 19: ``bench.py 500 3 --biot``'s headline on the port: the
    hierarchy ``mesh_hierarchy(unit_square(16), 6)`` (1,048,576 cells),
    ``biot_bench_fields`` (P2 / P2 / P1, f32 block-MG MINRES at rtol 1e-6,
    maxiter 400), then the engine (RT2, f32, 3 rows, chunk ``CHUNK``, every
    boundary facet kind 1) without weak symmetry, as the bench calls it,
    and with it on rows 0/1.  Reports the set-up seconds (``BiotMG`` by
    level: tables, power iteration, coarse inverse), MINRES iterations,
    residual, seconds and ms per iteration, the V-cycles' ms by level, the
    operator's ms, the fields' seconds, both calls' strict and pipelined
    ms, peak memory, launches (K1's by route), the output against the
    plain route and K1 and K2 on each call's own operands."""
    from dolfinx_eqlb_tpu_torch.eqlb.engine import EqlbEngine
    from dolfinx_eqlb_tpu_torch.eqlb.patches import build_patches
    from dolfinx_eqlb_tpu_torch.fem import FunctionSpace
    from dolfinx_eqlb_tpu_torch.fem.multigrid import mesh_hierarchy
    from dolfinx_eqlb_tpu_torch.mesh import unit_square
    from dolfinx_eqlb_tpu_torch.models.biot import biot_bench_fields

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    res = {}
    t0 = time.perf_counter()
    meshes = mesh_hierarchy(unit_square(coarse), nlevels)
    res["hierarchy_s"] = time.perf_counter() - t0
    msh = meshes[-1]
    res["cells"] = msh.num_cells
    info = {}
    t0 = time.perf_counter()
    d_proj, d_rhs = biot_bench_fields(
        msh, 2, rtol=1e-6, maxiter=400, dtype=torch.float32, chunk=25,
        mg_meshes=meshes, device=device, info=info)
    sync(device)
    res["bench_fields_s"] = time.perf_counter() - t0
    solver, mg = info["solver"], info["mg"]
    res["stages_s"] = info["stages_s"]
    res["ndofs"] = solver.nu + solver.np_ + solver.npt
    res["mg_u_setup"] = mg_setup_rows(mg.mg_u)
    res["mg_p_setup"] = mg_setup_rows(mg.mg_p)
    its = solver.last_iterations
    res.update(iterations=its, maxiter=solver.last_maxiter,
               residual=solver.last_residual,
               solve_ms_per_iteration=res["stages_s"]["solve"] * 1e3
               / max(its, 1))
    res["data_peak_mem_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    # the same solve again, with the allocator and libraries warm
    fe, ge = info["data"]
    t0 = time.perf_counter()
    solver.solve(fe, ge, msh.boundary_facets, rtol=1e-6, maxiter=400, mg=mg)
    sync(device)
    res["solve_again_s"] = time.perf_counter() - t0
    res["solve_again_ms_per_iteration"] = (res["solve_again_s"] * 1e3
                                           / max(solver.last_iterations, 1))
    res["vcycle_u"] = vcycle_ms(mg.mg_u, timer)
    res["vcycle_p"] = vcycle_ms(mg.mg_p, timer)
    x = torch.randn(res["ndofs"], device=device, dtype=torch.float32)
    res["psolve_ms"] = timer.ms(lambda: mg.psolve(x), reps=5)
    res["matvec_ms"] = timer.ms(lambda: solver.matvec(x), reps=5)
    res["fields_ok"] = (
        tuple(d_proj.shape) == (3, msh.num_cells, 2, 3)
        and tuple(d_rhs.shape) == (3, msh.num_cells, 3)
        and bool(torch.isfinite(d_proj).all())
        and bool(torch.isfinite(d_rhs).all())
        and float(d_proj.abs().max()) > 1e-3)
    del info, solver, mg, x, meshes, fe, ge
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    buckets = build_patches(msh)
    eng = EqlbEngine(FunctionSpace(msh, "RT", 2), buckets,
                     dtype=torch.float32, device=device,
                     max_patches_per_bucket=CHUNK)
    eng._device_tables()
    sync(device)
    res["engine_setup_s"] = time.perf_counter() - t0
    dpT = d_proj.movedim(1, -1).contiguous().to(torch.float32)
    drT = d_rhs.movedim(1, -1).contiguous().to(torch.float32)
    del d_proj, d_rhs
    fk = torch.as_tensor(
        np.where(msh.is_boundary_facet, 1, 0).astype(np.int8)[None].repeat(
            3, 0), device=device)
    bv = torch.zeros((3, msh.num_facets, 2), dtype=torch.float32,
                     device=device)
    res["k1_shapes"] = solve_shapes(eng)

    def call():
        return eng.equilibrate(dpT, drT, fk, bv, transposed_inputs=True)

    def call_ws():
        return eng.equilibrate(dpT, drT, fk, bv, weak_symmetry=True,
                               transposed_inputs=True)

    res["flux"] = engine_call_checks(eng, call, False, dpT, drT, fk, bv,
                                     device, 1e-4)
    t0 = time.perf_counter()
    eng.ensure_stress_caches()
    sync(device)
    res["stress_cache_s"] = time.perf_counter() - t0
    res["ws"] = engine_call_checks(eng, call_ws, True, dpT, drT, fk, bv,
                                   device, 1e-3)
    res["ws"]["sing_patches"] = sing_counts(eng)
    del eng, dpT, drT
    torch.cuda.empty_cache()
    return res


def report_biot_bench(r: dict, nph: int, failures: list) -> None:
    st = r["stages_s"]
    log(f"[19/{nph}] Biot bench (bench.py 500 3 --biot) mesh_hierarchy("
        f"unit_square({BIOT_COARSE}), {BIOT_LEVELS}) {r['cells']} cells, "
        f"{r['ndofs']} u-p-pt dofs f32: hierarchy {r['hierarchy_s']:.2f} s; "
        f"biot_bench_fields {r['bench_fields_s']:.2f} s (" + ", ".join(
            f"{key} {val:.3f} s" for key, val in st.items()) + "); MINRES "
        f"{r['iterations']} iterations of {r['maxiter']}, residual "
        f"{r['residual']:.3e}, {r['solve_ms_per_iteration']:.3f} ms an "
        f"iteration ({r['solve_again_ms_per_iteration']:.3f} ms solved "
        f"again); block V-cycle {r['psolve_ms']:.3f} ms (u "
        f"{r['vcycle_u']['apply_ms']:.3f}, p {r['vcycle_p']['apply_ms']:.3f})"
        f", operator {r['matvec_ms']:.3f} ms; data peak "
        f"{r['data_peak_mem_gib']:.2f} GiB; engine set-up "
        f"{r['engine_setup_s']:.2f} s; stress caches "
        f"{r['stress_cache_s']:.3f} s")
    for name, lv in (("u", r["mg_u_setup"]), ("p", r["mg_p_setup"])):
        log(f"    BiotMG {name} set-up by level (s): " + "; ".join(
            f"L{row['level']} {row['cells']} cells total {row['total_s']}"
            f" power {row['power_iteration_s']}"
            + (f" inverse {row['coarse_inverse_s']}"
               if "coarse_inverse_s" in row else "") for row in lv))
        vc = r[f"vcycle_{name}"]
        log(f"    V-cycle {name} ms by level (own share): " + ", ".join(
            f"L{i} {ms:.4f}" for i, ms in enumerate(vc["level_own_ms"])))
    if not r["fields_ok"]:
        failures.append("Biot bench: the fields have a wrong shape or "
                        "non-finite values")
    if not r["iterations"] < r["maxiter"]:
        failures.append(f"Biot bench: MINRES did not converge in "
                        f"{r['maxiter']} iterations")
    for name, label in (("flux", "without weak symmetry"),
                        ("ws", "with weak symmetry on rows 0/1")):
        c = r[name]
        kc = c["kernel_checks"]
        log(f"[19/{nph}] Biot bench engine RT2 f32 3 rows {label}: first "
            f"call {c['first_call_s']:.3f} s, strict "
            f"{c['strict_ms_median']:.3f} ms median, pipelined "
            f"{c['pipelined_ms_min']:.3f} ms; launches {c['launches']} over "
            f"{c['calls']} calls, K1 by route {c['k1_launches_by_route']}; "
            f"peak {c['peak_mem_gib']:.2f} GiB; max|x - plain| "
            f"{c['max_abs_err_vs_plain']:.3e} (limit {c['err_limit']:.3e}); "
            "K1 vs plain on its operands " + "; ".join(
                f"{k['dtype']} D={k['D']} R={k['R']} X={k['X']} max_rel_err "
                f"{k['max_rel_err']:.3e}" for k in kc["K1"])
            + f"; K2 bitwise {kc['K2']['bitwise']}")
        if min(c["launches"][kn] for kn in
               ("K1", "K2", "K5", "K6")) <= 0:
            failures.append(f"Biot bench {name}: a kernel was skipped: "
                            f"{c['launches']}")
        check_k1_routes(f"Biot bench {name}", c["k1_launches_by_route"],
                        r["k1_shapes"], torch.float32, failures)
        if not (c["shape_ok"] and c["finite"]):
            failures.append(f"Biot bench {name}: wrong shape or non-finite")
        if not c["max_abs_err_vs_plain"] <= c["err_limit"]:
            failures.append(f"Biot bench {name} disagrees with the plain "
                            "route")
        if not all(k["ok"] for k in kc["K1"]) or not kc["K2"]["ok"]:
            failures.append(f"Biot bench {name}: a kernel disagrees with "
                            "its plain version")
    log("    detail: " + json.dumps(
        {key: ({k: v for k, v in val.items() if k != "kernel_checks"}
               if isinstance(val, dict) else val) for key, val in r.items()}))


def phase_biot_flow(device, n: int = 256, n_parity: int = 16) -> dict:
    """Phase 20: ``demos.biot.run`` (``demo_biot``'s configuration: the
    hierarchy from ``unit_square(4)``, P2 / P2 / P1, block-MG MINRES at
    rtol 1e-12, ``biot_fields``, one ``FluxEqlbSE(equilibrate_stress=True)``
    over the three fields, RT2) in f64 at ``n``: stage seconds, MINRES
    iterations, the divergence and jump checks of every field and the weak
    symmetry check, launches (K1's by route), peak memory, K1 and K2 on the
    equilibrator's operands.  Then the same flow at ``n_parity`` on the card
    and on the CPU: the dofs within 1e-11 relative, the MINRES iterations
    within one."""
    from dolfinx_eqlb_tpu_torch.demos import biot as demo

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    res = {"n": n}
    info = {}
    reset_launches()
    t0 = time.perf_counter()
    demo.run(n, 2, device=device, verbose=False, info=info)
    res["seconds"] = time.perf_counter() - t0
    res["launches"] = read_launches()
    res["k1_launches_by_route"] = read_launches(split=True)["K1"]
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    for key in ("stages_s", "iterations", "maxiter", "residual", "checks",
                "cells"):
        res[key] = info[key]
    res["levels"] = len(info["meshes"])
    eq = info["eq"]
    res["k1_shapes"] = solve_shapes(eq.engine)
    res["kernel_checks"] = flux_kernel_checks(eq)
    del info, eq
    torch.cuda.empty_cache()

    runs = {}
    for dv in (device, "cpu"):
        info = {}
        demo.run(n_parity, 2, device=dv, verbose=False, info=info)
        runs[str(dv)] = (torch.cat([x.cpu() for x in info["x"]]),
                         info["iterations"], info["checks"])
    card, cpu = runs[str(device)], runs["cpu"]
    err = float((card[0] - cpu[0]).abs().max())
    res["parity"] = dict(n=n_parity, max_abs_err=err,
                         max_rel_err=err / float(cpu[0].abs().max()),
                         iterations=[card[1], cpu[1]],
                         checks_identical=card[2] == cpu[2])
    return res


def report_biot_flow(r: dict, nph: int, failures: list) -> None:
    log(f"[20/{nph}] Biot flow (demos.biot) n={r['n']} ({r['cells']} cells,"
        f" {r['levels']} levels) P2/RT2 f64: {r['seconds']:.1f} s; stages "
        f"(s) " + ", ".join(f"{key} {val:.3f}"
                            for key, val in r["stages_s"].items())
        + f"; MINRES {r['iterations']} iterations of {r['maxiter']}, "
        f"residual {r['residual']:.3e}; checks {r['checks']}; launches "
        f"{r['launches']}, K1 by route {r['k1_launches_by_route']}; peak "
        f"{r['peak_mem_gib']:.2f} GiB")
    kc = r["kernel_checks"]
    log("    kernels vs plain on the equilibrator's operands: K1 "
        + "; ".join(f"D={c['D']} R={c['R']} X={c['X']} max_rel_err "
                    f"{c['max_rel_err']:.3e}" for c in kc["K1"])
        + f" (limit 1e-12); K2 bitwise {kc['K2']['bitwise']}")
    p = r["parity"]
    ok = (p["max_rel_err"] <= 1e-11
          and abs(p["iterations"][0] - p["iterations"][1]) <= 1
          and p["checks_identical"])
    log(f"[20/{nph}] Biot flow n={p['n']} card vs CPU: max_rel_err "
        f"{p['max_rel_err']:.3e} (limit 1e-11), MINRES iterations "
        f"{p['iterations']} (card, CPU), checks identical "
        f"{p['checks_identical']}{'' if ok else '  FAILED'}")
    log("    detail: " + json.dumps(
        {key: val for key, val in r.items() if key != "kernel_checks"}))
    if not r["checks"] or not all(r["checks"].values()):
        failures.append(f"Biot flow: a check failed: {r['checks']}")
    if not r["iterations"] < r["maxiter"]:
        failures.append("Biot flow: MINRES did not converge")
    if min(r["launches"][kn] for kn in ("K1", "K2", "K5", "K6")) <= 0:
        failures.append(f"Biot flow skipped a kernel: {r['launches']}")
    check_k1_routes("Biot flow", r["k1_launches_by_route"], r["k1_shapes"],
                    torch.float64, failures)
    if not all(c["ok"] for c in kc["K1"]) or not kc["K2"]["ok"]:
        failures.append("Biot flow: a kernel disagrees with its plain "
                        "version")
    if not ok:
        failures.append("Biot flow: card and CPU disagree")


def mg_poisson_run(device, nlevels: int, gen) -> dict:
    """The P2 Poisson V-cycle MINRES (rtol 1e-10) on
    ``mesh_hierarchy(unit_square(4), nlevels)``, f64."""
    from dolfinx_eqlb_tpu_torch.fem.krylov import minres
    from dolfinx_eqlb_tpu_torch.fem.multigrid import (
        GeometricMG, mesh_hierarchy, scalar_stiffness_tensors,
    )
    from dolfinx_eqlb_tpu_torch.mesh import unit_square

    meshes = mesh_hierarchy(unit_square(4), nlevels)
    t0 = time.perf_counter()
    mg = GeometricMG(meshes, 2, lambda m: scalar_stiffness_tensors(m, 2),
                     device=device)
    setup_s = time.perf_counter() - t0
    o = mg.operands()[-1]
    n = o["Dinv"].shape[0]
    b = torch.randn(n, generator=gen, device=device,
                    dtype=torch.float64) * o["free"]
    sync(device)
    t0 = time.perf_counter()
    st = minres(lambda v: mg._matvec(o, v), b,
                torch.zeros(n, dtype=torch.float64, device=device),
                mg.apply, o["free"] > 0, rtol=1e-10, maxiter=2000)
    sync(device)
    s = time.perf_counter() - t0
    return dict(levels=nlevels, cells=meshes[-1].num_cells, dofs=n,
                iterations=st["it"], setup_s=setup_s, solve_s=s,
                ms_per_iteration=s * 1e3 / max(st["it"], 1),
                converged=float(st["phibar"]) < 1e-9 * float(b.norm()))


def vcycle_symmetry(mg, gen) -> dict:
    """|<B r1, r2> - <r1, B r2>| against 1e-12 ||B r1|| ||r2||."""
    o = mg.operands()[-1]
    r1, r2 = (torch.randn(o["Dinv"].shape[0], generator=gen,
                          device=mg.device, dtype=torch.float64) * o["free"]
              for _ in range(2))
    z1, z2 = mg.apply(r1), mg.apply(r2)
    dev = abs(float(torch.dot(z1, r2) - torch.dot(r1, z2)))
    limit = 1e-12 * float(z1.norm() * r2.norm())
    return dict(deviation=dev, limit=limit, ok=dev <= limit)


PERFTEST_CSVS = {"elasticity": "artifacts/Perftest_elasticity.csv",
                 "biot": "artifacts/Perftest_biot.csv"}


def phase_multigrid(device, n_levels_ela: int = 7, n_levels_up: int = 6,
                    perftest_nrefs: int = 4,
                    poisson_levels=range(2, 7)) -> dict:
    """Phase 21: multigrid on the card, f64.  The P2 Poisson V-cycle MINRES
    on ``mesh_hierarchy(unit_square(4), L)`` for each L (mesh
    independence) and the V-cycle's symmetry (block sizes 1 and 2) on the
    deepest; the MG elasticity CG (P2, u) on ``mesh_hierarchy(
    unit_square(8), 7)`` (1,048,576 cells) and the MG Herrmann MINRES
    (P3 x P2, u-p) on its first 6 levels (262,144 cells; the script's time
    limit keeps the finest level out), iterations and seconds; then
    ``run_perftest``
    for "elasticity" and "biot", orders 2-4, n0 = 8, nrefs = 4 (to 16,384
    cells; the script's time limit keeps the 65,536-cell rows out),
    repeats 1:
    its structural columns against the committed
    ``artifacts/Perftest_*.csv`` row for row, its times recorded."""
    import csv

    from dolfinx_eqlb_tpu_torch.demos.elasticity import f_body, u_exact
    from dolfinx_eqlb_tpu_torch.fem import FunctionSpace, expr_from_callable
    from dolfinx_eqlb_tpu_torch.fem.multigrid import (
        GeometricMG, mesh_hierarchy, scalar_stiffness_tensors,
        vector_eps_tensors,
    )
    from dolfinx_eqlb_tpu_torch.mesh import unit_square
    from dolfinx_eqlb_tpu_torch.models.elasticity import (
        ElasticitySolver, ElasticitySolverUP,
    )
    from dolfinx_eqlb_tpu_torch.utils.perftest import run_perftest

    gen = torch.Generator(device=device).manual_seed(5)
    res = {"poisson": [mg_poisson_run(device, nl, gen)
                       for nl in poisson_levels]}
    meshes = mesh_hierarchy(unit_square(4), max(poisson_levels))
    res["symmetry"] = {
        "bs1": vcycle_symmetry(GeometricMG(
            meshes, 2, lambda m: scalar_stiffness_tensors(m, 2),
            device=device), gen),
        "bs2": vcycle_symmetry(GeometricMG(
            meshes, 2, lambda m: vector_eps_tensors(m, 2), block_size=2,
            device=device), gen)}
    del meshes
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats(device)
    meshes = mesh_hierarchy(unit_square(8), n_levels_ela)
    msh = meshes[-1]
    f = expr_from_callable(f_body, msh, value_size=2)
    ud = expr_from_callable(u_exact, msh, value_size=2)
    ela = {"cells": msh.num_cells}
    t0 = time.perf_counter()
    s = ElasticitySolver(FunctionSpace(msh, "P", 2, vs=2), 1.0,
                         device=device)
    mg = GeometricMG(meshes, 2,
                     lambda m: vector_eps_tensors(m, 2, div_coeff=1.0),
                     block_size=2, device=device)
    sync(device)
    ela["u_setup_s"] = time.perf_counter() - t0
    ela["u_mg_setup"] = mg_setup_rows(mg)
    t0 = time.perf_counter()
    uh = s.solve(f, msh.boundary_facets, ud, rtol=1e-12, mg_meshes=mg)
    sync(device)
    ela.update(u_solve_s=time.perf_counter() - t0,
               u_iterations=s.last_iterations, u_maxiter=s.last_maxiter,
               u_dofs=s.ndofs, u_finite=bool(torch.isfinite(uh.x).all()))
    del s, mg, uh
    torch.cuda.empty_cache()
    meshes = meshes[:n_levels_up]
    msh = meshes[-1]
    f = expr_from_callable(f_body, msh, value_size=2)
    ud = expr_from_callable(u_exact, msh, value_size=2)
    ela["up_cells"] = msh.num_cells
    t0 = time.perf_counter()
    sup = ElasticitySolverUP(FunctionSpace(msh, "P", 3, vs=2),
                             FunctionSpace(msh, "P", 2), 1.0, device=device)
    uu, pp = sup.solve(f, msh.boundary_facets, ud, rtol=1e-12,
                       mg_meshes=meshes)
    sync(device)
    ela.update(up_s=time.perf_counter() - t0,
               up_iterations=sup.last_iterations, up_maxiter=sup.last_maxiter,
               up_dofs=sup.nu + sup.np_,
               up_finite=bool(torch.isfinite(uu.x).all()
                              and torch.isfinite(pp.x).all()))
    ela["peak_mem_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    del sup, uu, pp, meshes, msh
    torch.cuda.empty_cache()
    res["elasticity"] = ela

    res["perftest"] = {}
    for tc, path in PERFTEST_CSVS.items():
        t0 = time.perf_counter()
        rows = run_perftest(tc, orders=(2, 3, 4), n0=8,
                            nrefs=perftest_nrefs, repeats=1, out_csv=None,
                            device=device)
        with open(repo_file(path)) as fh:
            want = [(int(w["order"]), int(w["ncells"]), int(w["nnodes"]),
                     int(w["ndofs_prime"])) for w in csv.DictReader(fh)
                    if int(w["ncells"]) <= rows[-1]["ncells"]]
        got = [(r["order"], r["ncells"], r["nnodes"], r["ndofs_prime"])
               for r in rows]
        res["perftest"][tc] = dict(
            seconds=time.perf_counter() - t0, structure_ok=got == want,
            rows=[{key: (round(v, 4) if isinstance(v, float) else v)
                   for key, v in r.items()} for r in rows])
        torch.cuda.empty_cache()
    return res


def report_multigrid(r: dict, nph: int, failures: list) -> None:
    its = [p["iterations"] for p in r["poisson"]]
    log(f"[21/{nph}] MG Poisson P2 V-cycle MINRES (rtol 1e-10) by depth: "
        + "; ".join(f"{p['levels']} levels {p['cells']} cells "
                    f"{p['iterations']} its {p['ms_per_iteration']:.2f} ms "
                    f"an iteration (set-up {p['setup_s']:.2f} s)"
                    for p in r["poisson"])
        + "; V-cycle symmetry f64 " + ", ".join(
            f"{name} {s['deviation']:.2e} (limit {s['limit']:.2e})"
            for name, s in r["symmetry"].items()))
    if not (all(p["converged"] for p in r["poisson"]) and max(its) <= 25
            and its[-1] <= its[0] + 5):
        failures.append(f"MG Poisson: not mesh independent or not "
                        f"converged: {its}")
    if not all(s["ok"] for s in r["symmetry"].values()):
        failures.append("the V-cycle is not symmetric")
    e = r["elasticity"]
    log(f"[21/{nph}] MG elasticity on {e['cells']} cells: CG (P2 u, "
        f"{e['u_dofs']} dofs) {e['u_iterations']} iterations of "
        f"{e['u_maxiter']} in {e['u_solve_s']:.2f} s (set-up "
        f"{e['u_setup_s']:.2f} s; Jacobi CG at n = 500: "
        f"{JACOBI_CG_ITS_N500}); Herrmann MINRES on {e['up_cells']} cells "
        f"(P3 x P2, {e['up_dofs']} dofs) {e['up_iterations']} iterations "
        f"of {e['up_maxiter']} in {e['up_s']:.2f} s with its set-up; peak "
        f"{e['peak_mem_gib']:.2f} GiB")
    if not (e["u_iterations"] < e["u_maxiter"] and e["u_finite"]
            and e["up_iterations"] < e["up_maxiter"] and e["up_finite"]):
        failures.append("MG elasticity: a solve did not converge")
    for tc, p in r["perftest"].items():
        log(f"[21/{nph}] run_perftest {tc} orders 2-4 n0 8 nrefs "
            f"{len(p['rows']) // 3}: {p['seconds']:.1f} s; structural "
            f"columns equal {PERFTEST_CSVS[tc]}: {p['structure_ok']}")
        if not p["structure_ok"]:
            failures.append(f"run_perftest {tc}: the structural columns "
                            f"differ from {PERFTEST_CSVS[tc]}")
    log("    detail: " + json.dumps(r))


# --- phase 22: patch sharding and I/O (slice 6) -------------------------------

MSH_TEXTS = "tests/test_msh_io.py"
SHARD_RANKS = 2


def shard_dryrun_rank(rank, world, device, backend, probe):
    """One rank of phase 22 (a) and (c): ``entry.dryrun_multichip``'s cases
    (``entry.dryrun_record`` each), with this rank's K1 (by route) and K2
    launches of the sharded call; with ``probe``, rank 0 also holds K1 and
    K2 against their plain versions on its own operands (one more call of
    its part, without the reduce)."""
    from dolfinx_eqlb_tpu_torch.entry import (
        DRYRUN_CASES, dryrun_case, dryrun_record,
    )
    from dolfinx_eqlb_tpu_torch.parallel import (
        ShardedEqlbEngine, rank_device,
    )

    dev = rank_device(device, backend, rank)
    out = {}
    for name in DRYRUN_CASES:
        engine, args, ws, skip, groups = dryrun_case(name, world, dev)
        sh = ShardedEqlbEngine(engine)
        reset_launches()
        x = sh.equilibrate(*args, weak_symmetry=ws, ws_skip_nodes=skip)
        launches = read_launches()
        launches["K1_by_route"] = read_launches(split=True)["K1"]
        rec = dryrun_record(rank, engine, sh, x, args, ws, skip, groups)
        rec["launches"] = launches
        if probe and rank == 0:
            rec["probe"] = engine_kernel_checks(sh.local, lambda: sh.partial(
                *args, weak_symmetry=ws, ws_skip_nodes=skip))
        out[name] = rec
    return out


def stress_shard_rank(rank, world, device, n, reps):
    """One rank of phase 22 (b): ``bench.py --stress``'s headline (the
    crossed ``unit_square(n)``, RT2, two f32 stress rows of phase 15's
    data, chunk ``CHUNK``, ``weak_symmetry=True``) through
    ``ShardedEqlbEngine`` on this rank's rows: set-up seconds, strict ms
    of ``reps`` calls (host clock, the ranks started together by a
    barrier), the same calls split into the rank-local solve, the partial
    combine and the all-reduce, launches, peak memory; rank 0 also returns
    the result, and K1 and K2 against their plain versions on its own
    operands (one more call of its part, without the reduce)."""
    import torch.distributed as dist

    from dolfinx_eqlb_tpu_torch.eqlb.engine import EqlbEngine
    from dolfinx_eqlb_tpu_torch.eqlb.patches import build_patches
    from dolfinx_eqlb_tpu_torch.fem import FunctionSpace
    from dolfinx_eqlb_tpu_torch.mesh import unit_square
    from dolfinx_eqlb_tpu_torch.utils.precision import full_f32_matmul
    from dolfinx_eqlb_tpu_torch.parallel import ShardedEqlbEngine

    dev = torch.device(device)
    torch.cuda.init()  # the memory statistics below need the allocator
    res = {"rank": rank}
    t0 = time.perf_counter()
    msh = unit_square(n)
    engine = EqlbEngine(FunctionSpace(msh, "RT", 2), build_patches(msh),
                        dtype=torch.float32, device=dev,
                        max_patches_per_bucket=CHUNK, pad_to_multiple=world)
    dp, dr, fk, bv = make_data(msh, 2, 2, seed=0, np_dtype=np.float32)
    res["host_setup_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    sh = ShardedEqlbEngine(engine)
    sync(dev)
    res["local_tables_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sh.local.ensure_stress_caches()
    sync(dev)
    res["stress_cache_s"] = time.perf_counter() - t0
    res["patches"], res["rows"] = sh.npatches_local, sh.rows_local
    dpd = torch.as_tensor(dp, device=dev)
    drd = torch.as_tensor(dr, device=dev)
    fkd = torch.as_tensor(fk, device=dev)
    bvd = torch.as_tensor(bv, device=dev)

    def call():
        return sh.equilibrate(dpd, drd, fkd, bvd, weak_symmetry=True)

    reset_launches()
    t0 = time.perf_counter()
    x = call()
    sync(dev)
    res["first_call_s"] = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        dist.barrier()
        sync(dev)
        t0 = time.perf_counter()
        x = call()
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    res["launches"] = read_launches()
    res["k1_launches_by_route"] = read_launches(split=True)["K1"]
    res["calls"] = 1 + reps
    res["strict_ms"] = times
    res["strict_ms_median"] = float(np.median(times))
    loc = sh.local
    dpT, drT = loc.put_transposed(dp, dr)
    split = {"local_solve_ms": [], "partial_combine_ms": [],
             "all_reduce_ms": []}
    for _ in range(reps):
        dist.barrier()
        sync(dev)
        t0 = time.perf_counter()
        with full_f32_matmul():
            flat = loc._bucket_solutions(loc._pack_dofs(dpT, drT, True),
                                         fkd, bvd, True, None)
        sync(dev)
        t1 = time.perf_counter()
        xp = loc._combine_flat(flat)
        sync(dev)
        t2 = time.perf_counter()
        sh.reduce(xp)
        sync(dev)
        t3 = time.perf_counter()
        for name, (a, b) in (("local_solve_ms", (t0, t1)),
                             ("partial_combine_ms", (t1, t2)),
                             ("all_reduce_ms", (t2, t3))):
            split[name].append((b - a) * 1e3)
    res["split_ms_median"] = {k: float(np.median(v)) for k, v in split.items()}
    res["split_equals_call"] = bool(torch.equal(xp, x))
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    if rank == 0:
        res["x"] = x.cpu()
        del x, xp, flat
        res["kernel_checks"] = engine_kernel_checks(loc, lambda: sh.partial(
            dpd, drd, fkd, bvd, weak_symmetry=True))
    return res


def msh_texts() -> dict:
    """The Gmsh v2.2 and v4.1 texts of ``tests/test_msh_io.py``, read from
    its source (the test module itself imports JAX)."""
    import ast

    tree = ast.parse(repo_file(MSH_TEXTS).read_text())
    return {node.targets[0].id: ast.literal_eval(node.value)
            for node in tree.body if isinstance(node, ast.Assign)
            and getattr(node.targets[0], "id", "") in ("MSH_V2", "MSH_V4")}


def imported_mesh_flow(msh, device):
    """``tests/test_msh_io.py``'s equilibration on an imported mesh: SE,
    RT2, a linear projected flux with constant divergence."""
    from dolfinx_eqlb_tpu_torch.eqlb import (
        FluxEqlbSE, check_divergence_condition,
    )
    from dolfinx_eqlb_tpu_torch.fem import (
        FunctionSpace, expr_from_callable, local_projection,
    )

    k = 2
    rhs = local_projection(FunctionSpace(msh, "DG", k - 1),
                           [lambda x: np.ones(x.shape[:-1])], device=device)
    proj = local_projection(
        FunctionSpace(msh, "DG", k - 1, vs=2),
        [expr_from_callable(lambda x: 0.5 * np.stack([x[..., 0],
                                                       x[..., 1]], -1),
                            msh, value_size=2)], device=device)
    eq = FluxEqlbSE(k, msh, rhs, proj)
    eq.set_boundary_conditions([msh.boundary_facets], [[]])
    eq.equilibrate_fluxes()
    ok = check_divergence_condition(eq.list_flux[0], proj[0], rhs[0])
    return eq.list_flux[0].x.cpu(), bool(ok)


def xdmf_numeric(path) -> dict:
    """Parse an XDMF file as XML; every inline data item must hold only
    numeric tokens."""
    import re
    import xml.etree.ElementTree as ET

    num = re.compile(r"^-?(\d+(\.\d*)?|\.\d+)([eE][-+]?\d+)?$")
    root = ET.parse(path).getroot()
    items = list(root.iter("DataItem"))
    inline = [it for it in items if it.get("Format") == "XML"]
    bad = sum(not num.match(tok) for it in inline for tok in it.text.split())
    return {"items": len(items), "inline_items": len(inline),
            "non_numeric_tokens": bad,
            "attributes": sorted(a.get("Name") for a in root.iter("Attribute"))}


def phase_io(device, n: int = 64):
    """Phase 22 (d): ``read_msh`` on the v2 and v4 texts and the
    equilibration on the imported mesh, card against CPU; the
    reconstruction flow at n with its XDMF and VTU, written to a
    temporary directory and checked there."""
    import os
    import tempfile
    import xml.etree.ElementTree as ET

    from dolfinx_eqlb_tpu_torch.demos.reconstruction import (
        solve_and_equilibrate, write_output,
    )
    from dolfinx_eqlb_tpu_torch.eqlb import FluxEqlbSE
    from dolfinx_eqlb_tpu_torch.mesh import read_msh, unit_square

    res = {"msh": {}}
    for name, text in msh_texts().items():
        msh, ft, ct = read_msh(text)
        card, ok_card = imported_mesh_flow(msh, device)
        cpu, ok_cpu = imported_mesh_flow(msh, "cpu")
        err = float((card - cpu).abs().max())
        limit = 1e-11 * max(1.0, float(cpu.abs().max()))
        res["msh"][name] = dict(
            cells=msh.num_cells, vertices=msh.num_vertices,
            facet_tags={int(t): len(v) for t, v in ft.items()},
            cell_tags={int(t): len(v) for t, v in ct.items()},
            max_abs_err=err, limit=limit, divergence_ok=ok_card and ok_cpu,
            ok=(msh.num_cells == 4 and len(ft.get(10, ())) == 1
                and len(ft.get(20, ())) == 3 and err <= limit
                and ok_card and ok_cpu))
    t0 = time.perf_counter()
    msh = unit_square(n)
    uh, sp, eq = solve_and_equilibrate(msh, 2, 2, "dirichlet", FluxEqlbSE,
                                       device=device, verbose=False)
    res["flow_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as outdir:
        t0 = time.perf_counter()
        write_output(outdir, msh, uh, sp, eq)
        res["write_s"] = time.perf_counter() - t0
        xd = xdmf_numeric(os.path.join(outdir, "reconstruction.xdmf"))
        vtu = ET.parse(os.path.join(outdir, "reconstruction.vtu")).getroot()
        res["bytes"] = {ext: os.path.getsize(os.path.join(
            outdir, f"reconstruction.{ext}")) for ext in ("xdmf", "vtu")}
    res["xdmf"] = xd
    res["vtu_arrays"] = sorted(d.get("Name") for d in vtu.iter("DataArray")
                               if d.get("Name"))
    res["cells"] = msh.num_cells
    res["ok"] = (all(m["ok"] for m in res["msh"].values())
                 and xd["non_numeric_tokens"] == 0
                 and xd["attributes"] == ["sigma_R", "sigma_proj", "u"]
                 and {"u", "sigma_proj", "sigma_R"} <= set(res["vtu_arrays"]))
    return res


def stress_reference(n: int, device) -> torch.Tensor:
    """Phase 15's single-device call (weak symmetry) on the same data,
    returned on the host: the reference of phase 22 (b)."""
    from dolfinx_eqlb_tpu_torch.eqlb.engine import EqlbEngine
    from dolfinx_eqlb_tpu_torch.eqlb.patches import build_patches
    from dolfinx_eqlb_tpu_torch.fem import FunctionSpace
    from dolfinx_eqlb_tpu_torch.mesh import unit_square

    msh = unit_square(n)
    eng = EqlbEngine(FunctionSpace(msh, "RT", 2), build_patches(msh),
                     dtype=torch.float32, device=device,
                     max_patches_per_bucket=CHUNK)
    dp, dr, fk, bv = make_data(msh, 2, 2, seed=0, np_dtype=np.float32)
    x = eng.equilibrate(dp, dr, fk, bv, weak_symmetry=True).cpu()
    del eng
    torch.cuda.empty_cache()
    return x


def phase_sharding(device, n: int, reps: int = 7) -> dict:
    """Phase 22: (a) the four dry-run cases of ``entry.dryrun_multichip``,
    f64, on ``SHARD_RANKS`` gloo ranks on the card, each against the
    single-device engine, with K1 and K2 on rank 0's operands; (b) the
    stress headline split over the same ranks (``stress_shard_rank``)
    against phase 15's call (``stress_reference``), with K1 and K2 on
    rank 0's operands; (c) a one-rank NCCL group,
    bitwise against the single-device engine; (d) ``phase_io``.  A part
    that raises is recorded with its error and the others still run."""
    import traceback

    from dolfinx_eqlb_tpu_torch.entry import dryrun_check
    from dolfinx_eqlb_tpu_torch.parallel import spawn_ranks

    res = {}

    def part(name, fn):
        t0 = time.perf_counter()
        try:
            res[name] = fn()
        except Exception as e:  # report every part, then fail the phase
            res[name] = {"error": f"{type(e).__name__}: {e}",
                         "traceback": traceback.format_exc()}
        res[name]["seconds"] = time.perf_counter() - t0

    def dryrun(ranks, backend, probe):
        return dryrun_check(spawn_ranks(shard_dryrun_rank, ranks, backend,
                                        args=(str(device), backend, probe)))

    def full_width():
        x_stress = stress_reference(n, device)
        ranks = spawn_ranks(stress_shard_rank, SHARD_RANKS, "gloo",
                            args=(str(device), n, reps))
        x = ranks[0].pop("x")
        scale = float(x_stress.abs().max())
        out = {"ranks": ranks, "ndofs": int(x.shape[1]),
               "kernel_checks": ranks[0].pop("kernel_checks"),
               "max_abs_err_vs_single": float((x - x_stress).abs().max()),
               "err_limit": 1e-3 * scale,
               "finite": bool(torch.isfinite(x).all())}
        out["ok"] = (out["finite"] and tuple(x.shape) == tuple(x_stress.shape)
                     and out["max_abs_err_vs_single"] <= out["err_limit"]
                     and all(r["split_equals_call"] for r in ranks))
        return out

    def nccl_one_rank():
        rep = dryrun(1, "nccl", False)
        cases = {name: {"bitwise": bool(np.array_equal(r["x"],
                                                       r["x_single"])),
                        "max_abs_err": r["max_abs_err"],
                        "launches": r["ranks"][0]["launches"]}
                 for name, r in rep.items()}
        return {"cases": cases,
                "ok": all(c["bitwise"] for c in cases.values())}

    part("dryrun", lambda: {"cases": {
        name: {key: r[key] for key in ("max_abs_err", "limit", "ranks")}
        for name, r in dryrun(SHARD_RANKS, "gloo", True).items()}})
    part("full_width", full_width)
    part("nccl", nccl_one_rank)
    part("io", lambda: phase_io(device))
    return res


def report_sharding(r: dict, nph: int, failures: list) -> None:
    for name, p in r.items():
        if "error" in p:
            log(f"[22/{nph}] {name}: FAILED {p['error']}\n{p['traceback']}")
            failures.append(f"phase 22 {name}: {p['error']}")
    d = r["dryrun"]
    if "cases" in d:
        for name, c in d["cases"].items():
            kc = c["ranks"][0]["probe"]
            k1_ok = all(k["ok"] for k in kc["K1"]) and kc["K2"]["ok"]
            log(f"[22/{nph}] (a) dryrun {name}, {SHARD_RANKS} gloo ranks on "
                f"the card, f64: max|x - single device| "
                f"{c['max_abs_err']:.3e} (limit {c['limit']:.3e}); per rank "
                + "; ".join(f"rank {i}: {rk['patches']} patches / "
                            f"{rk['rows']} rows, K1 {rk['launches']['K1']} "
                            f"{rk['launches']['K1_by_route']}, K2 "
                            f"{rk['launches']['K2']}"
                            for i, rk in enumerate(c["ranks"]))
                + "; rank 0's operands: K1 " + ", ".join(
                    f"D={k['D']} R={k['R']} X={k['X']} rel "
                    f"{k['max_rel_err']:.1e}" for k in kc["K1"])
                + f", K2 bitwise {kc['K2']['bitwise']}")
            if not k1_ok:
                failures.append(f"phase 22 dryrun {name}: K1 or K2 "
                                "disagrees with its plain version")
            if any(min(rk["launches"][kn]
                       for kn in ("K1", "K2", "K5", "K6"))
                   <= 0 for rk in c["ranks"]):
                failures.append(f"phase 22 dryrun {name}: a rank skipped a "
                                "kernel")
        log(f"    (a) {d['seconds']:.1f} s")
    f = r["full_width"]
    if "ranks" in f:
        for rk in f["ranks"]:
            s = rk["split_ms_median"]
            log(f"[22/{nph}] (b) stress headline sharded, rank "
                f"{rk['rank']} of {SHARD_RANKS} (gloo, one card): "
                f"{rk['patches']} patches / {rk['rows']} rows; host set-up "
                f"{rk['host_setup_s']:.2f} s, local tables "
                f"{rk['local_tables_s']:.3f} s, stress caches "
                f"{rk['stress_cache_s']:.3f} s; first call "
                f"{rk['first_call_s']:.3f} s; strict "
                f"{rk['strict_ms_median']:.3f} ms median of "
                f"{len(rk['strict_ms'])} ({', '.join(f'{t:.2f}' for t in rk['strict_ms'])}); split: local solve "
                f"{s['local_solve_ms']:.3f}, partial combine "
                f"{s['partial_combine_ms']:.3f}, all-reduce "
                f"{s['all_reduce_ms']:.3f} ms; launches {rk['launches']} "
                f"over {rk['calls']} calls, K1 by route "
                f"{rk['k1_launches_by_route']}; peak "
                f"{rk['peak_mem_gib']:.2f} GiB")
            if min(rk["launches"][kn] for kn in
                   ("K1", "K2", "K5", "K6")) <= 0:
                failures.append("phase 22 full width: a rank skipped a "
                                "kernel")
        kc = f["kernel_checks"]
        log(f"    (b) {f['ndofs']} dofs; max|x - phase 15| "
            f"{f['max_abs_err_vs_single']:.3e} (limit {f['err_limit']:.3e})"
            f"; rank 0's operands: K1 " + ", ".join(
                f"D={k['D']} R={k['R']} X={k['X']} rel "
                f"{k['max_rel_err']:.1e}" for k in kc["K1"])
            + f", K2 ndofs={kc['K2']['ndofs']} bitwise "
            f"{kc['K2']['bitwise']}; {f['seconds']:.1f} s"
            f"{'' if f['ok'] else '  FAILED'}")
        if not f["ok"]:
            failures.append("phase 22 full width disagrees with phase 15")
        if not all(k["ok"] for k in kc["K1"]) or not kc["K2"]["ok"]:
            failures.append("phase 22 full width: K1 or K2 disagrees with "
                            "its plain version on rank 0's operands")
    c = r["nccl"]
    if "cases" in c:
        log(f"[22/{nph}] (c) one-rank NCCL group: bitwise equal to the "
            f"single-device engine " + ", ".join(
                f"{name} {v['bitwise']}" for name, v in c["cases"].items())
            + f"; {c['seconds']:.1f} s{'' if c['ok'] else '  FAILED'}")
        if not c["ok"]:
            failures.append("phase 22 NCCL one-rank group is not bitwise "
                            "equal to the single-device engine")
    io = r["io"]
    if "msh" in io:
        log(f"[22/{nph}] (d) read_msh "
            + ", ".join(f"{name}: {m['cells']} cells, facet tags "
                        f"{m['facet_tags']}, card vs CPU "
                        f"{m['max_abs_err']:.1e} (limit {m['limit']:.1e})"
                        for name, m in io["msh"].items())
            + f"; reconstruction n={int(np.sqrt(io['cells'] // 4))} "
            f"({io['cells']} cells) flow {io['flow_s']:.2f} s, output "
            f"{io['write_s']:.2f} s, bytes {io['bytes']}, XDMF "
            f"{io['xdmf']}; {io['seconds']:.1f} s"
            f"{'' if io['ok'] else '  FAILED'}")
        if not io["ok"]:
            failures.append("phase 22 I/O check failed")
    log("    detail: " + json.dumps(r))


# phase 23: the port's bench by mode: its arguments after n (None: n is
# fixed in the arguments) and the launches a timed call makes, K1 by route
# (routes absent: none); the bench hands the engine its boundary data as
# device tensors, so nothing is uploaded.  The timed calls follow three
# untimed ones, so stage 3 replays its captured graph once a call, but
# under weak symmetry (--stress), which stays eager
BENCH_NO_UPLOAD = {"input_uploads": 0, "input_bytes": 0}
BENCH_REPLAY = {"graph_captures": 0, "graph_replays": 1}
BENCH_MODES = {
    # K5 and K6 once a chunk: 6 chunks at n = 500 (chunk 131072), 10 at the
    # mixed chunk (65536), 6 on the Biot mesh
    "default": ([], {"K1": {"tile": 2}, "K2": 1, "K3": 0, "K4": 0, "K5": 6,
                     "K6": 6, "pivoted_solves": 0, **BENCH_NO_UPLOAD,
                     **BENCH_REPLAY}),
    "stress": (["--stress"], {"K1": {"tile": 2}, "K2": 1, "K3": 0, "K4": 0,
                              "K5": 6, "K6": 6, "pivoted_solves": 2,
                              **BENCH_NO_UPLOAD, "graph_captures": 0,
                              "graph_replays": 0}),
    # the f32 factorisation and its one f64 correction per boundary chunk
    "mixed": (["--mixed"], {"K1": {"tile": 4}, "K2": 0, "K3": 0, "K4": 1,
                            "K5": 10, "K6": 10, "pivoted_solves": 0,
                            **BENCH_NO_UPLOAD, **BENCH_REPLAY}),
    # 65,536 cells (phase 19 runs the 1,048,576-cell headline): three
    # boundary patch shapes on the refined hierarchy, three masked solves
    "biot": (None, {"K1": {"tile": 3}, "K2": 1, "K3": 0, "K4": 0, "K5": 6,
                    "K6": 6, "pivoted_solves": 0, **BENCH_NO_UPLOAD,
                    **BENCH_REPLAY}),
}
BENCH_BIOT = dict(n=128, n_fields=3, biot=True)
BENCH_BIOT_ARGS = ["128", "3", "--biot"]
BENCH_DIVERGENCE_REL_LIMIT = 1e-12


def bench_run(cmd: list, timeout: float = 600.0) -> dict:
    """One bench process: exit code, seconds, its JSON lines and the end
    of its log."""
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=repo_file(""), capture_output=True,
                         text=True, timeout=timeout)
    lines = [json.loads(line) for line in res.stdout.splitlines()
             if line.startswith("{")]
    return {"cmd": " ".join(cmd[1:]), "rc": res.returncode,
            "seconds": time.perf_counter() - t0, "lines": lines,
            "log_tail": res.stderr[-3000:]}


def bench_problems(run: dict, expected: dict, card: str, mixed: bool) -> list:
    """What is wrong with a bench run: its exit code, the two lines (strict
    first), an error, value, vs_baseline, the card, the launches per timed
    call, and under --mixed the relative divergence residual."""
    out = [] if run["rc"] == 0 else [f"exit code {run['rc']}"]
    lines = run["lines"]
    if len(lines) != 2:
        return out + [f"{len(lines)} JSON lines, not 2"]
    strict, piped = lines
    if not (strict["metric"].endswith(" [strict latency]")
            and "pipelined_ms" in piped and "pipelined_ms" not in strict):
        out.append("the strict line is not first")
    for name, line in zip(("strict", "pipelined"), lines):
        if "error" in line:
            out.append(f"{name}: error {line['error']}")
            continue
        if not line["value"] > 0:
            out.append(f"{name}: value {line['value']}")
        if line["vs_baseline"] is not None:
            out.append(f"{name}: vs_baseline {line['vs_baseline']}")
        if line["device"] != card:
            out.append(f"{name}: device {line['device']!r}")
        got = dict(line["launches"])
        got["K1"] = {rt: v for rt, v in got["K1"].items() if v}
        if got != expected:
            out.append(f"{name}: launches per call {got}, not {expected}")
        if mixed and not (line["divergence_rel_err"]
                          <= BENCH_DIVERGENCE_REL_LIMIT):
            out.append(f"{name}: divergence_rel_err "
                       f"{line['divergence_rel_err']}")
    return out


def bench_launch_totals(run: dict) -> dict:
    """Each kernel's launches over a bench run's timed calls (per call
    times the calls of each line)."""
    tot = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K6"), 0)
    for line in run["lines"]:
        calls = (8 * len(line["pipelined_samples_ms"])
                 if "pipelined_ms" in line
                 else len(line["latency_samples_ms"]))
        per = line["launches"]
        tot["K1"] += round(sum(per["K1"].values()) * calls)
        for kname in ("K2", "K3", "K4", "K5", "K6"):
            tot[kname] += round(per[kname] * calls)
    return tot


def load_moments_work(k: int, n: int, P: int, n_rhs: int, ncells: int,
                      size: int) -> tuple[int, int]:
    """(bytes, operations) K5 needs for a bucket of n cells a patch and P
    patches: the ``ncells`` distinct cells' 3 ndg dofs a RHS, each
    (cell slot, patch)'s ids, J, K, signs and detJ, and the two outputs,
    each once; the reference tensors."""
    ndg = k * (k + 1) // 2
    nkeep = 2 * ndg
    geometry = n * P * (2 * 8 + (4 + 4 + nkeep + 1) * size)
    gathered = n_rhs * ncells * 3 * ndg * size
    outputs = n * n_rhs * P * (nkeep + ndg) * size
    refs = 6 * (ndg * 2 * nkeep + ndg * ndg + 2) * size
    # per (cell slot, lane): gpsi, Fq, dpJ and Fv as the kernel runs them
    ops = 6 + ndg * (2 * ndg + 5) + 6 * ndg + nkeep * (4 * ndg + 2)
    return geometry + gathered + outputs + refs, ops * n * n_rhs * P


def reduced_step_work(n: int, ns: int, nflux: int, Dz: int, P: int,
                      n_rhs: int, size: int,
                      interior: bool, k: int = 2) -> tuple[int, int]:
    """(bytes, operations) K6 needs for a bucket of n cells and ns spokes a
    patch and P patches: Mc, cumalpha and (interior) the inverse once a
    patch, Fv and sp's nflux rows once a lane, the written rows once
    (interior: the Dz - 1 unit columns' and the ns d0 rows of sp; boundary:
    b_z), the index tables."""
    nkeep = k * (k + 1)
    nu = 2 * (k - 1) + (k - 1) * (k - 2) // 2
    X = n_rhs * P
    per_patch = n * nkeep * nkeep + ns + (Dz * Dz if interior else 0)
    per_lane = n * nkeep + nflux + ((Dz - 1 + ns) if interior else Dz)
    tables = 8 * (n * (nkeep + nu + 1) + Dz - 1)
    # per lane: the residual's multiply-adds, the d0 column, E's ones;
    # interior: the inverse product and the scatter
    ops = n * (2 * nkeep * nkeep + 4 + nu)
    if interior:
        ops += 2 * Dz * Dz + 2 * ns + Dz - 1
    return (per_patch * P + per_lane * X) * size + tables, ops * X


def phase_load_moments(n: int, device, timer) -> dict:
    """Phase 26: K5, then K6 on its real operands, alone on each chunk of
    the benchmark's semi-explicit engine (RT2, ``unit_square(n)``, chunk
    ``CHUNK``) in f64, the cells' precision, and in f32, the main path's,
    each with one field and with three folded into the lane axis, beside
    their plain einsum versions; then one f64 ``equilibrate``'s launches
    (reset to 0 before it) and the routes its spans record."""
    from dolfinx_eqlb_tpu_torch.eqlb.engine import EqlbEngine
    from dolfinx_eqlb_tpu_torch.eqlb.patches import build_patches
    from dolfinx_eqlb_tpu_torch.fem import FunctionSpace
    from dolfinx_eqlb_tpu_torch.mesh import unit_square
    from dolfinx_eqlb_tpu_torch.ops.load_moments import (
        load_moments, load_moments_plain,
    )
    from dolfinx_eqlb_tpu_torch.utils import profiling

    k = 2
    msh = unit_square(n)
    buckets = build_patches(msh)
    rows, k6_rows = [], []
    for dt, np_dt, tol in ((torch.float32, np.float32, 1e-6),
                           (torch.float64, np.float64, 1e-13)):
        eng = EqlbEngine(FunctionSpace(msh, "RT", k), buckets, dtype=dt,
                         device=device, max_patches_per_bucket=CHUNK)
        dev, refd = eng._device_tables()
        for n_rhs in (1, 3):
            d_proj, d_rhs, fk, bv = make_data(msh, k, n_rhs, seed=26,
                                              np_dtype=np_dt)
            dpT, drT = eng.put_transposed(d_proj, d_rhs)
            dprT = torch.cat([dpT, drT[:, None]], dim=1)
            fkt = torch.as_tensor(fk, device=device)
            bvt = torch.as_tensor(bv, dtype=dt, device=device)
            for key in sorted(eng.buckets):
                dv = dev[key]
                args = (dprT, *(dv[name] for name in (
                    "cells_bl", "combo_bl", "J_bl", "K_bl", "signs_bl",
                    "detJ_bl")), refd["RhatC"], refd["T3C"], refd["hatgC"])
                ncell, P = dv["cells_bl"].shape
                got = load_moments(*args)
                want = load_moments_plain(*args)
                sync(device)
                err = max(float((g - w).abs().max() / w.abs().max())
                          for g, w in zip(got, want))
                del got, want
                nbytes, flops = load_moments_work(
                    k, ncell, P, n_rhs,
                    int(torch.unique(dv["cells_bl"]).numel()),
                    dprT.element_size())
                bound_ms, bound_by = bound(nbytes, flops, dt)
                ms = timer.ms(lambda: load_moments(*args))
                plain_ms = timer.fit(lambda: load_moments_plain(*args))
                rows.append({"key": str(key), "n": ncell, "P": P,
                             "n_rhs": n_rhs, "X": n_rhs * P,
                             "boundary": eng.buckets[key].is_boundary,
                             "dtype": dname(dt), "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by, "of_bound": ms / bound_ms,
                             "max_rel_err": err, "limit": tol,
                             "ok": err <= tol})
                k6_rows.append(reduced_step_row(
                    eng, key, dv, refd, dprT, fkt, bvt, n_rhs, tol, timer))
            del dpT, drT, dprT
        if dt == torch.float64:
            d_proj, d_rhs, fk, bv = make_data(msh, k, 1, seed=26,
                                              np_dtype=np_dt)
            dpT, drT = eng.put_transposed(d_proj, d_rhs)
            fkt = torch.as_tensor(fk, device=device)
            bvt = torch.as_tensor(bv, dtype=dt, device=device)
            reset_launches()
            with profiling.recording() as recs:
                eng.equilibrate(dpT, drT, fkt, bvt, transposed_inputs=True)
                sync(device)
            launches = read_launches()["K5"]
            routes = sorted({str(r.attrs.get("route")) for r in recs
                             if r.name == "se.load_moments"})
            k6_call = {"launches": read_launches()["K6"],
                       "by_epilogue": read_launches(split=True)["K6"],
                       "interior_chunks": sum(
                           not b.is_boundary for b in eng.buckets.values()),
                       "rhs_routes": sorted({
                           str(r.attrs.get("route")) for r in recs
                           if r.name == "se.reduced_rhs"}),
                       "solve_routes": [
                           str(r.attrs.get("route")) for r in recs
                           if r.name == "se.reduced_solve"]}
            chunks = len(eng.buckets)
        del eng, dev, refd
        torch.cuda.empty_cache()
    return {"rows": rows, "chunks": chunks, "launches_per_call": launches,
            "routes": routes, "k6_rows": k6_rows, "k6_call": k6_call}


def reduced_step_row(eng, key, dv, refd, dprT, fk, bv, n_rhs, tol,
                     timer) -> dict:
    """K6 on one chunk's own operands (K5's moments and the explicit
    step's sp, as ``solve_bucket_semiexplicit`` builds them): the kernel
    against the plain einsum chain (on copies of sp: the interior epilogue
    writes into it), both timed, and the byte bound."""
    from dolfinx_eqlb_tpu_torch.eqlb.semiexplicit import (
        boundary_ess_bl, particular_bl,
    )
    from dolfinx_eqlb_tpu_torch.ops.load_moments import load_moments
    from dolfinx_eqlb_tpu_torch.ops.reduced_step import (
        reduced_step, reduced_step_plain,
    )

    b = eng.buckets[key]
    Fv, Fq = load_moments(dprT, *(dv[name] for name in (
        "cells_bl", "combo_bl", "J_bl", "K_bl", "signs_bl", "detJ_bl")),
        refd["RhatC"], refd["T3C"], refd["hatgC"])
    ess, hv = (boundary_ess_bl(eng, fk, bv, dv, refd) if b.is_boundary
               else (None, None))
    sp = particular_bl(eng, key, Fq, ess, hv, dv)
    tables = (dv["Mc_bl"], dv["patch_idx"], dv["Zunit"], dv["ucols"],
              dv["exit_idx"], dv["cumalpha_bl"], dv["sel"], dv.get("Ainv_bl"))
    got = reduced_step(sp.clone(), Fv, *tables)
    want = reduced_step_plain(sp.clone(), Fv, *tables)
    sync(eng.device)
    err = float((got - want).abs().max() / want.abs().max())
    del got, want, Fq
    Dz = dv["Zunit"].shape[-1]
    P = dv["Mc_bl"].shape[-1]
    nbytes, flops = reduced_step_work(
        b.ncells, b.nspokes, sp.shape[0], Dz, P, n_rhs, sp.element_size(),
        not b.is_boundary)
    bound_ms, bound_by = bound(nbytes, flops, sp.dtype)
    # repeated in place on one sp: only the values move, not the work
    ms = timer.ms(lambda: reduced_step(sp, Fv, *tables))
    plain_ms = timer.fit(lambda: reduced_step_plain(sp, Fv, *tables))
    return {"key": str(key), "n": b.ncells, "P": P, "Dz": Dz,
            "n_rhs": n_rhs, "boundary": b.is_boundary,
            "dtype": dname(sp.dtype), "ms": ms, "plain_ms": plain_ms,
            "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
            "of_bound": ms / bound_ms, "max_rel_err": err, "limit": tol,
            "ok": err <= tol}


def report_load_moments(r: dict, nph: int, failures: list) -> None:
    for row in r["rows"]:
        log(f"[26/{nph}] K5 chunk {row['key']} n={row['n']} P={row['P']} "
            f"n_rhs={row['n_rhs']} "
            f"{'boundary' if row['boundary'] else 'interior'} "
            f"{row['dtype']}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}; {row['of_bound']:.2f}x), rel err "
            f"{row['max_rel_err']:.2e} (limit {row['limit']:.0e})"
            + ("" if row["ok"] else "  FAILED"))
    log(f"[26/{nph}] K5 launches a call {r['launches_per_call']} over "
        f"{r['chunks']} chunks; se.load_moments routes {r['routes']}")
    log("    detail: " + json.dumps(r))
    if not all(row["ok"] for row in r["rows"]):
        failures.append("K5 disagrees with its plain version")
    if r["launches_per_call"] != r["chunks"] or r["routes"] != ["kernel"]:
        failures.append(f"K5 launches {r['launches_per_call']} a call over "
                        f"{r['chunks']} chunks, routes {r['routes']}")
    for row in r["k6_rows"]:
        log(f"[26/{nph}] K6 chunk {row['key']} n={row['n']} P={row['P']} "
            f"Dz={row['Dz']} n_rhs={row['n_rhs']} "
            f"{'boundary' if row['boundary'] else 'interior'} "
            f"{row['dtype']}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}, {row['bytes'] / 1e6:.1f} MB; "
            f"{row['of_bound']:.2f}x), rel err {row['max_rel_err']:.2e} "
            f"(limit {row['limit']:.0e})" + ("" if row["ok"] else "  FAILED"))
    c = r["k6_call"]
    want = {"inverse": c["interior_chunks"],
            "rhs": r["chunks"] - c["interior_chunks"]}
    log(f"[26/{nph}] K6 launches a call {c['launches']} over {r['chunks']} "
        f"chunks, by epilogue {c['by_epilogue']}; se.reduced_rhs routes "
        f"{c['rhs_routes']}, se.reduced_solve routes {c['solve_routes']}")
    if not all(row["ok"] for row in r["k6_rows"]):
        failures.append("K6 disagrees with its plain version")
    if (c["launches"] != r["chunks"] or c["by_epilogue"] != want
            or c["rhs_routes"] != ["kernel"]
            or c["solve_routes"].count("inverse") != c["interior_chunks"]):
        failures.append(f"K6 launches {c['launches']} a call over "
                        f"{r['chunks']} chunks, by epilogue "
                        f"{c['by_epilogue']} (want {want}), routes "
                        f"{c['rhs_routes']} / {c['solve_routes']}")


def phase_bench(n: int, card: str, device) -> dict:
    """Phase 23: ``python -m dolfinx_eqlb_tpu_torch.bench`` in its four
    modes, one process each (``n``, ``n --stress``, ``n --mixed``,
    ``128 3 --biot``), each run checked by ``bench_problems``; then
    ``engine_kernel_checks`` on the ``128 3 --biot`` engine, built here by
    ``bench.setup`` as the bench builds it."""
    from dolfinx_eqlb_tpu_torch import bench

    runs = {}
    for mode, (args, expected) in BENCH_MODES.items():
        argv = BENCH_BIOT_ARGS if args is None else [str(n), *args]
        run = bench_run([sys.executable, "-m", "dolfinx_eqlb_tpu_torch.bench",
                         *argv])
        run["problems"] = bench_problems(run, expected, card, mode == "mixed")
        runs[mode] = run
    b = bench.setup(**BENCH_BIOT, device=device)
    checks = engine_kernel_checks(b.engine, b.call)
    del b
    return {"runs": runs, "biot_kernel_checks": checks}


def report_bench(res: dict, nph: int, failures: list) -> None:
    r = res["runs"]
    keys = ("value", "latency_ms", "latency_median_ms", "pipelined_ms",
            "data_s", "engine_tables_s", "geometry_caches_s", "first_call_s",
            "peak_mem_gib", "divergence_max_err",
            "divergence_max_err_host_f64", "divergence_rel_err",
            "host_check_s")
    for mode, run in r.items():
        last = run["lines"][-1] if run["lines"] else {}
        log(f"[23/{nph}] bench {mode} ({run['cmd']}): exit {run['rc']}, "
            f"{run['seconds']:.1f} s; " + ", ".join(
                f"{key} {last[key]:.6g}" for key in keys
                if isinstance(last.get(key), float))
            + f"; launches per call {last.get('launches')}"
            + (f"  FAILED: {run['problems']}" if run["problems"] else ""))
        for line in run["lines"]:
            log("    " + json.dumps(line))
        if run["problems"]:
            log("    log tail:\n" + run["log_tail"])
            failures.append(f"phase 23 bench {mode}: {run['problems']}")
    kc = res["biot_kernel_checks"]
    ok = all(k["ok"] for k in kc["K1"]) and kc["K2"]["ok"]
    log(f"[23/{nph}] bench biot engine ({' '.join(BENCH_BIOT_ARGS)}), its "
        "operands: K1 " + ", ".join(
            f"{k['dtype']} D={k['D']} R={k['R']} X={k['X']} rel "
            f"{k['max_rel_err']:.1e}" for k in kc["K1"])
        + f"; K2 ndofs={kc['K2']['ndofs']} bitwise {kc['K2']['bitwise']}"
        + ("" if ok else "  FAILED"))
    if not ok:
        failures.append("phase 23 bench biot: K1 or K2 disagrees with its "
                        "plain version on the engine's operands")


def kernel_entry(name, source, replaces, launches, row, errs):
    """One entry of the "kernels" line from a phase row."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(errs), "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms"),
            "dtype": row["dtype"],
            "shape": {key: row[key] for key in ("D", "R", "X", "ndofs", "L")
                      if key in row}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=500,
                    help="crossed unit square with 4 n^2 cells (default 500)")
    ap.add_argument("--profile", action="store_true",
                    help="also print a torch.profiler table of one call")
    ap.add_argument("--k1-sweep", action="store_true",
                    help="only build the kernels and time K1's block-route "
                    "variants beside the tile and global routes")
    ap.add_argument("--phase22", action="store_true",
                    help="only build the kernels and run phase 22 (patch "
                    "sharding and I/O), against its own stress reference")
    ap.add_argument("--phase23", action="store_true",
                    help="only build the kernels and run phase 23 (the "
                    "port's bench in its four modes)")
    ap.add_argument("--phase24", action="store_true",
                    help="only build the kernels, run phase 8's K3 checks "
                    "and timings at the wide route's shapes and phase 24 "
                    "(the RT3 KKT path on the unstructured mesh)")
    ap.add_argument("--phase25", action="store_true",
                    help="only build the kernels, run phase 8's K3 checks "
                    "and timings at the cluster route's shapes and phase "
                    "25 (the RT4 KKT path on the unstructured mesh)")
    ap.add_argument("--phase26", action="store_true",
                    help="only build the kernels and run phase 26 (K5 at "
                    "the benchmark's semi-explicit chunks)")
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
    marks = [("start", time.perf_counter())]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    failures = []
    nph = 26

    card = card_line()
    log(card)
    log(f"[1/{nph}] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")

    _build.library()
    info = _build.build_info()
    log(f"[2/{nph}] nvcc build: {info['seconds']:.2f} s "
        f"({'compiled' if info['built'] else 'cached'}) -> {info['path']}")
    for line in info["log"].splitlines():
        if "Function properties for" in line:
            log(f"    ptxas: {line.split('properties for')[-1].strip()}")
        elif "registers" in line or "spill" in line:
            log(f"    ptxas: {line.strip()}")
    timer = Timer(device)
    if args.k1_sweep:
        rows = phase_k1_sweep(device, timer)
        loops = phase_k1_loop_plans(device)
        print(json.dumps({"k1_sweep": rows, "loops": loops}), flush=True)
        return 0 if all(r["ok"] for r in rows) else 1
    if args.phase22:
        shard = phase_sharding(device, args.n)
        report_sharding(shard, nph, failures)
        for f in failures:
            print(f"chip_smoke: FAILED: {f}", file=sys.stderr)
        return 1 if failures else 0
    if args.phase23:
        report_bench(phase_bench(args.n, card, device), nph, failures)
        for f in failures:
            print(f"chip_smoke: FAILED: {f}", file=sys.stderr)
        return 1 if failures else 0
    if args.phase24:
        log(f"[8/{nph}] K3 (the planned route and the shared route) vs "
            f"plain at {K3_WIDE_SHAPES}:")
        k3, k3_tiles = phase_k3(K3_WIDE_SHAPES, device, timer)
        if not all(r["ok"] for r in k3 + k3_tiles):
            failures.append("K3 disagrees with its plain version")
        torch.cuda.empty_cache()
        report_kkt_unstructured(
            phase_kkt_unstructured(device, unstructured_n(args.n)), nph,
            failures)
        for f in failures:
            print(f"chip_smoke: FAILED: {f}", file=sys.stderr)
        return 1 if failures else 0
    if args.phase25:
        log(f"[8/{nph}] K3 (the planned route and the routes beside it) vs "
            f"plain at {K3_CLUSTER_SHAPES}:")
        k3, k3_tiles = phase_k3(K3_CLUSTER_SHAPES, device, timer)
        if not all(r["ok"] for r in k3 + k3_tiles):
            failures.append("K3 disagrees with its plain version")
        torch.cuda.empty_cache()
        report_kkt_unstructured(
            phase_kkt_unstructured(device, unstructured_n_rt4(args.n), k=4,
                                   chunk=CHUNK_RT4), nph, failures, 25)
        for f in failures:
            print(f"chip_smoke: FAILED: {f}", file=sys.stderr)
        return 1 if failures else 0

    if args.phase26:
        report_load_moments(phase_load_moments(args.n, device, timer), nph,
                            failures)
        for f in failures:
            print(f"chip_smoke: FAILED: {f}", file=sys.stderr)
        return 1 if failures else 0

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
    log(f"[3/{nph}] host precompute: mesh {msh.num_cells} cells "
        f"{t_mesh:.2f} s; patches {npatches} in {len(buckets)} buckets "
        f"{t_patches:.2f} s; engine tables ({len(engine.buckets)} chunks, "
        f"{V.ndofs} dofs) {t_tables:.2f} s; data {t_data:.2f} s; native "
        f"library loaded: {native.available()}")

    shapes = solve_shapes(engine)
    shape_sets = k1_shape_sets(engine, rt3_solve_sizes(device))
    log(f"[4/{nph}] K1 (every route that takes the shape) vs plain at the "
        f"main path's shapes {shapes}, the mixed path's chunk, RT3's, the "
        f"tile split's, the P4/RT4 L-shape's last step and RT4 / RT5 at the "
        f"chunk:")
    k1, k1_edges = phase_k1(shape_sets, device, timer)
    marks.append(("1-4", time.perf_counter()))
    if not all(r["ok"] for r in k1 + k1_edges):
        failures.append("K1 disagrees with its plain version")

    log(f"[5/{nph}] K2 vs plain on the engine's combine tables:")
    k2 = phase_combine("K2", engine._src, engine._nfk, engine._flat_len + 1,
                       (torch.float32, torch.float64), device, timer, seed=1)
    if not all(r["ok"] for r in k2):
        failures.append("K2 is not bitwise equal to its plain version or "
                        "strays from embedding_bag")

    x, main_res = phase_main(engine, data, device, profile=args.profile)
    marks.append(("5-6", time.perf_counter()))
    launches = main_res["launches"]
    log(f"[6/{nph}] main path unit_square({args.n}) RT2 f32 1 field, "
        f"{main_res['patches']} patches: first call "
        f"{main_res['first_call_s']:.3f} s (geometry caches "
        f"{main_res['geometry_caches_s']:.3f} s before it); strict "
        f"{main_res['strict_ms_median']:.3f} ms median "
        f"({main_res['patches_per_s_strict']:.4g} patches/s), pipelined "
        f"{main_res['pipelined_ms_min']:.3f} ms "
        f"({main_res['patches_per_s_pipelined']:.4g} patches/s); launches "
        f"{launches}, K1 by route {main_res['k1_launches_by_route']}; "
        f"interior inverse build {main_res['inverse_build_ms']:.3f} ms "
        f"(by route " + ", ".join(
            f"{rt} {ms:.3f} ms" for rt, ms in
            main_res["inverse_build_ms_by_route"].items()) + "); "
        f"finite {main_res['finite']}; max|x - plain| "
        f"{main_res['max_abs_err_vs_plain']:.3e} (limit "
        f"{main_res['err_limit']:.3e}); host boundary data "
        f"{main_res['input_bytes']} B in {main_res['input_uploads']} uploads "
        f"a call (limit {INPUT_BYTES_LIMIT}), output bitwise "
        f"{main_res['host_bc_bitwise']}; stage graph captures "
        f"{main_res['graph_captures']}, replays {main_res['graph_replays']}")
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
    if not (main_res["graph_captures"] == 1
            and 0 < main_res["graph_replays"] == main_res["calls"] - 1):
        failures.append(
            f"main path: stage graph captures {main_res['graph_captures']}, "
            f"replays {main_res['graph_replays']} over {main_res['calls']} "
            "calls (want 1 and one a call after the first)")
    if main_res["k5_launches_per_call"] != main_res["chunks"]:
        failures.append(f"main path: K5 {main_res['k5_launches_per_call']} "
                        f"a call over {main_res['chunks']} chunks")
    k6_split = {"inverse": main_res["interior_chunks"] * main_res["calls"],
                "rhs": (main_res["chunks"] - main_res["interior_chunks"])
                * main_res["calls"]}
    if (main_res["k6_launches_per_call"] != main_res["chunks"]
            or main_res["k6_launches_by_epilogue"] != k6_split):
        failures.append(f"main path: K6 {main_res['k6_launches_per_call']} "
                        f"a call over {main_res['chunks']} chunks, by "
                        f"epilogue {main_res['k6_launches_by_epilogue']} "
                        f"(want {k6_split})")
    check_k1_routes("main path", main_res["k1_launches_by_route"], shapes,
                    torch.float32, failures)
    if not (main_res["shape_ok"] and main_res["finite"]):
        failures.append("main path output has a wrong shape or non-finite")
    if not main_res["max_abs_err_vs_plain"] <= main_res["err_limit"]:
        failures.append("main path disagrees with the plain route")
    if not (0 < main_res["input_bytes"] <= INPUT_BYTES_LIMIT
            and main_res["input_uploads"] == 2
            and main_res["host_bc_bitwise"]):
        failures.append(
            f"main path: host boundary data {main_res['input_bytes']} B in "
            f"{main_res['input_uploads']} uploads (limit "
            f"{INPUT_BYTES_LIMIT} B in 2), bitwise "
            f"{main_res['host_bc_bitwise']}")
    del x, engine
    torch.cuda.empty_cache()

    par = phase_f64_parity(device)
    marks.append(("7", time.perf_counter()))
    log(f"[7/{nph}] f64 parity unit_square({par['n']}) ({par['cells']} "
        f"cells), card vs CPU: max_abs_err {par['max_abs_err']:.3e} "
        f"(limit {par['limit']:.3e}){'' if par['ok'] else '  FAILED'}")
    if not par["ok"]:
        failures.append("f64 card result disagrees with the CPU")

    t0 = time.perf_counter()
    eng64 = EqlbEngine(V, buckets, dtype=torch.float64, device=device,
                       max_patches_per_bucket=CHUNK)
    t_tables64 = time.perf_counter() - t0
    shapes3 = kkt_shapes(eng64)
    log(f"[8/{nph}] K3 (the planned route and the routes beside it) vs "
        f"plain at the KKT path's shapes {shapes3} (f64 engine tables "
        f"{t_tables64:.2f} s), the wide route's {K3_WIDE_SHAPES} and the "
        f"cluster route's {K3_CLUSTER_SHAPES}:")
    k3, k3_tiles = phase_k3(shapes3 + K3_WIDE_SHAPES + K3_CLUSTER_SHAPES,
                            device, timer)
    marks.append(("8", time.perf_counter()))
    if not all(r["ok"] for r in k3 + k3_tiles):
        failures.append("K3 disagrees with its plain version")
    torch.cuda.empty_cache()

    kkt = phase_kkt(eng64, msh, device)
    marks.append(("9", time.perf_counter()))
    report_kkt(kkt, f"unit_square({args.n}) RT2", shapes3, nph, failures, 9)
    torch.cuda.empty_cache()

    log(f"[10/{nph}] K4 vs plain on the f64 engine's combine tables:")
    k4 = phase_combine("K4", eng64._src, eng64._nfk, eng64._flat_len + 1,
                       (torch.float64,), device, timer, seed=6)
    if not all(r["ok"] for r in k4):
        failures.append("K4 is not bitwise equal to its plain version or "
                        "strays from K2")
    del eng64
    torch.cuda.empty_cache()

    mixed = phase_mixed(V, buckets, msh, device)
    marks.append(("10-11", time.perf_counter()))
    log(f"[11/{nph}] mixed path unit_square({args.n}) RT2 f64 1 field, "
        f"kernel_mixed + ds, {mixed['chunks']} chunks: first call "
        f"{mixed['first_call_s']:.3f} s (geometry caches "
        f"{mixed['geometry_caches_s']:.3f} s); strict "
        f"{mixed['strict_ms_median']:.3f} ms median, pipelined "
        f"{mixed['pipelined_ms_min']:.3f} ms; launches {mixed['launches']}, "
        f"K1 by route {mixed['k1_launches_by_route']}; "
        f"max|x - plain f64| {mixed['max_abs_err_vs_plain_f64']:.3e} (limit "
        f"{mixed['err_limit']:.3e}); native f64 kernel + gather "
        f"{mixed['route_kernel_gather']}; kernel_mixed + gather "
        f"{mixed['route_kernel_mixed_gather']}"
        f"{'' if mixed['ok'] else '  FAILED'}")
    log("    detail: " + json.dumps(mixed))
    if not mixed["ok"]:
        failures.append("mixed path disagrees with the f64 plain route")
    if min(mixed["launches"][kn] for kn in ("K1", "K4", "K5", "K6")) <= 0:
        failures.append(f"mixed path skipped a kernel: {mixed['launches']}")
    # the mixed path runs K1 in f32
    check_k1_routes("mixed path", mixed["k1_launches_by_route"],
                    mixed["k1_shapes"], torch.float32, failures)
    del V, buckets, msh
    torch.cuda.empty_cache()

    api = phase_flux_api(args.n, device)
    marks.append(("12", time.perf_counter()))
    report_flux_api(api, nph, failures)
    torch.cuda.empty_cache()

    lsh = phase_lshape(device, timer)
    marks.append(("13", time.perf_counter()))
    report_lshape(lsh, nph, failures)
    torch.cuda.empty_cache()

    uni = phase_uniform(device)
    marks.append(("14", time.perf_counter()))
    report_uniform(uni, nph, failures)
    torch.cuda.empty_cache()

    msh = unit_square(args.n)
    buckets = build_patches(msh)
    stress = phase_stress(FunctionSpace(msh, "RT", k), buckets, msh, device)
    del buckets, msh
    marks.append(("15", time.perf_counter()))
    report_stress(stress, nph, failures)
    torch.cuda.empty_cache()

    ela = phase_elasticity(args.n, device)
    marks.append(("16", time.perf_counter()))
    report_elasticity(ela, nph, failures)
    torch.cuda.empty_cache()

    skkt = phase_stress_kkt(device)
    marks.append(("17", time.perf_counter()))
    report_stress_kkt(skkt, nph, failures)
    torch.cuda.empty_cache()

    cook = phase_cook(device)
    marks.append(("18", time.perf_counter()))
    report_cook(cook, nph, failures)
    torch.cuda.empty_cache()

    biot = phase_biot_bench(device, timer)
    marks.append(("19", time.perf_counter()))
    report_biot_bench(biot, nph, failures)

    bflow = phase_biot_flow(device)
    marks.append(("20", time.perf_counter()))
    report_biot_flow(bflow, nph, failures)
    torch.cuda.empty_cache()

    mgr = phase_multigrid(device)
    marks.append(("21", time.perf_counter()))
    report_multigrid(mgr, nph, failures)
    torch.cuda.empty_cache()

    shard = phase_sharding(device, args.n)
    marks.append(("22", time.perf_counter()))
    report_sharding(shard, nph, failures)
    torch.cuda.empty_cache()

    bench = phase_bench(args.n, card, device)
    marks.append(("23", time.perf_counter()))
    report_bench(bench, nph, failures)
    torch.cuda.empty_cache()

    ukkt = phase_kkt_unstructured(device, unstructured_n(args.n))
    marks.append(("24", time.perf_counter()))
    report_kkt_unstructured(ukkt, nph, failures)
    torch.cuda.empty_cache()

    rkkt = phase_kkt_unstructured(device, unstructured_n_rt4(args.n), k=4,
                                  chunk=CHUNK_RT4)
    marks.append(("25", time.perf_counter()))
    report_kkt_unstructured(rkkt, nph, failures, 25)
    torch.cuda.empty_cache()

    lm = phase_load_moments(args.n, device, timer)
    marks.append(("26", time.perf_counter()))
    report_load_moments(lm, nph, failures)

    log("seconds by phase (host clock, each to the end of its run): "
        + ", ".join(f"{name} {t - t0:.1f}" for (_, t0), (name, t) in
                    zip(marks, marks[1:])))
    if failures:
        for f in failures:
            print(f"chip_smoke: FAILED: {f}", file=sys.stderr)
        return 1

    paths = {"semiexplicit_f32": launches, "kkt_f64": kkt["float64"]["launches"],
             "kkt_f32": kkt["float32"]["launches"], "mixed_f64": mixed["launches"]}
    # the flux user API's equilibrators, both BC cases summed
    for name in ("SE", "EV"):
        paths[f"flux_api_{name.lower()}_f64"] = {
            kname: sum(r["launches"][name][kname]
                       for r in api["cases"].values())
            for kname in read_launches()}

    for name, r in lsh.items():
        paths["lshape_adaptive_se_f64" if name == "rt3"
              else f"lshape_adaptive_{name}_se_f64"] = r["launches"]
    for name in ("SE", "EV"):
        paths[f"uniform_series_{name.lower()}_f64"] = uni[name]["launches"]
    paths["kellogg_se_f64"] = uni["kellogg"]["launches"]
    # slice 4: weakly symmetric stress
    paths["stress_se_f32"] = stress["launches"]
    paths["elasticity_flow_f64"] = ela["launches"]
    paths["stress_kkt_f64"] = skkt["launches"]
    paths["cook_loop"] = {
        kname: sum(cook[name]["launches"][kname]
                   for name in ("demo", "long", "grouped"))
        for kname in read_launches()}
    # slice 5: multigrid and Biot
    paths["biot_bench_f32"] = biot["flux"]["launches"]
    paths["biot_bench_ws_f32"] = biot["ws"]["launches"]
    paths["biot_flow_f64"] = bflow["launches"]
    # slice 6: patch sharding, every rank's launches summed
    dry_cases = shard["dryrun"]["cases"]
    paths["sharded_dryrun_f64"] = {
        kname: sum(rk["launches"].get(kname, 0) for c in dry_cases.values()
                   for rk in c["ranks"]) for kname in read_launches()}
    paths["sharded_stress_f32"] = {
        kname: sum(rk["launches"][kname]
                   for rk in shard["full_width"]["ranks"])
        for kname in read_launches()}
    # slice 7: the bench's timed calls, one process per mode
    for mode, run in bench["runs"].items():
        paths[f"bench_{mode}"] = bench_launch_totals(run)
    # K3's wide and cluster routes: the RT3 and RT4 KKT paths on the
    # unstructured meshes
    for dt, r in ukkt["paths"].items():
        paths[f"kkt_rt3_unstructured_{dt}"] = r["launches"]
    for dt, r in rkkt["paths"].items():
        paths[f"kkt_rt4_unstructured_{dt}"] = r["launches"]

    def total(kname):
        return sum(p[kname] for p in paths.values())

    def biggest(rows, dtype):
        return max((r for r in rows if r["dtype"] == dtype),
                   key=lambda r: r["D"] * r["D"] * r["X"])

    # K1's numbers are those of the main path's largest shape by its
    # planned route; the block and global routes beside them
    k1_row = biggest([r for r in k1 if r["set"] == "main"], "float32")
    flux_checks = ([kc for r in api["cases"].values()
                    for kc in r["kernel_checks"].values()]
                   + [r["kernel_checks"] for r in lsh.values()]
                   + [stress["kernel_checks"], ela["kernel_checks"],
                      biot["flux"]["kernel_checks"],
                      biot["ws"]["kernel_checks"], bflow["kernel_checks"],
                      bench["biot_kernel_checks"]])
    biot_checks = {"biot_bench_f32": biot["flux"]["kernel_checks"],
                   "biot_bench_ws_f32": biot["ws"]["kernel_checks"],
                   "biot_flow_f64": bflow["kernel_checks"],
                   "bench_biot_128_f32": bench["biot_kernel_checks"]}
    k3_stress_checks = skkt["k3_checks"]
    k3_rt3_checks = [c for r in ukkt["paths"].values()
                     for c in r["k3_checks"]]
    k3_rt4_checks = [c for r in rkkt["paths"].values()
                     for c in r["k3_checks"]]
    k3_stress_errs = [c["max_abs_err"] for c in k3_stress_checks]
    # phase 22 (a), (b): K1 and K2 on rank 0's operands of each dry-run
    # case and of the sharded stress headline
    flux_checks += [c["ranks"][0]["probe"] for c in dry_cases.values()]
    flux_checks.append(shard["full_width"]["kernel_checks"])
    k1_errs = ([r["max_abs_err"] for r in k1]
               + [c["max_abs_err"] for kc in flux_checks for c in kc["K1"]])
    kkt_k2_checks = {
        **{f"kkt_{dt}": r["k2_check"] for dt, r in kkt.items()},
        **{f"kkt_rt3_unstructured_{dt}": r["k2_check"]
           for dt, r in ukkt["paths"].items()},
        **{f"kkt_rt4_unstructured_{dt}": r["k2_check"]
           for dt, r in rkkt["paths"].items()}}
    k2_errs = ([r["max_abs_err"] for r in k2]
               + [kc["K2"]["max_abs_err"] for kc in flux_checks]
               + [c["max_abs_err"] for c in kkt_k2_checks.values()])
    entries = [
        kernel_entry("K1 batched_kkt_solve_bl", K1_SOURCE, K1_REPLACES,
                     total("K1"), k1_row, k1_errs),
        kernel_entry("K2 combine_gather", K2_SOURCE, K2_REPLACES,
                     total("K2"), next(r for r in k2 if r["dtype"] == "float32"),
                     k2_errs),
        kernel_entry("K3 batched_kkt_solve", K3_SOURCE, K3_REPLACES,
                     total("K3"), biggest(k3, "float64"),
                     [r["max_abs_err"] for r in k3] + k3_stress_errs
                     + [c["max_abs_err"] for c in k3_rt3_checks
                        + k3_rt4_checks]),
        kernel_entry("K4 ds_combine_gather", K4_SOURCE, K4_REPLACES,
                     total("K4"), k4[0], [r["max_abs_err"] for r in k4]),
        # K5's numbers are those of its largest f64 one-field chunk (the
        # semi-explicit cells' shape)
        kernel_entry("K5 load_moments", K5_SOURCE, K5_REPLACES, total("K5"),
                     max((r for r in lm["rows"] if r["dtype"] == "float64"
                          and r["n_rhs"] == 1),
                         key=lambda r: r["n"] * r["P"]),
                     [r["max_rel_err"] for r in lm["rows"]]),
        # K6's likewise: its largest f64 one-field interior chunk
        kernel_entry("K6 reduced_step", K6_SOURCE, K6_REPLACES, total("K6"),
                     max((r for r in lm["k6_rows"] if r["dtype"] == "float64"
                          and r["n_rhs"] == 1 and not r["boundary"]),
                         key=lambda r: r["n"] * r["P"]),
                     [r["max_rel_err"] for r in lm["k6_rows"]]),
    ]
    for entry in entries:
        entry["launches_by_path"] = {
            name: p[entry["name"][:2]] for name, p in paths.items()}
    def k1_err(route):
        return max(r[f"{route}_max_abs_err"] for r in k1
                   if route in r["routes"])

    entries[0].update(
        k1_route=k1_row["route"], block_ms=k1_row["block_ms"],
        block_max_abs_err=k1_err("block"), global_ms=k1_row["global_ms"],
        global_max_abs_err=k1_err("global"),
        rt4_shapes=[{key: r.get(key) for key in (
            "dtype", "D", "R", "X", "route", "tile_ms", "block_ms",
            "global_ms", "plain_ms", "library_ms", "bound_ms")}
            for r in k1 if r["set"] in ("rt4", "large")],
        launches_by_route={
            "semiexplicit_f32": main_res["k1_launches_by_route"],
            "mixed_f64": mixed["k1_launches_by_route"],
            **{f"flux_api_{name.lower()}_f64_{bc}":
               r["k1_launches_by_route"][name]
               for bc, r in api["cases"].items() for name in ("SE", "EV")},
            **{"lshape_adaptive_se_f64" if name == "rt3"
               else f"lshape_adaptive_{name}_se_f64":
               r["k1_launches_by_route"] for name, r in lsh.items()},
            **{f"uniform_series_{name.lower()}_f64":
               uni[name]["k1_launches_by_route"] for name in ("SE", "EV")},
            "kellogg_se_f64": uni["kellogg"]["k1_launches_by_route"],
            "stress_se_f32": stress["k1_launches_by_route"],
            "elasticity_flow_f64": ela["k1_launches_by_route"],
            "cook_loop_demo": cook["demo"]["k1_launches_by_route"],
            "biot_bench_f32": biot["flux"]["k1_launches_by_route"],
            "biot_bench_ws_f32": biot["ws"]["k1_launches_by_route"],
            "biot_flow_f64": bflow["k1_launches_by_route"],
            **{f"sharded_stress_f32_rank{rk['rank']}":
               rk["k1_launches_by_route"]
               for rk in shard["full_width"]["ranks"]},
            **{f"bench_{mode}_per_call": run["lines"][-1]["launches"]["K1"]
               for mode, run in bench["runs"].items()}},
        lshape_last_step_shapes=[
            {key: c[key] for key in ("D", "R", "X", "route", "ms",
                                     "plain_ms", "library_ms", "bound_ms",
                                     "bound_by", "max_abs_err")}
            for r in lsh.values() for c in r["kernel_checks"]["K1"]],
        biot_operands={
            name: [{key: c[key] for key in ("dtype", "D", "R", "X", "route",
                                            "max_rel_err")}
                   for c in kc["K1"]] for name, kc in biot_checks.items()})
    entries[1]["biot_operands"] = {
        name: {key: kc["K2"][key] for key in ("dtype", "ndofs", "bitwise")}
        for name, kc in biot_checks.items()}
    entries[1]["kkt_operands"] = {
        name: {key: c[key] for key in ("dtype", "ndofs", "L", "bitwise")}
        for name, c in kkt_k2_checks.items()}
    # K3's numbers are those of its largest f64 shape (D = 105 at
    # X = 131072, on the wide route); the routes timed beside it, and every
    # timed shape with the routes beside it (the cluster route's among
    # them)
    k3_row = biggest(k3, "float64")
    entries[4].pop("max_abs_err")
    entries[4].update(
        max_rel_err={dt: max(r["max_rel_err"] for r in lm["rows"]
                             if r["dtype"] == dt)
                     for dt in ("float32", "float64")},
        launches_per_call={"semiexplicit_f32":
                           main_res["k5_launches_per_call"],
                           "phase26_f64": lm["launches_per_call"]},
        chunks=lm["rows"])
    entries[5].pop("max_abs_err")
    entries[5].update(
        max_rel_err={dt: max(r["max_rel_err"] for r in lm["k6_rows"]
                             if r["dtype"] == dt)
                     for dt in ("float32", "float64")},
        launches_per_call={"semiexplicit_f32":
                           main_res["k6_launches_per_call"],
                           "phase26_f64": lm["k6_call"]["launches"]},
        launches_by_epilogue={"semiexplicit_f32":
                              main_res["k6_launches_by_epilogue"],
                              "phase26_f64": lm["k6_call"]["by_epilogue"]},
        chunks=lm["k6_rows"])
    entries[2].update(
        k3_route=k3_row["route"], cluster_source=K3_CLUSTER_SOURCE,
        beside={a: k3_row[f"{a}_ms"] for a in k3_row["beside"]},
        shared_max_abs_err=max(r["shared_max_abs_err"] for r in k3
                               if "shared" in r["beside"]),
        launches_by_route={
            **{name: kkt[dt]["k3_launches_by_route"]
               for name, dt in (("kkt_f64", "float64"),
                                ("kkt_f32", "float32"))},
            **{f"kkt_rt3_unstructured_{dt}": r["k3_launches_by_route"]
               for dt, r in ukkt["paths"].items()},
            **{f"kkt_rt4_unstructured_{dt}": r["k3_launches_by_route"]
               for dt, r in rkkt["paths"].items()},
            "stress_kkt_f64": skkt["k3_launches_by_route"]},
        stress_operands=[{key: c[key] for key in (
            "D", "R", "X", "route", "max_rel_err")}
            for c in k3_stress_checks],
        **{f"{name}_unstructured_operands": [{key: c[key] for key in (
            "dtype", "D", "R", "X", "route", "max_rel_err",
            "linalg_max_rel_err") if key in c} for c in checks]
           for name, checks in (("rt3", k3_rt3_checks),
                                ("rt4", k3_rt4_checks))},
        shapes=[{key: r[key] for key in (
            "dtype", "D", "R", "X", "route", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "max_rel_err",
            "linalg_max_rel_err", *(f"{a}_ms" for a in r["beside"]))
            if key in r} for r in k3])
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
