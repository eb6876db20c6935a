"""The port's bench: ``bench.py``'s headline and its ``--stress``,
``--mixed`` and ``--biot`` modes, on the port's engine.

    python -m dolfinx_eqlb_tpu_torch.bench [n] [n_fields] [--stress]
        [--mixed] [--biot] [--device cpu]

(``python bench_torch.py ...`` from the repository root is the same.)
Counterpart of the JAX package's ``bench.py``: one equilibration of the
crossed ``unit_square(n)`` (4 n^2 cells; n = 500 is the 1M-cell headline)
at RT2, all patches batched, semi-explicit, timed strict (a sync after
every call) and pipelined (8 calls in flight, the minimum of 3 rounds),
printed as two JSON lines, strict first, with ``bench.py``'s metric
strings and keys.  The modes:

* default: one field of random DG data, f32, chunk 131072 (K1, K2);
* ``--stress``: at least two f32 rows with the weak-symmetry correction
  (K1, K2, pivoted ``torch.linalg.solve``);
* ``--mixed``: f64 curl-field data (sigma = curl z for a random P_k
  function z, f = 0, which meets the divergence invariant exactly),
  ``solver="kernel_mixed"`` (K1 in f32 plus an f64 correction) and
  ``combine="ds"`` (K4), chunk 65536; the divergence residual is checked
  on the device and again in f64 on the CPU by the port's own checker;
* ``--biot``: the three fields of a Biot poro-elasticity solve
  (``models.biot.biot_bench_fields``, block-multigrid MINRES) on
  ``mesh_hierarchy(unit_square(16), nlevels)``, n rounded to a
  power-of-two multiple of 16.

Every boundary facet is of kind 1 (primal Dirichlet) with zero data.

What differs from ``bench.py``:

* ``vs_baseline`` is null: its base was a target set for a TPU;
* ``latency_ms`` is, as there, the minimum of the strict calls;
  ``latency_median_ms`` and ``latency_samples_ms`` give their spread;
* both lines carry ``device`` (``nvidia-smi``'s name and power limit),
  ``data_s``, ``engine_tables_s``, ``geometry_caches_s``,
  ``first_call_s``, ``peak_mem_gib`` over the line's calls and
  ``launches``: each kernel's launches per call of the line (K1 by route,
  K2, K3, K4) and the engine's pivoted solves per call;
* the ``--mixed`` re-check in f64 runs in this process on the CPU (the
  reference needed a subprocess to reach its CPU backend), and its
  failure fails the run;
* left out: the backend probe and warm-up thread and the compile cache
  (they guarded a remote TPU backend); ``EQLB_BENCH_CHUNK``; and
  ``EQLB_BIOT_PREP_CPU``, which moved the Biot data solve to the CPU: a
  fallback that would hide a failure of the device path.

There is no fallback: without a card and without ``--device cpu`` the
run fails, and every failure prints one JSON line with ``"value": 0.0``
and ``"error"`` and exits non-zero.  Nothing here imports jax.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from types import SimpleNamespace

import numpy as np
import torch

from .elements.quadrature import gauss_triangle
from .eqlb.checks import check_divergence_condition, reconstructed_flux_expr
from .eqlb.engine import EqlbEngine
from .eqlb.equilibrators import _dg_dofs
from .eqlb.patches import build_patches
from .fem import Function, FunctionSpace, grad, local_projection
from .fem.multigrid import mesh_hierarchy
from .fem.spaces import resolve_device
from .mesh import unit_square
from .models.biot import biot_bench_fields
from .ops.lane_select import combine_gather, ds_combine_gather
from .ops.patch_solve import batched_kkt_solve, batched_kkt_solve_bl

__all__ = ["main", "setup", "cli", "CHUNK", "CHUNK_MIXED"]

# max_patches_per_bucket: bench.py's chunk; f64 (--mixed) halves it
CHUNK = 131072
CHUNK_MIXED = 65536
METRIC = "RT2 flux equilibration throughput"

_t_start = time.perf_counter()


def log(msg):
    print(f"[{time.perf_counter() - _t_start:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def emit(payload):
    print(json.dumps(payload), flush=True)


def fail(stage, detail, metric=METRIC) -> int:
    """One parseable JSON line on stdout for a failed run; returns the exit
    code."""
    log(f"FAILED at {stage}: {detail}")
    emit({"metric": metric, "value": 0.0, "unit": "patches/s",
          "vs_baseline": None, "error": f"{stage}: {detail}"})
    return 3


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, the
    card picked by its UUID (torch's index counts only the visible cards);
    "cpu" on the CPU."""
    if device.type != "cuda":
        return "cpu"
    uuid = str(torch.cuda.get_device_properties(device).uuid)
    if not uuid.startswith("GPU-"):
        uuid = f"GPU-{uuid}"
    res = subprocess.run(
        ["nvidia-smi", "-i", uuid, "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip()


def _make_data(msh, k, n_fields, stress, biot, dtype, mg_meshes=None,
               device=None):
    """Per-cell dof data for the bench (NumPy, ``dtype``), as
    ``bench.py``'s ``_make_data`` draws it: random DG dofs
    (``default_rng(0)``); for f64 (``--mixed``) curl-field data drawn row
    by row and projected on ``device``; with ``biot`` the three Biot
    fields, solved on ``device`` by block-multigrid MINRES when
    ``mg_meshes`` (the hierarchy whose finest mesh is ``msh``) is given.
    Returns (d_proj, d_rhs, facet_kind, bvals, n_fields)."""
    ndg = k * (k + 1) // 2
    nc = msh.num_cells
    nf = max(n_fields, 2) if stress else n_fields
    if biot:
        # f32 caps the attainable MINRES residual; the bench needs coupled
        # physical fields, not f64-grade dofs
        f64 = dtype == np.float64
        mg = mg_meshes is not None
        d_proj, d_rhs = biot_bench_fields(
            msh, k, rtol=1e-10 if f64 else (1e-6 if mg else 1e-4),
            dtype=torch.float64 if f64 else torch.float32,
            chunk=25 if mg else 100,
            maxiter=20000 if f64 else (400 if mg else 1000),
            mg_meshes=mg_meshes, device=device)
        d_proj, d_rhs = d_proj.cpu().numpy(), d_rhs.cpu().numpy()
        nf = d_proj.shape[0]
    elif dtype == np.float64:
        # the divergence invariant needs hat-compatible data: random dofs
        # violate it whatever the solver; sigma = curl z of a C0 P_k
        # function z with f = 0 meets it exactly at the same op counts
        rng = np.random.default_rng(0)
        Vp = FunctionSpace(msh, "P", k)
        Vf = FunctionSpace(msh, "DG", k - 1, vs=2)
        rows = []
        for _ in range(nf):
            z = Function(Vp, rng.normal(size=Vp.ndofs), device=device)
            d = _dg_dofs(local_projection(Vf, [grad(z)])[0], ndg)
            rows.append(torch.stack([d[:, 1], -d[:, 0]], dim=1).cpu().numpy())
        d_proj = np.stack(rows)
        d_rhs = np.zeros((nf, nc, ndg))
    else:
        rng = np.random.default_rng(0)
        d_proj = rng.normal(size=(nf, nc, 2, ndg))
        d_rhs = rng.normal(size=(nf, nc, ndg))
    facet_kind = (np.where(msh.is_boundary_facet, 1, 0).astype(np.int8)[None]
                  .repeat(nf, 0))
    bvals = np.zeros((nf, msh.num_facets, k))
    return (d_proj.astype(dtype), d_rhs.astype(dtype), facet_kind,
            bvals.astype(dtype), nf)


def _divergence_check(msh, k, x, d_proj0, d_rhs0, device):
    """max |div sigma_R - Pi f| of the flux dofs ``x`` (one row) against
    their data, in f64 on ``device`` by ``eqlb.checks``, and the field's
    inverse-estimate magnitude max|sigma_R| / h_min.

    With curl-field data (f = 0) the residual is pure cancellation whose
    terms carry the divergence operator's 1/detJ ~ 2 n^2 amplification:
    dofs that differ from an all-f64 solve only by summation order put the
    absolute residual near 1e-7 at 1M cells.  ``err / scale`` is the
    accuracy number comparable across mesh sizes."""
    f64 = torch.float64
    sig = Function(FunctionSpace(msh, "RT", k), x.detach().to(device, f64))
    ps = Function(FunctionSpace(msh, "DG", k - 1, vs=2), torch.as_tensor(
        d_proj0.transpose(1, 0, 2).reshape(-1), dtype=f64, device=device))
    pf = Function(FunctionSpace(msh, "DG", k - 1), torch.as_tensor(
        d_rhs0.reshape(-1), dtype=f64, device=device))
    err = check_divergence_condition(sig, ps, pf, return_error=True)
    pts, _ = gauss_triangle(2 * k + 2)
    vmax = float(reconstructed_flux_expr(sig, ps).evaluate(pts).abs().max())
    h_min = float(np.sqrt(2.0 * np.min(np.abs(np.asarray(msh.detJ)))))
    return float(err), vmax / h_min


def _counts(engine) -> dict:
    return {"K1": dict(batched_kkt_solve_bl.launches_by_route),
            "K2": combine_gather.launches, "K3": batched_kkt_solve.launches,
            "K4": ds_combine_gather.launches,
            "pivoted_solves": engine.pivoted_solves}


def _timed(call, engine, device, rounds, per_round):
    """``rounds`` rounds of ``per_round`` calls in flight, a sync closing
    each round (host clock): the last output, ms per call of each round,
    launches per call (K1 by route, K2, K3, K4, pivoted solves) and the peak
    device memory in GiB (None on the CPU)."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = _counts(engine)
    samples = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(per_round):
            x = call()
        _sync(device)
        samples.append((time.perf_counter() - t0) * 1e3 / per_round)
    after = _counts(engine)
    calls = rounds * per_round
    launches = {"K1": {rt: (n - before["K1"][rt]) / calls
                       for rt, n in after["K1"].items()}}
    for name in ("K2", "K3", "K4", "pivoted_solves"):
        launches[name] = (after[name] - before[name]) / calls
    peak = (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else None)
    return x, samples, launches, peak


def setup(n=500, k=2, n_fields=1, stress=False, mixed=False, biot=False,
          device=None):
    """The bench's mesh, data and engine, uploaded once, as ``main`` times
    them (``device`` resolved).  Returns a namespace: ``msh``,
    ``npatches``, ``nf``, ``data`` (d_proj, d_rhs, facet_kind, bvals as
    NumPy), ``engine``, ``call`` (one equilibration of the uploaded data)
    and the seconds of ``data_s``, ``engine_tables_s`` and
    ``geometry_caches_s``."""
    device = resolve_device(device, "bench")
    dtype = torch.float64 if mixed else torch.float32
    t0 = time.perf_counter()
    mg_meshes = None
    if biot:
        # the block-multigrid MINRES needs a nested hierarchy: the bench
        # mesh is a red refinement of a crossed base, n rounded to the
        # nearest power-of-two multiple of 16 (500 -> 512, 1,048,576 cells)
        nlevels = max(1, round(np.log2(max(n, 16) / 16))) + 1
        mg_meshes = mesh_hierarchy(unit_square(16), nlevels)
        msh = mg_meshes[-1]
    else:
        msh = unit_square(n)
    log(f"mesh: {msh.num_cells} cells, {msh.num_vertices} vertices "
        f"({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    buckets = build_patches(msh)
    npatches = sum(b.npatches for b in buckets.values())
    log(f"patches: {npatches} in {len(buckets)} buckets "
        f"({time.perf_counter() - t0:.1f}s)")

    np_dt = np.float64 if mixed else np.float32
    t0 = time.perf_counter()
    d_proj, d_rhs, facet_kind, bvals, nf = _make_data(
        msh, k, n_fields, stress, biot, np_dt, mg_meshes=mg_meshes,
        device=device)
    data_s = time.perf_counter() - t0
    log(f"data: {nf} fields ({data_s:.1f}s)")

    t0 = time.perf_counter()
    engine = EqlbEngine(FunctionSpace(msh, "RT", k), buckets, dtype=dtype,
                        device=device,
                        max_patches_per_bucket=CHUNK_MIXED if mixed else CHUNK)
    if mixed:
        engine.solver, engine.combine = "kernel_mixed", "ds"
    engine_tables_s = time.perf_counter() - t0
    log(f"engine tables ({engine_tables_s:.1f}s, solver={engine.solver}, "
        f"combine={engine.combine})")
    dpT, drT = engine.put_transposed(d_proj, d_rhs)
    fk = torch.as_tensor(facet_kind, device=device)
    bv = torch.as_tensor(bvals, dtype=dtype, device=device)
    t0 = time.perf_counter()
    engine._device_tables()
    if stress:
        engine.ensure_stress_caches()
    _sync(device)
    geometry_caches_s = time.perf_counter() - t0

    def call():
        return engine.equilibrate(dpT, drT, fk, bv, transposed_inputs=True,
                                  weak_symmetry=stress)

    return SimpleNamespace(
        msh=msh, npatches=npatches, nf=nf,
        data=(d_proj, d_rhs, facet_kind, bvals), engine=engine, call=call,
        data_s=data_s, engine_tables_s=engine_tables_s,
        geometry_caches_s=geometry_caches_s)


def main(n=500, k=2, repeats=5, n_fields=1, stress=False, mixed=False,
         biot=False, device=None):
    """Run the bench, print its two JSON lines (strict, then pipelined)
    and return ``{"lines": [strict, pipelined], "x": the last call's
    output, "data": (d_proj, d_rhs, facet_kind, bvals)}``.

    ``n_fields > 1`` equilibrates several fields at once through the
    shared patch factorisations; ``stress`` runs the weakly symmetric
    stress configuration; ``mixed`` f64 data through the mixed-precision
    solver with the divergence residual; ``biot`` the three physical
    fields of a Biot solve.  f32, f64 under ``mixed``, as in ``bench.py``.
    ``device``: the CUDA card by default (raises without one); ``"cpu"``
    runs the kernels' plain versions."""
    device = resolve_device(device, "bench")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = device_line(device)
    log(f"device: {card}")
    b = setup(n, k, n_fields, stress, mixed, biot, device)
    msh, npatches, nf, engine, call = (b.msh, b.npatches, b.nf, b.engine,
                                       b.call)
    d_proj, d_rhs = b.data[:2]

    t0 = time.perf_counter()
    x = call()
    if torch.isnan(x[:, ::1000]).any():
        raise RuntimeError("NaN in the equilibrated flux")
    first_call_s = time.perf_counter() - t0
    log(f"first call: {first_call_s:.2f}s (geometry caches "
        f"{b.geometry_caches_s:.2f}s before it)")
    for _ in range(2):
        call()
    _sync(device)

    x, strict, strict_launches, strict_peak = _timed(
        call, engine, device, repeats, 1)
    lat = min(strict)
    log(f"steady state (per-call sync): {lat:.2f} ms min, "
        f"{np.median(strict):.2f} ms median")

    field_tag = f", {nf} fields" if nf > 1 else ""
    if stress:
        field_tag = ", weakly-symmetric stress"
    if biot:
        field_tag += " (Biot primal data)"
    prec_tag = "f64 mixed-precision" if mixed else "f32"
    metric = (f"RT{k} flux equilibration throughput, "
              f"{msh.num_cells}-cell mesh, single chip, {prec_tag}{field_tag}")

    extras = {"device": card, "data_s": b.data_s,
              "engine_tables_s": b.engine_tables_s,
              "geometry_caches_s": b.geometry_caches_s,
              "first_call_s": first_call_s}
    if mixed:
        err, _ = _divergence_check(msh, k, x[0], d_proj[0], d_rhs[0], device)
        extras["divergence_max_err"] = err
        log(f"divergence residual (f64 on {device}): {err:.3e}")
        t0 = time.perf_counter()
        host_err, scale = _divergence_check(msh, k, x[0], d_proj[0],
                                            d_rhs[0], torch.device("cpu"))
        extras["host_check_s"] = time.perf_counter() - t0
        extras["divergence_max_err_host_f64"] = host_err
        extras["divergence_rel_err"] = host_err / scale
        log(f"divergence residual (f64 CPU re-check, "
            f"{extras['host_check_s']:.1f}s): {host_err:.3e} absolute, "
            f"{host_err / scale:.3e} relative to max|sigma|/h_min = "
            f"{scale:.3e}")

    latency = {"latency_ms": lat,
               "latency_median_ms": float(np.median(strict)),
               "latency_samples_ms": strict}
    strict_line = {
        "metric": metric + " [strict latency]",
        "value": npatches / (lat / 1e3),
        "unit": "patches/s",
        "vs_baseline": None,
        **latency,
        **extras,
        "peak_mem_gib": strict_peak,
        "launches": strict_launches,
    }
    emit(strict_line)

    nchain = 8
    x, piped, piped_launches, piped_peak = _timed(call, engine, device, 3,
                                                  nchain)
    dt = min(piped)
    log(f"steady state (pipelined x{nchain}): {dt:.2f} ms per equilibrate "
        f"({npatches / dt / 1e3:.2f} M patches/s)")
    piped_line = {
        "metric": metric,
        "value": npatches / (dt / 1e3),
        "unit": "patches/s",
        "vs_baseline": None,
        **latency,
        "pipelined_ms": dt,
        "pipelined_samples_ms": piped,
        **extras,
        "peak_mem_gib": piped_peak,
        "launches": piped_launches,
    }
    emit(piped_line)
    return {"lines": [strict_line, piped_line], "x": x, "data": b.data}


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=500,
                    help="crossed unit square with 4 n^2 cells (default 500)")
    ap.add_argument("n_fields", type=int, nargs="?", default=1)
    ap.add_argument("--stress", action="store_true")
    ap.add_argument("--mixed", action="store_true")
    ap.add_argument("--biot", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    try:
        main(n=args.n, n_fields=args.n_fields, stress=args.stress,
             mixed=args.mixed, biot=args.biot, device=args.device)
    except Exception as e:  # noqa: BLE001 - the caller needs the JSON line
        traceback.print_exc(file=sys.stderr)
        return fail("run", f"{type(e).__name__}: {e}")
    return 0


if __name__ == "__main__":
    sys.exit(cli())
