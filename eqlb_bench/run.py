"""One run of one cell of the port's benchmark.

    python -m eqlb_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the directory that holds ``BENCHMARK.json``.  Set-up loads the
cell's mesh, sets up the program (host tables, engine, geometry caches),
draws the load cases from the seed on the card and warms up the cell's
calls; ``setup_s`` leaves out the benchmark's own steps (the mesh, the
reference's topology, the load cases).  The window then drives
``EqlbEngine.equilibrate`` with the cell's traffic for ``--seconds``
seconds, and at least one call a load case: groups of ``in_flight``
calls, the load cases in turn, a sync closing each group (after each call
when ``in_flight`` is 1).  Once the window has closed and the peak memory
is read, the program is freed and the plain reference (``reference/``)
solves every load case; the last output of each load case in the window
is held to it (``check.py``).

The last line on stdout is one JSON object: ``correct``, ``attempted``
(calls in the window), ``failed`` (load cases outside the limit),
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics and ``breakdown``), ``device`` and, last, ``compared``:
each number compared with its limit, which are also the last lines on
stderr.  Without a card the run prints no result and exits non-zero.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """``time.perf_counter()`` at this process's start (Linux ``/proc``);
    the time of this import where that cannot be read."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_PROCESS = _process_start()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import cells, check, meshes, tracing  # noqa: E402
from .data import make_data  # noqa: E402
from .device import device_line  # noqa: E402
from .program import DTYPES, Program, sync  # noqa: E402
from .reference.kkt import Reference  # noqa: E402
from .reference.topology import Topology  # noqa: E402
from .roofline import solve_work  # noqa: E402

CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_cache")
# top-level module names that may not be loaded in a run (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "dolfinx_eqlb_tpu")


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T_PROCESS:8.2f}s] {msg}", file=sys.stderr,
          flush=True)


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def make_mesh(config: dict):
    """The configuration's mesh as (points, cells), as an analyst loads it:
    generated once into the checkout's mesh cache (``_cache/``, a fixed
    path beside this file), read from there by every later run."""
    name = f"{config['mesh']}-{config['mesh_n']}-{config['mesh_seed']}.npz"
    path = os.path.join(CACHE, name)
    if os.path.exists(path):
        with np.load(path) as f:
            return f["points"], f["cells"]
    gen = meshes.GENERATORS[config["mesh"]]
    if config["mesh"] == "unstructured":
        points, cells_ = gen(config["mesh_n"], config["mesh_seed"])
    else:
        points, cells_ = gen(config["mesh_n"])
    os.makedirs(CACHE, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, points=points, cells=cells_)
    os.replace(tmp, path)
    return points, cells_


class Window:
    """The timed calls of a run: groups of ``in_flight`` calls, the load
    cases in turn, a sync closing each group (and each call when
    ``in_flight`` is 1).  Keeps the last output of each load case."""

    def __init__(self, program, d_proj, d_rhs, traffic: dict, device):
        self.program, self.dp, self.dr = program, d_proj, d_rhs
        self.in_flight = traffic["in_flight"]
        self.device = device
        self.kept = [None] * d_proj.shape[0]
        self.calls = 0
        self.latency_s: list[float] = []  # per call, in_flight == 1 only
        self.dispatch_s: list[float] = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def group(self, record: bool = True, host=None) -> int:
        """One group of calls; ``record``: keep their latencies and
        dispatch times; ``host``: a ``tracing.HostSpans`` to record the
        ``dispatch`` and ``sync`` spans in."""
        L = len(self.kept)
        span = host.span if host is not None else (lambda name: nullcontext())
        for _ in range(self.in_flight):
            i = self.calls % L
            t0 = time.perf_counter()
            with span("dispatch"):
                out = self.program(self.dp[i:i + 1], self.dr[i:i + 1])
            t1 = time.perf_counter()
            self.kept[i] = out
            self.calls += 1
            if self.in_flight == 1:
                with span("sync"):
                    self._sync()
                if record:
                    self.latency_s.append(time.perf_counter() - t0)
            if record:
                self.dispatch_s.append(t1 - t0)
        if self.in_flight > 1:
            with span("sync"):
                self._sync()
        return self.in_flight

    def traced(self, groups: int) -> tracing.Stretch | None:
        """``groups`` groups under the profiler (the device's activity
        only), reduced to a ``tracing.Stretch``."""
        act = (torch.profiler.ProfilerActivity.CUDA if self.device.type == "cuda"
               else torch.profiler.ProfilerActivity.CPU)
        host, calls = tracing.HostSpans(), 0
        with torch.profiler.profile(activities=[act]) as prof:
            w0 = time.time_ns()
            for _ in range(groups):
                calls += self.group(record=False, host=host)
            w1 = time.time_ns()
        events = prof.profiler.kineto_results.events()
        dev = [e for e in events if tracing.on_device(e)]
        if dev:  # the profiler's clock against the host spans'
            first = (min(e.start_ns() for e in dev) - w0) / 1e6
            last = (w1 - max(e.end_ns() for e in dev)) / 1e6
            log(f"trace: {len(dev)} device events, the first {first:.3f} ms "
                f"after the stretch opens, the last {last:.3f} ms before it "
                "closes")
        return tracing.reduce(events, w0, w1, host, calls)


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool,
             device) -> tuple[dict, dict]:
    """Set up, time and check one run of ``cell``; returns the result line
    (without ``compared``) and ``compared``."""
    device = torch.device(device)
    config, traffic = cell.config, cell.traffic
    k = config["degree"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"cell {cell.name}, seed {seed}, {seconds} s, trace {int(trace)}")

    # set-up: the program's steps, and the benchmark's own (the mesh, the
    # reference's topology, the load cases), which setup_s leaves out
    t0 = time.perf_counter()
    points, cells_ = make_mesh(config)
    mesh_s = time.perf_counter() - t0
    program = Program(config, points, cells_, device)
    log(f"mesh {len(cells_)} cells ({mesh_s:.2f} s); host tables "
        f"{program.host_tables_s:.2f} s, geometry caches "
        f"{program.geometry_caches_s:.2f} s")
    t0 = time.perf_counter()
    topo = Topology(cells_, len(points))
    d_proj, d_rhs = make_data(points, topo, k, traffic["load_cases"], seed,
                              device)
    sync(device)
    data_s = time.perf_counter() - t0
    log(f"{traffic['load_cases']} load cases ({data_s:.2f} s)")
    window = Window(program, d_proj, d_rhs, traffic, device)
    for _ in range(traffic["warmup_groups"]):
        window.group(record=False)
    window.calls, window.kept = 0, [None] * traffic["load_cases"]
    setup_s = time.perf_counter() - T_PROCESS - mesh_s - data_s
    log(f"set-up {setup_s:.2f} s (the benchmark's own "
        f"{mesh_s + data_s:.2f} s left out)")

    # a traced run profiles ``trace_groups`` groups half way through
    stretch, to_trace = None, trace
    t_start = time.perf_counter()
    L = traffic["load_cases"]
    while time.perf_counter() - t_start < seconds or window.calls < L:
        if to_trace and time.perf_counter() - t_start >= seconds / 2:
            stretch, to_trace = window.traced(traffic["trace_groups"]), False
            continue
        window.group()
    window_s = time.perf_counter() - t_start
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    card = device_line(device)
    log(f"window {window_s:.3f} s, {window.calls} calls, peak "
        f"{peak / 2**30:.3f} GiB; device {card}")

    # the check: the program freed, the reference on the same data
    outputs = torch.cat(window.kept)
    facet_vertices = program.facet_vertices()
    host_tables_s = program.host_tables_s
    geometry_caches_s = program.geometry_caches_s
    calls, latency_s, dispatch_s = (window.calls, window.latency_s,
                                    window.dispatch_s)
    del program, window
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = Reference(points, cells_, k, topo=topo)
    x_ref = ref.solve(d_proj, d_rhs)
    errs = check.row_errors(outputs, facet_vertices, ref, x_ref)
    limit = config["limits"]["max_rel_err"]
    err = max(errs)
    failed = sum(1 for e in errs if not e <= limit)
    log(f"reference {time.perf_counter() - t0:.2f} s; max_rel_err {err!r} "
        f"(limit {limit!r}), load cases outside it {failed}")

    dtype = DTYPES[config["dtype"]]
    sizes = ref.patch_sizes()
    ctx = SimpleNamespace(
        config=config, traffic=traffic, dtype=dtype, setup_s=setup_s,
        host_tables_s=host_tables_s, geometry_caches_s=geometry_caches_s,
        window_s=window_s, calls=calls, latency_s=latency_s,
        dispatch_s=dispatch_s, peak_bytes=peak, stretch=stretch,
        work={fam: solve_work(sizes, k, fam, dtype)
              for fam in ("kkt", "reduced")})
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.read(ctx)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak), "card": card}
    result = {"correct": failed == 0, "attempted": ctx.calls,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and ctx.stretch is not None:
        dev["busy_s"] = ctx.stretch.busy_s
        dev["window_s"] = ctx.stretch.window_s
        result["breakdown"] = ctx.stretch.breakdown()
    compared = {"max_rel_err": {"value": err, "limit": limit}}
    return result, compared


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.find(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"no result: the cell needs {cell.chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, compared = run_cell(cell, args.seed, args.seconds,
                                bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"no result: modules loaded that the benchmark may not load: "
              f"{bad}", file=sys.stderr)
        return 3
    for name, c in compared.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr,
              flush=True)
    result["compared"] = compared
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
