"""A traced stretch credited to the program's spans, on the card:

    python -m eqlb_bench.spans --workload <cell> --seed <n> \\
        [--groups 8] [--pairs 4]

In one process the cell is set up as a run sets it up (the mesh, the
program, the load cases, the warm-up), then:

1. the spans' cost: ``pairs`` pairs of traced stretches of ``groups``
   groups each, recording off and on in turns (off, on, on, off, ...):
   host time a call (window over calls) and ``dispatch`` a call;
2. the credit: one traced stretch with the program's spans recorded
   (``utils.profiling.recording``).  Each device operation is credited to
   the innermost program span open when the runtime call that launched
   it began: the two share a CUPTI correlation id, and the launch's start
   lies on ``time.time_ns``, the spans' clock.  Each idle gap goes to the
   innermost program span open at its midpoint, under the benchmark's
   ``dispatch`` / ``sync`` span: ``dispatch/eqlb.input``.

The last line on stdout is one JSON object: the cost readings, the
stretch's device time by span path (self time; ``[route]`` on a solve
span), the largest operations split by span path, its idle gaps (the
largest, and the sum a call by name), the credited share, the per-layer
readings the spans give (``readings``), and the benchmark's own
``stages_device_ms``, ``device_idle_share`` and
``device_kernels_per_call`` on the same stretch.  The benchmark's runs
never run it: ``run.py`` times the program with recording off.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from types import SimpleNamespace

import torch

from dolfinx_eqlb_tpu_torch.utils import profiling

from . import cells, run, tracing
from .data import make_data
from .device import device_line
from .program import Program, sync
from .reference.topology import Topology


def launch_starts(events) -> dict[int, int]:
    """Correlation id -> host start (ns) of the call that launched each
    device operation among the profiler's ``events`` (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...)."""
    dev = {e.correlation_id() for e in events if tracing.on_device(e)}
    dev.discard(0)
    return {e.correlation_id(): e.start_ns() for e in events
            if not tracing.on_device(e) and e.correlation_id() in dev}


class SpanIndex:
    """The innermost program span open at a time, over records that nest
    (one thread's spans)."""

    def __init__(self, records):
        self.records = sorted(records, key=lambda r: (r.t0_ns, r.span_id))
        self.t0 = [r.t0_ns for r in self.records]
        self.by_id = {r.span_id: r for r in self.records}

    def at(self, t: int):
        """The innermost span with t0 <= t <= t1, or None."""
        i = bisect.bisect_right(self.t0, t) - 1
        while i >= 0:
            r = self.records[i]
            if r.t1_ns >= t:
                return r
            i -= 1
        return None

    def names(self, r) -> list[str]:
        """The names from the root down to ``r``."""
        out = []
        while r is not None:
            out.append(r.name)
            r = self.by_id.get(r.parent_id)
        return out[::-1]

    def path(self, r) -> str:
        """``r``'s path below its root (the root's own name for the root),
        with ``[route]`` on each span that has one."""
        parts = []
        while r is not None:
            route = r.attrs.get("route")
            parts.append(f"{r.name}[{route}]" if route else r.name)
            r = self.by_id.get(r.parent_id)
        parts = parts[::-1]
        return "/".join(parts[1:] if len(parts) > 1 else parts)


@dataclass
class Credit:
    """A stretch of ``calls`` calls credited to the program's spans, in
    seconds: ``device`` (path, names from the root, op name, seconds) per
    device operation, None where no span was open at its launch or the
    launch was not found; ``gaps`` (name, names from the root or [],
    seconds); ``input_s`` each ``eqlb.input`` span's length; ``spans`` the
    program spans seen."""

    calls: int
    spans: int = 0
    device: list = field(default_factory=list)
    gaps: list = field(default_factory=list)
    input_s: list = field(default_factory=list)

    def credited_share(self) -> float:
        total = sum(s for *_, s in self.device)
        done = sum(s for p, *_, s in self.device if p is not None)
        return done / total if total > 0 else 0.0

    def span_device(self, most: int = 10) -> list:
        """The ``most`` span paths with the most self device time."""
        by: dict[str, float] = {}
        for p, _, _, s in self.device:
            if p is not None:
                by[p] = by.get(p, 0.0) + s
        top = sorted(by.items(), key=lambda t: -t[1])[:most]
        return [[p, s] for p, s in top]

    def idle_gaps(self, most: int = 10) -> list:
        top = sorted(self.gaps, key=lambda t: -t[2])[:most]
        return [[n, s] for n, _, s in top]

    def idle_by_name(self) -> dict:
        """Idle time a call (ms) by gap name."""
        by: dict[str, float] = {}
        for n, _, s in self.gaps:
            by[n] = by.get(n, 0.0) + 1e3 * s / self.calls
        return by

    def op_split(self, most: int = 6) -> dict:
        """For the ``most`` device operation names with the most time:
        their time a call (ms) by span path (``none``: not credited)."""
        total: dict[str, float] = {}
        for _, _, op, s in self.device:
            total[op] = total.get(op, 0.0) + s
        out = {}
        for op, _ in sorted(total.items(), key=lambda t: -t[1])[:most]:
            by: dict[str, float] = {}
            for p, _, o, s in self.device:
                if o == op:
                    key = p or "none"
                    by[key] = by.get(key, 0.0) + 1e3 * s / self.calls
            out[op[:120]] = by
        return out

    def device_ms(self, select) -> float | None:
        """Device time a call (ms) of the operations whose span's names
        from the root satisfy ``select``; None where no span was seen."""
        t = sum(s for p, names, _, s in self.device
                if p is not None and select(names))
        return 1e3 * t / self.calls if self.calls and t > 0 else None

    def readings(self) -> dict:
        """The per-layer readings of the spans, ms a call (None: nothing
        to read)."""
        if not (self.calls and self.spans):
            return {}
        launch = [s for _, names, s in self.gaps
                  if "eqlb.call" in names and "eqlb.input" not in names]
        out = {
            "input_ms": (1e3 * sum(self.input_s) / len(self.input_s)
                         if self.input_s else None),
            "launch_idle_ms": 1e3 * sum(launch) / self.calls,
            "se_load_moments_device_ms": self.device_ms(
                _under("se.load_moments")),
            "se_explicit_device_ms": self.device_ms(_under("se.explicit")),
            "se_reduced_device_ms": self.device_ms(
                _under("se.reduced_rhs", "se.reduced_solve")),
            "kkt_element_device_ms": self.device_ms(
                _under("kkt.element_data")),
            # kkt.assemble's self time: the index_add_ scatter, the rank-1
            # term and the boundary masks
            "kkt_scatter_device_ms": self.device_ms(
                lambda names: names[-1] == "kkt.assemble"),
        }
        return {k: v for k, v in out.items() if v is not None}


def _under(*spans):
    """Whether a span's names from the root include one of ``spans``."""
    return lambda names: any(n in names for n in spans)


def credit(events, records, w0: int, w1: int, host: tracing.HostSpans,
           calls: int) -> Credit | None:
    """The stretch [w0, w1] (ns) of the profiler's raw ``events``, its
    device operations and idle gaps credited to the program's span
    ``records``; None where no device operation ran in it.  The gaps and
    the clipping are ``tracing.reduce``'s."""
    starts = launch_starts(events)
    dev = sorted((e.start_ns(), e.end_ns(), e.name(), e.correlation_id())
                 for e in events
                 if tracing.on_device(e)
                 and e.end_ns() > w0 and e.start_ns() < w1)
    if not dev:
        return None
    idx = SpanIndex(records)
    out = Credit(calls=calls, spans=len(records),
                 input_s=[(r.t1_ns - r.t0_ns) / 1e9 for r in idx.records
                          if r.name == "eqlb.input" and w0 <= r.t0_ns <= w1])
    for s, e, name, corr in dev:
        r = idx.at(starts[corr]) if corr in starts else None
        out.device.append((idx.path(r) if r else None,
                           idx.names(r) if r else [], name,
                           (min(e, w1) - max(s, w0)) / 1e9))
    end = w0
    for s, e, _, _ in dev + [(w1, w1, "", 0)]:
        s = max(s, w0)
        if s > end:
            mid = (s + end) // 2
            bench = next((n for a, b, n in host.spans if a <= mid <= b),
                         "between_calls")
            r = idx.at(mid)
            out.gaps.append((f"{bench}/{r.name}" if r else bench,
                             idx.names(r) if r else [], (s - end) / 1e9))
        end = max(end, min(e, w1))
    return out


def stretch(window: run.Window, groups: int, record: bool):
    """``groups`` groups of ``window`` under the profiler (the device's
    activity only), the program's spans recorded if ``record``: (events,
    records, w0, w1, host spans, calls)."""
    act = (torch.profiler.ProfilerActivity.CUDA
           if window.device.type == "cuda"
           else torch.profiler.ProfilerActivity.CPU)
    host, calls = tracing.HostSpans(), 0
    with profiling.recording() if record else nullcontext([]) as records:
        with torch.profiler.profile(activities=[act]) as prof:
            w0 = time.time_ns()
            for _ in range(groups):
                calls += window.group(record=False, host=host)
            w1 = time.time_ns()
    return (prof.profiler.kineto_results.events(), records, w0, w1, host,
            calls)


def measure(cell: cells.Cell, seed: int, groups: int, pairs: int,
            device) -> dict:
    """Set the cell up as a run does, then the cost pairs and the
    credited stretch (module docstring); returns the result line."""
    device = torch.device(device)
    config, traffic = cell.config, cell.traffic
    torch.backends.cuda.matmul.allow_tf32 = False
    points, cells_ = run.make_mesh(config)
    program = Program(config, points, cells_, device)
    topo = Topology(cells_, len(points))
    d_proj, d_rhs = make_data(points, topo, config["degree"],
                              traffic["load_cases"], seed, device)
    sync(device)
    window = run.Window(program, d_proj, d_rhs, traffic, device)
    for _ in range(traffic["warmup_groups"]):
        window.group(record=False)

    cost = {"off": [], "on": []}
    for i in range(2 * pairs):
        record = i % 4 in (1, 2)  # off, on, on, off, ...
        _, records, w0, w1, host, calls = stretch(window, groups, record)
        dispatch = sum(b - a for a, b, n in host.spans if n == "dispatch")
        cost["on" if record else "off"].append(
            {"call_ms": (w1 - w0) / 1e6 / calls,
             "dispatch_ms": dispatch / 1e6 / calls, "spans": len(records)})

    events, records, w0, w1, host, calls = stretch(window, groups, True)
    cr = credit(events, records, w0, w1, host, calls)
    st = tracing.reduce(events, w0, w1, host, calls)
    ctx = SimpleNamespace(stretch=st)
    bench = {name: cells.load_reader(name)(ctx) for name in
             ("stages_device_ms", "device_idle_share",
              "device_kernels_per_call")}
    line = {"workload": cell.name, "seed": seed, "groups": groups,
            "calls": calls, "spans_a_call": len(records) / max(calls, 1),
            "cost": cost, "bench": bench, "device": device_line(device)}
    if cr is not None:
        line.update(
            device_ops=len(cr.device), launches=len(launch_starts(events)),
            credited_share=cr.credited_share(), readings=cr.readings(),
            span_device=cr.span_device(), idle_gaps=cr.idle_gaps(),
            idle_by_name=cr.idle_by_name(), op_split=cr.op_split(),
            reconcile=reconcile(cr))
        run.log(f"spans: {100 * cr.credited_share():.3f} % of the stretch's "
                f"device time credited to a program span")
    return line


# what stages_device_ms leaves out
PORT_KERNELS = ("lu_solve_b", "combine_gather_kernel")
UPLOADS = "Memcpy HtoD"


def reconcile(cr: Credit) -> dict:
    """Device time a call (ms) of the operations ``stages_device_ms``
    counts (all but K1 / K3 ``lu_solve_b*``, K2 / K4
    ``*combine_gather_kernel`` and the uploads), by the innermost span's
    name (``none``: no span): where the stage metrics' time lies in it."""
    by: dict[str, float] = {}
    for _, names, name, s in cr.device:
        if any(k in name for k in PORT_KERNELS) or name.startswith(UPLOADS):
            continue
        key = names[-1] if names else "none"
        by[key] = by.get(key, 0.0) + 1e3 * s / cr.calls
    return by


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--groups", type=int, default=None,
                    help="groups a stretch (default: the traffic's "
                         "trace_groups)")
    ap.add_argument("--pairs", type=int, default=4)
    args = ap.parse_args(argv)
    cell = cells.find(args.workload)
    if not torch.cuda.is_available():
        print("no result: needs a CUDA card", file=sys.stderr)
        return 2
    groups = args.groups or cell.traffic["trace_groups"]
    line = measure(cell, args.seed, groups, args.pairs, "cuda")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
