"""The traced stretch of a ``--trace 1`` run.

``torch.profiler`` records the device's activity alone (kernels, copies,
fills), kept in memory as the profiler's raw events: no trace file, and no
host-side operator events, whose recording would slow the very dispatch a
strict call waits on.  The benchmark's own host spans (``dispatch``: inside
the call into the engine; ``sync``: waiting for the device) and the
stretch's bounds are read from ``time.time_ns``, the clock the profiler
stamps its events with.  The stretch reduces to device time by kernel name,
the device's busy and idle time, and the idle gaps, each named by the host
span open during it (``between_calls`` where none is).

``device_idle`` is ``chip_smoke.py``'s, adapted to raw events and to a
window given by its bounds: the union of the device's intervals clipped to
the window, against the window's length.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field


def device_idle(spans, w0: int, w1: int) -> dict:
    """Device busy time and idle share inside [w0, w1] (ns): the union of
    the device intervals ``spans`` (start, end), clipped to the window,
    against the window's length."""
    spans = sorted((max(s, w0), min(e, w1)) for s, e in spans
                   if e > w0 and s < w1)
    busy, end = 0, w0
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return {"window_ms": (w1 - w0) / 1e6, "device_busy_ms": busy / 1e6,
            "idle_share": 1.0 - busy / (w1 - w0), "device_events": len(spans)}


class HostSpans:
    """The benchmark's host spans of a traced stretch, on the profiler's
    clock."""

    def __init__(self):
        self.spans: list[tuple[int, int, str]] = []

    @contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((t0, time.time_ns(), name))


@dataclass
class Stretch:
    """What the traced stretch of ``calls`` calls saw, times in seconds."""

    calls: int
    window_s: float
    busy_s: float
    ops: list = field(default_factory=list)  # (name, seconds), device
    gaps: list = field(default_factory=list)  # (host span, seconds)

    def device_s(self, select=lambda name: True) -> float:
        return sum(s for name, s in self.ops if select(name))

    def kernels(self) -> int:
        return sum(1 for name, _ in self.ops
                   if not name.startswith(("Memcpy", "Memset")))

    def breakdown(self, most: int = 10) -> dict:
        by_name: dict[str, float] = {}
        for name, s in self.ops:
            by_name[name] = by_name.get(name, 0.0) + s
        ops = sorted(by_name.items(), key=lambda t: -t[1])[:most]
        gaps = sorted(self.gaps, key=lambda t: -t[1])[:most]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def on_device(e) -> bool:
    return (str(e.device_type()).endswith("CUDA")
            and not getattr(e, "is_user_annotation", lambda: False)())


def reduce(events, w0: int, w1: int, host: HostSpans, calls: int) -> Stretch | None:
    """The stretch [w0, w1] (ns) of the profiler's raw ``events``; None
    where no device operation ran in it."""
    dev = sorted((e.start_ns(), e.end_ns(), e.name()) for e in events
                 if on_device(e) and e.end_ns() > w0 and e.start_ns() < w1)
    if not dev:
        return None
    idle = device_idle([(s, e) for s, e, _ in dev], w0, w1)
    gaps, end = [], w0
    for s, e, _ in dev + [(w1, w1, "")]:
        s = max(s, w0)
        if s > end:
            mid = (s + end) // 2
            name = next((n for a, b, n in host.spans if a <= mid <= b),
                        "between_calls")
            gaps.append((name, (s - end) / 1e9))
        end = max(end, min(e, w1))
    return Stretch(calls=calls, window_s=idle["window_ms"] / 1e3,
                   busy_s=idle["device_busy_ms"] / 1e3,
                   ops=[(n, (min(e, w1) - max(s, w0)) / 1e9) for s, e, n in dev],
                   gaps=gaps)
