"""Profiling and tracing utilities: the port of the JAX package's
``utils/profiling.py``, and the program's spans.

* ``sync``: wait for the device work that produces some tensors
  (``torch.cuda.synchronize`` on each CUDA tensor's device; CPU tensors
  are done when the call returns).
* ``timed``: host-clock seconds of a block, between two synchronisations
  of the current CUDA card (none without one), printed and kept.
* ``span``, ``annotate``, ``recording``: the program's spans.
  ``EqlbEngine.equilibrate`` opens one ``eqlb.call`` span a call and a
  span at each stage boundary under it (``eqlb.input``, ``se.bucket`` /
  ``kkt.bucket`` and their stages, ``eqlb.concat``, ``eqlb.combine``);
  the solve wrappers ``annotate`` the route they launched.  Recording is
  off by default, and then ``span`` hands back one shared no-op object:
  no clock read, no record.  ``with recording() as records:`` turns it on
  for a block; a record (``SpanRecord``) is stamped with
  ``time.time_ns``, the clock ``torch.profiler`` stamps its events with,
  so a device operation can be credited to the span that launched it.
  No span ever synchronises the card.
* ``trace``: ``torch.profiler`` over a block (CPU and, with a card, CUDA
  activities), with the program's spans recorded; its Chrome trace, the
  spans written in as complete events on the trace's own time base, goes
  into a directory.  This is the operator's view of a call: in Perfetto
  (``ui.perfetto.dev``) or ``chrome://tracing`` the engine's stages sit
  above the kernels they launched::

      with trace("torch-trace"):
          engine.equilibrate(d_proj, d_rhs, facet_kind, bvals)
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field

import torch

__all__ = ["timed", "trace", "sync", "span", "annotate", "recording",
           "SpanRecord"]


def sync(*tensors):
    """Wait until the work producing ``tensors`` is done: one
    ``torch.cuda.synchronize`` per CUDA device among them.  Returns the
    tensor (one argument) or the tuple."""
    done = set()
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            if t.device not in done:
                torch.cuda.synchronize(t.device)
                done.add(t.device)
    return tensors[0] if len(tensors) == 1 else tensors


def _sync_card():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed(name: str):
    """``with timed("equilibrate") as t: ...``; ``t["s"]`` holds the
    host-clock seconds of the block after it.  The current CUDA card is
    synchronised before the clock starts and before it stops, so the time
    covers the block's device work and nothing queued before it."""
    rec = {"name": name}
    _sync_card()
    t0 = time.perf_counter()
    try:
        yield rec
    finally:
        _sync_card()
        rec["s"] = time.perf_counter() - t0
        print(f"[{name}] {rec['s']:.4f} s", flush=True)


# --- spans -------------------------------------------------------------------

@dataclass
class SpanRecord:
    """One closed span: ``t0_ns`` / ``t1_ns`` on ``time.time_ns``;
    ``parent_id`` 0 for a root span; ``call_id`` the ``span_id`` of the
    root span it opened under (one ``eqlb.call`` each); ``thread_id``
    ``threading.get_ident()``, which costs no system call (the native id
    does, one a span)."""

    name: str
    t0_ns: int
    t1_ns: int
    span_id: int
    parent_id: int
    call_id: int
    thread_id: int
    attrs: dict = field(default_factory=dict)


class _Off:
    """The span handed back while recording is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Recorder:
    """One ``recording()``: its records, span ids and each thread's stack
    of open spans."""

    def __init__(self):
        self.records: list[SpanRecord] = []
        self.ids = itertools.count(1)
        self.local = threading.local()

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s


class _Span:
    __slots__ = ("rec", "name", "attrs", "record")

    def __init__(self, rec: _Recorder, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        stack = self.rec.stack()
        sid = next(self.rec.ids)
        parent = stack[-1] if stack else None
        self.record = SpanRecord(
            self.name, time.time_ns(), 0, sid,
            parent.span_id if parent else 0,
            parent.call_id if parent else sid,
            threading.get_ident(), self.attrs)
        stack.append(self.record)
        return self

    def __exit__(self, *exc):
        self.record.t1_ns = time.time_ns()
        self.rec.stack().pop()
        self.rec.records.append(self.record)
        return False


_recorder: _Recorder | None = None  # the open recording, None while off


def span(name: str, **attrs):
    """A span over a ``with`` block, recorded while a ``recording()`` is
    open; otherwise one shared no-op object."""
    rec = _recorder
    if rec is None:
        return _OFF
    return _Span(rec, name, attrs)


def annotate(**attrs) -> None:
    """Add ``attrs`` to the innermost open span of this thread (nothing
    while recording is off or no span is open)."""
    rec = _recorder
    if rec is None:
        return
    stack = rec.stack()
    if stack:
        stack[-1].attrs.update(attrs)


@contextlib.contextmanager
def recording():
    """Record spans for the block; yields the list of ``SpanRecord`` that
    holds every span closed in it (in closing order) once the block ends.
    Leaving restores what was before (off, or an outer recording)."""
    global _recorder
    prev, rec = _recorder, _Recorder()
    _recorder = rec
    try:
        yield rec.records
    finally:
        _recorder = prev


# --- the operator's trace ----------------------------------------------------

def _write_spans(path: str, records: list[SpanRecord]) -> None:
    """Append ``records`` to the Chrome trace at ``path`` as complete
    events ("ph": "X", microseconds) on the trace's time base: relative to
    its ``baseTimeNanoseconds`` where it has one, else absolute.  Each
    thread's spans get a track of their own beside the profiler's."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    for r in records:
        args = {k: (v if isinstance(v, (bool, int, float, str)) else str(v))
                for k, v in r.attrs.items()}
        args.update(span_id=r.span_id, parent_id=r.parent_id,
                    call_id=r.call_id)
        doc["traceEvents"].append({
            "ph": "X", "cat": "eqlb_span", "name": r.name, "pid": pid,
            "tid": f"eqlb spans {r.thread_id}", "ts": (r.t0_ns - base) / 1e3,
            "dur": (r.t1_ns - r.t0_ns) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(logdir: str = "torch-trace"):
    """``torch.profiler`` over the block, CPU activities and, where a card
    is present, CUDA ones, with the program's spans recorded.  Yields the
    profiler (``key_averages()``, ``events()``); on leaving, writes its
    Chrome trace (Perfetto, ``chrome://tracing``), the spans added as
    complete events, to ``logdir/trace.json`` and keeps that path in the
    profiler's ``chrome_trace`` attribute and the spans in ``spans``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with recording() as records:
        with profile(activities=activities) as prof:
            yield prof
    prof.spans = records
    prof.chrome_trace = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(prof.chrome_trace)
    _write_spans(prof.chrome_trace, records)
