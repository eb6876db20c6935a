"""Profiling and tracing utilities: the port of the JAX package's
``utils/profiling.py``.

* ``sync``: wait for the device work that produces some tensors
  (``torch.cuda.synchronize`` on each CUDA tensor's device; CPU tensors
  are done when the call returns).
* ``timed``: host-clock seconds of a block, between two synchronisations
  of the current CUDA card (none without one), printed and kept.
* ``trace``: ``torch.profiler`` over a block (CPU and, with a card, CUDA
  activities), its Chrome trace written into a directory.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["timed", "trace", "sync"]


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


@contextlib.contextmanager
def trace(logdir: str = "torch-trace"):
    """``torch.profiler`` over the block, CPU activities and, where a card
    is present, CUDA ones.  Yields the profiler (``key_averages()``,
    ``events()``); on leaving, writes its Chrome trace (Perfetto,
    ``chrome://tracing``) to ``logdir/trace.json`` and keeps that path in
    the profiler's ``chrome_trace`` attribute."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.chrome_trace = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(prof.chrome_trace)
