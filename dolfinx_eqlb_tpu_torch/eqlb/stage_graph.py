"""The semi-explicit call's per-bucket stages as one captured CUDA graph.

On the card, stage 3 of a semi-explicit call (``EqlbEngine.
_bucket_solutions``: per bucket the load moments K5, the explicit step,
the reduced step K6, on boundary buckets the masked K1 solve and its
scatter back, the unfold; then the concatenation into the flat
(n_rhs, total + 1) array the combine reads) is ~160 small launches whose
Python dispatch takes about three times as long as the card takes to run
them.  None of them reads a device value back to the host, and every
shape follows from the mesh's buckets and ``n_rhs``.  So the engine runs
that stage from addresses it owns (a static packed dof buffer, its
boundary-data buffers and its device tables): the first call of a key
eagerly, the second captures it (``torch.cuda.CUDAGraph``) and replays it,
and later calls replay it, one graph launch in place of the dispatch.
The combine (K2 or K4) stays eager, so every call returns a fresh output.

A capture costs more host time than the eager call it stands in for, and
each replay saves the dispatch it skips.  At 1M cells on an H100 the
capture call takes 16-28 ms against 7.5-9 ms eager, the process's first
capture ~50 ms (a one-off of the CUDA graph machinery), and a replayed
call ~2.2 ms: a key breaks even at its 4th to 5th call, or its ~11th for
the process's first graph.  The port's flows make one call a key (the
demos, the adaptive loops, a sharded rank's engine: never captured), four
(``utils.perftest``: one, then its repeats) or many (load cases, time
steps).  Capturing at the second call gains most on the long flows and
costs the four-call flow least of the points up to its fourth call; a
point past that spares it, but moves the capture out of a long flow's
first few calls, which a warm-up covers, into the calls it times.

A call is eligible on a CUDA engine in the semi-explicit mode without weak
symmetry and with a solver other than "torch": the pivoted
``torch.linalg.solve`` of those paths checks its result on the host.  The
KKT mode and every CPU engine stay eager too.  One graph per engine: a new
key, or rebuilt device tables, drops the old graph and its memory pool.
Calls in flight share one stream, so stream order puts each call's input
copies and replay after the previous call's combine read the flat array.
"""

from __future__ import annotations

import torch

from ..ops._build import add_launches, launch_counts
from ..utils.profiling import span

__all__ = ["eligible", "graph_key", "StageGraph"]

# one capture stream per device, so that the libraries' per-stream state
# (cuBLAS's workspace) is made once and not once per graph
_CAPTURE_STREAMS: dict = {}


def eligible(engine, weak_symmetry: bool) -> bool:
    """Whether ``engine``'s call runs stage 3 through a ``StageGraph``."""
    return (engine.device.type == "cuda" and engine.mode == "semiexplicit"
            and not weak_symmetry and engine.solver != "torch")


def graph_key(engine, shape, facet_kind, bvals) -> tuple:
    """What a captured stage 3 depends on besides the engine's tables: the
    packed dof buffer's ``shape`` (n_rhs, 3, ndg, nc), the dtype,
    ``solver`` and ``mixed_refine_steps``, and the boundary-data buffers
    the stages read (shape, dtype, address)."""
    return (tuple(shape), engine.dtype, engine.solver,
            engine.mixed_refine_steps,
            *((tuple(t.shape), t.dtype, t.data_ptr())
              for t in (facet_kind, bvals)))


class StageGraph:
    """Stage 3 of one key: its static input ``dprT`` (set by the first
    call) and, once captured, its graph, its static output ``flat`` and
    the kernel launches of one replay.  It holds the tables and buffers it
    reads, so none is freed under it."""

    def __init__(self, key: tuple, facet_kind, bvals):
        self.key = key
        self.inputs = (facet_kind, bvals)
        self.dprT = None
        self.dev = None
        self.graph = self.flat = self.launches = None

    def holds(self, key: tuple, dev) -> bool:
        """Whether this graph serves a call of ``key`` on tables ``dev``
        (those of its first call, while it has not run: ``dev is None``)."""
        return key == self.key and (self.dev is None or self.dev is dev)

    def drop(self) -> None:
        """Release the graph and its pool once the replays in flight are
        done."""
        if self.graph is not None:
            torch.cuda.current_stream(self.flat.device).synchronize()
        self.graph = self.flat = self.launches = None

    def run(self, engine, facet_kind, bvals) -> torch.Tensor:
        """Stage 3 on ``self.dprT``: eagerly on the first call, captured
        and replayed on the second, replayed after."""
        if self.dev is None:
            flat = engine._bucket_solutions(self.dprT, facet_kind, bvals)
            self.dev = engine._dev
            return flat
        if self.graph is None:
            with span("se.graph", route="capture"):
                self._capture(engine, facet_kind, bvals)
                self.graph.replay()
            engine.graph_captures += 1
        else:
            with span("se.graph", route="replay"):
                add_launches(self.launches)
                self.graph.replay()
        engine.graph_replays += 1
        return self.flat

    def _capture(self, engine, facet_kind, bvals) -> None:
        """Capture stage 3 on the device's capture stream; the launches
        counted while capturing are those of one replay.  Capture begins
        and ends here, not in ``torch.cuda.graph``, whose entry also syncs
        the device, collects garbage and empties the allocator's cache:
        ~45 ms a capture at 1M cells, where nothing needs them (the capture
        runs nothing, and the replay follows the call's input copies on
        the current stream)."""
        device = self.dprT.device
        stream = _CAPTURE_STREAMS.get(device)
        if stream is None:
            stream = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        with torch.cuda.stream(stream):
            graph.capture_begin()
            try:
                self.flat = engine._bucket_solutions(self.dprT, facet_kind,
                                                     bvals)
            finally:
                graph.capture_end()
        self.launches = launch_counts(since=before)
        self.graph = graph
