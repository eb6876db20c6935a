"""Patch-parallel equilibration over ``torch.distributed``.

Port of the JAX package's ``parallel/sharding.py``.  There, every bucket's
patch axis is sharded over a 1-D device mesh, inputs and outputs are
replicated, and GSPMD turns the global combine into one all-reduce.  Here
each rank of a process group holds the same contiguous slice of every
bucket's padded patch axis that GSPMD's ``P(axis)`` gives it: rank r of W
takes rows [r P / W, (r + 1) P / W).  A call then runs, on every rank:

1. the single-device engine's per-bucket semi-explicit path on the rank's
   rows (K1 for the boundary buckets' masked solves; the interior
   inverses, built through K1 once, and the weak-symmetry caches are of
   the rank's rows only), with the per-patch weak-symmetry correction and
   its ``ws_skip_nodes`` masks;
2. the combine through K2, from a table of the rank's own rows: a dof
   gets the sum of the contributors the rank holds, zero without one;
3. one ``all_reduce(SUM)`` over the group, so that every rank returns the
   full (n_rhs, ndofs) vector.

A dof's 2-3 contributors are summed partly on one rank and partly in the
reduce, so the result matches the single-device engine within rounding,
not bit for bit.  Pad rows (``EqlbEngine(pad_to_multiple=W)``) are solved
and never combined.  gloo reduces CUDA tensors through host memory inside
the library; NCCL wants one card per rank.
"""

from __future__ import annotations

from dataclasses import replace

import torch
import torch.distributed as dist

from ..eqlb.engine import _PER_PATCH, EqlbEngine

__all__ = ["ShardedEqlbEngine"]


class ShardedEqlbEngine:
    """Wraps an ``EqlbEngine`` (built with ``pad_to_multiple`` = the group's
    size) so that each rank of ``group`` (default: the WORLD group) solves
    its rows of every bucket; inputs and outputs are replicated.

    The wrapped engine is used for its host tables only: its device state
    is never built.  Each rank's engine, ``local``, is built from the
    rank's rows (``EqlbEngine.from_host_tables(partial=True)``), so every
    patch is set up once across the ranks.  The check that every dof has
    all its contributors ran when ``engine`` was built, over the union of
    the ranks' rows."""

    def __init__(self, engine: EqlbEngine, group=None):
        if engine.mode != "semiexplicit":
            raise ValueError("the sharded engine runs the semi-explicit "
                             f"path, not mode={engine.mode!r}")
        self.engine = engine
        self.group = group if group is not None else dist.group.WORLD
        self.world = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        for t in engine.tables.values():
            if t["gdofs"].shape[0] % self.world != 0:
                raise ValueError(
                    "construct the engine with pad_to_multiple=n_devices")
        buckets, tables = {}, {}
        for key, t in engine.tables.items():
            b = engine.buckets[key]
            P, r, W = t["gdofs"].shape[0], self.rank, self.world
            rows = slice(r * P // W, (r + 1) * P // W)
            # the bucket keeps its real patches among the rank's rows;
            # the pad rows after them live in the tables only
            real = slice(min(rows.start, b.npatches),
                         min(rows.stop, b.npatches))
            buckets[key] = replace(
                b, nodes=b.nodes[real], cells=b.cells[real],
                lnode=b.lnode[real], spokes=b.spokes[real],
                entry_loc=b.entry_loc[real], exit_loc=b.exit_loc[real])
            tables[key] = {name: a[rows] if name in _PER_PATCH else a
                           for name, a in t.items()}
        self.local = EqlbEngine.from_host_tables(
            engine.V, buckets, tables, engine.se_static, engine.ref,
            dtype=engine.dtype, device=engine.device, partial=True)
        for name in ("solver", "mixed_refine_steps", "combine"):
            setattr(self.local, name, getattr(engine, name))
        self.local._device_tables()

    def equilibrate(self, sigma_proj_dofs, rhs_dofs, facet_kind, bvals,
                    weak_symmetry=False, ws_skip_nodes=None):
        """Replicated-in, replicated-out ``EqlbEngine.equilibrate``: the
        rank's part (``partial``), then one all-reduce over the group.
        ``ws_skip_nodes``: patch vertices whose per-patch weak-symmetry
        correction is skipped (deficient grouped patches; their joint
        correction, ``eqlb.grouping.grouped_weak_symmetry``, is a host
        post-pass on the reduced result, as on one device)."""
        x = self.partial(sigma_proj_dofs, rhs_dofs, facet_kind, bvals,
                         weak_symmetry, ws_skip_nodes)
        return self.reduce(x)

    def partial(self, sigma_proj_dofs, rhs_dofs, facet_kind, bvals,
                weak_symmetry=False, ws_skip_nodes=None) -> torch.Tensor:
        """The rank's rows solved and combined (K1, K2): the global vector
        restricted to the contributions this rank holds."""
        return self.local.equilibrate(
            sigma_proj_dofs, rhs_dofs, facet_kind, bvals,
            weak_symmetry=weak_symmetry, ws_skip_nodes=ws_skip_nodes)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum the ranks' partial vectors in place (all-reduce)."""
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    @property
    def npatches_local(self) -> int:
        """Real patches among this rank's rows."""
        return int(sum(b.npatches for b in self.local.buckets.values()))

    @property
    def rows_local(self) -> int:
        """This rank's table rows, pad rows included."""
        return int(sum(t["gdofs"].shape[0]
                       for t in self.local.tables.values()))

