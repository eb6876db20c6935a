"""Entry points: one weakly symmetric engine call, and the patch-sharded
dry run.

Counterparts of the JAX package's ``__graft_entry__.py``:

* ``entry()`` returns ``(fn, args)``: the weakly symmetric stress
  equilibration (RT2, two f32 stress rows, ``unit_square(8)``) as a
  function of its four inputs, with those inputs on the card;
* ``dryrun_multichip(n_devices)`` runs ``parallel.ShardedEqlbEngine`` on
  ``n_devices`` spawned ranks through four cases (``DRYRUN_CASES``: a
  chunked 32 x 32 mesh at k = 2, 8 x 8 at k = 3, a Cook membrane with
  grouped traction corners, three fields at once), f64, and holds each to
  the single-device engine within 1e-11 max(1, max|x|).

Run:  python -m dolfinx_eqlb_tpu_torch.entry [--ranks N] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .eqlb.engine import _NP_DTYPE, EqlbEngine
from .eqlb.grouping import build_groups, grouped_weak_symmetry
from .eqlb.patches import build_patches
from .fem import FunctionSpace
from .fem.spaces import resolve_device
from .mesh import cook_membrane, unit_square
from .parallel.launch import rank_device, spawn_ranks
from .parallel.sharding import ShardedEqlbEngine

__all__ = ["setup", "entry", "dryrun_multichip", "dryrun_case",
           "dryrun_rank", "dryrun_record", "dryrun_check", "DRYRUN_CASES"]

# the dry run's cases (``__graft_entry__.py:108-157``): setup() arguments
DRYRUN_CASES = {
    # bucket chunking forced, so each chunk is split over the ranks
    "32x32 k=2 chunked": dict(n=32, k=2, max_patches_per_bucket=256),
    "8x8 k=3": dict(n=8, k=3),
    # flux-essential corners: deficient patches are skipped inside the
    # sharded call and corrected jointly in a host post-pass
    "cook k=2 grouped": dict(n=3, k=2, mesh_kind="cook"),
    # three fields at once, without weak symmetry
    "8x8 k=2 3-field": dict(n=8, k=2),
}


def setup(n=8, k=2, dtype=torch.float32, pad_to_multiple=None,
          max_patches_per_bucket=None, mesh_kind="square", device=None):
    """The dry run's configurations: (mesh, engine, (d_proj, d_rhs,
    facet_kind, bvals)) with two rows of random DG data (NumPy, seed 0, as
    the reference draws them).  ``mesh_kind="cook"``: ``cook_membrane(n,
    n)`` with traction (kind 2) on the boundary except the clamped left
    edge (kind 1); else ``unit_square(n)``, every boundary facet kind 1."""
    msh = (unit_square(n) if mesh_kind == "square"
           else cook_membrane(n, n))
    V = FunctionSpace(msh, "RT", k)
    engine = EqlbEngine(V, build_patches(msh), dtype=dtype, device=device,
                        pad_to_multiple=pad_to_multiple,
                        max_patches_per_bucket=max_patches_per_bucket)
    ndg = k * (k + 1) // 2
    rng = np.random.default_rng(0)
    nc = msh.num_cells
    np_dt = _NP_DTYPE[dtype]
    d_proj = rng.normal(size=(2, nc, 2, ndg)).astype(np_dt)
    d_rhs = rng.normal(size=(2, nc, ndg)).astype(np_dt)
    if mesh_kind == "cook":
        fk = np.zeros(msh.num_facets, np.int8)
        fk[msh.boundary_facets] = 2
        left = msh.locate_boundary_facets(
            lambda x: np.isclose(x[..., 0], 0.0))
        fk[left] = 1
        facet_kind = fk[None].repeat(2, 0)
    else:
        facet_kind = (np.where(msh.is_boundary_facet, 1, 0)
                      .astype(np.int8)[None].repeat(2, 0))
    bvals = np.zeros((2, msh.num_facets, k), np_dt)
    return msh, engine, (d_proj, d_rhs, facet_kind, bvals)


def entry(device=None):
    """``(fn, args)``: ``fn(*args)`` is the weakly symmetric RT2 stress
    equilibration of two f32 rows on ``unit_square(8)``, ``args`` its
    inputs as tensors on ``device`` (the card by default)."""
    _, engine, args = setup(n=8, k=2, device=device)
    engine.ensure_stress_caches()
    targs = tuple(torch.as_tensor(a, device=engine.device) for a in args)

    def fn(d_proj, d_rhs, facet_kind, bvals):
        return engine.equilibrate(d_proj, d_rhs, facet_kind, bvals,
                                  weak_symmetry=True)

    return fn, targs


def dryrun_case(name: str, n_devices: int, device):
    """Case ``name`` of ``DRYRUN_CASES``, f64, padded for ``n_devices``
    ranks: (engine, args, weak_symmetry, ws_skip_nodes, groups)."""
    _, engine, args = setup(**DRYRUN_CASES[name], dtype=torch.float64,
                            pad_to_multiple=n_devices, device=device)
    if name == "cook k=2 grouped":
        groups, skip = build_groups(engine, args[2][:2])
        if not len(skip):
            raise RuntimeError("the Cook case must exercise grouping")
        return engine, args, True, skip, groups
    if name == "8x8 k=2 3-field":
        dp, dr, fk, bv = args
        rng = np.random.default_rng(7)
        nc, ndg = dp.shape[1], dp.shape[-1]
        args = (rng.normal(size=(3, nc, 2, ndg)),
                rng.normal(size=(3, nc, ndg)),
                np.concatenate([fk, fk[:1]]), np.concatenate([bv, bv[:1]]))
        return engine, args, False, None, []
    return engine, args, True, None, []


def dryrun_rank(rank: int, world: int, device: str, backend: str) -> dict:
    """One rank of ``dryrun_multichip``: every case through the sharded
    engine, recorded by ``dryrun_record``."""
    dev = rank_device(device, backend, rank)
    out = {}
    for name in DRYRUN_CASES:
        engine, args, ws, skip, groups = dryrun_case(name, world, dev)
        sharded = ShardedEqlbEngine(engine)
        x = sharded.equilibrate(*args, weak_symmetry=ws, ws_skip_nodes=skip)
        out[name] = dryrun_record(rank, engine, sharded, x, args, ws, skip,
                                  groups)
    return out


def dryrun_record(rank, engine, sharded, x, args, ws, skip, groups) -> dict:
    """A rank's record of one case: its result ``x`` of the sharded call
    and its patch counts.  Rank 0 also runs the single-device ``engine``
    on the same inputs and, with ``groups``, the grouped post-pass."""
    rec = {"x": x.cpu().numpy(), "patches": sharded.npatches_local,
           "rows": sharded.rows_local}
    if rank == 0:
        rec["x_single"] = engine.equilibrate(
            *args, weak_symmetry=ws, ws_skip_nodes=skip).cpu().numpy()
        if groups:
            x01 = grouped_weak_symmetry(engine, x[:2], args[2][:2], groups)
            rec["grouped_finite"] = bool(torch.isfinite(x01).all())
    return rec


def dryrun_check(ranks: list) -> dict:
    """Hold the ranks' records (``dryrun_record`` per case) to the
    single-device engine within 1e-11 max(1, max|x|), every rank's
    replicated result identical.  Raises on a mismatch; returns {case:
    {"x", "x_single", "max_abs_err", "limit", "ranks": [each rank's record
    without its arrays]}}."""
    report = {}
    for name in DRYRUN_CASES:
        recs = [r[name] for r in ranks]
        x, x_ref = recs[0]["x"], recs[0]["x_single"]
        err = float(np.abs(x - x_ref).max())
        limit = 1e-11 * max(1.0, float(np.abs(x_ref).max()))
        if not err <= limit:
            raise RuntimeError(f"{name}: sharded result mismatch: {err:.3e} "
                               f"(limit {limit:.3e})")
        if not all(np.array_equal(r["x"], x) for r in recs):
            raise RuntimeError(f"{name}: the ranks' results differ")
        if not recs[0].get("grouped_finite", True):
            raise RuntimeError(f"{name}: grouped correction not finite")
        print(f"dryrun_multichip({len(ranks)}) {name}: ok, max dev "
              f"{err:.2e}", flush=True)
        report[name] = {
            "x": x, "x_single": x_ref, "max_abs_err": err, "limit": limit,
            "ranks": [{key: val for key, val in r.items() if key not in (
                "x", "x_single", "grouped_finite")} for r in recs]}
    return report


def dryrun_multichip(n_devices: int, device=None, backend=None) -> dict:
    """Weakly symmetric stress equilibration sharded over ``n_devices``
    spawned ranks, each case held to the single-device engine
    (``dryrun_check``).

    ``device``: the card by default (``"cpu"`` for CPU tensors).
    ``backend``: ``"nccl"`` when there is a card per rank, else
    ``"gloo"`` (all ranks on ``device``).  Raises on a mismatch; returns
    ``dryrun_check``'s report, with each rank's patches and rows."""
    device = resolve_device(device, "dryrun_multichip")
    if backend is None:
        backend = ("nccl" if device.type == "cuda"
                   and torch.cuda.device_count() >= n_devices else "gloo")
    return dryrun_check(spawn_ranks(dryrun_rank, n_devices, backend,
                                    args=(str(device), backend)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    a = p.parse_args(argv)
    fn, args = entry(a.device)
    out = fn(*args)
    print("entry:", tuple(out.shape), float(out.abs().max()))
    dryrun_multichip(a.ranks, device=a.device)


if __name__ == "__main__":
    main()
