"""Patch sharding of the port (``parallel.ShardedEqlbEngine``) against the
port's single-device engine and the JAX package's ``EqlbEngine``, f64 on
the CPU:

* ``entry.dryrun_multichip(2, device="cpu")``: the four dry-run cases of
  ``__graft_entry__.py`` on a 2-rank gloo group of spawned processes, each
  within 1e-11 * max(1, max|x|) of a fresh unpadded single-device engine
  and of JAX's ``EqlbEngine.equilibrate``; a 1-rank group bitwise equal
  to the single-device engine;
* the per-rank split in one process (a 2-rank fake process group, rank by
  rank): the ranks' partial vectors sum to the single-device result, and
  every patch is solved on exactly one rank;
* ``EqlbEngine(pad_to_multiple=m)`` against the unpadded engine, with and
  without weak symmetry and ``ws_skip_nodes``; the refusal of an engine
  whose buckets do not split evenly; ``equilibrate(fuse=False)``'s two
  refusals;
* ``entry()`` against JAX's f32 engine on the same inputs."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from dolfinx_eqlb_tpu.eqlb.engine import EqlbEngine as JaxEngine
from dolfinx_eqlb_tpu.eqlb.patches import build_patches as jax_patches
from dolfinx_eqlb_tpu.fem import FunctionSpace as JaxSpace
from dolfinx_eqlb_tpu.mesh import generators as jax_gen

from dolfinx_eqlb_tpu_torch import entry as tentry
from dolfinx_eqlb_tpu_torch.eqlb.grouping import build_groups
from dolfinx_eqlb_tpu_torch.parallel import ShardedEqlbEngine

torch.set_num_threads(2)

CASES = list(tentry.DRYRUN_CASES)


def _limit(x_ref):
    return 1e-11 * max(1.0, float(np.abs(x_ref).max()))


@pytest.fixture(scope="module")
def dryrun():
    """The dry run on 2 gloo ranks, each with 2 CPU threads."""
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "2"
    try:
        return tentry.dryrun_multichip(2, device="cpu")
    finally:
        if old is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = old


def _jax_engine(name, dtype=np.float64):
    spec = dict(tentry.DRYRUN_CASES[name])
    msh = (jax_gen.cook_membrane(spec["n"], spec["n"])
           if spec.get("mesh_kind") == "cook"
           else jax_gen.unit_square(spec["n"]))
    return JaxEngine(JaxSpace(msh, "RT", spec["k"]), jax_patches(msh),
                     dtype=dtype, pad_to_multiple=2,
                     max_patches_per_bucket=spec.get(
                         "max_patches_per_bucket"))


@pytest.mark.parametrize("name", CASES)
def test_dryrun_case_matches_single_device_engine(dryrun, name):
    rep = dryrun[name]
    x = rep["x"]
    assert np.isfinite(x).all()
    assert np.abs(x - rep["x_single"]).max() <= _limit(rep["x_single"])
    # a fresh single-device engine without pad rows
    engine, args, ws, skip, _ = tentry.dryrun_case(name, 1, "cpu")
    assert all(t["gdofs"].shape[0] == engine.buckets[key].npatches
               for key, t in engine.tables.items())
    x1 = engine.equilibrate(*args, weak_symmetry=ws,
                            ws_skip_nodes=skip).numpy()
    assert np.abs(x - x1).max() <= _limit(x1)
    # each rank held half of every bucket's padded rows
    ranks = rep["ranks"]
    engine2, *_ = tentry.dryrun_case(name, 2, "cpu")
    rows = sum(t["gdofs"].shape[0] for t in engine2.tables.values())
    assert [r["rows"] for r in ranks] == [rows // 2, rows // 2]
    assert sum(r["patches"] for r in ranks) == engine.mesh.num_vertices


@pytest.mark.parametrize("name", CASES)
def test_dryrun_case_matches_jax_engine(dryrun, name):
    engine, args, ws, skip, groups = tentry.dryrun_case(name, 2, "cpu")
    jeng = _jax_engine(name)
    assert np.array_equal(jeng.mesh.points, engine.mesh.points)
    x_jax = np.asarray(jeng.equilibrate(*args, weak_symmetry=ws,
                                        ws_skip_nodes=skip))
    x = dryrun[name]["x"]
    assert x.shape == x_jax.shape
    assert np.abs(x - x_jax).max() <= _limit(x_jax)


def test_dryrun_grouped_case_is_grouped():
    engine, args, ws, skip, groups = tentry.dryrun_case(
        "cook k=2 grouped", 2, "cpu")
    g2, s2 = build_groups(engine, args[2][:2])
    assert ws and len(skip) and groups == g2
    assert np.array_equal(skip, s2)


def test_one_rank_group_is_bitwise():
    rep = tentry.dryrun_multichip(1, device="cpu")
    for name in CASES:
        assert np.array_equal(rep[name]["x"], rep[name]["x_single"]), name
        assert rep[name]["max_abs_err"] == 0.0


def _fake_group(rank, world):
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


@pytest.mark.parametrize("name", ["32x32 k=2 chunked", "cook k=2 grouped"])
def test_rank_partials_sum_to_single_device(name):
    engine, args, ws, skip, _ = tentry.dryrun_case(name, 2, "cpu")
    x1 = engine.equilibrate(*args, weak_symmetry=ws,
                            ws_skip_nodes=skip).numpy()
    parts, nodes = [], []
    for rank in range(2):
        _fake_group(rank, 2)
        try:
            sh = ShardedEqlbEngine(engine)
            assert (sh.rank, sh.world) == (rank, 2)
            parts.append(sh.partial(*args, weak_symmetry=ws,
                                    ws_skip_nodes=skip).numpy())
            nodes.append(np.concatenate(
                [b.nodes for b in sh.local.buckets.values()]))
            # the local engine's device state holds the rank's rows only
            dev, _ = sh.local._device_tables()
            for key, t in engine.tables.items():
                assert dev[key]["J_bl"].shape[-1] == t["J"].shape[0] // 2
        finally:
            dist.destroy_process_group()
    assert np.abs((parts[0] + parts[1]) - x1).max() <= _limit(x1)
    # every vertex's patch is solved on exactly one rank
    allnodes = np.sort(np.concatenate(nodes))
    assert np.array_equal(allnodes, np.arange(engine.mesh.num_vertices))


def test_unpadded_engine_refused():
    # unit_square(3) has buckets of odd size
    _, engine, _ = tentry.setup(n=3, k=2, dtype=torch.float64, device="cpu")
    assert any(t["gdofs"].shape[0] % 2 for t in engine.tables.values())
    _fake_group(0, 2)
    try:
        with pytest.raises(ValueError, match="pad_to_multiple"):
            ShardedEqlbEngine(engine)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("m", [3, 8])
@pytest.mark.parametrize("mode", ["flux", "weak_symmetry", "ws_skip"])
def test_padded_engine_equals_unpadded(m, mode):
    kind = "cook" if mode == "ws_skip" else "square"
    n = 3 if kind == "cook" else 4
    _, e0, args = tentry.setup(n=n, k=2, dtype=torch.float64,
                               mesh_kind=kind, device="cpu")
    _, e1, _ = tentry.setup(n=n, k=2, dtype=torch.float64, mesh_kind=kind,
                            device="cpu", pad_to_multiple=m)
    padded = 0
    for key, t in e1.tables.items():
        P, n_real = t["gdofs"].shape[0], e1.buckets[key].npatches
        assert P % m == 0 and P - n_real < m
        assert (t["gdofs"][n_real:] == e1.V.ndofs).all()
        padded += P - n_real
    assert padded > 0
    skip = None
    if mode == "ws_skip":
        _, skip = build_groups(e0, args[2][:2])
        assert len(skip)
    ws = mode != "flux"
    x0 = e0.equilibrate(*args, weak_symmetry=ws, ws_skip_nodes=skip)
    x1 = e1.equilibrate(*args, weak_symmetry=ws, ws_skip_nodes=skip)
    assert np.abs((x1 - x0).numpy()).max() <= _limit(x0.numpy())


def test_fuse_false_refusals():
    _, engine, args = tentry.setup(n=3, k=2, dtype=torch.float64,
                                   mesh_kind="cook", device="cpu")
    _, skip = build_groups(engine, args[2][:2])
    x_none = engine.equilibrate(*args)
    for fuse in (True, False):
        assert torch.equal(engine.equilibrate(*args, fuse=fuse), x_none)
    dpT, drT = engine.put_transposed(args[0], args[1])
    with pytest.raises(ValueError, match="transposed_inputs"):
        engine.equilibrate(dpT, drT, *args[2:], fuse=False,
                           transposed_inputs=True)
    with pytest.raises(ValueError, match="ws_skip_nodes"):
        engine.equilibrate(*args, weak_symmetry=True, fuse=False,
                           ws_skip_nodes=skip)
    # the fused default takes both
    engine.equilibrate(dpT, drT, *args[2:], fuse=True, transposed_inputs=True)
    engine.equilibrate(*args, weak_symmetry=True, ws_skip_nodes=skip)


def test_entry_matches_jax_f32():
    fn, args = tentry.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    x = fn(*args)
    msh = jax_gen.unit_square(8)
    jeng = JaxEngine(JaxSpace(msh, "RT", 2), jax_patches(msh),
                     dtype=np.float32)
    x_jax = np.asarray(jeng.equilibrate(*(a.numpy() for a in args),
                                        weak_symmetry=True))
    assert x.dtype == torch.float32 and tuple(x.shape) == x_jax.shape
    assert np.isfinite(x.numpy()).all()
    scale = float(np.abs(x_jax).max())
    assert np.abs(x.numpy() - x_jax).max() <= 1e-4 * scale
