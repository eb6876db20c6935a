"""Stage 3 of the semi-explicit call as one captured CUDA graph
(``eqlb.stage_graph``).

On the CPU: the rule that decides which calls run through the graph, the
key a graph is held to, the launch registry's snapshot and replay
arithmetic, and that a CPU engine never captures, its outputs bit for bit
those of the packing it replaced (two batch-last transposes and a
``torch.cat``).  On the card only (marker ``card``): every replayed call
bit for bit the eager first call of a fresh engine on the same inputs, at
the options and inputs that reach the graph, boundary data changed between
replays, 8 calls in flight, the launch counts of a replayed call, the
kernels a profiler trace of a replayed call holds, input layouts that
share a graph, the spans, a new key and rebuilt tables, and the paths
that never capture.
This module imports no JAX, so the card tests run on a machine without it,
past the JAX set-up of ``conftest.py``:

    python -m pytest --noconftest tests/test_torch_stage_graph.py -m card
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dolfinx_eqlb_tpu_torch.eqlb import stage_graph
from dolfinx_eqlb_tpu_torch.eqlb.engine import EqlbEngine
from dolfinx_eqlb_tpu_torch.eqlb.patches import build_patches
from dolfinx_eqlb_tpu_torch.fem import FunctionSpace
from dolfinx_eqlb_tpu_torch.mesh import unit_square, unit_square_unstructured
from dolfinx_eqlb_tpu_torch.ops import _build, launches, reset_launches
from dolfinx_eqlb_tpu_torch.utils.profiling import recording

torch.set_num_threads(2)

_MESHES = {
    "crossed4": lambda: unit_square(4),
    "unstructured7": lambda: unit_square_unstructured(7),
}


def _engine(mesh, k=2, mode="semiexplicit", device="cpu",
            dtype=torch.float64, chunk=7, solver="kernel", combine="gather"):
    msh = _MESHES[mesh]()
    eng = EqlbEngine(FunctionSpace(msh, "RT", k), build_patches(msh),
                     dtype=dtype, device=device, max_patches_per_bucket=chunk)
    eng.mode, eng.solver, eng.combine = mode, solver, combine
    return eng


def _data(msh, k, n_rhs, seed, device="cpu", dtype=torch.float64):
    """Random DG data (tensors on ``device``) and host boundary data: each
    boundary facet, at random, primal Dirichlet (kind 1) or flux-essential
    (2) with random facet values."""
    rng = np.random.default_rng(seed)
    nc, nf, ndg = msh.num_cells, msh.num_facets, k * (k + 1) // 2
    dp = torch.as_tensor(rng.normal(size=(n_rhs, nc, 2, ndg)), dtype=dtype,
                         device=device)
    dr = torch.as_tensor(rng.normal(size=(n_rhs, nc, ndg)), dtype=dtype,
                         device=device)
    bf = msh.boundary_facets
    fk = np.zeros((n_rhs, nf), dtype=np.int8)
    bv = np.zeros((n_rhs, nf, k))
    fk[:, bf] = rng.integers(1, 3, size=(n_rhs, len(bf)))
    bv[:, bf] = rng.normal(size=(n_rhs, len(bf), k))
    return dp, dr, fk, bv


def _bits(x):
    x = x.detach().cpu()
    return x.view(torch.int64 if x.dtype == torch.float64 else torch.int32)


def _assert_bitwise(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(_bits(got), _bits(want))


# --- on the CPU ---------------------------------------------------------------


@pytest.mark.parametrize("solver", ["kernel", "kernel_mixed", "torch"])
@pytest.mark.parametrize("weak_symmetry", [False, True])
@pytest.mark.parametrize("mode", ["semiexplicit", "kkt"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_eligible(device, mode, weak_symmetry, solver):
    """Only a CUDA engine's semi-explicit call without weak symmetry and
    with a solver other than "torch" runs stage 3 as a graph."""
    eng = SimpleNamespace(device=torch.device(device), mode=mode,
                          solver=solver)
    want = (device == "cuda" and mode == "semiexplicit"
            and not weak_symmetry and solver != "torch")
    assert stage_graph.eligible(eng, weak_symmetry) is want


# boundary-data buffers that live as long as the module, so that two keys
# built on one of them see the same address
_BUFS = {(n, dt): torch.zeros((n, 56), dtype=dt)
         for n in (1, 3) for dt in (torch.int8, torch.int64, torch.float32,
                                     torch.float64)}


def _key(n_rhs=1, dtype=torch.float64, solver="kernel", refine=1, ndg=3,
         fk_dtype=torch.int8):
    eng = SimpleNamespace(dtype=dtype, solver=solver,
                          mixed_refine_steps=refine)
    nc, nf = 32, 56
    return stage_graph.graph_key(
        eng, (n_rhs, 3, ndg, nc), _BUFS[(n_rhs, fk_dtype)],
        _BUFS[(n_rhs, dtype)][:, :, None].expand(n_rhs, nf, 2))


@pytest.mark.parametrize("change", [
    dict(n_rhs=3), dict(dtype=torch.float32), dict(solver="kernel_mixed"),
    dict(refine=2), dict(ndg=6), dict(fk_dtype=torch.int64)])
def test_key_changes(change):
    """The key follows the packed dof buffer's shape, the dtype, the
    solver, its refinement steps and the boundary-data buffers, and
    nothing else."""
    assert _key() == _key()
    assert _key(**change) != _key()


def test_holds_follows_key_and_tables():
    g = stage_graph.StageGraph(("key",), None, None)
    dev = {}
    assert g.holds(("key",), dev) and not g.holds(("other",), dev)
    g.dev = dev
    assert g.holds(("key",), dev) and not g.holds(("key",), {})


def test_launch_counts_since_and_add():
    """A capture's counts are the registry's since its snapshot; a replay
    adds them back, split by split."""
    reset_launches()
    before = _build.launch_counts()
    delta = {"K1": dict.fromkeys(before["K1"], 0), "K5": {None: 6}}
    delta["K1"]["tile"] = 2
    _build.add_launches(delta)
    since = _build.launch_counts(since=before)
    assert since["K1"]["tile"] == 2 and since["K5"] == {None: 6}
    assert sum(sum(c.values()) for c in since.values()) == 8
    _build.add_launches(since)
    assert launches()["K1"] == 4 and launches()["K5"] == 12
    assert launches(split=True)["K1"]["tile"] == 4
    reset_launches()
    assert not any(launches().values())


def _parent_path(eng, dp, dr, fk, bv, transposed=False):
    """The call as the engine ran it before the packing moved to the
    device: batch-last transposes (on the host for NumPy data), one
    ``torch.cat``, stage 3, the combine."""
    if transposed:
        dpT, drT = dp, dr
    elif isinstance(dp, np.ndarray):
        dpT, drT = eng.put_transposed(dp, dr)
    else:
        dpT = dp.to(eng.dtype).movedim(1, -1).contiguous()
        drT = dr.to(eng.dtype).movedim(1, -1).contiguous()
    dprT = torch.cat([dpT, drT[:, None]], dim=1)
    fk = torch.as_tensor(fk)
    bv = torch.as_tensor(bv, dtype=eng.dtype)
    return eng._combine_flat(eng._bucket_solutions(dprT, fk, bv))


@pytest.mark.parametrize("inputs", ["tensors", "numpy", "transposed"])
@pytest.mark.parametrize("n_rhs", [1, 3])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_cpu_engine_never_captures(k, n_rhs, inputs):
    """Repeated calls of one key on a CPU engine stay eager: no graph, no
    capture, no replay, and each output is the parent's bit for bit."""
    eng = _engine("unstructured7", k)
    for seed in range(3):
        dp, dr, fk, bv = _data(eng.mesh, k, n_rhs, seed)
        args = (dp, dr)
        if inputs == "numpy":
            args = (dp.numpy(), dr.numpy())
        elif inputs == "transposed":
            args = eng.put_transposed(dp.numpy(), dr.numpy())
        got = eng.equilibrate(*args, fk, bv,
                              transposed_inputs=inputs == "transposed")
        _assert_bitwise(got, _parent_path(eng, *args, fk, bv,
                                          inputs == "transposed"))
    assert eng._graph is None
    assert eng.graph_captures == eng.graph_replays == 0


@pytest.mark.parametrize("options", [
    dict(solver="kernel_mixed", combine="ds"), dict(solver="torch"),
    dict(dtype=torch.float32)])
def test_cpu_engine_options_never_capture(options):
    opts = dict(options)
    dtype = opts.pop("dtype", torch.float64)
    eng = _engine("crossed4", 2, dtype=dtype, **opts)
    for seed in range(3):
        dp, dr, fk, bv = _data(eng.mesh, 2, 2, seed, dtype=dtype)
        _assert_bitwise(eng.equilibrate(dp, dr, fk, bv),
                        _parent_path(eng, dp, dr, fk, bv))
    assert eng.graph_captures == eng.graph_replays == 0


# --- on the card --------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs capture and replay only "
                    "there")
    return torch.device("cuda", 0)


def _fresh(mesh, k, card, call, **options):
    """The eager first call of a fresh engine."""
    out = call(_engine(mesh, k, device=card, **options))
    torch.cuda.synchronize(card)
    return out


def _calls_of_one_key(eng, cases, call):
    """One call a case on ``eng``: the first eager, the second captured,
    the rest replayed; the outputs and the counters after each."""
    outs, counts = [], []
    for case in cases:
        outs.append(call(eng, case))
        torch.cuda.synchronize(eng.device)
        counts.append((eng.graph_captures, eng.graph_replays))
    assert counts[:3] == [(0, 0), (1, 1), (1, 2)]
    return outs


_CARD_CASES = [("crossed4", 2, 1), ("crossed4", 2, 3),
               ("unstructured7", 2, 1), ("unstructured7", 3, 3)]


@pytest.mark.card
@pytest.mark.parametrize("mesh,k,n_rhs", _CARD_CASES)
def test_replay_bitwise_eager(card, mesh, k, n_rhs):
    eng = _engine(mesh, k, device=card)
    cases = [_data(eng.mesh, k, n_rhs, seed, card) for seed in range(4)]

    def call(e, c):
        return e.equilibrate(*c)

    outs = _calls_of_one_key(eng, cases, call)
    for case, got in zip(cases, outs):
        _assert_bitwise(got, _fresh(mesh, k, card, lambda e: call(e, case)))


@pytest.mark.card
@pytest.mark.parametrize("options", [
    dict(transposed=True), dict(solver="kernel_mixed"),
    dict(combine="ds"), dict(solver="kernel_mixed", combine="ds"),
    dict(tensor_bcs=True), dict(dtype=torch.float32)])
def test_replay_bitwise_eager_options(card, options):
    opts = dict(options)
    transposed = opts.pop("transposed", False)
    tensor_bcs = opts.pop("tensor_bcs", False)
    dtype = opts.get("dtype", torch.float64)
    eng = _engine("unstructured7", 2, device=card, **opts)
    cases = [_data(eng.mesh, 2, 2, seed, card, dtype) for seed in range(4)]

    def call(e, c):
        dp, dr, fk, bv = c
        if transposed:
            dp, dr = e.put_transposed(dp.cpu().numpy(), dr.cpu().numpy())
        if tensor_bcs:
            fk = torch.as_tensor(fk, device=card)
            bv = torch.as_tensor(bv, dtype=dtype, device=card)
        return e.equilibrate(dp, dr, fk, bv, transposed_inputs=transposed)

    outs = _calls_of_one_key(eng, cases, call)
    for case, got in zip(cases, outs):
        _assert_bitwise(got, _fresh("unstructured7", 2, card,
                                    lambda e: call(e, case), **opts))


@pytest.mark.card
def test_changed_boundary_data_between_replays(card):
    """One set of dof data, new host boundary data (flux-essential facets
    with new values) on every call: each replay sees its own."""
    eng = _engine("crossed4", 3, device=card)
    dp, dr = _data(eng.mesh, 3, 1, 0, card)[:2]
    bcs = [_data(eng.mesh, 3, 1, seed)[2:] for seed in range(1, 6)]
    outs = _calls_of_one_key(eng, [(dp, dr, *bc) for bc in bcs],
                             lambda e, c: e.equilibrate(*c))
    for bc, got in zip(bcs, outs):
        _assert_bitwise(got, _fresh("crossed4", 3, card,
                                    lambda e: e.equilibrate(dp, dr, *bc)))
    assert not torch.equal(outs[2], outs[3])


@pytest.mark.card
def test_eight_calls_in_flight(card):
    """8 replays queued, one sync after the last: each output is its case's
    strict result bit for bit, in storage of its own."""
    eng = _engine("unstructured7", 2, device=card)
    cases = [_data(eng.mesh, 2, 1, seed, card) for seed in range(8)]
    strict = []
    for case in cases:
        strict.append(eng.equilibrate(*case))
        torch.cuda.synchronize(card)
    assert eng.graph_captures == 1
    out = [eng.equilibrate(*case) for case in cases]
    torch.cuda.synchronize(card)
    assert eng.graph_replays == 7 + 8
    assert len({x.data_ptr() for x in out}) == 8
    for got, want in zip(out, strict):
        _assert_bitwise(got, want)


@pytest.mark.card
def test_replayed_call_counts_the_eager_launches(card):
    eng = _engine("unstructured7", 2, device=card)
    case = _data(eng.mesh, 2, 3, 0, card)
    eng._device_tables()  # its interior inverse builds launch K1 once
    per_call = []
    for _ in range(4):
        reset_launches()
        eng.equilibrate(*case)
        torch.cuda.synchronize(card)
        per_call.append((launches(), launches(split=True)))
    assert eng.graph_captures == 1 and eng.graph_replays == 3
    assert per_call[0][0]["K5"] == per_call[0][0]["K6"] == len(eng.buckets)
    assert all(c == per_call[0] for c in per_call[1:])


# the launch registry's kernel of a kernel name in a profiler trace (K4's
# name holds K2's: test it first)
_TRACE_NAMES = (("K4", "ds_combine_gather_kernel"),
                ("K2", "combine_gather_kernel"), ("K1", "lu_solve_bl"),
                ("K3", "lu_solve_bm"), ("K5", "load_moments_kernel"),
                ("K6", "reduced_step_kernel"))


def _traced_kernels(call, device) -> dict:
    """The port's kernels that ``call`` ran on the device, counted by name
    in a profiler trace of it."""
    act = torch.profiler.ProfilerActivity.CUDA
    with torch.profiler.profile(activities=[act]) as prof:
        call()
        torch.cuda.synchronize(device)
    counts = {}
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA"):
            continue
        kernel = next((k for k, part in _TRACE_NAMES if part in e.name()),
                      None)
        if kernel is not None:
            counts[kernel] = counts.get(kernel, 0) + 1
    return counts


@pytest.mark.card
@pytest.mark.parametrize("options", [
    dict(), dict(solver="kernel_mixed", combine="ds")])
def test_replay_trace_runs_the_counted_kernels(card, options):
    """A replayed call's kernels, counted by name in a profiler trace, are
    the ones the registry counts for it: the graph's launches, which the
    capture took and each replay adds back, and the eager combine."""
    eng = _engine("unstructured7", 2, device=card, **options)
    case = _data(eng.mesh, 2, 3, 0, card)
    for _ in range(2):
        eng.equilibrate(*case)
    torch.cuda.synchronize(card)
    reset_launches()
    traced = _traced_kernels(lambda: eng.equilibrate(*case), card)
    assert eng.graph_captures == 1 and eng.graph_replays == 2
    counted = {k: n for k, n in launches().items() if n}
    assert traced == counted
    in_graph = {k: sum(c.values()) for k, c in eng._graph.launches.items()
                if sum(c.values())}
    combine = "K4" if eng.combine == "ds" else "K2"
    assert counted == {**in_graph, combine: 1}
    assert in_graph["K5"] == in_graph["K6"] == len(eng.buckets)
    assert in_graph["K1"] > 0


@pytest.mark.card
def test_input_layouts_share_one_graph(card):
    """Batch-major tensors and ``put_transposed``'s batch-last pair pack to
    the same buffer: alternating them replays one graph, bit for bit."""
    eng = _engine("crossed4", 2, device=card)
    dp, dr, fk, bv = _data(eng.mesh, 2, 1, 0, card)
    dpT, drT = eng.put_transposed(dp.cpu().numpy(), dr.cpu().numpy())
    want = _fresh("crossed4", 2, card,
                  lambda e: e.equilibrate(dp, dr, fk, bv))
    for i in range(5):
        got = (eng.equilibrate(dpT, drT, fk, bv, transposed_inputs=True)
               if i % 2 else eng.equilibrate(dp, dr, fk, bv))
        torch.cuda.synchronize(card)
        _assert_bitwise(got, want)
    assert eng.graph_captures == 1 and eng.graph_replays == 4


@pytest.mark.card
def test_spans_of_eager_capture_and_replay(card):
    """The per-bucket spans on the eager and capture calls, one
    ``se.graph`` span on the capture (``route`` capture) and replay
    calls, inside ``eqlb.call``."""
    eng = _engine("crossed4", 2, device=card)
    case = _data(eng.mesh, 2, 1, 0, card)
    seen = []
    for _ in range(3):
        with recording() as recs:
            eng.equilibrate(*case)
        torch.cuda.synchronize(card)
        (call,) = [r for r in recs if r.name == "eqlb.call"]
        graphs = [r for r in recs if r.name == "se.graph"]
        assert all(r.parent_id == call.span_id for r in graphs)
        seen.append((sum(r.name == "se.bucket" for r in recs),
                     [r.attrs["route"] for r in graphs]))
    nb = len(eng.buckets)
    assert seen == [(nb, []), (nb, ["capture"]), (0, ["replay"])]


@pytest.mark.card
def test_new_key_and_rebuilt_tables_drop_the_graph(card):
    """n_rhs 1 -> 3 -> 1 and the device tables rebuilt: each change runs
    eagerly, then captures anew; every output is the fresh engine's."""
    eng = _engine("crossed4", 2, device=card)
    one = _data(eng.mesh, 2, 1, 0, card)
    three = _data(eng.mesh, 2, 3, 1, card)
    want = {n: _fresh("crossed4", 2, card, lambda e: e.equilibrate(*c))
            for n, c in ((1, one), (3, three))}
    plan = [(1, 0), (1, 1), (1, 1), (3, 1), (3, 2), (1, 2), (1, 3)]
    for n_rhs, captures in plan:
        got = eng.equilibrate(*(one if n_rhs == 1 else three))
        torch.cuda.synchronize(card)
        _assert_bitwise(got, want[n_rhs])
        assert eng.graph_captures == captures
    eng._dev = None
    for captures in (3, 4, 4):
        _assert_bitwise(eng.equilibrate(*one), want[1])
        torch.cuda.synchronize(card)
        assert eng.graph_captures == captures


@pytest.mark.card
@pytest.mark.parametrize("path", ["weak_symmetry", "torch", "kkt"])
def test_paths_that_never_capture(card, path):
    mode = "kkt" if path == "kkt" else "semiexplicit"
    solver = "torch" if path == "torch" else "kernel"
    k = 3 if path == "kkt" else 2
    eng = _engine("crossed4", k, mode=mode, device=card, solver=solver)
    case = _data(eng.mesh, k, 2, 0, card)
    outs = [eng.equilibrate(*case, weak_symmetry=path == "weak_symmetry")
            for _ in range(3)]
    torch.cuda.synchronize(card)
    assert eng._graph is None
    assert eng.graph_captures == eng.graph_replays == 0
    for got in outs[1:]:
        _assert_bitwise(got, outs[0])
