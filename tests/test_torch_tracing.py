"""The program's spans (``utils.profiling``: ``span``, ``annotate``,
``recording``) on the CPU at tiny sizes: the span tree of one
semi-explicit call (crossed mesh, RT2) and one KKT call (unstructured
mesh, RT3), the outputs with recording on and off, the off state, and a
span raised through."""

import time

import numpy as np
import pytest
import torch

from dolfinx_eqlb_tpu_torch.eqlb.engine import EqlbEngine
from dolfinx_eqlb_tpu_torch.eqlb.patches import build_patches
from dolfinx_eqlb_tpu_torch.fem import FunctionSpace
from dolfinx_eqlb_tpu_torch.mesh import generators as gen
from dolfinx_eqlb_tpu_torch.utils import profiling
from dolfinx_eqlb_tpu_torch.utils.profiling import annotate, recording, span

torch.set_num_threads(2)

# mode -> (mesh, k, max_patches_per_bucket): the chunk splits a bucket, so
# chunked keys are in the tree too
_CASES = {
    "semiexplicit": (lambda: gen.unit_square(3), 2, 8),
    "kkt": (lambda: gen.unit_square_unstructured(4), 3, 16),
}
_STAGES = {
    "semiexplicit": ("se.bucket", ["se.load_moments", "se.explicit",
                                   "se.reduced_rhs", "se.reduced_solve"]),
    "kkt": ("kkt.bucket", ["kkt.assemble", "kkt.solve"]),
}


@pytest.fixture(scope="module", params=list(_CASES))
def setup(request):
    """(mode, engine, inputs): one RHS, random DG data, the boundary
    primal Dirichlet with zero data, host arrays as ``_solve`` hands
    them; the engine called once, so its geometry caches (built by the
    first call) are in place."""
    mode = request.param
    mesh_fn, k, chunk = _CASES[mode]
    msh = mesh_fn()
    eng = EqlbEngine(FunctionSpace(msh, "RT", k), build_patches(msh),
                     dtype=torch.float64, device="cpu",
                     max_patches_per_bucket=chunk)
    eng.mode = mode
    rng = np.random.default_rng(3)
    nc, nf, ndg = msh.num_cells, msh.num_facets, k * (k + 1) // 2
    dp = torch.as_tensor(rng.normal(size=(1, nc, 2, ndg)))
    dr = torch.as_tensor(rng.normal(size=(1, nc, ndg)))
    fk = np.zeros((1, nf), dtype=np.int8)
    fk[:, msh.boundary_facets] = 1
    bv = np.zeros((1, nf, k))
    eng.equilibrate(dp, dr, fk, bv)
    return mode, eng, (dp, dr, fk, bv)


def _children(records, parent):
    return sorted((r for r in records if r.parent_id == parent.span_id),
                  key=lambda r: r.t0_ns)


def test_span_tree_of_one_call(setup):
    mode, eng, inputs = setup
    with recording() as records:
        eng.equilibrate(*inputs)
    roots = [r for r in records if r.parent_id == 0]
    assert [r.name for r in roots] == ["eqlb.call"]
    call = roots[0]
    assert call.attrs == {"mode": mode, "n_rhs": 1,
                          "buckets": len(eng.buckets)}
    assert {r.call_id for r in records} == {call.span_id}
    assert len({r.span_id for r in records}) == len(records)
    by_id = {r.span_id: r for r in records}
    for r in records:
        assert r.t0_ns <= r.t1_ns and r.thread_id == call.thread_id
        if r.parent_id:
            p = by_id[r.parent_id]
            assert p.t0_ns <= r.t0_ns and r.t1_ns <= p.t1_ns

    bucket, stages = _STAGES[mode]
    top = _children(records, call)
    nb = len(eng.buckets)
    assert [r.name for r in top] == (["eqlb.input"] + [bucket] * nb
                                     + ["eqlb.concat", "eqlb.combine"])
    assert all(not _children(records, r) for r in top if r.name != bucket)
    assert [r.attrs["key"] for r in top[1:1 + nb]] == sorted(eng.buckets)
    for b in top[1:1 + nb]:
        assert [r.name for r in _children(records, b)] == stages
        size = "Dz" if mode == "semiexplicit" else "D"
        assert set(b.attrs) == {"key", "P", "boundary", size}
        assert b.attrs["boundary"] == eng.buckets[b.attrs["key"]].is_boundary
        solve = _children(records, b)[-1]
        assert solve.attrs["route"] != ""
        if mode == "semiexplicit":
            inverse = solve.attrs["route"] == "inverse"
            assert inverse == (not b.attrs["boundary"])
        else:
            assert solve.attrs["route"] != "linalg"  # K3 takes every D here
            asm = _children(records, b)[0]
            assert [r.name for r in _children(records, asm)] == [
                "kkt.element_data"]


def test_outputs_equal_with_recording_on_and_off(setup):
    _, eng, inputs = setup
    off = eng.equilibrate(*inputs)
    with recording() as records:
        on = eng.equilibrate(*inputs)
    assert records
    assert torch.equal(off, on)


def test_off_records_nothing_and_reads_no_clock(setup, monkeypatch):
    _, eng, inputs = setup
    with recording() as closed:
        pass
    reads = []
    clock = time.time_ns

    def counting():
        reads.append(1)
        return clock()
    monkeypatch.setattr(time, "time_ns", counting)
    eng.equilibrate(*inputs)
    assert reads == [] and closed == []
    assert span("a", x=1) is span("b")  # one shared no-op object


def test_span_raised_through_closes_and_recording_restores_off():
    assert profiling._recorder is None
    with pytest.raises(RuntimeError):
        with recording() as records:
            with span("outer"):
                annotate(step=1)
                with span("inner"):
                    raise RuntimeError("stage failed")
    assert profiling._recorder is None
    inner, outer = records
    assert (inner.name, outer.name) == ("inner", "outer")
    assert inner.parent_id == outer.span_id and outer.attrs == {"step": 1}
    assert outer.t0_ns <= inner.t0_ns <= inner.t1_ns <= outer.t1_ns
    with recording() as outer_records:
        with recording() as inner_records:
            with span("a"):
                pass
        annotate(ignored=True)  # no span open: nothing to annotate
        with span("b"):
            pass
    assert profiling._recorder is None
    assert [r.name for r in inner_records] == ["a"]
    assert [r.name for r in outer_records] == ["b"]
    assert outer_records[0].parent_id == 0
