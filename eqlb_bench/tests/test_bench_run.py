"""Whole runs of the harness on the CPU at tiny sizes: the result line, the
refusal without a card, the control and the planted faults."""

import json
import os
import subprocess
import sys

import pytest
import torch

from eqlb_bench import calibrate, cells, run
from eqlb_bench.program import Program

from .conftest import ROOT, TINY_N

WORKLOADS = ["se_rt2_crossed_1m.strict", "ev_rt3_unstructured_1m.strict",
             "se_rt2_crossed_1m.inflight8"]


def _run(bench_path, workload, trace=False, seconds=0.3, seed=2**31 + 3):
    cell = cells.find(workload, bench_path)
    return run.run_cell(cell, seed, seconds, trace, "cpu")


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(tiny_bench, workload, trace):
    result, compared = _run(tiny_bench, workload, trace)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    cell = cells.find(workload, tiny_bench)
    names = {m.name for m in (cell.per_layer if trace else cell.end_to_end)}
    # the CPU has no device trace and no allocator peak: those stay out
    host_only = {"setup_s", "call_ms", "call_p95_ms", "host_tables_s",
                 "geometry_caches_s", "dispatch_ms"}
    assert set(result["metrics"]) == names & host_only
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(compared) == {"max_rel_err"}
    assert compared["max_rel_err"]["value"] < compared["max_rel_err"]["limit"]
    json.dumps(dict(result, compared=compared), allow_nan=False)


def test_no_card_no_result():
    """Without a card the command prints no result and exits non-zero
    (on a machine with a card the test has nothing to show)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "eqlb_bench.run", "--workload",
                        WORKLOADS[0], "--seed", str(2**31 + 9), "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_modules_named():
    assert run.forbidden_modules() == []
    sys.modules["jaxlib"] = None
    try:
        assert run.forbidden_modules() == ["jaxlib"]
    finally:
        del sys.modules["jaxlib"]


@pytest.mark.parametrize("name", ["se_rt2_crossed_1m", "ev_rt3_unstructured_1m"])
def test_control_fails_and_the_program_passes(name, tmp_path, monkeypatch):
    """The configuration's limit lies between the program's readings and
    the control's (the engine in f32) on a tiny mesh, three seeds."""
    monkeypatch.setattr(run, "CACHE", str(tmp_path))
    with open(os.path.join(ROOT, "eqlb_bench", "configs", f"{name}.json")) as f:
        conf = json.load(f)
    limit = conf["limits"]["max_rel_err"]
    conf = dict(conf, name=name, mesh_n=TINY_N[conf["mesh"]])
    with open(os.path.join(ROOT, "eqlb_bench", "traffic", "strict.json")) as f:
        traffic = json.load(f)
    lines = calibrate.readings(conf, traffic, [1, 2, 3], [1, 2, 3], "cpu",
                               emit=lambda s: None)
    prog = [x["max_rel_err"] for x in lines if x["side"] == "program"]
    ctrl = [x["max_rel_err"] for x in lines if x["side"] == "control"]
    assert len(prog) == len(ctrl) == 3
    assert max(prog) < limit < min(ctrl)


def _stale(orig):
    """A call that returns the state it first produced, unchanged."""
    first = {}

    def call(self, dp, dr):
        if "x" not in first:
            first["x"] = orig(self, dp, dr)
        return first["x"].clone()
    return call


def _altered(orig):
    """An answer altered where it is produced: one dof moved by 1e-6 of
    the largest."""
    def call(self, dp, dr):
        x = orig(self, dp, dr)
        x[0, x.shape[1] // 3] += 1e-6 * x.abs().max()
        return x
    return call


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_planted_faults_are_not_correct(tiny_bench, workload, fault,
                                        monkeypatch):
    """The rest of a run, the timed path broken underneath: ``correct``
    comes out false.  ``half``: half of the patch solutions left out of
    the combine."""
    from dolfinx_eqlb_tpu_torch.eqlb.engine import EqlbEngine

    if fault == "half":
        orig = EqlbEngine._combine_flat

        def half(self, flat):
            flat = flat.clone()
            flat[:, flat.shape[1] // 2:] = 0
            return orig(self, flat)
        monkeypatch.setattr(EqlbEngine, "_combine_flat", half)
    else:
        plant = {"stale": _stale, "altered": _altered}[fault]
        monkeypatch.setattr(Program, "__call__", plant(Program.__call__))
    result, compared = _run(tiny_bench, workload)
    assert result["correct"] is False and result["failed"] >= 1
    c = compared["max_rel_err"]
    assert not c["value"] <= c["limit"]
