"""BENCHMARK.json against the rules of its format that a file can show
(keys, names, units, bounds, cells), and the cells, mixes and metrics the
harness finds by name."""

import json
import os
import re

import pytest

from eqlb_bench import cells

from .conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_names_and_units(bench):
    assert set(bench) == KEYS["top"]
    assert bench["paths"] == ["eqlb_bench"]
    assert 1 <= bench["run_seconds"] <= 51
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[part]]
        assert len(set(names)) == len(names)
        for e in bench[part]:
            extra = set(e) - KEYS[part]
            assert extra <= ({"workloads"} if part in ("end_to_end", "per_layer")
                             else set()), extra
            assert KEYS[part] <= set(e)
            assert NAME.match(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]


def test_cells_metrics_and_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    cellnames = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert w["chips"] == 1
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        cell = cells.find(w["name"], os.path.join(ROOT, "BENCHMARK.json"))
        assert {m.name for m in cell.end_to_end} >= {"setup_s", "call_ms", "peak_mem_gib"}
        assert cell.per_layer
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cellnames)) <= cellnames
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert set(c["reduced"]) <= set(conf)
        assert conf["limits"]["max_rel_err"] > 0


def test_every_metric_has_a_reader(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(cells.load_reader(m["name"]))


def test_a_new_cell_mix_and_metric_are_found_by_name(bench, bench_copy, tmp_path):
    """A later cell brings a mix and a metric as new files and entries: the
    harness finds them without an edit."""
    (bench_copy / "traffic" / "burst4.json").write_text(json.dumps(
        {"in_flight": 4, "load_cases": 4, "warmup_groups": 1,
         "trace_groups": 1}))
    (bench_copy / "metrics" / "calls_in_window.py").write_text(
        "def read(ctx):\n    return float(ctx.calls)\n")
    new = dict(bench)
    new["configs"] = [dict(c, file=os.path.join(ROOT, c["file"]))
                      for c in bench["configs"]]
    new["workloads"] = bench["workloads"] + [
        {"name": "se_rt2_crossed_1m.burst4", "config": "se_rt2_crossed_1m",
         "traffic": "burst4", "chips": 1, "why": "a test cell"}]
    new["per_layer"] = bench["per_layer"] + [
        {"name": "calls_in_window", "unit": "calls", "better": "higher",
         "source": "host_clock", "layer": "device", "moves": "call_ms",
         "workloads": ["se_rt2_crossed_1m.burst4"]}]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(new))
    cell = cells.find("se_rt2_crossed_1m.burst4", str(path), root=str(bench_copy))
    assert cell.traffic["in_flight"] == 4
    assert cell.config["mode"] == "semiexplicit"
    reader = {m.name: m.read for m in cell.per_layer}["calls_in_window"]
    assert reader(type("Ctx", (), {"calls": 12})) == 12.0
    old = cells.find("se_rt2_crossed_1m.strict", str(path), root=str(bench_copy))
    assert "calls_in_window" not in {m.name for m in old.per_layer}
    with pytest.raises(KeyError):
        cells.find("nope.strict", str(path), root=str(bench_copy))
