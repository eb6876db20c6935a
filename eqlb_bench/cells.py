"""What ``BENCHMARK.json`` names, found by name: a cell's configuration
(``configs/<config>.json``, through the file ``BENCHMARK.json`` gives), its
traffic mix (``traffic/<traffic>.json``) and the reader of each of its
metrics (``metrics/<metric>.py``).  A later cell, mix or metric is added as
files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Metric:
    name: str
    unit: str
    read: object  # read(ctx) -> float | None


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[Metric]
    per_layer: list[Metric]


def load_reader(name: str, root: str = HERE):
    """``read`` of ``metrics/<name>.py``."""
    path = os.path.join(root, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"eqlb_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _metrics(entries, cell: str, root: str) -> list[Metric]:
    return [Metric(m["name"], m["unit"], load_reader(m["name"], root))
            for m in entries if cell in m.get("workloads", [cell])]


def find(workload: str, benchmark: str = "BENCHMARK.json",
         root: str = HERE) -> Cell:
    """The cell ``workload`` of ``benchmark``; file paths in it are taken
    from the directory that holds it."""
    with open(benchmark) as f:
        bench = json.load(f)
    base = os.path.dirname(os.path.abspath(benchmark))
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in {benchmark}")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(base, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "traffic", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    return Cell(name=workload, chips=cell["chips"], config=config,
                traffic=traffic,
                end_to_end=_metrics(bench["end_to_end"], workload, root),
                per_layer=_metrics(bench["per_layer"], workload, root))
