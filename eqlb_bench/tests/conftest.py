"""Tests of the benchmark, on the CPU at tiny sizes; the tests marked
``card`` need a CUDA card and skip without one (decided in a fixture)."""

import json
import os
import shutil

import pytest
import torch

from eqlb_bench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# tiny meshes of each configuration's generator for the CPU
TINY_N = {"crossed": 4, "unstructured": 7}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")
    torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def tiny_bench(tmp_path, monkeypatch):
    """BENCHMARK.json with every configuration cut to a tiny mesh, in a
    temporary directory; the mesh cache there too.  Returns its path."""
    monkeypatch.setattr(run, "CACHE", str(tmp_path / "cache"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        conf["mesh_n"] = TINY_N[conf["mesh"]]
        c["file"] = f"{c['name']}.json"
        with open(tmp_path / c["file"], "w") as f:
            json.dump(conf, f)
    path = tmp_path / "BENCHMARK.json"
    with open(path, "w") as f:
        json.dump(bench, f)
    return str(path)


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of the benchmark's folder, to add files to."""
    dst = tmp_path / "eqlb_bench"
    shutil.copytree(os.path.join(ROOT, "eqlb_bench"), dst,
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    return dst
