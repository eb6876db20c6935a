"""On a card: one short run of each cell through the command, its last line
parsed (python -m pytest eqlb_bench/tests -m card)."""

import json
import subprocess
import sys

import pytest

from .conftest import ROOT


@pytest.mark.card
@pytest.mark.parametrize("workload", ["se_rt2_crossed_1m.strict",
                                      "ev_rt3_unstructured_1m.strict",
                                      "se_rt2_crossed_1m.inflight8"])
def test_cell_runs_correct_on_the_card(card, workload):
    p = subprocess.run([sys.executable, "-m", "eqlb_bench.run", "--workload",
                        workload, "--seed", str(2**31 + 21), "--seconds", "3",
                        "--trace", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
