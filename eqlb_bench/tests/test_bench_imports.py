"""What a run loads: nothing of JAX or of the JAX package anywhere, and
nothing of the program in the reference (top-level names compared whole)."""

import glob
import os
import subprocess
import sys

from .conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "dolfinx_eqlb_tpu")


def _loaded(code: str) -> set[str]:
    p = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       check=True)
    return set(p.stdout.split())


def test_harness_reference_and_metrics_load_no_jax():
    metrics = sorted(os.path.basename(p)[:-3] for p in
                     glob.glob(os.path.join(ROOT, "eqlb_bench", "metrics", "*.py")))
    code = ("import eqlb_bench.run, eqlb_bench.calibrate, eqlb_bench.program\n"
            "import eqlb_bench.reference.kkt, eqlb_bench.check, eqlb_bench.data\n"
            "from eqlb_bench.cells import load_reader\n"
            f"[load_reader(m) for m in {metrics!r}]\n")
    top = _loaded(code)
    assert "dolfinx_eqlb_tpu_torch" in top  # the program is loaded ...
    assert not top & set(FORBIDDEN)  # ... and nothing of JAX


def test_reference_loads_nothing_of_the_program():
    top = _loaded("import eqlb_bench.reference.kkt, eqlb_bench.reference.element\n"
                  "import eqlb_bench.reference.topology, eqlb_bench.check\n"
                  "import eqlb_bench.data, eqlb_bench.meshes, eqlb_bench.roofline")
    assert "dolfinx_eqlb_tpu_torch" not in top
    assert not top & set(FORBIDDEN)
