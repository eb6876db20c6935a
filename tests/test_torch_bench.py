"""The port's bench (``dolfinx_eqlb_tpu_torch.bench``) against the JAX
package's ``bench.py``, on the CPU at small sizes:

* ``_make_data`` against ``bench._make_data`` on ``unit_square(4)`` at
  k = 2: the random data bitwise; ``--mixed``'s curl-field data within
  1e-12 max(1, max|d|); ``--biot``'s fields in f64 on
  ``mesh_hierarchy(unit_square(4), 2)`` within 1e-9 max|d| (both solves
  stop at MINRES rtol 1e-10);
* ``main(n=4, device="cpu")`` in the four modes: two JSON lines, strict
  first, with ``bench.py``'s keys and the port's extras, ``value > 0``,
  no ``"error"``, and the returned solution against JAX's ``EqlbEngine``
  (f64, its plain route) on the port's data: within 1e-9 max(1, max|x|)
  under ``--mixed`` (f64), and at the other modes' f32 within 1e-4 (1e-3
  with weak symmetry), the f32 bars of ``chip_smoke.py``.  ``--biot``
  rounds n = 4 up to 4,096 cells;
* the f32 modes' engine settings (``bench.CHUNK``) in f64 on the same
  data against JAX's f64 engine within 1e-11 max(1, max|x|);
* without a card and without ``--device`` both launchers print the
  failure line and exit non-zero;
* importing the bench imports no jax."""

import contextlib
import io
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from dolfinx_eqlb_tpu.eqlb.engine import EqlbEngine as JaxEngine
from dolfinx_eqlb_tpu.eqlb.patches import build_patches as jax_patches
from dolfinx_eqlb_tpu.fem import FunctionSpace as JaxSpace
from dolfinx_eqlb_tpu.fem.multigrid import mesh_hierarchy as jax_hierarchy
from dolfinx_eqlb_tpu.mesh import unit_square as jax_unit_square

from dolfinx_eqlb_tpu_torch import bench as tbench
from dolfinx_eqlb_tpu_torch.eqlb.engine import EqlbEngine
from dolfinx_eqlb_tpu_torch.eqlb.patches import build_patches
from dolfinx_eqlb_tpu_torch.fem import FunctionSpace
from dolfinx_eqlb_tpu_torch.fem.multigrid import mesh_hierarchy
from dolfinx_eqlb_tpu_torch.mesh import unit_square

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# bench.py's keys of each line, then the port's extras
STRICT_KEYS = {"metric", "value", "unit", "vs_baseline", "latency_ms"}
PIPELINED_KEYS = STRICT_KEYS | {"pipelined_ms"}
MIXED_KEYS = {"divergence_max_err", "divergence_max_err_host_f64",
              "divergence_rel_err"}
EXTRA_KEYS = {"latency_median_ms", "latency_samples_ms", "device", "data_s",
              "engine_tables_s", "geometry_caches_s", "first_call_s",
              "peak_mem_gib", "launches"}

MODES = {"default": {}, "stress": {"stress": True}, "mixed": {"mixed": True},
         "biot": {"biot": True}}


@pytest.fixture(scope="module")
def jax_engines():
    """JAX's f64 engines (the plain "xla" route) by mesh, built once."""
    engines = {}

    def get(name):
        if name not in engines:
            if name == "biot":
                msh = jax_hierarchy(jax_unit_square(16), 2)[-1]
                assert np.array_equal(msh.cells, _bench_mesh("biot").cells)
            else:
                msh = jax_unit_square(4)
            engines[name] = JaxEngine(JaxSpace(msh, "RT", 2),
                                      jax_patches(msh), dtype=jnp.float64)
        return engines[name]

    return get


def _same(got, want):
    d_proj, d_rhs, fk, bv, nf = got
    assert nf == want[4]
    for a, b in zip((d_proj, d_rhs, fk, bv), want[:4]):
        assert a.dtype == b.dtype and a.shape == b.shape
    return got


@pytest.mark.parametrize("n_fields, stress", [(1, False), (3, False),
                                              (1, True)])
def test_make_data_random_bitwise(n_fields, stress):
    args = (2, n_fields, stress, False, np.float32)
    want = jbench._make_data(jax_unit_square(4), *args)
    got = _same(tbench._make_data(unit_square(4), *args, device="cpu"), want)
    for a, b in zip(got[:4], want[:4]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("n_fields, stress", [(1, False), (1, True)])
def test_make_data_curl_fields(n_fields, stress):
    args = (2, n_fields, stress, False, np.float64)
    want = jbench._make_data(jax_unit_square(4), *args)
    got = _same(tbench._make_data(unit_square(4), *args, device="cpu"), want)
    assert np.array_equal(got[2], want[2]) and np.array_equal(got[3], want[3])
    assert not np.any(got[1])
    for a, b in zip(got[:2], want[:2]):
        assert np.abs(a - b).max() <= 1e-12 * max(1.0, np.abs(b).max())


def test_make_data_biot_f64():
    args = (2, 1, False, True, np.float64)
    jmeshes = jax_hierarchy(jax_unit_square(4), 2)
    want = jbench._make_data(jmeshes[-1], *args, mg_meshes=jmeshes)
    meshes = mesh_hierarchy(unit_square(4), 2)
    got = _same(tbench._make_data(meshes[-1], *args, mg_meshes=meshes,
                                  device="cpu"), want)
    assert got[4] == 3
    assert np.array_equal(got[2], want[2]) and np.array_equal(got[3], want[3])
    for a, b in zip(got[:2], want[:2]):
        assert np.isfinite(a).all()
        assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max()


@pytest.fixture(scope="module")
def bench_runs():
    """``main(n=4, device="cpu")`` by mode, run once: its record and the
    lines it printed."""
    runs = {}

    def get(mode):
        if mode not in runs:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rec = tbench.main(n=4, device="cpu", **MODES[mode])
            runs[mode] = rec, out.getvalue().strip().splitlines()
        return runs[mode]

    return get


def _bench_mesh(mode):
    # bench.py's --biot rule at n = 4: two levels from 16
    return (mesh_hierarchy(unit_square(16), 2)[-1] if mode == "biot"
            else unit_square(4))


def _jax_solution(jax_engines, mode, data):
    d_proj, d_rhs, fk, bv = data
    eng = jax_engines("biot" if mode == "biot" else "square")
    return np.asarray(eng.equilibrate(
        d_proj.astype(np.float64), d_rhs.astype(np.float64), fk,
        bv.astype(np.float64), weak_symmetry=mode == "stress"))


@pytest.mark.parametrize("mode", list(MODES))
def test_main(mode, bench_runs, jax_engines):
    rec, out = bench_runs(mode)
    assert len(out) == 2
    lines = [json.loads(line) for line in out]
    assert lines == json.loads(json.dumps(rec["lines"]))
    strict, piped = lines
    extra = EXTRA_KEYS | {"pipelined_samples_ms"}
    if mode == "mixed":
        extra = extra | MIXED_KEYS | {"host_check_s"}
    assert set(strict) == STRICT_KEYS | (extra - {"pipelined_samples_ms"})
    assert set(piped) == PIPELINED_KEYS | extra
    assert strict["metric"] == piped["metric"] + " [strict latency]"
    cells = 4096 if mode == "biot" else 64
    assert f"{cells}-cell mesh, single chip" in piped["metric"]
    for line in lines:
        assert line["value"] > 0 and line["unit"] == "patches/s"
        assert line["vs_baseline"] is None and "error" not in line
        assert line["latency_ms"] == min(line["latency_samples_ms"])
        assert len(line["latency_samples_ms"]) == 5
        assert line["device"] == "cpu" and line["peak_mem_gib"] is None
        # the CPU takes the plain versions: no kernel launches
        launches = line["launches"]
        assert not any(launches["K1"].values())
        assert launches["K2"] == launches["K3"] == launches["K4"] == 0
        assert launches["K5"] == launches["K6"] == 0
        assert launches["pivoted_solves"] == (2 if mode == "stress" else 0)
    assert piped["pipelined_ms"] == min(piped["pipelined_samples_ms"])
    if mode == "mixed":
        assert piped["divergence_rel_err"] <= 1e-12
        assert piped["divergence_max_err_host_f64"] <= 1e-8

    d_proj = rec["data"][0]
    x = rec["x"].numpy()
    assert x.dtype == (np.float64 if mode == "mixed" else np.float32)
    assert x.shape[0] == d_proj.shape[0] == (3 if mode == "biot" else
                                             2 if mode == "stress" else 1)
    want = _jax_solution(jax_engines, mode, rec["data"])
    assert want.shape == x.shape
    if mode == "mixed":
        tol = 1e-9
    else:
        tol = 1e-3 if mode == "stress" else 1e-4
    assert np.isfinite(x).all()
    assert np.abs(x - want).max() <= tol * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("mode", ["default", "stress", "biot"])
def test_engine_f64_at_bench_chunk(mode, bench_runs, jax_engines):
    """The f32 modes' engine settings (chunk 131072, the default solver
    and combine) in f64 on the bench's data, against JAX's f64 engine
    within 1e-11 max(1, max|x|)."""
    rec, _ = bench_runs(mode)
    msh = _bench_mesh(mode)
    eng = EqlbEngine(FunctionSpace(msh, "RT", 2), build_patches(msh),
                     dtype=torch.float64, device="cpu",
                     max_patches_per_bucket=tbench.CHUNK)
    d_proj, d_rhs, fk, bv = rec["data"]
    x = eng.equilibrate(d_proj.astype(np.float64), d_rhs.astype(np.float64),
                        fk, bv.astype(np.float64),
                        weak_symmetry=mode == "stress").numpy()
    want = _jax_solution(jax_engines, mode, rec["data"])
    assert x.shape == want.shape and np.isfinite(x).all()
    assert np.abs(x - want).max() <= 1e-11 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("launcher", [
    ["-m", "dolfinx_eqlb_tpu_torch.bench"], ["bench_torch.py"]])
def test_no_card_fails_with_json(launcher):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, *launcher, "4"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last["value"] == 0.0 and "error" in last
    assert "CUDA card" in last["error"]


def test_imports_no_jax():
    code = ("import sys, dolfinx_eqlb_tpu_torch.bench; "
            "print(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'dolfinx_eqlb_tpu.')) "
            "or m == 'dolfinx_eqlb_tpu'))")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert res.stdout.strip() == "[]"
