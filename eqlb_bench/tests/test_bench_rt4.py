"""The RT4 cell ``ev_rt4_unstructured_250k.strict`` on the CPU at a tiny
size (``unit_square_unstructured(7)``, interior KKT systems of D = 104-208):
``test_bench_run.py``'s checks of the result line, the planted faults and
the control against the program, run on this cell, and the reader of K3's
cluster route.

The reference solves systems of D >= 156 here, which ``torch.linalg.solve``
on the CPU build of torch (MKL) can hang on with more than one thread: the
tests of this file run on one."""

from types import SimpleNamespace

import pytest
import torch

from eqlb_bench import cells, tracing

from . import test_bench_run as base

WORKLOAD = "ev_rt4_unstructured_250k.strict"


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(tiny_bench, trace):
    base.test_result_line(tiny_bench, WORKLOAD, trace)
    cell = cells.find(WORKLOAD, tiny_bench)
    names = {m.name for m in (cell.per_layer if trace else cell.end_to_end)}
    assert ("k3_cluster_device_ms" in names) is trace
    assert "call_p95_ms" not in names


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_planted_faults_are_not_correct(tiny_bench, fault, monkeypatch):
    base.test_planted_faults_are_not_correct(tiny_bench, WORKLOAD, fault,
                                             monkeypatch)


def test_control_fails_and_the_program_passes(tmp_path, monkeypatch):
    base.test_control_fails_and_the_program_passes(
        "ev_rt4_unstructured_250k", tmp_path, monkeypatch)


def test_cluster_reader_reads_only_the_cluster_route():
    read = cells.load_reader("k3_cluster_device_ms")
    st = tracing.Stretch(calls=2, window_s=1.0, busy_s=1.0, ops=[
        ("void (anonymous namespace)::lu_solve_bm_cluster_kernel<double, 2, 5, 10, 1>", 0.010),
        ("void (anonymous namespace)::lu_solve_bm_cluster_kernel<double, 4, 3, 12, 2>", 0.004),
        ("void (anonymous namespace)::lu_solve_bm_reg_kernel<double, 16, 16, 6, 6>", 0.100),
        ("void (anonymous namespace)::lu_solve_bm_kernel<double>", 0.200),
        ("sm90_xmma_gemm_f64f64_f64f64_f64_nt_n", 0.400),
    ])
    assert read(SimpleNamespace(stretch=st)) == pytest.approx(1e3 * 0.014 / 2)
    st.ops = [op for op in st.ops if "cluster" not in op[0]]
    assert read(SimpleNamespace(stretch=st)) is None
    assert read(SimpleNamespace(stretch=None)) is None
    st.calls = 0
    assert read(SimpleNamespace(stretch=st)) is None
