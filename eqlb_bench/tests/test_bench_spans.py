"""A traced stretch credited to the program's spans (``eqlb_bench.spans``),
on synthetic profiler events, and the tool's flow on the CPU."""

import pytest

from dolfinx_eqlb_tpu_torch.utils.profiling import SpanRecord
from eqlb_bench import cells, spans, tracing

from .test_bench_tracing import _Ev


class _CEv(_Ev):
    """A profiler event with a CUPTI correlation id; runtime calls are on
    the host (``DeviceType.CPU``), the operations they launch on the
    device."""

    def __init__(self, name, s, e, corr, dev="DeviceType.CUDA"):
        super().__init__(name, s, e, dev=dev)
        self._c = corr

    def correlation_id(self):
        return self._c


def _rec(name, t0, t1, sid, parent=0, **attrs):
    return SpanRecord(name, t0, t1, sid, parent, 1, 7, attrs)


def _launch(name, t, corr):
    return _CEv(name, t, t + 5, corr, dev="DeviceType.CPU")


def _se_stretch():
    """One semi-explicit call in [100, 1400] (ns): dispatch to 1000, then
    the sync; a GEMM launched in ``se.load_moments`` runs while
    ``se.reduced_solve`` is open, K2 runs in the sync, one operation's
    launch is missing."""
    records = [
        _rec("eqlb.call", 100, 1000, 1, mode="semiexplicit", buckets=1),
        _rec("eqlb.input", 110, 200, 2, 1),
        _rec("se.bucket", 210, 700, 3, 1, key=(8, False), P=4, Dz=5,
             boundary=False),
        _rec("se.load_moments", 220, 300, 4, 3),
        _rec("se.reduced_solve", 310, 690, 5, 3, route="tile"),
        _rec("eqlb.concat", 710, 750, 6, 1),
        _rec("eqlb.combine", 760, 990, 7, 1),
    ]
    host = tracing.HostSpans()
    host.spans = [(100, 1000, "dispatch"), (1000, 1400, "sync")]
    events = [
        _launch("cudaMemcpyAsync", 120, 11),
        _CEv("Memcpy HtoD (Pageable -> Device)", 130, 180, 11),
        _launch("cudaLaunchKernel", 230, 12),
        _CEv("gemm", 400, 600, 12),
        _launch("cuLaunchKernel", 320, 13),
        _CEv("lu_solve_bl_tile_kernel<double>", 600, 650, 13),
        _launch("cudaLaunchKernel", 770, 14),
        _CEv("combine_gather_kernel<double>", 1000, 1100, 14),
        _CEv("gemv", 1150, 1160, 99),
        _CEv("aten::mm", 0, 1400, 0, dev="DeviceType.CPU"),
    ]
    return events, records, host


def test_kernel_credited_to_the_span_of_its_launch():
    events, records, host = _se_stretch()
    cr = spans.credit(events, records, 100, 1400, host, calls=1)
    by_op = {op: path for path, _, op, _ in cr.device}
    # launched in se.load_moments, ran under se.reduced_solve
    assert by_op["gemm"] == "se.bucket/se.load_moments"
    assert by_op["lu_solve_bl_tile_kernel<double>"] == \
        "se.bucket/se.reduced_solve[tile]"
    assert by_op["Memcpy HtoD (Pageable -> Device)"] == "eqlb.input"
    assert by_op["combine_gather_kernel<double>"] == "eqlb.combine"
    assert by_op["gemv"] is None  # no launch found
    assert cr.credited_share() == pytest.approx(400 / 410)


def test_span_device_and_idle_gaps():
    events, records, host = _se_stretch()
    cr = spans.credit(events, records, 100, 1400, host, calls=1)
    sd = cr.span_device()
    assert sd[:2] == [["se.bucket/se.load_moments", pytest.approx(200e-9)],
                      ["eqlb.combine", pytest.approx(100e-9)]]
    assert {p for p, _ in sd[2:]} == {"eqlb.input",
                                      "se.bucket/se.reduced_solve[tile]"}
    gaps = [(n, s) for n, _, s in cr.gaps]
    assert gaps == [("dispatch/eqlb.input", pytest.approx(30e-9)),
                    ("dispatch/se.load_moments", pytest.approx(220e-9)),
                    ("dispatch/eqlb.combine", pytest.approx(350e-9)),
                    ("sync", pytest.approx(50e-9)),
                    ("sync", pytest.approx(240e-9))]
    assert cr.idle_gaps()[0] == ["dispatch/eqlb.combine",
                                 pytest.approx(350e-9)]
    assert cr.idle_by_name()["sync"] == pytest.approx(290e-6)  # ms a call
    assert cr.op_split()["gemm"] == {
        "se.bucket/se.load_moments": pytest.approx(200e-6)}
    assert cr.op_split()["gemv"] == {"none": pytest.approx(10e-6)}
    # the benchmark's own reduction of the same events is unchanged
    st = tracing.reduce(events, 100, 1400, host, calls=1)
    assert sorted(s for _, s in st.gaps) == sorted(s for _, s in gaps)
    assert st.busy_s == pytest.approx(410e-9)


def test_readings_leave_input_gaps_out_of_launch_idle():
    events, records, host = _se_stretch()
    r = spans.credit(events, records, 100, 1400, host, calls=1).readings()
    assert r == {
        "input_ms": pytest.approx(90e-6),
        # the gaps under se.load_moments and eqlb.combine, not the one
        # under eqlb.input nor the sync's
        "launch_idle_ms": pytest.approx(570e-6),
        "se_load_moments_device_ms": pytest.approx(200e-6),
        "se_reduced_device_ms": pytest.approx(50e-6),
    }
    rec = spans.reconcile(spans.credit(events, records, 100, 1400, host, 1))
    # stages_device_ms's operations: not K1 / K2, not the upload
    assert rec == {"se.load_moments": pytest.approx(200e-6),
                   "none": pytest.approx(10e-6)}


def test_kkt_scatter_is_the_assembly_self_time():
    records = [
        _rec("eqlb.call", 0, 1000, 1, mode="kkt", buckets=1),
        _rec("kkt.bucket", 10, 900, 2, 1, key=(6, False), P=8, D=75,
             boundary=False),
        _rec("kkt.assemble", 20, 500, 3, 2),
        _rec("kkt.element_data", 30, 200, 4, 3),
        _rec("kkt.solve", 510, 890, 5, 2, route="wide8x8"),
    ]
    host = tracing.HostSpans()
    host.spans = [(0, 1000, "dispatch")]
    events = [_launch("cudaLaunchKernel", 40, 1), _CEv("gemm", 50, 250, 1),
              _launch("cudaLaunchKernel", 300, 2),
              _CEv("index_add", 300, 420, 2),
              _launch("cudaLaunchKernel", 520, 3),
              _CEv("lu_solve_bm_wide_kernel", 530, 880, 3)]
    cr = spans.credit(events, records, 0, 1000, host, calls=2)
    assert cr.readings() == {
        # every gap lies under eqlb.call, none under an eqlb.input
        "launch_idle_ms": pytest.approx(1e3 * 330e-9 / 2),
        "kkt_element_device_ms": pytest.approx(1e3 * 200e-9 / 2),
        "kkt_scatter_device_ms": pytest.approx(1e3 * 120e-9 / 2),
    }
    assert [p for p, _ in cr.span_device()] == [
        "kkt.bucket/kkt.solve[wide8x8]",
        "kkt.bucket/kkt.assemble/kkt.element_data",
        "kkt.bucket/kkt.assemble"]


def test_every_reading_is_none_without_spans():
    events, _, host = _se_stretch()
    cr = spans.credit(events, [], 100, 1400, host, calls=1)
    assert cr.readings() == {} and cr.span_device() == []
    assert cr.credited_share() == 0.0
    assert {n for n, _, _ in cr.gaps} == {"dispatch", "sync"}
    no_device = [e for e in events if e.device_type() != "DeviceType.CUDA"]
    assert spans.credit(no_device, _se_stretch()[1], 100, 1400, host,
                        1) is None


@pytest.mark.parametrize("workload", ["se_rt2_crossed_1m.strict",
                                      "ev_rt3_unstructured_1m.strict"])
def test_tool_records_spans_only_when_on(tiny_bench, workload):
    """The tool's flow on a tiny mesh on the CPU: spans recorded in the
    stretches with recording on and in the credited one, none in those
    with it off; no device, so no credit."""
    cell = cells.find(workload, tiny_bench)
    line = spans.measure(cell, 2**31 + 5, groups=1, pairs=1, device="cpu")
    assert [c["spans"] for c in line["cost"]["off"]] == [0]
    assert line["cost"]["on"][0]["spans"] > 0
    assert line["spans_a_call"] == line["cost"]["on"][0]["spans"]
    assert all(c["call_ms"] > 0 for c in line["cost"]["off"]
               + line["cost"]["on"])
    assert "credited_share" not in line
