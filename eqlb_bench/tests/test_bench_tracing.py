"""The traced stretch's reduction, on synthetic profiler events."""

import pytest

from eqlb_bench import tracing


class _Ev:
    def __init__(self, name, s, e, dev="DeviceType.CUDA", annotation=False):
        self._n, self._s, self._e, self._d, self._a = name, s, e, dev, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return self._a


def test_busy_idle_gaps_and_kernels():
    host = tracing.HostSpans()
    host.spans = [(0, 100, "dispatch"), (100, 400, "sync")]
    events = [
        _Ev("lu_solve_bl_tile_kernel<double>", 50, 150),
        _Ev("Memset (Device)", 140, 160),
        _Ev("gemm", 250, 300),
        _Ev("aten::mm", 0, 400, dev="DeviceType.CPU"),
        _Ev("annotation", 0, 400, annotation=True),
        _Ev("outside", 500, 600),
    ]
    st = tracing.reduce(events, 0, 400, host, calls=2)
    assert st.busy_s == pytest.approx((110 + 50) / 1e9)
    assert st.window_s == pytest.approx(400 / 1e9)
    assert st.kernels() == 2 and st.calls == 2
    assert st.device_s(lambda n: "lu_solve_bl" in n) == pytest.approx(100 / 1e9)
    names = [n for n, _ in st.gaps]
    assert names == ["dispatch", "sync", "sync"]
    assert [s for _, s in st.gaps] == pytest.approx([50e-9, 90e-9, 100e-9])
    bd = st.breakdown()
    assert bd["device_ops"][0][0].startswith("lu_solve_bl")
    assert bd["idle_gaps"][0] == ["sync", pytest.approx(100e-9)]


def test_no_device_work_reads_nothing():
    host = tracing.HostSpans()
    assert tracing.reduce([_Ev("aten::mm", 0, 10, dev="DeviceType.CPU")],
                          0, 10, host, 1) is None


def test_stages_leave_out_port_kernels_and_uploads():
    from types import SimpleNamespace

    from eqlb_bench.cells import load_reader
    st = tracing.Stretch(calls=2, window_s=1.0, busy_s=1.0, ops=[
        ("lu_solve_bl_tile_kernel<double>", 0.001),
        ("combine_gather_kernel<double>", 0.002),
        ("Memcpy HtoD (Pageable -> Device)", 0.004),
        ("Memcpy DtoD (Device -> Device)", 0.008),
        ("gemm", 0.016),
    ])
    ms = load_reader("stages_device_ms")(SimpleNamespace(stretch=st))
    assert ms == pytest.approx(1e3 * (0.008 + 0.016) / 2)
