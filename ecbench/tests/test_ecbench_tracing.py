"""The trace's reduction: window between markers, busy union, copies by
direction, idle gaps named by the host span open at their middle."""

import pytest

from ecbench import tracing


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_summarize_a_small_trace():
    t0_ns = 5_000_000  # the host saw the first marker end here
    events = [
        _x("kernel", "at::cuda::spin_kernel(long)", 990, 10),  # ends at 1000
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1100, 200),
        _x("kernel", "apply_packedbit_kernel", 1250, 100),  # overlaps
        _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1400, 100),
        _x("gpu_memset", "Memset (Device)", 1700, 50),
        _x("kernel", "at::cuda::spin_kernel(long)", 2000, 10),
        _x("cpu_op", "aten::copy_", 1000, 500),
    ]
    # host spans on the host clock: t0_ns <-> trace 1000 us
    host = {tracing.SEAM: [(t0_ns + 50_000, t0_ns + 550_000)],
            "ecbench.encode": [(t0_ns, t0_ns + 800_000)]}
    s = tracing.summarize(events, host, t0_ns, t0_ns + 1_000_000)
    assert s.window_s == pytest.approx(1000e-6)
    assert s.kernel_s == pytest.approx(100e-6)
    assert s.h2d_s == pytest.approx(200e-6)
    assert s.d2h_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx((250 + 100 + 50) * 1e-6)
    gaps = dict(s.idle_gaps)
    # 1000-1100 and 1350-1400: in the seam; 1500-1700: in the op, outside
    # the seam; 1750-2000: the op ended at 1800, the middle 1875 is between
    # ops
    assert gaps[tracing.SEAM] == pytest.approx(150e-6)
    assert gaps["ecbench.encode"] == pytest.approx(200e-6)
    assert gaps[tracing.WINDOW] == pytest.approx(250e-6)
    assert s.device_ops[0][0] == "Memcpy HtoD (Pageable -> Device)"


def test_without_markers_the_host_window_serves():
    s = tracing.summarize([], {}, 1_000_000, 3_000_000)
    assert s.window_s == pytest.approx(2e-3) and s.busy_s == 0
    assert s.idle_gaps == [(tracing.WINDOW, pytest.approx(2e-3))]


@pytest.mark.parametrize("lost", [0, -1])
def test_one_marker_and_the_host_window_place_the_other(lost):
    t0_ns = 7_000_000
    events = [
        _x("kernel", "at::cuda::spin_kernel(long)", 990, 10),
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1100, 200),
        _x("kernel", "at::cuda::spin_kernel(long)", 2000, 10),
    ]
    del events[lost]
    s = tracing.summarize(events, {}, t0_ns, t0_ns + 1_000_000)
    assert s.markers == 1 and s.window_s == pytest.approx(1000e-6)
    assert s.h2d_s == pytest.approx(200e-6)
    assert s.busy_s == pytest.approx(200e-6)
