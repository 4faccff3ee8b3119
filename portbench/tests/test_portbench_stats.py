"""The shared arithmetic on synthetic intervals: window rates, tails over
all requests, busy and idle time, and the reduction of a trace."""

import math

import pytest

from portbench.harness import stats
from portbench.harness.trace import SPAN, WINDOW, DeviceOp, HostRange, Trace


def test_window_rate_counts_all_work_over_all_time():
    assert stats.window_rate(300, 10.0, 13.0) == pytest.approx(100.0)
    # one long stall inside the window moves the rate, as it should
    assert stats.window_rate(300, 10.0, 16.0) == pytest.approx(50.0)
    with pytest.raises(ValueError):
        stats.window_rate(1, 2.0, 2.0)


def test_p95_over_all_requests_failed_ones_missing():
    lat = [0.010] * 95 + [0.020] * 5
    assert stats.percentile(lat, 95) == pytest.approx(0.010)
    # a stall that holds six requests moves the tail
    assert stats.percentile([0.010] * 94 + [1.0] * 6, 95) == pytest.approx(1.0)
    # a failed request counts as missing any limit
    assert math.isinf(stats.percentile([0.01] * 90 + [math.inf] * 10, 95))


def test_idle_share_and_gaps():
    busy = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert stats.busy(busy, 0.0, 4.0) == pytest.approx(3.0)
    assert stats.idle_share(busy, 0.0, 4.0) == pytest.approx(25.0)
    assert stats.gaps(busy, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    # one long stall in an otherwise busy window
    steady = [(i * 0.1, i * 0.1 + 0.099) for i in range(100)]
    stalled = [(s + (5.0 if s >= 5.0 else 0.0), e + (5.0 if s >= 5.0 else 0.0))
               for s, e in steady]
    assert stats.idle_share(steady, 0.0, 10.0) < 2.0
    assert stats.idle_share(stalled, 0.0, 15.0) > 33.0


def _trace():
    host = [HostRange(WINDOW, 0.0, 10.0, 1, True),
            HostRange(SPAN + "attention/fwd", 1.0, 2.0, 1, True),
            HostRange(SPAN + "attention/bwd", 3.0, 4.0, 2, True),
            HostRange("aten::mm", 6.0, 8.0, 1, False)]
    ops = [DeviceOp("k_attn_f", 1.5, 2.5, "kernel", 1, 1.5),
           DeviceOp("k_attn_b", 3.6, 4.6, "kernel", 2, 3.5),
           DeviceOp("k_other", 4.6, 5.0, "kernel", 1, 4.5),
           DeviceOp("k_wrong_thread", 5.0, 5.5, "kernel", 2, 1.5),
           DeviceOp("Memcpy HtoD", 8.5, 9.0, "memcpy", 1, 8.4)]
    return Trace(ops, host, 0.0, 10.0)


def test_trace_attributes_kernels_by_launch_thread_and_time():
    t = _trace()
    assert t.span_device_s("attention") == pytest.approx(2.0)
    assert t.busy_s() == pytest.approx(1.0 + 1.0 + 0.4 + 0.5 + 0.5)
    assert t.idle_share() == pytest.approx(100 * (1 - 3.4 / 10))
    assert t.kernels() == 4


def test_breakdown_names_gaps_by_the_host():
    b = _trace().breakdown()
    assert b["device_ops"][0][0] in ("k_attn_f", "k_attn_b")
    longest = b["idle_gaps"][0]
    assert longest[0] == "aten::mm" and longest[1] == pytest.approx(3.0)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
