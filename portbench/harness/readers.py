"""The readers that per-layer metrics share. Each takes the run's ``View``
and returns a number, or None where the run holds nothing to read (then
the metric is left out of the line; a share of a roofline or a peak is
never given as 0 for want of a reading).

Counts and busy time come from the device-only trace of the profiled
units (``window.trace``), which leaves the program's pace as it is;
what needs the link from a kernel to its launch (the spans) comes from
the host-and-device trace of as many further units
(``window.host_trace``)."""

from __future__ import annotations

import statistics
from typing import Optional

from portbench.work.common import bound_s


def mfu(view) -> Optional[float]:
    """The model operations of the unprofiled window over its time, as a
    share of the f32-accurate peak, in percent."""
    w = view.window
    if not w.flops or w.seconds <= 0:
        return None
    return 100.0 * w.flops / w.seconds / view.peaks["f32_accurate_flops"]


def launches_per_unit(view) -> Optional[float]:
    """Kernels of the profiled steps or calls, per step or call."""
    t, n = view.trace, view.window.profiled_units
    if t is None or not n or not t.kernels():
        return None
    return t.kernels() / n


def idle_share(view) -> Optional[float]:
    """The share of the device-only trace's window, the profiled units,
    with no device operation running. CUPTI's record of each launch slows a
    host-paced program's dispatch, which this counts as idle time
    (PERF.md gives the size of that)."""
    t = view.trace
    if t is None or t.window_s <= 0 or not t.ops:
        return None
    return t.idle_share()


def span_share(view, label: str) -> Optional[float]:
    """Device time launched inside ``label``'s spans over all the device
    time of the profiled sub-window, in percent."""
    t = view.window.host_trace
    if t is None:
        return None
    total, inside = t.device_s(), t.span_device_s(label)
    if total <= 0 or inside <= 0:
        return None
    return 100.0 * inside / total


def roofline(view, label: str = "attention") -> Optional[float]:
    """The least time the spans' work needs (operations or bytes, from the
    shapes the spans saw) over the device time inside the spans."""
    t = view.window.host_trace
    records = view.window.attention
    if t is None or not records:
        return None
    device = t.span_device_s(label)
    if device <= 0:
        return None
    return 100.0 * sum(bound_s(f, b) for f, b in records) / device


def latency_p95_ms(view) -> Optional[float]:
    return view.window.counters.get("latency_p95_ms")


def rows_per_call(view) -> Optional[float]:
    c = view.window.counters
    if not c.get("calls"):
        return None
    return c["call_rows"] / c["calls"]


def queue_wait_ms_p50(view) -> Optional[float]:
    waits = view.window.counters.get("queue_waits_s")
    if not waits:
        return None
    return 1e3 * statistics.median(waits)
