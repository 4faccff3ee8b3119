"""Readers of the program's own spans: the ``mmef/...`` ranges that
``core.profiling.annotate`` opens inside the port while a profiler
records (the batcher, the predictors, the train step, the MoE layer). In
the trace they are host ranges of their name (CPU operations, not user
annotations).

Each takes the host-and-device trace of a traced run
(``window.host_trace``) and returns a number, or None where the trace
holds none of the spans it reads (a program that has none) or nothing
else to read. The host trace slows a host-paced program's dispatch, so a
reading of host time is an upper bound of the unprofiled program's; a
served call's readings are those of the profiled calls alone, whose
slower batcher also groups requests otherwise than the window's.
"""

from __future__ import annotations

import bisect
import statistics
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

from portbench.harness import stats
from portbench.harness.trace import DeviceOp, HostRange, Trace


def spans(trace: Optional[Trace], name: str) -> List[HostRange]:
    """The program's spans called ``name`` that start in the window, in
    order of their start."""
    if trace is None:
        return []
    return sorted((h for h in trace.host
                   if h.name == name
                   and trace.start <= h.start <= trace.end),
                  key=lambda h: h.start)


def _inside(t: Optional[float], merged: List[Tuple[float, float]]) -> bool:
    if t is None or not merged:
        return False
    i = bisect.bisect_right(merged, (t, float("inf"))) - 1
    return i >= 0 and merged[i][0] <= t <= merged[i][1]


def launched_share(trace: Optional[Trace], names: Iterable[str],
                   own_thread: bool) -> Optional[float]:
    """Device time of the window's operations launched inside the spans
    ``names``, over all its device time, in percent. ``own_thread``: the
    launch counts only on the span's own thread; otherwise at the span's
    time on any thread (the autograd engine's thread launches a backward
    while the step's thread waits in ``backward()``)."""
    ranges = [h for name in names for h in spans(trace, name)]
    if not ranges:
        return None
    total = trace.device_s()
    if total <= 0:
        return None
    by_tid: Dict[Optional[int], list] = defaultdict(list)
    for h in ranges:
        by_tid[h.tid if own_thread else None].append((h.start, h.end))
    merged = {tid: stats.merge(iv) for tid, iv in by_tid.items()}

    def inside(op: DeviceOp) -> bool:
        key = op.launch_tid if own_thread else None
        return _inside(op.launch_ts, merged.get(key, []))

    return 100.0 * sum(min(o.end, trace.end) - max(o.start, trace.start)
                       for o in trace.ops if o.end > trace.start
                       and o.start < trace.end and inside(o)) / total


def between_calls_s(trace: Optional[Trace]) -> List[float]:
    """For each predictor call after the first on its thread, its start
    less the end of the call before it."""
    by_tid: Dict[int, List[HostRange]] = defaultdict(list)
    for h in spans(trace, "mmef/predict"):
        by_tid[h.tid].append(h)
    return [b.start - a.end for calls in by_tid.values()
            for a, b in zip(calls, calls[1:])]


def between_calls_ms_p50(trace: Optional[Trace]) -> Optional[float]:
    gaps = between_calls_s(trace)
    return 1e3 * statistics.median(gaps) if gaps else None


def idle_outside_share(trace: Optional[Trace], name: str) -> Optional[float]:
    """The share of the window, in percent, in which no device operation
    runs and the threads that hold the spans ``name`` are outside them."""
    calls = spans(trace, name)
    if not calls or not trace.ops or trace.window_s <= 0:
        return None
    idle = stats.gaps([(o.start, o.end) for o in trace.ops],
                      trace.start, trace.end)
    covered = stats.busy([(h.start, h.end) for h in calls], trace.start,
                         trace.end)
    both = stats.busy(idle + [(h.start, h.end) for h in calls], trace.start,
                      trace.end)
    # idle and outside = idle − (idle ∩ inside) = union − inside
    return 100.0 * (both - covered) / trace.window_s
