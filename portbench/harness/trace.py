"""The profiled sub-window of a traced run, reduced to plain records.

``capture()`` profiles a block with ``torch.profiler`` (CPU and CUDA
activities) and returns a ``Trace``: the device operations (kernels,
copies, sets) with the host thread and time of the call that launched each,
and the host's ranges (operators and the harness's spans, which are
``record_function`` annotations). Everything a per-layer metric reads is
computed from these records, so that the CPU tests can hold it on
synthetic ones.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from portbench.harness import stats

WINDOW = "portbench.window"    # the annotation around the profiled units
SPAN = "portbench.span/"        # prefix of the layer spans: SPAN<label>/fwd|bwd


@dataclass
class DeviceOp:
    name: str
    start: float                 # s, the trace's clock
    end: float
    kind: str = "kernel"         # kernel | memcpy | memset
    launch_tid: Optional[int] = None
    launch_ts: Optional[float] = None


@dataclass
class HostRange:
    name: str
    start: float
    end: float
    tid: int
    annotation: bool = False


@dataclass
class Trace:
    ops: List[DeviceOp]
    host: List[HostRange]
    start: float
    end: float
    _span_index: Dict[str, dict] = field(default_factory=dict, repr=False)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def _in_window(self) -> List[DeviceOp]:
        return [o for o in self.ops if o.end > self.start and o.start < self.end]

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        return stats.busy([(o.start, o.end) for o in self.ops],
                          self.start, self.end)

    def idle_share(self) -> float:
        return stats.idle_share([(o.start, o.end) for o in self.ops],
                                self.start, self.end)

    def kernels(self) -> int:
        """Kernels launched in the window (copies and sets not counted)."""
        return sum(1 for o in self._in_window() if o.kind == "kernel")

    def device_s(self) -> float:
        """The summed duration of the window's device operations."""
        return sum(min(o.end, self.end) - max(o.start, self.start)
                   for o in self._in_window())

    def annotated(self, prefix: str) -> List[HostRange]:
        """The harness's annotations whose name starts with ``prefix``."""
        return [h for h in self.host
                if h.annotation and h.name.startswith(prefix)]

    def _index(self, prefix: str) -> dict:
        if prefix not in self._span_index:
            by_tid = defaultdict(list)
            for h in self.annotated(prefix):
                by_tid[h.tid].append((h.start, h.end))
            self._span_index[prefix] = {
                tid: stats.merge(iv) for tid, iv in by_tid.items()}
        return self._span_index[prefix]

    def launched_in(self, op: DeviceOp, prefix: str) -> bool:
        """Whether ``op`` was launched inside an annotation starting with
        ``prefix``, on the annotation's own thread."""
        if op.launch_tid is None:
            return False
        spans = self._index(prefix).get(op.launch_tid)
        if not spans:
            return False
        i = bisect.bisect_right(spans, (op.launch_ts, float("inf"))) - 1
        return i >= 0 and spans[i][0] <= op.launch_ts <= spans[i][1]

    def span_device_s(self, label: str) -> float:
        """Device time of the operations launched inside ``label``'s
        spans, forward and backward."""
        prefix = f"{SPAN}{label}/"
        return sum(o.end - o.start for o in self._in_window()
                   if self.launched_in(o, prefix))

    def host_at(self, t: float, tids=None) -> str:
        """The innermost host operator running at ``t`` (on ``tids``)."""
        best = None
        for h in self.host:
            if h.annotation or not (h.start <= t <= h.end):
                continue
            if tids is not None and h.tid not in tids:
                continue
            if best is None or h.start > best.start:
                best = h
        return best.name if best is not None else "host: no operator"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by what the host was doing in their middle."""
        by_name: Dict[str, float] = defaultdict(float)
        for o in self._in_window():
            by_name[o.name[:160]] += min(o.end, self.end) - max(o.start,
                                                                 self.start)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        launchers = {o.launch_tid for o in self.ops
                     if o.launch_tid is not None} or None
        idle = sorted(stats.gaps([(o.start, o.end) for o in self.ops],
                                 self.start, self.end),
                      key=lambda g: g[0] - g[1])[:top]
        named = [[self.host_at((s + e) / 2, launchers)[:160], e - s]
                 for s, e in idle]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy") or "memcpy" in low[:12]:
        return "memcpy"
    if low.startswith("memset") or "memset" in low[:12]:
        return "memset"
    return "kernel"


def from_kineto(events) -> Trace:
    """A ``Trace`` from ``prof.profiler.kineto_results.events()``: CPU
    events are host ranges, the others device operations, each linked to
    the CPU event that launched it by its correlation id. The window is the
    ``WINDOW`` annotation's, or with no host events the stretch from the
    first device operation's start to the last one's end."""
    from torch.autograd import DeviceType

    cpu, dev = [], []
    for e in events:
        (cpu if e.device_type() == DeviceType.CPU else dev).append(e)
    by_corr = {}
    for e in cpu:
        c = e.correlation_id()
        if c and not e.is_user_annotation():
            by_corr.setdefault(c, e)
    host = [HostRange(e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9,
                      e.start_thread_id(), bool(e.is_user_annotation()))
            for e in cpu]
    ops = []
    for e in dev:
        if e.is_user_annotation():
            continue                 # the device-side copy of an annotation
        launch = by_corr.get(e.linked_correlation_id()) or by_corr.get(
            e.correlation_id())
        ops.append(DeviceOp(
            e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9, _kind(e.name()),
            launch.start_thread_id() if launch is not None else None,
            launch.start_ns() * 1e-9 if launch is not None else None))
    windows = [h for h in host if h.annotation and h.name == WINDOW]
    if windows:
        start, end = windows[0].start, windows[0].end
    else:
        times = [o.start for o in ops] + [o.end for o in ops]
        start, end = (min(times), max(times)) if times else (0.0, 0.0)
    return Trace(ops, host, start, end)


class Capture:
    """``with Capture(host) as cap: ...``; ``cap.trace`` after the block.

    ``host=False`` traces the device alone (CUPTI's activity records, a
    microsecond or two a launch): its busy and idle time are those of the
    program as it runs unprofiled. ``host=True`` adds every host operator
    and annotation, which links each device operation to its launch and so
    to the spans, but slows a host-paced program's dispatch, so its idle
    time is not the program's; the block should open the ``WINDOW``
    annotation (``window()``) around its units. Either block should
    synchronise the device before it closes."""

    def __init__(self, host: bool = True):
        self.host = host
        self.trace: Optional[Trace] = None
        self._prof = None

    def __enter__(self):
        import torch

        acts = []
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        if self.host or not acts:       # on a host with no card, the host
            acts.append(torch.profiler.ProfilerActivity.CPU)
        # host operators of every thread (a batcher's worker, the autograd
        # thread), where this PyTorch has the option
        try:
            config = torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)
        except TypeError:
            config = None
        self._prof = torch.profiler.profile(activities=acts,
                                            experimental_config=config)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = from_kineto(self._prof.profiler.kineto_results.events())
        return False


@contextlib.contextmanager
def annotate(name: str):
    import torch

    with torch.autograd.profiler.record_function(name):
        yield


def window():
    return annotate(WINDOW)
