"""Profiling and step timing. Counterpart of
``multimodal_eeg_fmri_tpu/core/profiling.py``:

- ``trace()``: a context manager around ``torch.profiler`` that writes a
  Chrome trace (host and, on a card, device activity) into ``log_dir``;
  the profiler is yielded, so ``key_averages()`` can be read after.
- ``StepTimer``: step timing that discards warmup steps and ends each
  step in ``torch.cuda.synchronize()`` when the result lies on a card.
- ``timed_fn``: wraps a callable, timing each call the same way and
  logging it to a metrics logger.
- ``compiled_memory_stats``: the caching allocator's peak around one call
  whose arguments lie on a card (``None`` on the CPU).
- ``annotate``: the port's span. While a profiler records it opens a
  ``RecordFunction``, so the span lies in the profiler's trace beside the
  device activity it launches, on the same clock; with no profiler it is
  one shared no-op context and calls nothing in PyTorch. The port names
  its spans ``mmef/<layer>/<part>``.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.autograd import profiler as _profiler

_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """A span over the enclosed block, decided at entry: while a profiler
    records (the process-wide flag, which a profiler started on another
    thread sets too) a ``RecordFunction`` named ``name``, else the shared
    no-op context. It closes only what it opened, so a profiler that starts
    or stops inside the block leaves no half span.

    The span is ``torch._C._profiler._RecordFunctionFast``, as PyTorch's
    own compiled programs mark their regions, not ``record_function``:
    that one enters the dispatcher through ``torch.ops``, which lets go of
    the interpreter lock, and a thread among many busy ones (a batcher
    among its clients) then waits for the lock at every span's edge. In
    the profiler's trace the span is a CPU operation of its name, not a
    user annotation."""
    if _profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN


def _cuda_devices(x: Any) -> set:
    """The cards that hold a tensor of ``x`` (a tensor, a module, or a nest
    of lists, tuples and dicts of them)."""
    if torch.is_tensor(x):
        return {x.device} if x.is_cuda else set()
    if isinstance(x, torch.nn.Module):
        return {t.device for t in x.state_dict().values() if t.is_cuda}
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return set().union(*(_cuda_devices(v) for v in x))
    return set()


def _sync(result: Any) -> None:
    """Wait for the cards that hold any tensor of ``result``."""
    for d in _cuda_devices(result):
        torch.cuda.synchronize(d)


@contextlib.contextmanager
def trace(log_dir: str | Path = "./profile", with_stack: bool = False):
    """Profile the enclosed block: host activity, and the card's when one
    is there; the Chrome trace goes to ``log_dir/trace.json``."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                with_stack=with_stack) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


@dataclass
class StepTimer:
    """Wall-clock step timing with a device sync; discards warmup."""

    warmup: int = 2
    times_ms: List[float] = field(default_factory=list)
    _seen: int = 0

    @contextlib.contextmanager
    def step(self, result_to_block: Any = None):
        """Time the enclosed block; ``result_to_block`` (tensors) is waited
        for before the clock stops."""
        t0 = time.perf_counter()
        yield
        _sync(result_to_block)
        self._record(time.perf_counter() - t0)

    def time_call(self, fn: Callable, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync(out)
        self._record(time.perf_counter() - t0)
        return out

    def _record(self, dt: float):
        self._seen += 1
        if self._seen > self.warmup:
            self.times_ms.append(dt * 1000.0)

    def stats(self) -> Dict[str, float]:
        if not self.times_ms:
            return {}
        a = np.asarray(self.times_ms)
        return {
            "mean_ms": float(a.mean()),
            "p50_ms": float(np.percentile(a, 50)),
            "p95_ms": float(np.percentile(a, 95)),
            "min_ms": float(a.min()),
            "n": len(a),
        }


def timed_fn(fn: Callable, metrics=None, tag: str = "step") -> Callable:
    """Wrap ``fn``: every call waits for its result and logs its duration
    to ``metrics`` (anything with ``log(step, **values)``) under
    ``{tag}_ms``."""
    counter = {"step": 0}

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync(out)
        dt_ms = (time.perf_counter() - t0) * 1000.0
        if metrics is not None:
            metrics.log(counter["step"], **{f"{tag}_ms": dt_ms})
        counter["step"] += 1
        return out

    return wrapper


def compiled_memory_stats(fn: Callable, *args) -> Optional[Dict[str, int]]:
    """Device memory of one call ``fn(*args)`` on the card that holds its
    tensor arguments: what was allocated before it (``argument_bytes``),
    what the call left allocated (``output_bytes``) and the allocator's
    peak during it (``peak_bytes``, ``torch.cuda.max_memory_allocated``).
    ``None`` when no argument lies on a card: the CPU has no caching
    allocator to read. (The JAX package reads XLA's memory analysis of the
    compiled executable; eager PyTorch has none, so the peak is measured.)"""
    devices = _cuda_devices(list(args))
    if not devices:
        return None
    device = min(devices, key=lambda d: d.index)
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn(*args)
    _sync(out)
    torch.cuda.synchronize(device)
    return {"argument_bytes": int(before),
            "output_bytes": int(torch.cuda.memory_allocated(device) - before),
            "peak_bytes": int(torch.cuda.max_memory_allocated(device))}
