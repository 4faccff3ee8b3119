"""One run of one cell: set-up, the measured window, the traced
sub-window, the metrics and the check that decides ``correct``.

``BENCHMARK.json`` names the cell's configuration and traffic mix; the
mix names its driver, and the cell's workload file holds the limits. The
driver (``drivers/<driver>.py``) does the cell's own work through four
functions: ``setup(ctx)`` builds the system under test from the seed and
warms every shape the cell uses; ``measure(ctx, state)`` runs the window of
``ctx.seconds`` and, in a traced run, a fixed number of units under the
profiler after it; ``check(ctx, state, window)`` frees the program's state
and compares what the window's path produced with the plain reference;
``control(ctx)`` gives the same numbers for the reference put in the
program's place in the next precision down (TF32), which the limits must
fail.
"""

from __future__ import annotations

import sys
import time
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from portbench.harness import registry
from portbench.harness.compare import Check
from portbench.harness.env import BENCH
from portbench.harness.trace import Trace


@dataclass
class Context:
    cell: str
    traffic: dict                   # {"driver", "params"}
    limits: dict
    config: dict
    device: torch.device
    seed: int
    seconds: float
    trace: bool
    t0: float                       # the process's start, perf_counter
    builder: Any = None
    reference: Any = None
    work: Any = None
    bench_dir: Path = BENCH         # the benchmark's folder
    checks: List[Check] = field(default_factory=list)

    @property
    def params(self) -> dict:
        return self.traffic["params"]

    @property
    def spans(self) -> dict:
        return self.config.get("spans", {})

    def seed_for(self, stream: str) -> int:
        """A 63-bit seed of its own for each named stream of the run."""
        ss = np.random.SeedSequence([self.seed % 2**63, self.seed >> 63,
                                     zlib.crc32(stream.encode())])
        hi, lo = ss.generate_state(2)
        return (int(hi) << 31 | int(lo) >> 1) & (2**63 - 1)

    def generator(self, stream: str, device=None) -> torch.Generator:
        g = torch.Generator(device=self.device if device is None else device)
        g.manual_seed(self.seed_for(stream))
        return g

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    def mark(self, stage: str) -> None:
        """Log the seconds from the process's start to the end of a stage
        of set-up."""
        self.log(f"setup: {stage} done at {now() - self.t0:.3f} s")


@dataclass
class Window:
    start: float                    # perf_counter at the window's start
    end: float
    units: int                      # steps or calls in the window
    attempted: int
    failed: int
    e2e: Dict[str, float]
    flops: float = 0.0              # the model operations of the window
    trace: Optional[Trace] = None   # the device alone, profiled units
    host_trace: Optional[Trace] = None   # host and device, as many units
    profiled_units: int = 0
    attention: List[tuple] = field(default_factory=list)  # (flops, bytes)
    counters: Dict[str, Any] = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class View:
    """What a per-layer metric reads."""
    ctx: Context
    window: Window
    peaks: dict

    @property
    def trace(self) -> Optional[Trace]:
        return self.window.trace


def context(cell: str, seed: int, seconds: float, trace: bool, device,
            t0: float, bench: Optional[dict] = None,
            params: Optional[dict] = None,
            bench_dir: Path = BENCH) -> Context:
    """The run's context; ``params`` overrides traffic parameters (the CPU
    tests' small sizes), ``bench_dir`` is the benchmark's folder."""
    entry = registry.cell(bench or registry.benchmark(bench_dir.parent), cell)
    mix = registry.traffic(entry["traffic"], bench_dir)
    mix = {**mix, "params": {**mix["params"], **(params or {})}}
    cfg = registry.config(entry["config"], bench_dir)
    return Context(cell, mix, registry.workload(cell, bench_dir)["limits"],
                   cfg, torch.device(device), int(seed),
                   float(seconds), bool(trace), t0,
                   registry.builder(cfg["name"], bench_dir),
                   registry.reference(cfg["name"], bench_dir),
                   registry.work(cfg["name"], bench_dir), bench_dir)


def precision(ctx: Context) -> None:
    """The backends as the configuration states its precision: f32 with
    TF32 off unless it says otherwise."""
    tf32 = bool(ctx.config["precision"].get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def device_info(ctx: Context) -> dict:
    if ctx.device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(ctx.device),
                "count": 1,
                "memory_peak_bytes": int(
                    torch.cuda.max_memory_allocated(ctx.device))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def per_layer(ctx: Context, window: Window, bench: dict) -> Dict[str, dict]:
    from portbench.work.common import PEAKS

    view = View(ctx, window, PEAKS)
    out = {}
    for entry in registry.per_layer(bench, ctx.cell):
        value = registry.metric(entry["name"], ctx.bench_dir).read(view)
        if value is None:
            ctx.log(f"metric {entry['name']}: nothing to read")
            continue
        out[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    return out


def run(ctx: Context, bench: dict) -> dict:
    """One run of the cell; returns the result line as a dict, the
    compared numbers last."""
    driver = registry.driver(ctx.traffic["driver"], ctx.bench_dir)
    precision(ctx)
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    state = driver.setup(ctx)
    window = driver.measure(ctx, state)
    setup_s = window.start - ctx.t0
    device = device_info(ctx)
    if ctx.trace:
        metrics = per_layer(ctx, window, bench)
        device["busy_s"] = window.trace.busy_s()
        device["window_s"] = window.trace.window_s
    else:
        metrics = {}
        for entry in registry.end_to_end(bench, ctx.cell):
            name = entry["name"]
            value = setup_s if name == "setup_s" else window.e2e[name]
            metrics[name] = {"value": float(value), "unit": entry["unit"]}
    checks: List[Check] = driver.check(ctx, state, window)
    # a request or step that failed never gave its answer: not correct
    result = {"correct": (bool(checks) and all(c.ok for c in checks)
                          and window.failed == 0),
              "attempted": int(window.attempted),
              "failed": int(window.failed),
              "metrics": metrics, "device": device}
    if ctx.trace:
        result["breakdown"] = {
            "device_ops": window.trace.breakdown()["device_ops"],
            "idle_gaps": window.host_trace.breakdown()["idle_gaps"]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    ctx.checks = checks
    return result


def checks_text(checks: List[Check]) -> List[str]:
    """Each compared number beside its limit, for standard error."""
    return [f"check {c.name}: {c.value!r} (limit {c.limit!r})"
            f"{' at ' + c.where if c.where else ''}"
            f"{'' if c.ok else '  FAILS'}" for c in checks]


def now() -> float:
    return time.perf_counter()
