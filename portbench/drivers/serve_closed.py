"""Serving traffic: a closed loop of client threads in front of the port's
``DynamicBatcher`` over an ``EnsemblePredictor`` of fold members.

Parameters: ``members``, ``batch_size`` (the predictor's), ``max_batch``
and ``max_delay_ms`` (the batcher's), ``clients``, ``pool`` (subjects made
from the seed, on the host), ``T``, ``warmup_s`` (load before the window,
part of set-up), ``check_requests`` (the sample the reference recomputes),
``profile_calls`` (the traced sub-window) and ``timeout_s``.

Each client sends one subject's features (one row), drawn from the pool by
its own seeded stream, and sends its next request when its reply arrives.
A request's latency runs from the client's call to its return. The window
counts every request that completed in it: rows per second are its rows
over its time (the end-to-end metric: a closed loop that always has a
batch waiting runs the server at its capacity), and the 95th percentile
is over all of them, a failed request counting as missing any limit (a
per-layer reading: at capacity a tail swings with the smallest change).
The harness wraps the predictor to see, through a request id that rides
along as an input of its own, when the call that carries each row starts.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from portbench.harness import compare, stats
from portbench.harness.cell import Context, Window, now
from portbench.harness.spans import Spans
from portbench.harness.trace import Capture, window as trace_window
from portbench.harness.weights import init_from_seed

RID = "rid"


class Recorder:
    """The predictor, wrapped: pops the request ids, notes when each call
    starts and ends and how many rows it carries, and passes the rest on.
    ``profile(capture, n)`` profiles the next n whole calls on the
    batcher's own thread, which makes them."""

    def __init__(self, predictor, sync):
        self.predictor = predictor
        self.batch_size = predictor.batch_size
        self.reduce = predictor.reduce
        self.sync = sync
        self.calls: List[tuple] = []           # (start, end, rows)
        self.started: Dict[int, float] = {}    # request id -> call start
        # [capture, n, done, calls so far, window annotation]
        self._plan: Optional[list] = None
        self.error: Optional[BaseException] = None

    def profile(self, capture: Capture, n: int) -> threading.Event:
        done = threading.Event()
        self._plan = [capture, n, done, 0, trace_window()]
        return done

    def _begin(self, plan) -> bool:
        try:
            plan[0].__enter__()
            plan[4].__enter__()
            return True
        except Exception as e:      # the run fails with it in measure()
            self.error, self._plan = e, None
            plan[2].set()
            return False

    def __call__(self, **inputs):
        rid = inputs.pop(RID)
        plan = self._plan
        if plan is not None and plan[3] == 0 and not self._begin(plan):
            plan = None
        t = now()
        out = self.predictor(**inputs)
        self.calls.append((t, now(), len(rid)))
        for r in rid.tolist():
            self.started[r] = t
        if plan is not None:
            plan[3] += 1
            if plan[3] == plan[1]:
                self.sync()
                plan[4].__exit__(None, None, None)
                plan[0].__exit__(None, None, None)
                self._plan = None
                plan[2].set()
        return out


@dataclass
class Reply:
    rid: int
    subject: int
    sent: float
    done: float
    probs: Optional[np.ndarray]
    error: Optional[str] = None


class Clients:
    def __init__(self, ctx: Context, batcher, pool: Dict[str, np.ndarray],
                 n: int):
        self.batcher, self.pool = batcher, pool
        self.keys = list(pool)
        self.size = len(pool[self.keys[0]])
        self.stop = threading.Event()
        self.replies: List[List[Reply]] = [[] for _ in range(n)]
        self.streams = [np.random.default_rng([ctx.seed % 2**63,
                                               ctx.seed >> 63, c])
                        for c in range(n)]
        self.threads = [threading.Thread(target=self._client, args=(c,),
                                         name=f"client-{c}", daemon=True)
                        for c in range(n)]

    def _client(self, c: int) -> None:
        rng, out = self.streams[c], self.replies[c]
        j = 0
        while not self.stop.is_set():
            i = int(rng.integers(self.size))
            rid = c * 10**9 + j
            j += 1
            req = {k: self.pool[k][i:i + 1] for k in self.keys}
            req[RID] = np.array([rid], dtype=np.int64)
            sent = now()
            try:
                probs = np.asarray(self.batcher(**req))
                out.append(Reply(rid, i, sent, now(), probs))
            except Exception as e:      # a failed request: counted, kept
                out.append(Reply(rid, i, sent, now(), None, repr(e)))

    def start(self):
        for t in self.threads:
            t.start()

    def join(self, timeout: float) -> int:
        """Stop sending and wait for every request in flight; returns how
        many clients never got their last reply."""
        self.stop.set()
        deadline = now() + timeout
        for t in self.threads:
            t.join(max(0.0, deadline - now()))
        return sum(t.is_alive() for t in self.threads)

    def all(self) -> List[Reply]:
        return [r for rs in self.replies for r in rs]


@dataclass
class State:
    members: Dict[str, torch.Tensor]
    buffers: Dict[str, torch.Tensor]
    pool: Dict[str, np.ndarray]
    skeleton: Any = None
    predictor: Any = None
    recorder: Any = None
    batcher: Any = None
    clients: Any = None
    stuck: int = 0
    sample: List[Reply] = field(default_factory=list)


def preprocess(inputs):
    """The training cell's in-step z-score of each sample's ERP and PW."""
    from multimodal_eeg_fmri_tpu_torch.ops.signal import zscore

    return {k: zscore(inputs[k], axis=(1, 2)) for k in ("erp", "pw")}


def inputs(ctx: Context):
    """(skeleton, stacked member weights, buffers, pool): what the
    benchmark makes from the seed, for the program and the reference."""
    p = ctx.params
    skeleton = ctx.builder.skeleton(ctx.config, ctx.device)
    members = init_from_seed(skeleton, ctx.generator("weights"),
                             members=p["members"])
    buffers = {n: b[None].expand(p["members"], *b.shape).clone()
               for n, b in skeleton.named_buffers()}
    cohort = ctx.builder.cohort(ctx.config, p["pool"], p["T"],
                                ctx.generator("pool"), ctx.device)
    pool = {k: v.cpu().numpy() for k, v in cohort.items()
            if k not in ("label", "weight")}
    return skeleton, members, buffers, pool


def setup(ctx: Context) -> State:
    from multimodal_eeg_fmri_tpu_torch.serving import (
        DynamicBatcher,
        EnsemblePredictor,
    )

    p = ctx.params
    skeleton, members, buffers, pool = inputs(ctx)
    state = State(members, buffers, pool, skeleton)
    state.predictor = EnsemblePredictor(
        skeleton, members, buffers, batch_size=p["batch_size"],
        preprocess=preprocess, reduce="mean_probs")
    ctx.mark("members, pool and predictor")
    warm = {k: v[:p["batch_size"]] for k, v in pool.items()}
    for _ in range(2):
        state.predictor(**warm)
    ctx.sync()
    ctx.mark("predictor warm-up")
    state.recorder = Recorder(state.predictor, ctx.sync)
    state.batcher = DynamicBatcher(state.recorder,
                                   max_delay_ms=p["max_delay_ms"],
                                   max_batch=p["max_batch"],
                                   timeout_s=p["timeout_s"])
    state.clients = Clients(ctx, state.batcher, pool, p["clients"])
    state.clients.start()
    t = now()
    while now() - t < p["warmup_s"]:
        state.clients.stop.wait(0.05)
    return state


def _attention_recorder(records: list, members: int):
    from portbench.work.common import mha_work

    def on_call(label, module, args):
        if label != "attention":
            return
        q, k = args[0], args[1]
        # inside vmap the inputs show one member's shape
        records.append(mha_work(members * q.shape[0], q.shape[1], k.shape[1],
                                q.shape[2], module.num_heads,
                                args[0] is args[1] is args[2], False))

    return on_call


def measure(ctx: Context, state: State) -> Window:
    p = ctx.params
    start = now()
    state.clients.stop.wait(ctx.seconds)
    end = now()
    device = host = None
    profiled, records = 0, []
    if ctx.trace:
        profiled, wait = p["profile_calls"], p["timeout_s"]
        rec = state.recorder
        device = Capture(host=False)
        with Spans([state.predictor.net.skeleton], ctx.spans,
                   backward=False,
                   on_call=_attention_recorder(records, p["members"])) as sp:
            sp.remove()             # the device-only calls run without hooks
            if not rec.profile(device, profiled).wait(wait) or rec.error:
                raise RuntimeError("the profiled calls failed") from rec.error
            sp.install()
            host = Capture(host=True)
            if not rec.profile(host, profiled).wait(wait) or rec.error:
                raise RuntimeError("the profiled calls failed") from rec.error
    state.stuck = state.clients.join(p["timeout_s"] + 60.0)
    state.batcher.close()
    replies = state.clients.all()
    done = [r for r in replies if start <= r.done <= end]
    ok = [r for r in done if r.error is None]
    failed = len(done) - len(ok) + state.stuck
    lat = [r.done - r.sent if r.error is None else float("inf")
           for r in done] + [float("inf")] * state.stuck
    rows = sum(len(r.probs) for r in ok)
    calls = [c for c in state.recorder.calls if start <= c[0] <= end]
    waits = [state.recorder.started[r.rid] - r.sent for r in ok
             if r.rid in state.recorder.started]
    flops = rows * p["members"] * ctx.work.forward_flops(ctx.config, p["T"])
    e2e = {"serve_rows_per_s": stats.window_rate(rows, start, end)}
    p95 = 1e3 * stats.percentile(lat, 95) if lat else float("inf")
    win = Window(start, end, len(calls), len(done) + state.stuck,
                 failed, e2e, flops=flops,
                 trace=device.trace if device else None,
                 host_trace=host.trace if host else None,
                 profiled_units=profiled, attention=records,
                 counters={"calls": len(calls), "latency_p95_ms": p95,
                           "call_rows": sum(c[2] for c in calls),
                           "queue_waits_s": waits})
    rng = np.random.default_rng([ctx.seed % 2**63, ctx.seed >> 63, 1 << 20])
    n = min(p["check_requests"], len(ok))
    state.sample = [ok[i] for i in sorted(rng.choice(len(ok), n,
                                                     replace=False))]
    return win


def _free(ctx: Context, state: State) -> None:
    state.predictor = state.recorder = state.batcher = None
    state.clients = state.skeleton = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def _reference(ctx: Context, state: State, subjects: List[int],
               tf32: bool, fault: str = "") -> torch.Tensor:
    """The reference's mean probabilities; with ``fault`` the reference put
    in the program's place with it planted: ``half_members`` (half of the
    members left out, the mean over the rest), ``answer_altered`` (each
    row given its neighbour's answer)."""
    k = ctx.params["members"]
    if fault == "half_members":
        k = max(1, k // 2)
    members = [{**{n: t[j] for n, t in state.members.items()},
                **{n: t[j] for n, t in state.buffers.items()}}
               for j in range(k)]
    idx = np.asarray(subjects, dtype=np.int64)
    rows = {key: torch.from_numpy(v[idx]).to(ctx.device)
            for key, v in state.pool.items()}
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        probs = ctx.reference.serve_probs(ctx.config, members, rows).cpu()
        return probs.roll(1, 0) if fault == "answer_altered" else probs
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def check(ctx: Context, state: State, window: Window):
    sample = state.sample
    _free(ctx, state)
    limit = ctx.limits["prob_gap"]
    if not sample:
        return [compare.Check("prob_gap", float("inf"), limit)]
    served = torch.from_numpy(np.concatenate([r.probs for r in sample]))
    ref = _reference(ctx, state, [r.subject for r in sample], tf32=False)
    return compare.answers(served, ref, limit)


FAULTS = ("answer_altered", "half_members")


def control(ctx: Context, fault: str = ""):
    """The reference in TF32 in the program's place (or in f32 with
    ``fault`` planted), on as many subjects as a run compares, drawn from
    the seed, from the weights and pool a run of this seed makes."""
    _, members, buffers, pool = inputs(ctx)
    state = State(members, buffers, pool)
    rng = np.random.default_rng([ctx.seed % 2**63, ctx.seed >> 63, 1 << 20])
    n = ctx.params["check_requests"]
    subjects = rng.choice(len(next(iter(state.pool.values()))), n).tolist()
    low = _reference(ctx, state, subjects, tf32=not fault, fault=fault)
    ref = _reference(ctx, state, subjects, tf32=False)
    return compare.answers(low, ref, ctx.limits["prob_gap"])
