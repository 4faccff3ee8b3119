"""The port's spans (``core.profiling.annotate``): where they open under a
profiler (the batcher, the predictors, the train step, the MoE layer), that
without one they call nothing in the dispatcher, that a profiler starting or
stopping inside one leaves no half span, and that none reaches an exported
program."""

import threading

import numpy as np
import pytest
import torch
from torch import nn

from multimodal_eeg_fmri_tpu_torch.core import profiling
from multimodal_eeg_fmri_tpu_torch.core.config import TrainConfig
from multimodal_eeg_fmri_tpu_torch.models import LongContextClassifier
from multimodal_eeg_fmri_tpu_torch.models.eeg import ModelOutput
from multimodal_eeg_fmri_tpu_torch.serving import (
    DynamicBatcher,
    EnsemblePredictor,
    Predictor,
)
from multimodal_eeg_fmri_tpu_torch.train.fit import TrainStep

torch.set_num_threads(1)

BATCHER = ("mmef/batcher/wait", "mmef/batcher/join", "mmef/batcher/deliver")
PREDICT = "mmef/predict"
CHUNK = ("mmef/predict/h2d", "mmef/predict/forward", "mmef/predict/d2h")
STEP = ("mmef/step/augment", "mmef/step/forward", "mmef/step/backward",
        "mmef/step/clip", "mmef/step/optimizer")
MOE = ("mmef/moe/route", "mmef/moe/dispatch", "mmef/moe/experts",
       "mmef/moe/combine")


class Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(4, 3)

    def forward(self, x):
        return ModelOutput(logits=self.lin(x))


def _profile():
    """A CPU profile of every thread (the batcher's worker included)."""
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True))


def _spans(prof):
    """The program's spans: (name, thread, start, end), by start."""
    return sorted(((e.name, e.thread, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith("mmef/")),
                  key=lambda s: s[2])


def _within(inner, outer) -> bool:
    return (inner[1] == outer[1] and outer[2] <= inner[2]
            and inner[3] <= outer[3])


def _lc_moe():
    torch.manual_seed(0)
    return LongContextClassifier(hidden_dim=16, num_layers=2, num_heads=2,
                                 num_experts=4, moe_top_k=2, in_channels=3,
                                 device="cpu")


def test_batcher_records_the_serving_spans_on_its_thread():
    torch.manual_seed(0)
    ens = EnsemblePredictor.from_modules([Tiny(), Tiny()], batch_size=2)
    x = np.random.default_rng(0).standard_normal((4, 4)).astype(np.float32)
    with _profile() as prof:
        with profiling.annotate("mmef/test/main"):
            pass
        with DynamicBatcher(ens, max_delay_ms=1.0, max_batch=2,
                            timeout_s=60) as batcher:
            one = batcher(x=x[:1])
            three = batcher(x=x[1:])      # more rows than a chunk: two
    np.testing.assert_allclose(np.concatenate([one, three]), ens(x=x),
                               rtol=1e-6)
    spans = _spans(prof)
    names = {s[0] for s in spans}
    assert set(BATCHER + (PREDICT,) + CHUNK) <= names
    main = next(s[1] for s in spans if s[0] == "mmef/test/main")
    served = [s for s in spans if s[0] != "mmef/test/main"]
    assert {s[1] for s in served} != {main}
    assert len({s[1] for s in served}) == 1          # the batcher's thread
    calls = [s for s in served if s[0] == PREDICT]
    assert len(calls) == 2
    forwards = [sum(_within(s, c) for s in served
                    if s[0] == "mmef/predict/forward") for c in calls]
    assert forwards == [1, 2]
    for s in served:
        if s[0] != PREDICT:
            assert any(_within(s, c) for c in calls) == (s[0] in CHUNK), s


def test_train_step_records_the_step_and_moe_spans():
    model = _lc_moe()
    cfg = TrainConfig(batch_size=4, learning_rate=1e-3, grad_clip=1.0)
    step = TrainStep(model, cfg, augment=lambda g, b: dict(b))
    g = torch.Generator().manual_seed(0)
    batch = {"erp": torch.randn(4, 16, 3, generator=g),
             "label": torch.tensor([0, 1, 0, 1])}
    with _profile() as prof:
        loss = step(batch, generator=g)
    assert torch.isfinite(loss)
    counts = {}
    for name, *_ in _spans(prof):
        counts[name] = counts.get(name, 0) + 1
    assert {n: counts.get(n, 0) for n in STEP} == dict.fromkeys(STEP, 1)
    # one forward through each of the two MoE blocks
    assert {n: counts.get(n, 0) for n in MOE} == dict.fromkeys(MOE, 2)


def test_without_a_profiler_a_span_calls_nothing(monkeypatch):
    real = torch.ops.profiler._record_function_enter_new

    def entered(name, *args):
        # torch's own optimizer labels its steps whether or not a profiler
        # records; the port's spans never enter the dispatcher
        if name.startswith("mmef/"):
            raise AssertionError(f"{name} entered the dispatcher")
        return real(name, *args)

    class Opened:
        def __init__(self, name):
            raise AssertionError(f"{name} opened a RecordFunction")

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        entered)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Opened)
    assert profiling.annotate("mmef/a") is profiling.annotate("mmef/b")
    with profiling.annotate("mmef/a"):
        pass
    # the program's spans, each opened with no profiler
    torch.manual_seed(0)
    ens = EnsemblePredictor.from_modules([Tiny(), Tiny()], batch_size=2)
    with DynamicBatcher(ens, max_delay_ms=1.0, timeout_s=60) as batcher:
        batcher(x=np.ones((3, 4), np.float32))
    step = TrainStep(_lc_moe(), TrainConfig(batch_size=2, grad_clip=1.0),
                     augment=lambda g, b: dict(b))
    step({"erp": torch.ones(2, 8, 3), "label": torch.tensor([0, 1])})
    # the patch is live: under a profiler a span does open
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="opened"):
            profiling.annotate("mmef/a")


def test_a_profiler_started_or_stopped_inside_a_span_leaves_no_half_span():
    cpu = [torch.profiler.ProfilerActivity.CPU]
    with profiling.annotate("mmef/before"):
        with torch.profiler.profile(activities=cpu) as started:
            torch.ones(4).sum()
    assert not [e for e in started.events() if e.name.startswith("mmef/")]
    assert [e.name for e in started.events()]          # the trace is there
    stopped = torch.profiler.profile(activities=cpu)
    stopped.__enter__()
    with profiling.annotate("mmef/across"):
        torch.ones(4).sum()
        stopped.__exit__(None, None, None)
        inner = profiling.annotate("mmef/after")
    assert inner is profiling.annotate("mmef/later")   # no-op again
    for e in stopped.events():
        assert e.time_range.end >= e.time_range.start, e.name


def test_exported_program_holds_no_span(tmp_path):
    """Exported under a running profiler, so that the MoE layer's spans
    open while the program is traced: it holds none of them."""
    pred = Predictor(_lc_moe(), batch_size=2)
    erp = np.random.default_rng(0).standard_normal((2, 16, 3)
                                                   ).astype(np.float32)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        pred.export_artifact({"erp": erp}, tmp_path / "lc.pt2")
    program = torch.export.load(tmp_path / "lc.pt2")
    targets = [str(n.target) for n in program.graph.nodes]
    assert targets and not [t for t in targets if "profiler" in t]
    out = program.module()(erp=torch.from_numpy(erp))
    np.testing.assert_allclose(out.detach().numpy(), pred(erp=erp), rtol=1e-5,
                               atol=1e-6)


def test_span_threads_see_a_profiler_started_on_another_thread():
    """The guard reads the process-wide flag: a span on a thread other than
    the profiler's opens (the serving benchmark starts its profiler on the
    batcher's thread; an operator's may start anywhere)."""
    seen = []
    with _profile():
        t = threading.Thread(
            target=lambda: seen.append(profiling.annotate("mmef/other")))
        t.start()
        t.join(30)
    assert not t.is_alive()
    assert seen and seen[0] is not profiling.annotate("mmef/off")
