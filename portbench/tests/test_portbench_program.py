"""The readers of the program's own spans (``mmef/...``) and the idle gaps
named by them, on synthetic traces."""

from types import SimpleNamespace

import pytest

from portbench.harness import registry
from portbench.harness.trace import SPAN, WINDOW, DeviceOp, HostRange, Trace

SERVING = ("serve.between_calls_ms_p50", "serve.idle_outside_predict_share")
TRAINING = ("train.optimizer_share", "moe.dispatch_fwd_share")


def _read(name, trace):
    view = SimpleNamespace(window=SimpleNamespace(host_trace=trace))
    return registry.metric(name).read(view)


def _span(name, start, end, tid=1):
    """A span as the profiler records it: the program's a host range of its
    name, the harness's an annotation."""
    return HostRange(name, start, end, tid, not name.startswith("mmef/"))


def _serving():
    """Three calls on the batcher's thread (1), the second of two chunks;
    a client thread (9) with a span of its own."""
    host = [_span(WINDOW, 0.0, 10.0),
            _span("mmef/predict", 1.0, 3.0),
            _span("mmef/predict/forward", 1.5, 2.5),
            _span("mmef/batcher/deliver", 3.0, 3.5),
            _span("mmef/batcher/wait", 3.5, 4.8),
            _span("mmef/batcher/join", 4.8, 5.0),
            _span("mmef/predict", 5.0, 7.0),
            _span("mmef/predict/forward", 5.2, 5.8),
            _span("mmef/predict/forward", 6.0, 6.8),
            _span("mmef/predict", 8.0, 9.5),
            _span("mmef/predict/forward", 8.1, 9.4),
            _span("mmef/client", 0.0, 10.0, tid=9),
            HostRange("aten::copy_", 3.6, 4.0, 1)]
    ops = [DeviceOp("k1", 1.6, 2.4, "kernel", 1, 1.6),
           DeviceOp("k2", 5.3, 6.7, "kernel", 1, 5.3),
           DeviceOp("k3", 8.2, 9.4, "kernel", 1, 8.2)]
    return Trace(ops, host, 0.0, 10.0)


def _training():
    """One step on thread 1; the autograd engine's thread (2) launches the
    backward and, here, part of AdamW."""
    host = [_span(WINDOW, 0.0, 8.0),
            _span("mmef/step/forward", 0.0, 2.0),
            _span("mmef/moe/dispatch", 0.5, 0.8),
            _span("mmef/moe/combine", 1.0, 1.2),
            _span("mmef/step/backward", 2.0, 5.0),
            _span("mmef/step/clip", 5.0, 6.0),
            _span("mmef/step/optimizer", 6.0, 7.0)]
    ops = [DeviceOp("k_fwd", 0.2, 0.4, "kernel", 1, 0.1),
           DeviceOp("k_dispatch", 0.6, 0.9, "kernel", 1, 0.6),
           DeviceOp("k_other_thread", 0.9, 1.0, "kernel", 2, 0.7),
           DeviceOp("k_combine", 1.1, 1.35, "kernel", 1, 1.1),
           DeviceOp("k_bwd", 3.0, 4.0, "kernel", 2, 3.0),
           DeviceOp("k_clip", 5.5, 5.7, "kernel", 1, 5.5),
           DeviceOp("k_adam", 6.5, 6.8, "kernel", 2, 6.5)]
    return Trace(ops, host, 0.0, 8.0)


def test_serving_readers():
    t = _serving()
    # 5 − 3 and 8 − 7 s
    assert _read("serve.between_calls_ms_p50", t) == pytest.approx(1500.0)
    # idle and outside the calls: [0, 1], [3, 5], [7, 8], [9.5, 10]
    assert _read("serve.idle_outside_predict_share",
                 t) == pytest.approx(45.0)


def test_training_readers():
    t = _training()
    total = 0.2 + 0.3 + 0.1 + 0.25 + 1.0 + 0.2 + 0.3
    # clip and AdamW by launch time, whatever thread launched
    assert _read("train.optimizer_share", t) == pytest.approx(
        100 * (0.2 + 0.3) / total)
    # dispatch and combine on their own thread only
    assert _read("moe.dispatch_fwd_share", t) == pytest.approx(
        100 * (0.3 + 0.25) / total)


@pytest.mark.parametrize("name", SERVING + TRAINING)
def test_readers_give_nothing_without_program_spans(name):
    """A program with none of the spans (the parent's) reads nothing, as
    does a run with no host trace."""
    host = [_span(WINDOW, 0.0, 10.0), _span(SPAN + "moe/fwd", 1.0, 2.0),
            HostRange("aten::mm", 1.0, 2.0, 1)]
    ops = [DeviceOp("k", 1.0, 2.0, "kernel", 1, 1.0)]
    assert _read(name, Trace(ops, host, 0.0, 10.0)) is None
    assert _read(name, None) is None


def test_gap_label_names_the_program_span_with_no_operator_inside():
    """The program's spans are host ranges (CPU operations) in the trace,
    so the gap label, the innermost host range at the gap's middle on the
    launching threads, names the span where no operator runs inside it."""
    gaps = dict((round(d, 6), n)
                for n, d in _serving().breakdown()["idle_gaps"])
    # [2.4, 5.3]: its middle, 3.85, in the wait, inside a host operator
    assert gaps[2.9] == "aten::copy_"
    # [6.7, 8.2]: 7.45, between calls; the client thread's span is not on a
    # launching thread
    assert gaps[1.5] == "host: no operator"
    host = [_span(WINDOW, 0.0, 10.0), _span("mmef/predict", 0.0, 10.0),
            _span("mmef/predict/forward", 2.0, 4.0),
            _span("mmef/batcher/join", 6.0, 8.0)]
    ops = [DeviceOp("k", 0.0, 2.0, "kernel", 1, 0.0),
           DeviceOp("k", 4.0, 6.5, "kernel", 1, 4.0),
           DeviceOp("k", 7.5, 10.0, "kernel", 1, 7.5)]
    labels = [n for n, _ in Trace(ops, host, 0.0, 10.0).breakdown()
              ["idle_gaps"]]
    assert labels == ["mmef/predict/forward", "mmef/batcher/join"]
