"""The share of the traced calls' window in which the device is idle and
the thread that launches the predictor's kernels is outside ``mmef/predict``:
idle time that the batcher, not the predictor, leaves. A reading of the
profiled calls alone, under the host trace, which slows the batcher's
thread: an upper bound of the window's."""

from portbench.harness import program


def read(view):
    return program.idle_outside_share(view.window.host_trace, "mmef/predict")
