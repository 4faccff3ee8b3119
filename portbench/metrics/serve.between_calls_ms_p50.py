"""Median time on the batcher's thread from the end of one predictor call
(``mmef/predict``) to the start of the next: delivery, the wait for rows and
the join. A reading of the profiled calls alone, under the host trace,
which slows the batcher's thread: an upper bound of the window's."""

from portbench.harness import program


def read(view):
    return program.between_calls_ms_p50(view.window.host_trace)
