"""Median wait of a request in the batcher's queue, from the client's call to
the start of the predictor call that carries its row."""

from portbench.harness import readers


def read(view):
    return readers.queue_wait_ms_p50(view)
