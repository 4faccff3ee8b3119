"""Rows per call of the predictor behind the batcher over the window: the
batcher's coalescing (serving.py:DynamicBatcher)."""

from portbench.harness import readers


def read(view):
    return readers.rows_per_call(view)
