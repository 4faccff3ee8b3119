"""Kernels launched per train step in the profiled sub-window
(train/fit.py:TrainStep)."""

from portbench.harness import readers


def read(view):
    return readers.launches_per_unit(view)
