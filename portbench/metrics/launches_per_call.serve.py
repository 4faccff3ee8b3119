"""Kernels launched per predictor call in the profiled sub-window
(EnsemblePredictor -> models/)."""

from portbench.harness import readers


def read(view):
    return readers.launches_per_unit(view)
