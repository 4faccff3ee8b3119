"""The share of the profiled training steps' wall time in which no operation
ran on the device."""

from portbench.harness import readers


def read(view):
    return readers.idle_share(view)
