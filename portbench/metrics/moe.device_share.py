"""Device time of the kernels inside MoEFFN's forward and backward spans, as a
share of the step's device time."""

from portbench.harness import readers


def read(view):
    return readers.span_share(view, "moe")
