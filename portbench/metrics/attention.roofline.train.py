"""The least time the MultiHeadAttention spans' work needs (projections, every
score, forward and backward) over the device time inside them."""

from portbench.harness import readers


def read(view):
    return readers.roofline(view, "attention")
