"""The least time the MultiHeadAttention spans' forward work needs (all
members) over the device time inside them."""

from portbench.harness import readers


def read(view):
    return readers.roofline(view, "attention")
