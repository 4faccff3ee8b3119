"""The model's operations (forward and backward, counted from shapes) per
second of the window, as a share of the card's f32-accurate peak."""

from portbench.harness import readers


def read(view):
    return readers.mfu(view)
