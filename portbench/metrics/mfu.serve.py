"""The members' forward operations for the rows served per second of the
window, as a share of the card's f32-accurate peak."""

from portbench.harness import readers


def read(view):
    return readers.mfu(view)
