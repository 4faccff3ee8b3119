"""The 95th percentile of every request that completed in the window, from
the client's call to its return, a failed request counting as missing. The
closed loop runs the server at its capacity, where a tail swings with the
smallest change: a per-layer reading, beside the rows per second."""

from portbench.harness import readers


def read(view):
    return readers.latency_p95_ms(view)
