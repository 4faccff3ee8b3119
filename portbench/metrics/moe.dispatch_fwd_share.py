"""Device time launched inside MoEFFN's forward ``mmef/moe/dispatch`` and
``mmef/moe/combine`` spans (the dense (S, E, C) products) on their own
thread, as a share of the traced steps' device time. Forward only: the
backward's kernels come from the autograd thread."""

from portbench.harness import program


def read(view):
    return program.launched_share(
        view.window.host_trace, ("mmef/moe/dispatch", "mmef/moe/combine"),
        own_thread=True)
