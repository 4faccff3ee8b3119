"""Device time launched during the train step's ``mmef/step/clip`` and
``mmef/step/optimizer`` spans (global-norm clipping and AdamW), as a share of
the traced steps' device time."""

from portbench.harness import program


def read(view):
    return program.launched_share(
        view.window.host_trace, ("mmef/step/clip", "mmef/step/optimizer"),
        own_thread=False)
