"""Device milliseconds a batch launched inside the program's
``frontend.vgg`` spans (``data/frontend.py::frames_through_vgg``, each
frame chunk's conv stack and classifier)."""

from pbench import spans


def read(run):
    if run.program != "serve":
        return None
    return spans.per_unit_ms(run, ("frontend.vgg",))
