"""Device milliseconds a batch launched inside the program's
``frontend.resize`` span (``ops/vgg.py::preprocess_frames``: the resize
weights, the two resize contractions, the normalisation)."""

from pbench import spans


def read(run):
    if run.program != "serve":
        return None
    return spans.per_unit_ms(run, ("frontend.resize",))
