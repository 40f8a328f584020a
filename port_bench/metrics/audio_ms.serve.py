"""Device milliseconds a batch launched inside the program's
``frontend.audio`` span (``data/frontend.py::apply_frontend``: the waveform
to MFCCs; at 4096 frames K4's raw mel, then the dB and DCT tail)."""

from pbench import spans


def read(run):
    if run.program != "serve":
        return None
    return spans.per_unit_ms(run, ("frontend.audio",))
