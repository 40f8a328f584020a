"""Device idle milliseconds a batch whose innermost open program span, at
the gap's middle, is one of the frontend's (``frontend.*``: the resize and
the host rebuild of its weights, the VGG's blocks, the audio stage)."""

from pbench import spans


def read(run):
    if run.program != "serve" or run.trace is None or run.trace.busy_s <= 0:
        return None
    s = spans.idle(run.trace, lambda name: name.startswith("frontend."))
    return None if s is None else s / run.window.units * 1e3
