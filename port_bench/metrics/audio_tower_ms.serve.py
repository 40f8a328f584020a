"""Device milliseconds a batch launched inside the program's
``model.audio_tower`` span (``models/mmbidaf.py``'s audio ``tower``: the
BiLSTM's input projection, K1's walk over every frame, the BiDAF block)."""

from pbench import spans


def read(run):
    if run.program != "serve":
        return None
    return spans.per_unit_ms(run, ("model.audio_tower",))
