"""Device milliseconds a batch launched inside the program's
``model.audio_tower.bidaf`` span (the audio tower's BiDAF block, through
K2's wrapper: K9 past its cluster plan)."""

from pbench import spans


def read(run):
    if run.program != "serve":
        return None
    return spans.per_unit_ms(run, ("model.audio_tower.bidaf",))
