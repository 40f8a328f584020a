"""Device milliseconds a step launched inside the program's
``train.grad_norm``, ``train.optimizer`` and ``train.ema`` spans (the
metrics' gradient norm; clip, Adadelta and the update; the EMA)."""

from pbench import spans


def read(run):
    if run.program != "train":
        return None
    return spans.per_unit_ms(run, spans.UPDATE)
