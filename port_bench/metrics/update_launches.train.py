"""Device activities a step launched inside the program's
``train.grad_norm``, ``train.optimizer`` and ``train.ema`` spans: a count
that each step repeats exactly."""

from pbench import spans


def read(run):
    if run.program != "train" or run.trace is None or run.trace.busy_s <= 0:
        return None
    got = spans.device(run.trace, spans.UPDATE)
    return None if got is None else got[1] / run.window.units
