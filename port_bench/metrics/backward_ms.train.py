"""Device milliseconds a step launched inside the program's
``train.backward`` span (``.backward()``; autograd's own thread launches
the kernels, counted by their launch time)."""

from pbench import spans


def read(run):
    if run.program != "train":
        return None
    return spans.per_unit_ms(run, ("train.backward",))
