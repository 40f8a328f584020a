"""Device milliseconds a step launched inside the program's
``train.forward`` span (``train/loop.py::train_step``: the features, the
model's teacher-forced forward and the NLL)."""

from pbench import spans


def read(run):
    if run.program != "train":
        return None
    return spans.per_unit_ms(run, ("train.forward",))
