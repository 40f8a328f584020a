"""The train step's share of the card's f32 peak outside the tensor cores
(the program is f32): the counted FLOPs of the steps in the traced window
over its wall time."""

from pbench import counts


def read(run):
    if run.program != "train" or run.trace is None or run.peaks is None:
        return None
    flops = counts.train_step_flops(run.cfg, run.batch, counts.n_params(run.cfg)) * run.window.units
    return 100.0 * flops / run.window.wall_s / run.peaks["f32"]
