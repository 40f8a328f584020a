"""The serving program's share of the card's dense bf16 peak: the counted
FLOPs of the videos completed in the traced window over its wall time."""

from pbench import counts


def read(run):
    if run.program != "serve" or run.trace is None or run.peaks is None:
        return None
    flops = counts.serve_flops_per_video(run.cfg, run.mix["frame_hw"]) * run.batch * run.window.units
    return 100.0 * flops / run.window.wall_s / run.peaks["bf16"]
