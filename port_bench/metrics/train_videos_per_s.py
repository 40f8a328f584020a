"""Videos trained on a second: B × steps completed in the window ÷ the
window's wall time, which ends in a synchronise after the last step (host
clock)."""


def read(run):
    if run.program != "train":
        return None
    return run.batch * run.window.units / run.window.wall_s
