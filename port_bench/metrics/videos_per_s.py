"""Videos served a second: B × batches completed in the window ÷ the
window's wall time, which ends in a synchronise (host clock)."""


def read(run):
    if run.program != "serve":
        return None
    return run.batch * run.window.units / run.window.wall_s
