"""The share of the traced training window that no device activity covers
(the union of the trace's intervals)."""


def read(run):
    if run.program != "train" or run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
