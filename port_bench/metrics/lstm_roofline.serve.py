"""K1's share of its roofline: its least time a batch (``counts.k1_bound_s``)
over its device time a batch, both routes matched by symbol."""

from pbench import counts


def read(run):
    if run.program != "serve" or run.trace is None or run.peaks is None:
        return None
    spent = run.trace.kernel_s(lambda n: counts.is_kernel(n, "K1"))
    if spent <= 0:
        return None
    return 100.0 * counts.k1_bound_s(run.cfg, run.batch, run.peaks) * run.window.units / spent
