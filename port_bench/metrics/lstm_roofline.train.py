"""K5's and K6's share of their roofline: their least time a step
(``counts.k5_k6_bound_s``) over their device time a step, every route and
phase matched by symbol."""

from pbench import counts


def read(run):
    if run.program != "train" or run.trace is None or run.peaks is None:
        return None
    spent = run.trace.kernel_s(lambda n: counts.is_kernel(n, "K5") or counts.is_kernel(n, "K6"))
    if spent <= 0:
        return None
    return 100.0 * counts.k5_k6_bound_s(run.cfg, run.batch, run.peaks) * run.window.units / spent
