"""The 90th percentile of every batch's wall time in the window, from
dispatch to its picks on the host (host clock; ``statistics.quantiles``,
inclusive method; a window of one batch reads that batch)."""

import statistics


def read(run):
    if run.program != "serve" or not run.window.latencies_s:
        return None
    lat = run.window.latencies_s
    p90 = statistics.quantiles(lat, n=10, method="inclusive")[8] if len(lat) > 1 else lat[0]
    return p90 * 1e3
