"""Device milliseconds a batch inside the benchmark's ``model`` span around
``models/mmbidaf.py::mmbidaf_decode`` (towers, BiDAF, fusion, decoder)."""


def read(run):
    if run.program != "serve" or run.trace is None or run.trace.busy_s <= 0 or not run.trace.count("model"):
        return None
    return run.trace.span_device_s("model") / run.trace.count("model") * 1e3
