"""Device milliseconds a batch inside the benchmark's ``frontend`` span
around ``data/frontend.py::apply_frontend`` (resize, VGG-16, MFCC)."""


def read(run):
    if run.program != "serve" or run.trace is None or run.trace.busy_s <= 0 or not run.trace.count("frontend"):
        return None
    return run.trace.span_device_s("frontend") / run.trace.count("frontend") * 1e3
