"""The readers of the program's spans (``pbench/spans.py`` and the metrics
that use it) on traces built by hand: host spans, device activities with
their launch times, and the idle gaps the trace derives."""

import types

import pytest

from pbench import spec
from pbench.trace import Trace

US = 1000  # ns


def _trace(host, device, window=(0, 1000)):
    """Times in microseconds; ``device``: ``(name, start, end, launch)``."""
    us = lambda t: None if t is None else t * US  # noqa: E731
    return Trace([(n, us(s), us(e), us(la)) for n, s, e, la in device],
                 [(n, us(s), us(e)) for n, s, e in host], {}, (window[0] * US, window[1] * US))


def _run(program, trace, units=2):
    return types.SimpleNamespace(program=program, trace=trace,
                                 window=types.SimpleNamespace(units=units))


SERVE_HOST = [
    ("frontend", 0, 600),  # the benchmark's own span: no program span
    ("frontend.resize", 10, 100), ("frontend.resize.weights", 10, 60), ("aten::copy_", 20, 50),
    ("frontend.vgg", 100, 500), ("frontend.vgg.block1", 100, 300),
    ("frontend.audio", 500, 580), ("model", 600, 950), ("model.text", 600, 700),
]
SERVE_DEVICE = [
    ("resize", 70, 90, 65), ("conv", 120, 300, 110), ("conv", 300, 480, 290),
    ("mfcc", 510, 560, 505), ("lstm", 620, 900, 610), ("copy", 950, 960, None),
]
TRAIN_HOST = [
    ("train.forward", 0, 300), ("model.text", 10, 100), ("train.backward", 300, 700),
    ("train.grad_norm", 700, 750), ("train.optimizer", 750, 850), ("train.ema", 850, 900),
]
TRAIN_DEVICE = [
    ("fwd", 20, 120, 20), ("fwd", 150, 250, 150),
    ("bwd", 330, 680, 320),  # launched from autograd's thread, inside the span by time
    ("norm", 710, 720, 710), ("adadelta", 760, 780, 760), ("apply", 780, 800, 770),
    ("ema", 860, 865, 860),
]


@pytest.mark.parametrize("name,program,value", [
    ("resize_ms.serve", "serve", 0.010),          # 20 us over 2 batches
    ("vgg_ms.serve", "serve", 0.180),             # 360 us
    # gaps [0, 70] (middle in frontend.resize.weights), [90, 120] and
    # [480, 510] (frontend.vgg); [560, 620] falls between program spans
    ("frontend_idle_ms.serve", "serve", 0.065),
    ("forward_ms.train", "train", 0.100),
    ("backward_ms.train", "train", 0.175),
    ("update_ms.train", "train", 0.0275),
    ("update_launches.train", "train", 2.0),
])
def test_span_readers_on_a_trace_built_by_hand(name, program, value):
    host, device = (SERVE_HOST, SERVE_DEVICE) if program == "serve" else (TRAIN_HOST, TRAIN_DEVICE)
    read = spec.reader(name)
    assert read(_run(program, _trace(host, device))) == pytest.approx(value, rel=1e-12)
    # the other program, a trace with no device activity (the CPU), and a
    # program without the spans (an older commit) read nothing
    other = "train" if program == "serve" else "serve"
    assert read(_run(other, _trace(host, device))) is None
    assert read(_run(program, _trace(host, []))) is None
    no_spans = [ev for ev in host if not ev[0].startswith(("frontend.", "model.", "train."))]
    assert read(_run(program, _trace(no_spans, device))) is None


def test_program_spans_leave_the_benchmark_spans_as_they_read():
    """The benchmark's ``frontend`` span reads the same device time with the
    program's spans inside it as without them."""
    spans = {"frontend": [(0, 600 * US)]}
    bare = [ev for ev in SERVE_HOST if "." not in ev[0]]
    with_program = _trace(SERVE_HOST, SERVE_DEVICE)
    with_program.spans = spans
    without = _trace(bare, SERVE_DEVICE)
    without.spans = spans
    assert with_program.span_device_s("frontend") == without.span_device_s("frontend") > 0


def test_every_new_reader_has_an_entry():
    bench = spec.load_benchmark()
    names = {m["name"] for m in bench["per_layer"]}
    assert {"resize_ms.serve", "vgg_ms.serve", "frontend_idle_ms.serve", "forward_ms.train",
            "backward_ms.train", "update_ms.train", "update_launches.train"} <= names
