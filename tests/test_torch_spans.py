"""The port's spans (``utils/profiling.py::span``) on the CPU: every span of
``SPANS`` is recorded under a profiler, in its place in the nesting, once a
train step for each ``train.*`` span; with no profiler a span is one shared
no-op context; and a profiler changes no output bit. Widths are the
benchmark's CPU-test widths (``port_bench/tests/conftest.py``), with the
serving cell's flags (bf16, the kernel flags on, VGG-16) and the training
cell's (f32, drop 0.2, Adadelta, flat updates)."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mmbidaf_tpu_torch.config import tiny_test_config
from mmbidaf_tpu_torch.data.frontend import cast_vgg_weights, frontend_init, make_end_to_end_decode
from mmbidaf_tpu_torch.data.synthetic import random_word_vectors, synthetic_batch
from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_init
from mmbidaf_tpu_torch.ops.vgg import VGG16_SPEC
from mmbidaf_tpu_torch.train.loop import init_train_state, make_train_step
from mmbidaf_tpu_torch.utils import profiling
from mmbidaf_tpu_torch.utils.bench_config import make_raw_batch_on_device
from mmbidaf_tpu_torch.utils.profiling import SPANS, span

# the program span each span sits directly under (None: none)
PARENT = {
    "frontend.resize": None, "frontend.resize.weights": "frontend.resize",
    "frontend.vgg": None, "frontend.audio": None,
    **{f"frontend.vgg.block{k}": "frontend.vgg" for k in range(1, 6)},
    "frontend.vgg.classifier": "frontend.vgg",
    **{n: None for n in SPANS if n.startswith(("model.", "train."))},
    "model.image_tower.bidaf": "model.image_tower", "model.audio_tower.bidaf": "model.audio_tower",
}
TRAIN_PARENT = {**{n: "train.forward" for n in SPANS if n.startswith("model.")},
                **{n: PARENT[n] for n in SPANS if n.endswith(".bidaf")},
                **{n: None for n in SPANS if n.startswith("train.")}}


def _cfg(program: str):
    cfg = tiny_test_config()
    model = dict(hidden_size=8, emb_dim=12, img_feat_dim=20, audio_feat_dim=8,
                 use_pallas_lstm=True, use_pallas_attention=True, max_decode_steps=4,
                 vgg_variant="vgg16")
    train = {}
    if program == "serve":
        model.update(compute_dtype="bfloat16", use_pallas_melspec=True)
    else:
        model.update(drop_prob=0.2)
        train = dict(optimizer="adadelta", lr=0.5, flat_updates=True, max_grad_norm=5.0,
                     ema_decay=0.999)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **model),
        data=dataclasses.replace(cfg.data, max_sentences=7, max_words=5, max_keyframes=3,
                                 max_audio_frames=9, vocab_size=50),
        train=dataclasses.replace(cfg.train, **train))


def _model(cfg):
    wv = random_word_vectors(np.random.default_rng(0), cfg.data.vocab_size, cfg.model.emb_dim)
    return mmbidaf_init(cfg, wv, "cpu", seed=0)


def _serve():
    """One served batch: ``() -> (log_p, picks)``."""
    cfg = _cfg("serve")
    model = _model(cfg)
    fe = cast_vgg_weights(frontend_init(cfg, VGG16_SPEC, "cpu", seed=1), cfg.model.compute_dtype)
    raw = make_raw_batch_on_device(cfg, 2, "cpu", frame_hw=(40, 48))
    end_to_end = make_end_to_end_decode(cfg, VGG16_SPEC)
    return lambda: end_to_end(model, fe, raw)


def _train():
    """One train step from a fresh state: ``() -> (loss, params)``."""
    cfg = _cfg("train")
    batch = {k: torch.from_numpy(v) for k, v in
             synthetic_batch(np.random.default_rng(3), cfg, batch_size=4).items()}
    step = make_train_step(cfg)

    def once():
        state = init_train_state(_model(cfg), cfg, seed=1)
        state, metrics = step(state, batch)
        return metrics["loss"], {n: p.detach() for n, p in state.params.named_parameters()}
    return once


PROGRAMS = {"serve": _serve, "train": _train}


def _program_parent(ev):
    p = ev.cpu_parent
    while p is not None and p.name not in PARENT:
        p = p.cpu_parent
    return p.name if p is not None else None


@pytest.mark.parametrize("program", ["serve", "train"])
def test_spans_recorded_nested_and_bit_identical(program):
    """Every span of the program is recorded with its parent; ``train.*``
    once a step; the outputs equal, bit for bit, those of the same call with
    no profiler running."""
    fn = PROGRAMS[program]()
    plain = fn()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = fn()
    spans = [ev for ev in prof.events() if ev.name in PARENT]
    got = {ev.name for ev in spans}
    want = ({n for n in SPANS if n.startswith(("frontend.", "model."))} if program == "serve"
            else {n for n in SPANS if n.startswith(("model.", "train."))})
    assert got == want
    parents = PARENT if program == "serve" else TRAIN_PARENT
    for ev in spans:
        assert _program_parent(ev) == parents[ev.name], ev.name
    if program == "train":
        names = [ev.name for ev in spans if ev.name.startswith("train.")]
        assert sorted(names) == sorted(n for n in SPANS if n.startswith("train."))
    for a, b in zip(torch.utils._pytree.tree_leaves(plain), torch.utils._pytree.tree_leaves(traced)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_span_is_a_shared_no_op_without_a_profiler():
    """No profiler: every span is the same ``nullcontext`` and leaves no
    event; under a profiler, a recorded span; after it, the no-op again."""
    assert span("frontend.vgg") is span("train.ema") is profiling._NO_SPAN
    assert isinstance(span("model.text"), contextlib.nullcontext)
    with span("model.fuse"):
        torch.ones(2) + 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(2) * 2
        with span("model.fuse"):
            torch.ones(2) + 1
    assert [ev.name for ev in prof.events()].count("model.fuse") == 1
    assert span("model.fuse") is profiling._NO_SPAN
