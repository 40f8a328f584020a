"""The port's data layer on the CPU against the JAX package's: gold labels,
the corpus (raw and ``features.npz`` examples), the plain and bucketed
iterators, the bucket ladders, the grain loader and ``DevicePrefetcher``.

Both packages read the same on-disk corpus, written by
``examples/make_synthetic_corpus.py::make_corpus``; the data is numpy on
both sides, so every comparison is exact (``np.array_equal``).
"""

import dataclasses
import importlib.util
import os
import shutil
import time
from itertools import islice
from pathlib import Path

import numpy as np
import pytest
import torch

from mmbidaf_tpu.config import tiny_test_config as j_tiny_config
from mmbidaf_tpu.data import labels as j_labels
from mmbidaf_tpu.data import pipeline as j_pipeline
from mmbidaf_tpu.data.prefetch import DevicePrefetcher as JDevicePrefetcher
from mmbidaf_tpu_torch.config import tiny_test_config
from mmbidaf_tpu_torch.data import labels, pipeline
from mmbidaf_tpu_torch.data.prefetch import DevicePrefetcher, batch_uploader
from mmbidaf_tpu_torch.data.vocab import vocab_from_corpus_dir

REPO = Path(__file__).resolve().parents[1]


def load_corpus_module():
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_corpus", REPO / "examples" / "make_synthetic_corpus.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def corpus_root(tmp_path_factory):
    """Ten labeled videos, ragged on all four axes: sentence counts 3-10
    (tiny config: 7 sentences, 9 words; one video of three short
    sentences), 3 or 10 frames (6 keyframes), and
    0.01 s or 0.5 s of audio (11 MFCC frames need 224 samples). Two more
    videos carry ``features.npz`` in a corpus of their own."""
    mk = load_corpus_module()
    base = tmp_path_factory.mktemp("corpus")
    root = base / "raw"
    for part, frames, seconds, seed in (("a", 3, 0.01, 1), ("b", 10, 0.5, 2)):
        mk.make_corpus(str(base / part), videos=5, sentences=10, ragged=True, frames=frames,
                       seconds=seconds, seed=seed)
        for vd in sorted((base / part).iterdir()):
            shutil.move(str(vd), str(root / f"{part}_{vd.name}"))
    # short sentences in one video: the word axis is ragged too
    (root / "b_video004" / "transcript.txt").write_text(
        "Short one here. Gradient descent again. Tiny words.")
    (root / "b_video004" / "summary.txt").write_text("Gradient descent again.")
    pre = base / "pre"
    cfg = tiny_test_config()
    rng = np.random.default_rng(0)
    for i, name in enumerate(sorted(os.listdir(root))[:2]):
        shutil.copytree(root / name, pre / name)
        n_img, n_aud = (2, 11) if i == 0 else (6, 4)
        np.savez(pre / name / "features.npz",
                 images=rng.standard_normal((6, cfg.model.img_feat_dim)).astype(np.float32),
                 audio=rng.standard_normal((11, cfg.model.audio_feat_dim)).astype(np.float64),
                 img_mask=(np.arange(6) < n_img).astype(np.float32),
                 aud_mask=(np.arange(11) < n_aud).astype(np.int32))
    return root, pre


def _corpora(root, cfg=None, j_cfg=None, **kw):
    cfg, j_cfg = cfg or tiny_test_config(), j_cfg or j_tiny_config()
    w2i = vocab_from_corpus_dir(str(root), max_size=cfg.data.vocab_size)
    return (pipeline.VideoCorpus(str(root), cfg, w2i, **kw),
            j_pipeline.VideoCorpus(str(root), j_cfg, w2i, **kw))


def _assert_batches_equal(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in b:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# Labels, corpus items, lengths.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_labels_match_jax(seed):
    """``greedy_extractive_labels`` and ``make_targets`` on random token
    lists (empty sentences, k past the sentence count, repeated words)."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(12)]
    sents = [[str(x) for x in rng.choice(words, size=int(rng.integers(0, 8)))]
             for _ in range(int(rng.integers(1, 9)))]
    summary = [str(x) for x in rng.choice(words, size=int(rng.integers(1, 15)))]
    for k in (1, 3, 10):
        assert labels.greedy_extractive_labels(sents, summary, k) == \
            j_labels.greedy_extractive_labels(sents, summary, k)
        ours, theirs = labels.make_targets(sents, summary, k), j_labels.make_targets(sents, summary, k)
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert labels.rouge_l_f(sents[0], summary) == j_labels.rouge_l_f(sents[0], summary)
    assert labels.rouge_1_f(sents[0], summary) == j_labels.rouge_1_f(sents[0], summary)


@pytest.mark.parametrize("branch", ["raw", "features"])
def test_corpus_items_match_jax(corpus_root, branch):
    """Every ``VideoCorpus[i]`` array, its ``repr`` (grain's state check),
    ``example_lengths`` and ``example_text``; a second read of an item (the
    port caches its gold labels) equals the first."""
    root = corpus_root[0] if branch == "raw" else corpus_root[1]
    ours, theirs = _corpora(root, require_summary=True)
    assert repr(ours) == repr(theirs) and len(ours) == len(theirs)
    for i in range(len(theirs)):
        a, b = ours[i], theirs[i]
        assert a.keys() == b.keys()
        assert ("frames" in a) == (branch == "raw")
        for k in b:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (i, k)
        again = ours[i]
        assert all(np.array_equal(again[k], a[k]) for k in a)
        assert ours.example_lengths(i) == theirs.example_lengths(i)
        assert ours.example_text(i) == theirs.example_text(i)
    lens = [ours.example_lengths(i) for i in range(len(ours))]
    if branch == "raw":  # the corpus is ragged on every axis
        assert all(len({ln[k] for ln in lens}) > 1 for k in lens[0]), lens


def test_unlabeled_videos_are_skipped(tmp_path, corpus_root):
    root = tmp_path / "c"
    shutil.copytree(corpus_root[0], root)
    (root / "a_video000" / "summary.txt").unlink()
    ours, theirs = _corpora(root, require_summary=True)
    assert ours.video_ids == theirs.video_ids and "a_video000" not in ours.video_ids
    (tmp_path / "e").mkdir()
    with pytest.raises(FileNotFoundError):
        pipeline.VideoCorpus(str(tmp_path / "e"), tiny_test_config(), {})


# ---------------------------------------------------------------------------
# Iterators and bucket ladders.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch_size,skip,drop", [(4, 0, True), (3, 4, True), (4, 2, False),
                                                  (16, 1, True)])
def test_batched_iterator_matches_jax(corpus_root, batch_size, skip, drop):
    ours, theirs = _corpora(corpus_root[0], require_summary=True)
    _assert_batches_equal(
        islice(pipeline.batched_iterator(ours, batch_size, seed=5, skip=skip,
                                         drop_remainder=drop), 5),
        islice(j_pipeline.batched_iterator(theirs, batch_size, seed=5, skip=skip,
                                           drop_remainder=drop), 5))


BUCKET_CASES = {
    "default_ladders": dict(buckets=(3, 5, 7)),
    "all_axes_skip": dict(buckets=(4, 7), word_buckets=(3, 6, 9), img_buckets=(2, 6),
                          aud_buckets=(4, 8, 11), skip=3),
    "static_axes_decode_rows": dict(buckets=(7,), word_buckets=(), img_buckets=(),
                                    aud_buckets=(), decode_rows=(0, 2)),
    "seq_align": dict(buckets=(4, 7), aud_buckets=(3, 7), seq_align=2, max_audio_frames=12),
    "no_shuffle": dict(buckets=(2, 6), shuffle=False, skip=1),
}


@pytest.mark.parametrize("case", list(BUCKET_CASES))
def test_bucketed_iterator_matches_jax(corpus_root, case):
    """``bucketed_iterator`` batch for batch: trimmed shapes on all four
    axes, ``skip``, ``decode_rows`` placeholders and ``seq_align``."""
    kw = dict(BUCKET_CASES[case])
    cfg, j_cfg = tiny_test_config(), j_tiny_config()
    if "max_audio_frames" in kw:
        n = kw.pop("max_audio_frames")
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, max_audio_frames=n))
        j_cfg = dataclasses.replace(j_cfg, data=dataclasses.replace(j_cfg.data, max_audio_frames=n))
    ours, theirs = _corpora(corpus_root[0], cfg, j_cfg, require_summary=True)
    got = list(islice(pipeline.bucketed_iterator(ours, 3, seed=7, **kw), 6))
    _assert_batches_equal(got, islice(j_pipeline.bucketed_iterator(theirs, 3, seed=7, **kw), 6))
    if case == "all_axes_skip":  # the batches really were trimmed
        assert len({b["text_ids"].shape for b in got}) > 1
    if case == "static_axes_decode_rows":
        assert all(not b["text_ids"][1].any() for b in got)  # a placeholder row


def test_bucket_ladders_match_jax(corpus_root):
    ours, theirs = _corpora(corpus_root[0], require_summary=True)
    for num_seq in (1, 3):
        assert pipeline.suggest_buckets(ours, num_seq=num_seq) == \
            j_pipeline.suggest_buckets(theirs, num_seq=num_seq)
    assert pipeline.suggest_buckets(ours, quantiles=(0.25, 1.0), audio_align=4) == \
        j_pipeline.suggest_buckets(theirs, quantiles=(0.25, 1.0), audio_align=4)
    for n in (1, 5, 16, 512):
        assert pipeline.default_axis_buckets(n) == j_pipeline.default_axis_buckets(n)
    for c in (0, 3, 9):
        assert pipeline.bucket_for(c, (2, 4, 8)) == j_pipeline.bucket_for(c, (2, 4, 8))
    with pytest.raises(ValueError):
        pipeline.bucketed_iterator(ours, 2, (4,), seq_align=2).__next__()


# ---------------------------------------------------------------------------
# grain.
# ---------------------------------------------------------------------------


def test_grain_loader_order_matches_jax(corpus_root):
    pytest.importorskip("grain")
    ours, theirs = _corpora(corpus_root[0], require_summary=True)
    it, j_it = (iter(pipeline.make_grain_loader(ours, 3, seed=4)),
                iter(j_pipeline.make_grain_loader(theirs, 3, seed=4)))
    _assert_batches_equal(islice(it, 4), islice(j_it, 4))
    state = it.get_state()
    assert state == j_it.get_state()
    for workers, bs in ((2, 3), (0, 1), (3, 2)):
        assert pipeline.translate_grain_state(state, workers, bs) == \
            j_pipeline.translate_grain_state(state, workers, bs)


@pytest.mark.parametrize("last_seen,w_old,w_new,bs", [
    ({"0": 5, "1": 2}, 2, 3, 1), ({"0": 7, "1": 4, "2": 5}, 3, 1, 2), ({}, 2, 2, 4),
    ({"0": 11}, 0, 2, 3)])
def test_translate_grain_state_matches_jax(last_seen, w_old, w_new, bs):
    """Hand-made snapshots, including a partly consumed round and an empty
    one; an unreadable or foreign state raises in both."""
    import json

    state = json.dumps({"version": 2, "last_seen_indices": last_seen, "worker_count": w_old,
                        "last_worker_index": 0, "sampler": "s", "data_source": "d"}).encode()
    assert pipeline.translate_grain_state(state, w_new, bs) == \
        j_pipeline.translate_grain_state(state, w_new, bs)
    for bad in (b"not json", json.dumps({"version": 1}).encode()):
        with pytest.raises(ValueError):
            pipeline.translate_grain_state(bad, w_new, bs)


# ---------------------------------------------------------------------------
# DevicePrefetcher: tests/test_prefetch.py's cases against the port.
# ---------------------------------------------------------------------------


class FakeStream:
    """Stateful iterator mimicking grain's get_state checkpointing."""

    def __init__(self, n=10, fail_at=None):
        self.i, self.n, self.fail_at = 0, n, fail_at

    def __iter__(self):
        return self

    def __next__(self):
        if self.fail_at is not None and self.i == self.fail_at:
            raise RuntimeError("boom")
        if self.i >= self.n:
            raise StopIteration
        self.i += 1
        return {"x": np.full((2,), self.i - 1)}

    def get_state(self):
        return str(self.i).encode()


@pytest.mark.parametrize("impl", [DevicePrefetcher, JDevicePrefetcher], ids=["port", "jax"])
def test_prefetch_order_and_transform(impl):
    pf = impl(FakeStream(8), lambda nb: nb["x"] * 2, depth=3)
    out = list(pf)
    assert [int(nb["x"][0]) for nb, _ in out] == list(range(8))
    assert [int(d[0]) for _, d in out] == [2 * i for i in range(8)]


def test_prefetch_state_tracks_delivered_not_prefetched():
    s = FakeStream(10)
    pf = DevicePrefetcher(s, lambda nb: nb, depth=3)
    try:
        assert pf.get_state() == b"0"
        deadline = time.time() + 10
        while s.i < 3 and time.time() < deadline:
            time.sleep(0.01)
        assert s.i >= 3  # the thread ran ahead of the consumer...
        assert pf.get_state() == b"0"  # ...but the state is the delivered position
        next(pf)
        assert pf.get_state() == b"1"
        next(pf)
        next(pf)
        assert pf.get_state() == b"3"
    finally:
        pf.close()


def test_prefetch_exception_after_good_batches():
    pf = DevicePrefetcher(FakeStream(10, fail_at=4), lambda nb: nb, depth=2)
    got = []
    with pytest.raises(RuntimeError, match="boom"):
        for nb, _ in pf:
            got.append(int(nb["x"][0]))
    assert got == [0, 1, 2, 3]


def test_prefetch_stateless_stream_returns_none():
    pf = DevicePrefetcher(iter([{"x": np.zeros(1)}]), lambda nb: nb, depth=1)
    try:
        assert pf.get_state() is None
        next(pf)
        assert pf.get_state() is None
    finally:
        pf.close()


def test_prefetch_close_mid_stream_stops_thread():
    pf = DevicePrefetcher(FakeStream(100_000), lambda nb: nb, depth=2)
    next(pf)
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetch_depth_validation():
    with pytest.raises(ValueError, match="depth"):
        DevicePrefetcher(FakeStream(1), lambda nb: nb, depth=0)


def test_prefetch_exhaustion_is_sticky():
    pf = DevicePrefetcher(FakeStream(2), lambda nb: nb, depth=2)
    assert len(list(pf)) == 2
    for _ in range(3):
        with pytest.raises(StopIteration):
            next(pf)


def test_prefetch_error_then_stop_iteration():
    pf = DevicePrefetcher(FakeStream(5, fail_at=1), lambda nb: nb, depth=2)
    next(pf)
    with pytest.raises(RuntimeError, match="boom"):
        next(pf)
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetch_next_after_close_raises():
    pf = DevicePrefetcher(FakeStream(100), lambda nb: nb, depth=1)
    next(pf)
    assert pf.close() is True
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetch_uploads_corpus_batches(corpus_root):
    """The CPU upload over the plain iterator: the same order and values
    as the iterator alone, as tensors."""
    ours, _ = _corpora(corpus_root[0], require_summary=True)
    ref = list(islice(pipeline.batched_iterator(ours, 4, seed=2), 3))
    with DevicePrefetcher(pipeline.batched_iterator(ours, 4, seed=2),
                          batch_uploader(torch.device("cpu")), depth=2) as pf:
        got = list(islice(pf, 3))
    for (nb, dev), want in zip(got, ref):
        for k in want:
            assert isinstance(dev[k], torch.Tensor)
            assert np.array_equal(nb[k], want[k]) and np.array_equal(dev[k].numpy(), want[k])


def test_prefetch_order_and_state_under_thread_switching():
    """With the interpreter switching threads every few microseconds, 3000
    items through depth-1 and depth-4 prefetchers arrive in order, each with
    the state snapshot taken right after it was read."""
    import sys

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for depth in (1, 4):
            pf = DevicePrefetcher(FakeStream(3000), lambda nb: nb["x"] + 1, depth=depth)
            for i, (nb, dev) in enumerate(pf):
                assert int(nb["x"][0]) == i and int(dev[0]) == i + 1
                assert pf.get_state() == str(i + 1).encode()
            assert i == 2999
            pf.close(timeout=10)
            assert not pf._thread.is_alive()
    finally:
        sys.setswitchinterval(interval)
