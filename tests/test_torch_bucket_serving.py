"""Bucket-ladder serving of the port against the JAX package, on the CPU.

The ladder helpers are numpy and must equal JAX's exactly. A bucketed
``Summarizer`` trims each batch's ragged axes to the rungs covering its true
lengths; the masks carry the lengths, so its greedy and beam answers must
equal JAX's bucketed ``Summarizer``'s (same weights, ``interop.from_jax``)
and the unbucketed port's, and its ``bucket_stats`` JAX's. The kernel flags
are on: on the CPU each wrapper runs its plain version, JAX its kernel (K3's
dB reference over the trimmed frames included). ``warmup`` runs every
diagonal level and leaves top-k's stream alone.
"""

import dataclasses
import wave as wave_mod

import numpy as np
import pytest
import torch

import jax

from mmbidaf_tpu import serving as jserving
from mmbidaf_tpu.config import MeshConfig, tiny_test_config
from mmbidaf_tpu.ops.vgg import TINY_SPEC as J_TINY
from mmbidaf_tpu_torch import serving
from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC


def _cfg(kernels=True):
    cfg = tiny_test_config()  # caps: T_s 7, W 9, T_img 6, T_aud 11
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, img_feat_dim=32, audio_feat_dim=cfg.data.n_mfcc, use_pallas_lstm=kernels,
        use_pallas_attention=kernels, use_pallas_melspec=kernels))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# -- the ladder helpers ---------------------------------------------------------


@pytest.mark.parametrize("spec", [
    True,
    {"keyframes": (2,), "audio_frames": (4, 8)},
    {"sentences": [3, 5, 100], "words": (2,)},
    {"audio_frames": (11, 1)},
], ids=["defaults", "explicit", "past_cap", "cap_rung"])
def test_ladders_and_levels_match_jax(spec):
    cfg = _cfg()
    lad = serving.serving_bucket_ladders(cfg, spec)
    assert lad == jserving.serving_bucket_ladders(cfg, spec)
    levels = serving.bucket_ladder_levels(lad)
    assert levels == jserving.bucket_ladder_levels(lad)
    rng = np.random.default_rng(0)
    for _ in range(50):
        needs = {k: int(rng.integers(1, v[-1] + 1)) for k, v in lad.items()}
        assert serving.covering_level(levels, needs) == jserving.covering_level(levels, needs)


@pytest.mark.parametrize("bad", [{"frames": (2,)}, {"keyframes": (0, 2)}, (4, 8), [4, 8], {}, "auto"],
                         ids=["axis", "rung0", "tuple", "list", "empty", "str"])
def test_ladder_errors_match_jax(bad):
    cfg = _cfg()
    with pytest.raises(ValueError) as want:
        jserving.serving_bucket_ladders(cfg, bad)
    with pytest.raises(ValueError) as got:
        serving.serving_bucket_ladders(cfg, bad)
    assert str(got.value) == str(want.value)


def test_sp_audio_rounding_matches_jax():
    cfg = _cfg()
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, max_audio_frames=16),
                              mesh=MeshConfig(num_data=2, num_seq=4, sp_audio=True))
    for spec in ({"audio_frames": (3, 6)}, True):
        lad = serving.serving_bucket_ladders(cfg, spec)
        assert lad == jserving.serving_bucket_ladders(cfg, spec)
    assert serving.serving_bucket_ladders(cfg, {"audio_frames": (3, 6)})["audio_frames"] == (4, 8, 16)
    bad = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, max_audio_frames=14))
    with pytest.raises(ValueError, match="multiple of"):
        serving.serving_bucket_ladders(bad, True)


def test_covering_level_missing_axis_never_covers():
    levels = [{"sentences": 4, "words": 4}]
    assert serving.covering_level(levels, {"sentences": 2, "keyframes": 3}) == -1
    assert serving.covering_level(levels, {"sentences": 2, "words": 4}) == 0


def _ragged_raw(cfg, B=3, featurized=False, seed=2):
    rng = np.random.default_rng(seed)
    d = cfg.data
    raw = {
        "text_ids": rng.integers(2, d.vocab_size, (B, d.max_sentences, d.max_words)).astype(np.int32),
        "word_mask": np.zeros((B, d.max_sentences, d.max_words), np.float32),
        "sent_mask": np.zeros((B, d.max_sentences), np.float32),
        "img_mask": np.zeros((B, d.max_keyframes), np.float32),
        "aud_mask": np.zeros((B, d.max_audio_frames), np.float32),
        "targets": np.zeros((B, 3), np.int32),
    }
    if featurized:
        raw["images"] = rng.standard_normal((B, d.max_keyframes, 32)).astype(np.float32)
        raw["audio"] = rng.standard_normal((B, d.max_audio_frames, d.n_mfcc)).astype(np.float32)
    else:
        raw["frames"] = rng.integers(0, 255, (B, d.max_keyframes, 12, 16, 3)).astype(np.uint8)
        n = d.max_audio_frames * d.hop_length + d.win_length
        raw["waveform"] = rng.standard_normal((B, n)).astype(np.float32)
    for b, (s, w, i, a) in enumerate(((3, 4, 2, 4), (1, 2, 1, 6), (2, 1, 3, 2))[:B]):
        raw["sent_mask"][b, :s] = 1.0
        raw["word_mask"][b, :s, :w] = 1.0
        raw["img_mask"][b, :i] = 1.0
        raw["aud_mask"][b, :a] = 1.0
    return raw


@pytest.mark.parametrize("featurized", [False, True], ids=["raw", "featurized"])
@pytest.mark.parametrize("drop", [None, "img_mask"], ids=["all_axes", "no_images"])
def test_trims_match_jax(featurized, drop):
    cfg = _cfg()
    raw = _ragged_raw(cfg, featurized=featurized)
    if drop:
        for k in (drop, "frames", "images"):
            raw.pop(k, None)
    assert serving.batch_true_lengths(raw) == jserving.batch_true_lengths(raw)
    lad = serving.serving_bucket_ladders(cfg, True)
    got, want = serving.trim_raw_batch(raw, cfg, lad), jserving.trim_raw_batch(raw, cfg, lad)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["sent_mask"].shape[1] < cfg.data.max_sentences
    rungs = {"sentences": 4, "words": 5, "keyframes": 3, "audio_frames": 7}
    for b in range(3):  # one row at a time, as _stack_rows trims
        row = {k: v[b] for k, v in raw.items()}
        assert serving.batch_true_lengths(row) == jserving.batch_true_lengths(row)
        got = serving.trim_raw_to_rungs(row, cfg, rungs, batched=False)
        want = jserving.trim_raw_to_rungs(row, cfg, rungs, batched=False)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_record_bucket_stat_matches_jax():
    import threading

    cfg = _cfg()
    raw = serving.trim_raw_batch(_ragged_raw(cfg), cfg, serving.serving_bucket_ladders(cfg, True))
    ours, theirs, lock = {}, {}, threading.Lock()
    for _ in range(2):
        serving.record_bucket_stat(ours, lock, raw)
        jserving.record_bucket_stat(theirs, lock, raw)
    assert ours == theirs and list(ours.values()) == [2]


# -- the bucketed Summarizer ------------------------------------------------------


def _write_video(vd, rng, cfg, sentences, n_frames, audio_frac):
    from PIL import Image

    d = cfg.data
    (vd / "frames").mkdir(parents=True)
    for i in range(n_frames):
        Image.fromarray((rng.random((12, 16, 3)) * 255).astype(np.uint8)).save(vd / "frames" / f"f{i}.png")
    n = max(int((d.max_audio_frames * d.hop_length + d.win_length) * audio_frac), 1)
    with wave_mod.open(str(vd / "audio.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(d.sample_rate)
        w.writeframes((rng.standard_normal(n) * 8000).astype(np.int16).tobytes())
    (vd / "transcript.txt").write_text(" ".join(sentences))
    return str(vd)


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """Three short ragged videos, one at the caps, one long transcript and
    one empty transcript. Sentences use the init_random vocabulary ("w<i>",
    a leading capital for the sentence splitter) so embeddings are distinct
    and no argmax ties."""
    rng = np.random.default_rng(17)
    cfg = _cfg()
    root = tmp_path_factory.mktemp("bucket_vids")
    short = [_write_video(root / f"vid{v}", rng, cfg,
                          [f"W{(7 * v + 2 * j) % 30} w{(7 * v + 2 * j + 1) % 30}." for j in range(3)],
                          n_frames=2, audio_frac=0.3) for v in range(3)]
    full = _write_video(root / "full", rng, cfg,
                        [f"W{j} w{j + 40} w{j + 50} w{j + 60} w{j + 70} w{j + 80}." for j in range(7)],
                        n_frames=6, audio_frac=1.0)
    long_vid = _write_video(root / "long", rng, cfg,
                            [f"W{2 * j} w{2 * j + 1} w{(3 * j) % 40}." for j in range(12)],
                            n_frames=2, audio_frac=0.3)
    empty = _write_video(root / "empty", rng, cfg, [], n_frames=1, audio_frac=0.2)
    return {"short": short, "full": full, "long": long_vid, "empty": empty}


@pytest.fixture(scope="module")
def pair():
    """JAX's and the port's Summarizer factories over the same weights."""
    cfg = _cfg()
    base = jserving.Summarizer.init_random(cfg, seed=5, vgg_spec=J_TINY)
    params, fe = _np(base.params), _np(base.fe_params)

    def jax_s(**kw):
        return jserving.Summarizer(base.params, base.fe_params, base.word2idx, cfg, J_TINY, **kw)

    def port_s(**kw):
        return serving.Summarizer.from_jax_params(params, fe, base.word2idx, cfg, TINY_SPEC,
                                                  device="cpu", **kw)

    return jax_s, port_s


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_bucketed_summarize_batch_matches_jax(pair, videos, mode):
    jax_s, port_s = pair
    kw = {"mode": mode, "topk": 3} if mode == "beam" else {}
    js, ts, plain = jax_s(serve_buckets=True, **kw), port_s(serve_buckets=True, **kw), port_s(**kw)
    batch = videos["short"] + [videos["empty"]]
    ours = ts.summarize_batch(batch)
    assert ours == js.summarize_batch(batch) == plain.summarize_batch(batch)
    assert ts.summarize(videos["full"]) == js.summarize(videos["full"]) == plain.summarize(videos["full"])
    assert ts.bucket_stats == js.bucket_stats
    d = ts.cfg.data
    caps = (d.max_sentences, d.max_words, d.max_keyframes, d.max_audio_frames)
    assert caps in ts.bucket_stats  # the full video decodes at the caps
    assert any(all(r < c for r, c in zip(rung, caps)) for rung in ts.bucket_stats)


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_bucketed_summarize_long_matches_jax(pair, videos, mode):
    """The long video's media are trimmed before the B=1 featurize; its
    windows then decode at feature shapes."""
    jax_s, port_s = pair
    kw = {"mode": mode, "topk": 3} if mode == "beam" else {}
    ts = port_s(serve_buckets=True, serve_batch_size=2, **kw)
    ours = ts.summarize_long(videos["long"])
    assert ours == jax_s(serve_buckets=True, serve_batch_size=2, **kw).summarize_long(videos["long"])
    assert ours == port_s(serve_batch_size=2, **kw).summarize_long(videos["long"])
    assert ts.summarize_long(videos["short"][0]) == ts.summarize(videos["short"][0])
    assert all(rung[2] < ts.cfg.data.max_keyframes for rung in ts.bucket_stats)


def test_explicit_ladder_dict(pair, videos):
    _, port_s = pair
    s = port_s(serve_buckets={"keyframes": (2,), "audio_frames": (6,)})
    assert s.summarize(videos["short"][0]) == port_s().summarize(videos["short"][0])
    (rung,) = s.bucket_stats
    assert rung[2] == 2 and rung[3] == 6
    off = port_s(serve_buckets=False)
    assert off._ladders is None and off.bucket_levels == []


def test_warmup_runs_every_diagonal_level(pair, videos):
    """Warmup at B=2 with the long programs: the full shape and each
    diagonal level at B=2 and B=1, then the featurized window decode; the
    answers after it equal a cold summarizer's."""
    _, port_s = pair
    s = port_s(serve_buckets=True)
    seen = []
    orig = s._decode_batch_device

    def spy(raw, generator=None):
        seen.append((raw["sent_mask"].shape[0], raw["sent_mask"].shape[1],
                     raw["word_mask"].shape[2], raw["img_mask"].shape[1],
                     raw["aud_mask"].shape[1], "frames" in raw))
        return orig(raw, generator=generator)

    s._decode_batch_device = spy
    s.warmup(frame_hw=(12, 16), batch_size=2, include_long=True)
    d = s.cfg.data
    caps = (d.max_sentences, d.max_words, d.max_keyframes, d.max_audio_frames)
    levels = [tuple(lv[k] for k in serving.AXES) for lv in s.bucket_levels]
    assert len(levels) == 2
    want = [(2, *caps, True)] + [(2, *lv, True) for lv in levels]
    want += [(1, *caps, True)] + [(1, *lv, True) for lv in levels] + [(2, *caps, False)]
    assert seen == want
    assert s.bucket_stats == {}  # warmup's zero batches are not requests
    assert s.summarize_batch(videos["short"]) == port_s(serve_buckets=True).summarize_batch(videos["short"])


def test_warmup_keeps_the_topk_stream(pair, videos):
    _, port_s = pair
    warm = port_s(mode="topk", topk=3, seed=3, serve_batch_size=2)
    warm.warmup(frame_hw=(12, 16), include_long=True)
    cold = port_s(mode="topk", topk=3, seed=3, serve_batch_size=2)
    dirs = videos["short"]
    assert warm.summarize_batch(dirs) == cold.summarize_batch(dirs)
    other = port_s(mode="topk", topk=3, seed=4, serve_batch_size=2)
    assert all(isinstance(x, str) for x in other.summarize_batch(dirs))


def test_topk_summarizer_valid_and_seeded(pair, videos):
    """Top-k answers are summaries of distinct transcript sentences, equal
    under one seed."""
    _, port_s = pair
    a = port_s(mode="topk", topk=2, seed=8).summarize_batch(videos["short"])
    b = port_s(mode="topk", topk=2, seed=8).summarize_batch(videos["short"])
    assert a == b
    for vd, summary in zip(videos["short"], a):
        transcript = open(f"{vd}/transcript.txt").read()
        assert summary and all(sent in transcript for sent in summary.split(". ") if sent)


def test_upload_keeps_device_tensors(pair):
    """``_stack_rows`` stacks tensors already on the device beside numpy rows
    (the featurized windows of summarize_long)."""
    _, port_s = pair
    s = port_s(serve_buckets=True)
    cfg = s.cfg
    raw = _ragged_raw(cfg, featurized=True)
    rows = [{k: (torch.from_numpy(v[b]) if k in ("images", "audio") else v[b])
             for k, v in raw.items() if k != "targets"} for b in range(3)]
    out = s._stack_rows(rows)
    assert all(isinstance(v, torch.Tensor) for v in out.values())
    want = serving.trim_raw_batch({k: v for k, v in raw.items() if k != "targets"}, cfg, s._ladders)
    for k, v in want.items():
        np.testing.assert_array_equal(out[k].numpy(), v)
