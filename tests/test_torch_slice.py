"""The port's serving slice against the JAX package, end to end on the CPU:
raw video batch → frontend → model → greedy decode, and the Summarizer on a
synthetic on-disk corpus, with the JAX weights carried across
(``interop.from_jax``) and the same seeded numpy inputs.

Tolerances. f32: picks equal, log-probs ``atol=1e-5, rtol=1e-5`` (the same
f32 arithmetic, sums in XLA's vs PyTorch's order; masked slots hold the
same -1e30 fill). bf16: picks equal, log-probs ``atol=2e-2`` — bf16 keeps
8 significand bits (relative rounding ~4e-3), and XLA and PyTorch round
bf16 intermediates at different places (XLA fuses elementwise chains and
rounds once), differences the LSTMs then carry; 2e-2 is ~5 roundings on
O(1) log-probs.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmbidaf_tpu.config import tiny_test_config
from mmbidaf_tpu.data.frontend import frontend_init as j_frontend_init
from mmbidaf_tpu.data.frontend import make_end_to_end_decode as j_end_to_end
from mmbidaf_tpu.data.synthetic import random_word_vectors, synthetic_batch
from mmbidaf_tpu.models.mmbidaf import mmbidaf_decode as j_decode
from mmbidaf_tpu.models.mmbidaf import mmbidaf_init as j_init
from mmbidaf_tpu.ops.vgg import TINY_SPEC as J_TINY
from mmbidaf_tpu_torch.data.frontend import cast_vgg_weights, make_end_to_end_decode
from mmbidaf_tpu_torch.interop.from_jax import frontend_from_jax, model_from_jax
from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_decode
from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC

REPO = Path(__file__).resolve().parents[1]


def _cfg(kernels=True, dtype="float32", **model):
    cfg = tiny_test_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, img_feat_dim=32, audio_feat_dim=cfg.data.n_mfcc, compute_dtype=dtype,
        use_pallas_lstm=kernels, use_pallas_attention=kernels, use_pallas_melspec=kernels,
        **model))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_weights():
    rng = np.random.default_rng(11)
    cfg = _cfg()
    wv = random_word_vectors(rng, cfg.data.vocab_size, cfg.model.emb_dim)
    params = j_init(jax.random.key(0), cfg, jnp.asarray(wv))
    fe = j_frontend_init(jax.random.key(1), cfg, vgg_spec=J_TINY)
    return params, fe


def _raw_batch(cfg, B=3, frame_hw=(12, 16)):
    """The ``bench.py::make_raw_batch`` layout at tiny shapes: ragged masks
    from ``synthetic_batch``, random uint8 frames, a noise waveform."""
    rng = np.random.default_rng(5)
    d = cfg.data
    base = synthetic_batch(rng, cfg, batch_size=B)
    raw = {k: base[k] for k in ("text_ids", "word_mask", "sent_mask", "img_mask", "aud_mask")}
    raw["frames"] = (rng.random((B, d.max_keyframes, *frame_hw, 3)) * 255).astype(np.uint8)
    n = d.max_audio_frames * d.hop_length + d.win_length
    raw["waveform"] = (rng.standard_normal((B, n)) * 0.1).astype(np.float32)
    raw["waveform"][1] = 0.0  # a silent track
    raw["word_mask"][0, 2] = 0.0  # an empty sentence inside a real transcript
    raw["text_ids"][0, 2] = 0
    return raw


def _run_both(cfg, jax_weights, raw):
    params, fe = jax_weights
    j_lp, j_picks = j_end_to_end(cfg, vgg_spec=J_TINY)(
        params, fe, {k: jnp.asarray(v) for k, v in raw.items()})
    model = model_from_jax(_np(params), cfg, device="cpu")
    front = cast_vgg_weights(frontend_from_jax(_np(fe), cfg, TINY_SPEC, device="cpu"),
                             cfg.model.compute_dtype)
    lp, picks = make_end_to_end_decode(cfg, TINY_SPEC)(
        model, front, {k: torch.from_numpy(v) for k, v in raw.items()})
    return (np.asarray(j_lp), np.asarray(j_picks)), (lp.numpy(), picks.numpy())


@pytest.mark.parametrize("kernels", [True, False], ids=["kernel_flags_on", "kernel_flags_off"])
def test_end_to_end_matches_jax_f32(jax_weights, kernels):
    cfg = _cfg(kernels=kernels)
    raw = _raw_batch(cfg)
    (j_lp, j_picks), (lp, picks) = _run_both(cfg, jax_weights, raw)
    assert lp.shape == (3, cfg.model.max_decode_steps, cfg.data.max_sentences)
    np.testing.assert_array_equal(picks, j_picks)
    np.testing.assert_allclose(lp, j_lp, atol=1e-5, rtol=1e-5)
    # picks are valid, distinct sentences (mask_selected)
    for b in range(picks.shape[0]):
        assert all(raw["sent_mask"][b, p] == 1 for p in picks[b])
        assert len(set(picks[b].tolist())) == len(picks[b])


def test_end_to_end_matches_jax_bf16(jax_weights):
    cfg = _cfg(dtype="bfloat16")
    (j_lp, j_picks), (lp, picks) = _run_both(cfg, jax_weights, _raw_batch(cfg))
    np.testing.assert_array_equal(picks, j_picks)
    np.testing.assert_allclose(lp, j_lp, atol=2e-2, rtol=1e-5)


@pytest.mark.parametrize("model_kw", [
    {"num_rnn_layers": 2},
    {"use_images": False, "use_audio": False},
    {"fusion": "concat_linear", "use_audio": False},
], ids=["stacked_lstm", "text_only", "concat_linear"])
def test_model_configs_match_jax(model_kw):
    """Other tower/fusion configs on precomputed features: stacked
    ``{"layers": [...]}`` BiLSTMs, text-only self-attention, and the fusion
    without a modeling BiLSTM."""
    rng = np.random.default_rng(3)
    cfg = _cfg(**model_kw)
    wv = random_word_vectors(rng, cfg.data.vocab_size, cfg.model.emb_dim)
    params = j_init(jax.random.key(2), cfg, jnp.asarray(wv))
    batch = synthetic_batch(rng, cfg, batch_size=3)
    batch.pop("targets"), batch.pop("target_mask")
    j_lp, j_picks = j_decode(params, {k: jnp.asarray(v) for k, v in batch.items()}, cfg)
    with torch.inference_mode():
        lp, picks = mmbidaf_decode(model_from_jax(_np(params), cfg, device="cpu"),
                                   {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    np.testing.assert_array_equal(picks.numpy(), np.asarray(j_picks))
    np.testing.assert_allclose(lp.numpy(), np.asarray(j_lp), atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_corpus", REPO / "examples" / "make_synthetic_corpus.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path_factory.mktemp("corpus")
    mod.make_corpus(str(out), videos=3, sentences=6, frames=4, seconds=0.5, seed=0)
    return sorted(str(p) for p in out.iterdir())


def test_summarizer_matches_jax(corpus):
    """Port and JAX Summarizers sharing weights return the same summaries,
    through the static serve_batch_size padding (3 requests over batch 2)."""
    from mmbidaf_tpu.serving import Summarizer as JaxSummarizer
    from mmbidaf_tpu_torch.serving import Summarizer

    cfg = _cfg()
    js = JaxSummarizer.init_random(cfg, seed=0, vgg_spec=J_TINY, serve_batch_size=2)
    ts = Summarizer.from_jax_params(_np(js.params), _np(js.fe_params), js.word2idx, cfg,
                                    vgg_spec=TINY_SPEC, device="cpu", serve_batch_size=2)
    ours = ts.summarize_batch(corpus)
    assert ours == js.summarize_batch(corpus)
    assert len(ours) == 3 and all(isinstance(s, str) and s for s in ours)
    assert ts.summarize(corpus[1]) == ours[1]
    assert ts.summarize_batch([]) == []


def test_unported_paths_raise(corpus):
    """What the port refuses, as the JAX package does: data-parallel serving
    without a static batch the data axes divide, ``tp_vgg`` without the
    image tower, a misspelt decode mode (data-parallel, tensor-parallel and
    sequence-parallel serving are ported: ``tests/test_torch_parallel.py``)."""
    from mmbidaf_tpu_torch.serving import Summarizer

    cfg = _cfg()
    with pytest.raises(ValueError, match="serve_batch_size"):
        Summarizer.init_random(cfg, vgg_spec=TINY_SPEC, device="cpu", data_parallel=True)
    no_img = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, use_images=False),
                                 mesh=dataclasses.replace(cfg.mesh, tp_vgg=True))
    with pytest.raises(ValueError, match="image tower is disabled"):
        Summarizer.init_random(no_img, vgg_spec=TINY_SPEC, device="cpu")
    with pytest.raises(ValueError):
        Summarizer.init_random(cfg, vgg_spec=TINY_SPEC, device="cpu", mode="greddy")
    s = Summarizer.init_random(cfg, vgg_spec=TINY_SPEC, device="cpu")
    with pytest.raises(ValueError, match="unknown decode mode"):
        mmbidaf_decode(s.model, {}, cfg, mode="sample")
    with pytest.raises(ValueError, match="2 devices, have 1"):
        Summarizer.init_random(dataclasses.replace(
            cfg, mesh=dataclasses.replace(cfg.mesh, sp_audio=True, num_seq=2)),
            vgg_spec=TINY_SPEC, device="cpu")


def test_sentence_split_without_nltk(monkeypatch):
    """Without nltk installed the port splits sentences with the JAX
    package's own regex fallback (the JAX splitter raises there)."""
    from mmbidaf_tpu.data import text as j_text
    from mmbidaf_tpu_torch.data.text import encode_transcript, sent_tokenize

    transcript = "First point here. Second one follows!  Third (a quote) ends?"
    expected = sent_tokenize(transcript)
    monkeypatch.setitem(__import__("sys").modules, "nltk", None)
    monkeypatch.setitem(__import__("sys").modules, "nltk.tokenize", None)
    with pytest.raises(ImportError):
        j_text.sent_tokenize(transcript)
    assert sent_tokenize(transcript) == expected == [
        "First point here.", "Second one follows!", "Third (a quote) ends?"]
    enc = encode_transcript(transcript, {"first": 2}, 4, 5)
    assert enc["sent_mask"].tolist() == [1, 1, 1, 0]
