"""The PyTorch port's ops and model pieces against their JAX counterparts,
on the CPU in f32, with the same weights and inputs (made from a seed with
numpy and handed to both).

Tolerances: both sides run the same f32 arithmetic on the same CPU, but
XLA and PyTorch order the sums of their products differently, so results
agree to f32 rounding of the sums: ``atol=1e-5`` for O(1) values unless a
test states otherwise. Anything that involves no sum (masking, argmax
picks, numpy constants) is compared exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmbidaf_tpu.ops import audio as j_audio
from mmbidaf_tpu.ops import bidaf as j_bidaf
from mmbidaf_tpu.ops import highway as j_highway
from mmbidaf_tpu.ops import lstm as j_lstm
from mmbidaf_tpu.ops import masked as j_masked
from mmbidaf_tpu.ops import vgg as j_vgg
from mmbidaf_tpu_torch.interop.from_jax import load_pytree
from mmbidaf_tpu_torch.ops import audio as t_audio
from mmbidaf_tpu_torch.ops import bidaf as t_bidaf
from mmbidaf_tpu_torch.ops import highway as t_highway
from mmbidaf_tpu_torch.ops import lstm as t_lstm
from mmbidaf_tpu_torch.ops import masked as t_masked
from mmbidaf_tpu_torch.ops import vgg as t_vgg
from mmbidaf_tpu_torch.ops.common import mm

ATOL = 1e-5
GEN = torch.Generator().manual_seed(0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _ported(module, jax_params):
    """A port module holding the JAX params (the interop loader's path copy)."""
    load_pytree(module, _np(jax_params))
    return module


def _mask(rng, B, T, lengths=None):
    if lengths is None:
        lengths = rng.integers(1, T + 1, size=B)
        lengths[0] = T
    return (np.arange(T)[None] < np.asarray(lengths)[:, None]).astype(np.float32)


def test_masked_softmax_fill_and_uniform_rows(rng):
    logits = rng.standard_normal((3, 5, 7)).astype(np.float32)
    mask = _mask(rng, 3, 7, [7, 2, 0])[:, None, :]
    np.testing.assert_array_equal(
        t_masked.mask_logits(_t(logits), _t(mask)).numpy(),
        np.asarray(j_masked.mask_logits(jnp.asarray(logits), jnp.asarray(mask))),
    )
    for log in (False, True):
        ours = t_masked.masked_softmax(_t(logits), _t(mask), dim=-1, log_softmax=log).numpy()
        ref = np.asarray(j_masked.masked_softmax(jnp.asarray(logits), jnp.asarray(mask),
                                                 axis=-1, log_softmax=log))
        np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=1e-6)
    # a fully masked row is the uniform distribution the -1e30 fill gives
    np.testing.assert_allclose(
        t_masked.masked_softmax(_t(logits), _t(mask))[2].numpy(), np.full((5, 7), 1 / 7), atol=1e-7
    )


def test_mm_promotes_like_jax():
    a = torch.ones(2, 3, dtype=torch.bfloat16)
    b = torch.ones(3, 4)
    assert mm(a, b).dtype == torch.float32
    assert (jnp.ones((2, 3), jnp.bfloat16) @ jnp.ones((3, 4))).dtype == jnp.float32
    assert mm(a, b.bfloat16()).dtype == torch.bfloat16


def test_highway(rng):
    jp = j_highway.highway_init(jax.random.key(1), 2, 6)
    x = rng.standard_normal((4, 5, 6)).astype(np.float32)
    ours = t_highway.highway_apply(_ported(t_highway.Highway(2, 6, GEN, "cpu"), jp), _t(x))
    ref = j_highway.highway_apply(jp, jnp.asarray(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)


def test_lstm_cell(rng):
    h_dim = 5
    gates = rng.standard_normal((3, 4 * h_dim)).astype(np.float32)
    h, c = (rng.standard_normal((3, h_dim)).astype(np.float32) for _ in range(2))
    w_h = rng.standard_normal((h_dim, 4 * h_dim)).astype(np.float32)
    ours = t_lstm.lstm_cell(_t(gates), _t(h), _t(c), _t(w_h))
    ref = j_lstm.lstm_cell(*(jnp.asarray(v) for v in (gates, h, c, w_h)))
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_scan(rng, reverse):
    jp = j_lstm.lstm_init(jax.random.key(2), 6, 8)
    x = rng.standard_normal((4, 9, 6)).astype(np.float32)
    mask = _mask(rng, 4, 9, [9, 4, 1, 0])
    out, (h, c) = t_lstm.lstm_scan(_ported(t_lstm.LSTMParams(6, 8, GEN, "cpu"), jp),
                                   _t(x), _t(mask), reverse=reverse)
    r_out, (r_h, r_c) = j_lstm.lstm_scan(jp, jnp.asarray(x), jnp.asarray(mask), reverse=reverse)
    for o, r in ((out, r_out), (h, r_h), (c, r_c)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_bilstm_pack_padded_and_empty_rows(rng, num_layers):
    """Zero-length rows keep the zero state in both directions; padded steps
    emit zeros; stacked ``{"layers": [...]}`` params load and run."""
    jp = j_lstm.stacked_bilstm_init(jax.random.key(3), 6, 8, num_layers)
    x = rng.standard_normal((5, 7, 6)).astype(np.float32)
    mask = _mask(rng, 5, 7, [7, 3, 0, 1, 5])
    port = _ported(t_lstm.stacked_bilstm_init(6, 8, num_layers, GEN, "cpu"), jp)
    out, (h, c) = t_lstm.bilstm_apply(port, _t(x), _t(mask))
    r_out, (r_h, r_c) = j_lstm.bilstm_apply(jp, jnp.asarray(x), jnp.asarray(mask))
    for o, r in ((out, r_out), (h, r_h), (c, r_c)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL)
    assert not out[2].any() and not h[2].any() and not c[2].any()
    assert not out[1, 3:].any()


def test_bidaf_similarity_and_block(rng):
    B, T_c, T_q, D = 3, 6, 9, 10
    jp = j_bidaf.bidaf_init(jax.random.key(4), D)
    jp = dict(jp, bias=jnp.float32(0.3))
    c = rng.standard_normal((B, T_c, D)).astype(np.float32)
    q = rng.standard_normal((B, T_q, D)).astype(np.float32)
    c_mask, q_mask = _mask(rng, B, T_c), _mask(rng, B, T_q, [9, 0, 4])
    port = _ported(t_bidaf.BiDAFParams(D, GEN, "cpu"), jp)
    np.testing.assert_allclose(
        t_bidaf.similarity_matrix(port, _t(c), _t(q)).numpy(),
        np.asarray(j_bidaf.similarity_matrix(jp, jnp.asarray(c), jnp.asarray(q))), atol=ATOL,
    )
    ours = t_bidaf.bidaf_apply(port, _t(c), _t(q), _t(c_mask), _t(q_mask))
    ref = j_bidaf.bidaf_apply(jp, *(jnp.asarray(v) for v in (c, q, c_mask, q_mask)))
    assert ours.shape == (B, T_c, 4 * D)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("shape", [(16000, 64, 48, 12, 8), (16000, 512, 400, 64, 40)])
def test_audio_consts_bitwise_equal(shape):
    ours = {k: v.numpy() for k, v in t_audio.make_audio_frontend_consts(*shape, device="cpu").items()}
    ref = j_audio.make_audio_frontend_consts(*shape)
    assert set(ours) == set(ref)
    for k in ours:
        assert ours[k].dtype == np.float32
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]))


@pytest.mark.parametrize("feature", ["mfcc", "logmel"])
def test_waveform_to_features(rng, feature):
    """Framing, matmul power spectrum, mel, dB with the per-example max
    reference, DCT (or log-mel) — the unfused path. MFCCs reach ~100 in
    magnitude, so the bound is relative: ``rtol=2e-5, atol=2e-4``."""
    n_fft, win, hop, T = 64, 48, 16, 20
    consts_t = t_audio.make_audio_frontend_consts(16000, n_fft, win, 12, 8, device="cpu")
    consts_j = {k: jnp.asarray(v.numpy()) for k, v in consts_t.items()}
    sig = rng.standard_normal((3, T * hop + win)).astype(np.float32)
    sig[1] = 0.0  # silent example: every dB value is the -100 reference
    frames = t_audio.frame_signal(_t(sig), win, hop, T)
    np.testing.assert_array_equal(frames.numpy(),
                                  np.asarray(j_audio.frame_signal(jnp.asarray(sig), win, hop, T)))
    ours = t_audio.waveform_to_features(_t(sig), consts_t, win, hop, T, feature=feature)
    ref = j_audio.waveform_to_features(jnp.asarray(sig), consts_j, win, hop, T, feature=feature)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-4)
    if feature == "mfcc":
        assert not ours[1].any()


def test_waveform_to_features_unported_paths_raise(rng):
    """Once the unported paths raised; both are ported now. The Stockham FFT
    equals JAX's within ``test_waveform_to_features``' bound."""
    consts = t_audio.make_audio_frontend_consts(16000, 64, 48, 12, 8, device="cpu")
    sig = _t(rng.standard_normal((1, 400)).astype(np.float32))
    stockham = t_audio.waveform_to_features(sig, consts, 48, 16, 10, fft="stockham")
    ref = j_audio.waveform_to_features(jnp.asarray(sig.numpy()),
                                       {k: jnp.asarray(v.numpy()) for k, v in consts.items()},
                                       48, 16, 10, fft="stockham")
    np.testing.assert_allclose(stockham.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-4)
    # the fused log-mel path is ported (K4): it computes the unfused chain
    fused = t_audio.waveform_to_features(sig, consts, 48, 16, 10, feature="logmel", fused=True)
    plain = t_audio.waveform_to_features(sig, consts, 48, 16, 10, feature="logmel")
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("dst,src", [(224, 240), (224, 320), (5, 13), (17, 9), (6, 6)])
def test_resize_matrix_matches_jax_image_resize(dst, src):
    """The port derives jax.image.resize's antialiased half-pixel weights in
    numpy, op by op in f32. ``jax.image.resize`` runs under jit, where XLA
    fuses the same arithmetic (contracted multiply-adds): the two differ by
    up to 7e-6 (measured at 224←320), while each is within 1.4e-5 of the
    exact f64 weights — so ``atol=1e-5`` on weights in [0, 1]."""
    ours = t_vgg.resize_matrix(dst, src)
    ref = np.asarray(j_vgg.resize_matrix(dst, src))
    assert ours.shape == ref.shape == (dst, src) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    # same support (which source pixels feed each output pixel)
    np.testing.assert_array_equal(ours > 0, ref > 0)


def test_preprocess_frames(rng):
    frames = (rng.random((3, 12, 16, 3)) * 255).astype(np.uint8)
    ours = t_vgg.preprocess_frames(_t(frames), 10)
    ref = j_vgg.preprocess_frames(jnp.asarray(frames), 10)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)


def test_vgg_features_carried_weights(rng):
    """HWIO → OIHW conv weights and the NCHW flatten before fc1: features
    equal JAX's (values are O(1); ``atol=1e-4`` covers the conv sums)."""
    from mmbidaf_tpu_torch.interop.from_jax import frontend_from_jax
    from mmbidaf_tpu.config import tiny_test_config
    from mmbidaf_tpu.data.frontend import frontend_init as j_frontend_init

    cfg = tiny_test_config()
    fe = j_frontend_init(jax.random.key(5), cfg, vgg_spec=j_vgg.TINY_SPEC)
    port = frontend_from_jax(_np(fe), cfg, t_vgg.TINY_SPEC, device="cpu")
    images = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    ours = t_vgg.vgg_features(port.vgg, _t(images), t_vgg.TINY_SPEC)
    ref = j_vgg.vgg_features(fe["vgg"], jnp.asarray(images), j_vgg.TINY_SPEC)
    assert ours.shape == (4, cfg.model.img_feat_dim)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)


def test_embedding(rng):
    from mmbidaf_tpu.models.embedding import embedding_apply, embedding_init
    from mmbidaf_tpu_torch.models.embedding import Embedding, embedding_apply as t_apply

    wv = rng.standard_normal((30, 7)).astype(np.float32)
    jp = embedding_init(jax.random.key(6), jnp.asarray(wv), 6, 2)
    ids = rng.integers(0, 30, size=(2, 3, 4)).astype(np.int32)
    port = _ported(Embedding(wv, 6, 2, GEN, "cpu"), jp)
    np.testing.assert_allclose(t_apply(port, _t(ids)).numpy(),
                               np.asarray(embedding_apply(jp, jnp.asarray(ids))), atol=ATOL)


@pytest.mark.parametrize("teacher_forcing", [False, True])
def test_decoder(rng, teacher_forcing):
    """Greedy picks (first maximum, picked sentences masked out) and teacher
    forcing; log-probs compared where finite-valued (masked slots are the
    same -1e30 fill on both sides)."""
    from mmbidaf_tpu.models.decoder import decoder_apply, decoder_init
    from mmbidaf_tpu_torch.models.decoder import Decoder, decoder_apply as t_apply

    B, T_s, d = 4, 7, 10
    jp = decoder_init(jax.random.key(7), d, d)
    M = rng.standard_normal((B, T_s, d)).astype(np.float32)
    sent_mask = _mask(rng, B, T_s, [7, 5, 3, 4])
    targets = np.array([[0, 1, 2], [4, 3, 2], [1, 0, 2], [3, 0, 1]], np.int32)
    kw = dict(num_steps=3, teacher_forcing=teacher_forcing, mask_selected=True)
    lp, picks = t_apply(_ported(Decoder(d, d, GEN, "cpu"), jp), _t(M), _t(sent_mask),
                        targets=_t(targets), **kw)
    r_lp, r_picks = decoder_apply(jp, jnp.asarray(M), jnp.asarray(sent_mask),
                                  targets=jnp.asarray(targets), **kw)
    np.testing.assert_array_equal(picks.numpy(), np.asarray(r_picks))
    np.testing.assert_allclose(lp.numpy(), np.asarray(r_lp), atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("n_frames,image_size,first_ch,itemsize,budget", [
    (1024, 224, 64, 2, 14e9), (2048, 224, 64, 2, 14e9), (1024, 224, 64, 4, 32e9),
    (300, 1024, 64, 2, 5e9), (4, 32, 8, 4, 14e9),
])
def test_auto_vgg_chunk_is_the_jax_rule(n_frames, image_size, first_ch, itemsize, budget):
    """The frame-chunk rule is JAX's; only the budget is re-set for the card."""
    from mmbidaf_tpu.data.frontend import _auto_vgg_chunk as j_chunk
    from mmbidaf_tpu_torch.data.frontend import _auto_vgg_chunk

    assert (_auto_vgg_chunk(n_frames, image_size, first_ch, itemsize, budget)
            == j_chunk(n_frames, image_size, first_ch, itemsize, budget=budget))


def test_vgg_frame_chunks_match_one_pass(rng):
    """Frames are independent, so a chunked VGG pass equals the single pass."""
    import dataclasses

    from mmbidaf_tpu.config import tiny_test_config
    from mmbidaf_tpu_torch.data.frontend import apply_frontend, frontend_init

    cfg = tiny_test_config()
    raw = {"frames": _t((rng.random((2, 6, 12, 16, 3)) * 255).astype(np.uint8)),
           "img_mask": torch.ones(2, 6)}
    fe = frontend_init(cfg, t_vgg.TINY_SPEC, device="cpu")
    one = apply_frontend(fe, raw, cfg, t_vgg.TINY_SPEC)["images"]
    chunked_cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, vgg_frame_chunk=5))
    chunked = apply_frontend(fe, raw, chunked_cfg, t_vgg.TINY_SPEC)["images"]
    np.testing.assert_allclose(chunked.numpy(), one.numpy(), atol=1e-6)


def test_from_jax_refuses_mismatched_weights():
    """Weights cross strictly: a missing or extra path, a wrong shape, or
    audio constants other than the port's own raise instead of loading."""
    from mmbidaf_tpu.config import tiny_test_config
    from mmbidaf_tpu.data.frontend import frontend_init as j_frontend_init
    from mmbidaf_tpu_torch.interop.from_jax import frontend_from_jax

    jp = _np(j_lstm.bilstm_init(jax.random.key(8), 6, 8))
    port = t_lstm.BiLSTMParams(6, 8, GEN, "cpu")
    missing = {"fwd": jp["fwd"], "bwd": {k: v for k, v in jp["bwd"].items() if k != "b"}}
    with pytest.raises(RuntimeError, match="Missing key"):
        load_pytree(port, missing)
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_pytree(port, {"fwd": jp["fwd"], "bwd": dict(jp["bwd"], b=np.zeros(3, np.float32))})
    cfg = tiny_test_config()
    fe = _np(j_frontend_init(jax.random.key(9), cfg, vgg_spec=j_vgg.TINY_SPEC))
    bad = dict(fe, audio_consts=dict(fe["audio_consts"], dct=fe["audio_consts"]["dct"] * 2))
    with pytest.raises(ValueError, match="dct"):
        frontend_from_jax(bad, cfg, t_vgg.TINY_SPEC, device="cpu")
    with pytest.raises(ValueError, match="use_images"):
        frontend_from_jax({"audio_consts": fe["audio_consts"]}, cfg, t_vgg.TINY_SPEC, device="cpu")
