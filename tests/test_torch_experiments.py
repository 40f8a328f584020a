"""The port's A/B and profiling drivers (``mmbidaf_tpu_torch/experiments/``)
on the CPU, against the JAX package's functions they time.

The same seeded inputs go through both packages; on CPU tensors each kernel
wrapper (K1-K8, K10, K14) runs its plain version. Tolerances, f32 on both
sides with sums in different orders:

- ``fft_ab``: the matmul-DFT and Stockham power spectra and K4's log-mel
  within ``1e-5`` of the largest value of JAX's ``power_spectrum``,
  ``stockham_power_spectrum`` and ``log_mel`` on the same frames;
- ``conv_profile``'s int8 im2col product: equal, exactly, to JAX's int8
  ``lax.conv_general_dilated`` with int32 accumulation;
- ``train_breakdown`` at drop 0 on weights carried by ``interop/from_jax.py``:
  the forward loss and the gradient norms of ``value_and_grad`` (every
  trainable leaf) and ``decoder_grad`` (the decoder's leaves) ``rtol=1e-5``
  against JAX's ``mmbidaf_apply`` / ``decoder_apply`` + ``nll_loss``;
- ``e2e_breakdown``'s stages at the quick bench config against
  ``apply_frontend``, ``preprocess_frames``, ``vgg_features``,
  ``waveform_to_features``, ``mmbidaf_decode`` and the end-to-end program:
  the resize ``atol=5e-5`` (``resize_matrix`` differs from XLA's by up to
  7e-6 before the division by the ImageNet std), features and log-probs
  ``atol=rtol=1e-4`` (VGG and MFCC values up to ~100), greedy picks equal.

Each driver's ``main`` also runs once with tiny flags on the CPU, every
line it prints parsed as JSON, and raises without a card unless given
``--device cpu``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from mmbidaf_tpu.config import tiny_test_config as j_tiny_config
from mmbidaf_tpu.data import frontend as j_frontend
from mmbidaf_tpu.data.synthetic import random_word_vectors, synthetic_batch
from mmbidaf_tpu.models.decoder import decoder_apply as j_decoder_apply
from mmbidaf_tpu.models.mmbidaf import mmbidaf_apply as j_apply
from mmbidaf_tpu.models.mmbidaf import mmbidaf_decode as j_decode
from mmbidaf_tpu.models.mmbidaf import mmbidaf_init as j_init
from mmbidaf_tpu.ops import audio as j_audio
from mmbidaf_tpu.ops import vgg as j_vgg
from mmbidaf_tpu.train.loop import nll_loss as j_nll
from mmbidaf_tpu_torch.config import tiny_test_config
from mmbidaf_tpu_torch.experiments import (beam_ab, bucket_ab, conv_profile, e2e_breakdown,
                                           fft_ab, prefetch_ab, preprocess_profile,
                                           train_breakdown, winograd_pallas_profile,
                                           winograd_profile)
from mmbidaf_tpu_torch.interop.from_jax import flatten_pytree, frontend_from_jax, model_from_jax
from mmbidaf_tpu_torch.ops import audio
from mmbidaf_tpu_torch.ops.cuda import melspec_kernel
from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC
from mmbidaf_tpu_torch.train.loop import init_train_state, trainable_parameters
from mmbidaf_tpu_torch.utils.bench_config import build_bench_config, make_raw_batch_on_device

FEATURE_TOL = {"atol": 1e-4, "rtol": 1e-4}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# fft_ab
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_fft", [512, 4096], ids=["fft_route", "dense_route"])
def test_fft_ab_spectra_match_jax(n_fft):
    win = fft_ab.window_for(n_fft)
    frames = (np.random.default_rng(0).standard_normal((16, win)) * 0.1).astype(np.float32)
    consts = audio.make_audio_frontend_consts(fft_ab.SAMPLE_RATE, n_fft, win, fft_ab.N_MELS,
                                              fft_ab.N_MFCC, device="cpu")
    got = {k: v.numpy() for k, v in fft_ab.spectra(torch.from_numpy(frames), consts).items()}
    jc = {k: jnp.asarray(v) for k, v in j_audio.make_audio_frontend_consts(
        fft_ab.SAMPLE_RATE, n_fft, win, fft_ab.N_MELS, fft_ab.N_MFCC).items()}
    want = jax.jit(lambda f: {"matmul": j_audio.power_spectrum(f, jc),
                              "stockham": j_audio.stockham_power_spectrum(f, jc),
                              "k4": j_audio.log_mel(f, jc)})(jnp.asarray(frames))
    route = melspec_kernel.log_mel_route(win, n_fft // 2 + 1)
    assert route == "fft"  # 4096 too: the FFT route reaches n_fft 8192
    # the dense route also holds 4096, at 8 frames a block
    assert melspec_kernel.dense_frames(win, n_fft // 2 + 1) == (32 if n_fft <= 512 else 8)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].shape == w.shape
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=k)
    ref = fft_ab.reference_spectra(frames, n_fft, consts["mel_fb"].numpy())
    err = np.abs(got["stockham"] - ref["power"]).max() / ref["power"].max()
    assert err < fft_ab.STOCKHAM_RTOL


# ---------------------------------------------------------------------------
# conv_profile's int8 arm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw,cin,cout", [(5, 3, 16), (6, 16, 8)])
def test_int8_im2col_equals_jax_int8_conv(hw, cin, cout):
    rng = np.random.default_rng(hw)
    x = rng.integers(-127, 127, (2, hw, hw, cin)).astype(np.int8)
    w = rng.integers(-127, 127, (3, 3, cin, cout)).astype(np.int8)
    want = lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (1, 1), "SAME",
                                    dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                    preferred_element_type=jnp.int32)
    got = conv_profile.conv_int8_im2col(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert conv_profile.im2col_int8(torch.from_numpy(x)).shape[1] % 8 == 0


# ---------------------------------------------------------------------------
# train_breakdown
# ---------------------------------------------------------------------------


def test_train_breakdown_matches_jax():
    jcfg = j_tiny_config()
    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, use_pallas_lstm=True, use_pallas_attention=True))
    rng = np.random.default_rng(3)
    wv = random_word_vectors(rng, jcfg.data.vocab_size, jcfg.model.emb_dim)
    params = j_init(jax.random.key(0), jcfg, jnp.asarray(wv))
    batch = synthetic_batch(rng, jcfg, batch_size=3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    state = init_train_state(model_from_jax(_np(params), cfg, "cpu"), cfg, seed=1)
    gen = torch.Generator().manual_seed(7)
    trainable = {n for n, _ in trainable_parameters(state.params)}

    def j_loss(p):
        log_p = j_apply(p, jb, jcfg, rng=jax.random.key(7))
        return j_nll(log_p, jb["targets"], jb["target_mask"])

    j_l, j_g = jax.jit(jax.value_and_grad(j_loss))(params)
    j_norm = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64)))
                         for k, g in flatten_pytree(_np(j_g)).items() if k in trainable))
    loss = train_breakdown.forward_loss(state.params, tb, cfg, gen)
    np.testing.assert_allclose(float(loss), float(j_l), rtol=1e-5)
    loss, grads = train_breakdown.value_and_grad(state.params, tb, cfg, gen)
    assert set(grads) == trainable
    np.testing.assert_allclose(float(loss), float(j_l), rtol=1e-5)
    np.testing.assert_allclose(train_breakdown.grad_norm(grads), j_norm, rtol=1e-5)

    M = np.random.default_rng(4).standard_normal(
        (3, jcfg.data.max_sentences, 2 * jcfg.model.hidden_size)).astype(np.float32)

    def j_dec_loss(dp):
        log_p, _ = j_decoder_apply(dp, jnp.asarray(M), jb["sent_mask"], targets=jb["targets"],
                                   num_steps=jcfg.model.max_decode_steps, teacher_forcing=True,
                                   mask_selected=jcfg.model.mask_selected)
        return j_nll(log_p, jb["targets"], jb["target_mask"])

    jd_l, jd_g = jax.jit(jax.value_and_grad(j_dec_loss))(params["decoder"])
    loss, grads = train_breakdown.decoder_grad(state.params.decoder, torch.from_numpy(M), tb, cfg)
    assert set(grads) == {n for n, _ in state.params.decoder.named_parameters()}
    np.testing.assert_allclose(float(loss), float(jd_l), rtol=1e-5)
    jd_norm = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64)))
                          for g in flatten_pytree(_np(jd_g)).values()))
    np.testing.assert_allclose(train_breakdown.grad_norm(grads), jd_norm, rtol=1e-5)


# ---------------------------------------------------------------------------
# e2e_breakdown
# ---------------------------------------------------------------------------


def test_e2e_breakdown_stages_match_jax():
    import bench as jbench

    cfg, jcfg = build_bench_config(True), jbench.build_bench_config(True)
    d, m = cfg.data, cfg.model
    B = 2
    wv = random_word_vectors(np.random.default_rng(0), d.vocab_size, m.emb_dim)
    params = j_init(jax.random.key(0), jcfg, jnp.asarray(wv))
    fe_params = j_frontend.frontend_init(jax.random.key(1), jcfg, vgg_spec=j_vgg.TINY_SPEC)
    model = model_from_jax(_np(params), cfg, "cpu")
    fe = frontend_from_jax(_np(fe_params), cfg, TINY_SPEC, "cpu")
    raw = make_raw_batch_on_device(cfg, B, "cpu", frame_hw=(24, 32))
    inputs = e2e_breakdown.stage_inputs(cfg, B, "cpu")
    stages = e2e_breakdown.make_stages(cfg, model, fe, raw, inputs, TINY_SPEC)
    assert tuple(stages) == e2e_breakdown.STAGES
    jraw = {k: jnp.asarray(v.numpy()) for k, v in raw.items()}
    got = {k: jax.tree.map(lambda t: t.numpy(), fn()) for k, fn in stages.items()}

    lp, picks = j_frontend.make_end_to_end_decode(jcfg, j_vgg.TINY_SPEC)(params, fe_params, jraw)
    np.testing.assert_array_equal(got["full_pipeline"][1], np.asarray(picks))
    np.testing.assert_allclose(got["full_pipeline"][0], np.asarray(lp), **FEATURE_TOL)
    jfeats = jax.jit(lambda r: j_frontend.apply_frontend(fe_params, r, jcfg, j_vgg.TINY_SPEC))(jraw)
    for k in ("images", "audio"):
        np.testing.assert_allclose(got["frontend"][k], np.asarray(jfeats[k]), **FEATURE_TOL,
                                   err_msg=k)
    flat = jraw["frames"].reshape((-1,) + jraw["frames"].shape[2:])
    resized = jax.jit(lambda f: j_vgg.preprocess_frames(f, d.image_size))(flat)
    np.testing.assert_allclose(got["resize_normalize"], np.asarray(resized), atol=5e-5)
    j_vgg_features = jax.jit(lambda x: j_vgg.vgg_features(fe_params["vgg"], x, j_vgg.TINY_SPEC))
    vgg = j_vgg_features(jnp.asarray(inputs["imgs"].numpy()))
    np.testing.assert_allclose(got["vgg_only"], np.asarray(vgg), **FEATURE_TOL)
    np.testing.assert_allclose(got["vgg_on_resized"], np.asarray(j_vgg_features(resized)),
                               **FEATURE_TOL)
    mfcc = jax.jit(lambda w: j_audio.waveform_to_features(
        w, fe_params["audio_consts"], d.win_length, d.hop_length, d.max_audio_frames,
        feature="mfcc"))(jraw["waveform"])
    np.testing.assert_allclose(got["audio_frontend"], np.asarray(mfcc), **FEATURE_TOL)
    feats = {k: jraw[k] for k in ("text_ids", "word_mask", "sent_mask", "img_mask", "aud_mask")}
    feats.update(images=jnp.asarray(inputs["images"].numpy()),
                 audio=jnp.asarray(inputs["audio"].numpy()))
    lp, picks = jax.jit(lambda p, f: j_decode(p, f, jcfg))(params, feats)
    np.testing.assert_array_equal(got["model_decode_on_features"][1], np.asarray(picks))
    np.testing.assert_allclose(got["model_decode_on_features"][0], np.asarray(lp), **FEATURE_TOL)


# ---------------------------------------------------------------------------
# every driver's main on the CPU
# ---------------------------------------------------------------------------

TINY = {
    "conv_profile": (conv_profile, ["--n", "1", "--layers", "conv1_1,conv5_x", "--gemm_size",
                                    "32", "--iters", "1", "--skip_full"]),
    "winograd_profile": (winograd_profile, ["--n", "1", "--layers", "conv5_x", "--iters", "1"]),
    "winograd_pallas_profile": (winograd_pallas_profile, ["--n", "1", "--layers", "conv5_x",
                                                          "--iters", "1"]),
    "preprocess_profile": (preprocess_profile, ["--frames", "2", "--iters", "1"]),
    "fft_ab": (fft_ab, ["--frames", "8", "--nffts", "512,4096", "--iters", "1"]),
    "e2e_breakdown": (e2e_breakdown, ["--quick", "--batch", "2", "--iters", "1"]),
    "train_breakdown": (train_breakdown, ["--quick", "--batch", "2", "--iters", "1",
                                          "--pallas"]),
    "beam_ab": (beam_ab, ["--quick", "--batch", "2", "--iters", "1"]),
    "bucket_ab": (bucket_ab, ["--quick", "--batch", "2", "--iters", "1"]),
    "prefetch_ab": (prefetch_ab, ["--quick", "--batch", "2", "--steps", "1", "--pallas"]),
}


@pytest.mark.parametrize("name", list(TINY))
def test_driver_main_on_the_cpu(name, capsys):
    mod, argv = TINY[name]
    ret = mod.main(argv + ["--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.strip()]
    assert lines
    if isinstance(ret, dict):  # the A/B drivers print one line
        assert lines == [json.loads(json.dumps(ret))]
    else:
        assert lines == json.loads(json.dumps(ret)) and lines[0]["device"] == "cpu"
    if name == "fft_ab":
        assert [r["k4_route"] for r in lines[1:]] == ["fft", "fft"]  # the FFT route to 8192
        assert "k4_log_mel_ms" in lines[1] and "k4_log_mel_ms" in lines[2]
    if name == "bucket_ab":
        assert ret["picks_mismatched"] == 0 and ret["rungs"]["keyframes"] < 4
    if name == "train_breakdown":
        assert [r["op"] for r in lines[1:]] == list(train_breakdown.PARTS)
        assert all(np.isfinite(r["loss"]) for r in lines[1:])


@pytest.mark.parametrize("name", list(TINY))
def test_driver_defaults_to_the_card(name):
    """Without ``--device cpu`` a driver asks for the card, and raises
    without one instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TINY[name][0].main(TINY[name][1])
