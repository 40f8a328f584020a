"""The port's Stockham FFT (``ops/audio.py``) against the JAX package's and
against ``numpy.fft.rfft`` in f64.

Tolerances. The port runs JAX's butterflies in the same order on the same
f32 twiddles: the power spectra agree to ``rtol=1e-6`` of the largest bin
(XLA may contract a multiply-add the port rounds twice). Against an f64
``rfft`` the f32 FFT's error grows like ``eps·log2(n_fft)`` times the
signal's energy: ``2e-6`` of the largest bin at n_fft up to 1024. MFCC and
log-mel through ``waveform_to_features`` keep ``test_waveform_to_features``'
bound (``rtol=2e-5, atol=2e-4``), and the frontend's audio features the
same.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmbidaf_tpu.config import tiny_test_config as j_tiny_config
from mmbidaf_tpu.data.frontend import apply_frontend as j_apply_frontend
from mmbidaf_tpu.data.frontend import frontend_init as j_frontend_init
from mmbidaf_tpu.ops import audio as j_audio
from mmbidaf_tpu.ops.vgg import TINY_SPEC as J_TINY
from mmbidaf_tpu_torch.config import tiny_test_config
from mmbidaf_tpu_torch.data.frontend import apply_frontend
from mmbidaf_tpu_torch.interop.from_jax import frontend_from_jax
from mmbidaf_tpu_torch.ops import audio as t_audio
from mmbidaf_tpu_torch.ops.cuda import melspec_kernel
from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC

SHAPES = [(16, 16), (64, 48), (256, 256), (512, 400), (1024, 1000)]


def _consts(n_fft, win):
    t = t_audio.make_audio_frontend_consts(16000, n_fft, win, 12, 8, device="cpu")
    return t, {k: jnp.asarray(v.numpy()) for k, v in t.items()}


@pytest.mark.parametrize("n_fft", [2, 16, 512])
def test_stages_equal_jax(n_fft):
    ours, theirs = t_audio.stockham_stages(n_fft), j_audio.stockham_stages(n_fft)
    assert len(ours) == len(theirs) == int(np.log2(n_fft))
    for a, b in zip(ours, theirs):
        assert a[:2] == b[:2]
        np.testing.assert_array_equal(a[2], b[2])
        np.testing.assert_array_equal(a[3], b[3])


@pytest.mark.parametrize("n_fft,win", SHAPES)
def test_power_spectrum_matches_jax_and_numpy(rng, n_fft, win):
    consts_t, consts_j = _consts(n_fft, win)
    frames = rng.standard_normal((2, 5, win)).astype(np.float32)
    ours = t_audio.power_spectrum(torch.from_numpy(frames), consts_t, fft="stockham").numpy()
    theirs = np.asarray(j_audio.stockham_power_spectrum(jnp.asarray(frames), consts_j))
    window = t_audio.hann_window(win).astype(np.float64)
    exact = np.abs(np.fft.rfft(frames.astype(np.float64) * window, n=n_fft)) ** 2
    assert ours.shape == theirs.shape == (2, 5, n_fft // 2 + 1) and ours.dtype == np.float32
    top = exact.max()
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6 * top)
    np.testing.assert_allclose(ours, exact, rtol=0, atol=2e-6 * top)


def test_non_power_of_two_and_unknown_fft_raise(rng):
    consts, _ = _consts(400, 400)
    frames = torch.from_numpy(rng.standard_normal((1, 3, 400)).astype(np.float32))
    with pytest.raises(ValueError, match="power-of-two"):
        t_audio.stockham_power_spectrum(frames, consts)
    with pytest.raises(ValueError, match="unknown fft"):
        t_audio.power_spectrum(frames, consts, fft="radix4")
    sig = torch.from_numpy(rng.standard_normal((1, 4000)).astype(np.float32))
    with pytest.raises(ValueError, match="unknown fft"):
        t_audio.waveform_to_features(sig, consts, 400, 160, 5, fft="radix4")


@pytest.mark.parametrize("feature", ["mfcc", "logmel"])
def test_waveform_to_features_stockham_drops_fused(rng, monkeypatch, feature):
    """``fft="stockham"`` equals JAX's and takes no kernel with ``fused``:
    the K3/K4 wrappers are never called (as in JAX, where the fused Pallas
    pass is matmul-DFT inside)."""
    consts_t, consts_j = _consts(64, 48)
    sig = rng.standard_normal((3, 20 * 16 + 48)).astype(np.float32)
    sig[1] = 0.0
    ref = j_audio.waveform_to_features(jnp.asarray(sig), consts_j, 48, 16, 20, feature=feature,
                                       fft="stockham")

    def no_kernel(*a, **k):
        raise AssertionError("a kernel ran on the Stockham path")

    monkeypatch.setattr(melspec_kernel, "mfcc_fused", no_kernel)
    monkeypatch.setattr(melspec_kernel, "log_mel_fused", no_kernel)
    for fused in (False, True):
        ours = t_audio.waveform_to_features(torch.from_numpy(sig), consts_t, 48, 16, 20,
                                            feature=feature, fused=fused, fft="stockham")
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-4)


def test_frontend_takes_audio_fft(rng):
    """``DataConfig.audio_fft="stockham"`` reaches the port's frontend with
    the kernel flag on: its audio features equal JAX's frontend's."""
    cfg, j_cfg = tiny_test_config(), j_tiny_config()
    cfg, j_cfg = (dataclasses.replace(c, data=dataclasses.replace(c.data, audio_fft="stockham"),
                                      model=dataclasses.replace(c.model, use_pallas_melspec=True,
                                                                use_images=False))
                  for c in (cfg, j_cfg))
    j_fe = j_frontend_init(jax.random.key(0), j_cfg, vgg_spec=J_TINY)
    fe = frontend_from_jax(jax.tree.map(np.asarray, j_fe), cfg, TINY_SPEC, device="cpu")
    T = cfg.data.max_audio_frames
    n = (T - 1) * cfg.data.hop_length + cfg.data.win_length
    raw = {"waveform": rng.standard_normal((2, n)).astype(np.float32),
           "aud_mask": np.ones((2, T), np.float32)}
    ours = apply_frontend(fe, {k: torch.from_numpy(v) for k, v in raw.items()}, cfg, TINY_SPEC)
    ref = j_apply_frontend(j_fe, {k: jnp.asarray(v) for k, v in raw.items()}, j_cfg, J_TINY)
    np.testing.assert_allclose(ours["audio"].numpy(), np.asarray(ref["audio"]),
                               rtol=2e-5, atol=2e-4)
