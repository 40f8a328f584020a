"""The port's long-video serving path against the JAX package on the CPU:
the tiled mel kernel K4 (``log_mel_fused``) and the blockwise BiDAF kernel
K9 (``bidaf_attention_tiled``) through their plain versions against the JAX
Pallas kernels in interpret mode, the two frontend branches K4 serves
(``audio_features="logmel"`` and MFCC past ``mfcc_fused_fits``), the BiDAF
wrapper's choice between K2 and K9, and windowed long-transcript serving
(``Summarizer.summarize_long``) with the JAX weights carried across.

Tolerances: f32 on both sides with sums in different orders. Log-mel
values are O(10): ``atol=2e-5, rtol=1e-5``; the raw mel is a power sum up
to ~1e3, held at ``rtol=1e-5`` of each value plus ``1e-5·max|ref|``; BiDAF
outputs are O(1): ``atol=3e-5`` as ``tests/test_pallas_kernels.py`` holds
the tiled kernel; MFCCs reach ~100: ``rtol=2e-4, atol=2e-4`` as the JAX
package holds its own fused MFCC; end to end, picks equal and log-probs
within ``atol=rtol=1e-5`` as ``tests/test_torch_slice.py``.

JAX caches a trace per static argument set, so each test that changes the
MFCC dispatch bound uses frame counts that no other test here traces.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmbidaf_tpu import serving as j_serving
from mmbidaf_tpu.config import tiny_test_config
from mmbidaf_tpu.data.frontend import frontend_init as j_frontend_init
from mmbidaf_tpu.data.frontend import make_end_to_end_decode as j_end_to_end
from mmbidaf_tpu.data.synthetic import random_word_vectors, synthetic_batch
from mmbidaf_tpu.models.mmbidaf import mmbidaf_init as j_init
from mmbidaf_tpu.ops import audio as j_audio
from mmbidaf_tpu.ops.bidaf import bidaf_init
from mmbidaf_tpu.ops.pallas import melspec_kernel as j_melspec
from mmbidaf_tpu.ops.pallas.bidaf_tiled_kernel import bidaf_attention_tiled as j_tiled
from mmbidaf_tpu.ops.vgg import TINY_SPEC as J_TINY
from mmbidaf_tpu_torch import serving
from mmbidaf_tpu_torch.data.frontend import make_end_to_end_decode
from mmbidaf_tpu_torch.interop.from_jax import frontend_from_jax, load_pytree, model_from_jax
from mmbidaf_tpu_torch.ops import audio as t_audio
from mmbidaf_tpu_torch.ops.bidaf import BiDAFParams
from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel, melspec_kernel
from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC

REPO = Path(__file__).resolve().parents[1]
N_FFT, WIN, HOP = 64, 48, 16


def _t(x):
    return torch.from_numpy(np.array(x))


def _consts():
    return t_audio.make_audio_frontend_consts(16000, N_FFT, WIN, 12, 8, device="cpu")


def _j(consts):
    return {k: jnp.asarray(v.numpy()) for k, v in consts.items()}


def _signal(rng, B, T):
    sig = rng.standard_normal((B, (T - 1) * HOP + WIN)).astype(np.float32)
    sig[1] = 0.0  # a silent example
    return sig


@pytest.mark.parametrize("log", [True, False], ids=["log", "raw_mel"])
def test_log_mel_wrapper_matches_pallas(rng, log):
    """Strided frames straight from the waveform (a partial last tile of 16
    frames) and a silent example: its mel is 0, so log mode gives log(1e-6)."""
    T = 37
    consts = _consts()
    sig = _signal(rng, 3, T)
    frames = t_audio.frame_signal(_t(sig), WIN, HOP, T)
    assert frames.stride(-1) == 1 and not frames.is_contiguous()  # a view, not a copy
    before = melspec_kernel.log_mel_fused.launches
    ours = melspec_kernel.log_mel_fused(frames, consts, log=log)
    ref = np.asarray(j_melspec.log_mel_fused(
        j_audio.frame_signal(jnp.asarray(sig), WIN, HOP, T), _j(consts), tile_n=16,
        interpret=True, log=log))
    assert ours.shape == (3, T, 12) and ours.dtype == torch.float32
    if log:
        np.testing.assert_allclose(ours.numpy(), ref, atol=2e-5, rtol=1e-5)
        np.testing.assert_allclose(ours[1].numpy(), np.log(np.float32(1e-6)), rtol=1e-6)
    else:
        np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5 * np.abs(ref).max(), rtol=1e-5)
        assert not ours[1].any()
    # any leading dims, as the TPU kernel's contract: [N, win] and [2, 3, T, win]
    flat = frames.reshape(-1, WIN)
    np.testing.assert_array_equal(melspec_kernel.log_mel_fused(flat, consts, log=log).numpy(),
                                  ours.reshape(-1, 12).numpy())
    four = torch.stack([frames, frames])
    assert melspec_kernel.log_mel_fused(four, consts, log=log).shape == (2, 3, T, 12)
    # the plain path on the CPU is not a launch
    assert melspec_kernel.log_mel_fused.launches == before


def _spy_log_mel(monkeypatch) -> tuple[list, list]:
    """Record the ``log`` argument of every ``log_mel_fused`` call the port
    and the JAX package make (JAX's at trace time: a cached trace records
    nothing, so the test sees it)."""
    calls = ([], [])
    for module, seen in zip((melspec_kernel, j_melspec), calls):
        def spy(*args, _fn=getattr(module, "log_mel_fused"), _seen=seen, **kw):
            _seen.append(kw["log"])
            return _fn(*args, **kw)
        monkeypatch.setattr(module, "log_mel_fused", spy)
    return calls


def _ragged(rng, B, T, lengths=None):
    lengths = rng.integers(1, T + 1, size=B) if lengths is None else np.asarray(lengths)
    return (np.arange(T)[None] < lengths[:, None]).astype(np.float32)


@pytest.mark.parametrize("B,T_c,T_q,D,c_len,q_len", [
    (2, 20, 13, 16, None, None),      # the shape of test_pallas_kernels.py: both axes padded
    (3, 16, 24, 16, [16, 0, 9], [24, 5, 0]),  # block multiples; a fully masked row and column
], ids=["padded_ragged", "fully_masked"])
def test_bidaf_tiled_wrapper_matches_pallas(rng, B, T_c, T_q, D, c_len, q_len):
    """K9's plain version against the blockwise Pallas kernel with 8x8
    blocks. Fully masked rows are checked at block multiples: where the TPU
    kernel pads an axis, its uniform softmax also spreads over the padding,
    where the port keeps K2's function (the true length)."""
    jp = dict(bidaf_init(jax.random.key(6), D), bias=jnp.float32(0.3))
    c = rng.standard_normal((B, T_c, D)).astype(np.float32)
    q = rng.standard_normal((B, T_q, D)).astype(np.float32)
    c_mask, q_mask = _ragged(rng, B, T_c, c_len), _ragged(rng, B, T_q, q_len)
    port = BiDAFParams(D, torch.Generator().manual_seed(0), "cpu")
    load_pytree(port, jax.tree.map(np.asarray, jp))
    before = bidaf_kernel.bidaf_attention_tiled.launches
    ours = bidaf_kernel.bidaf_attention_tiled(port, _t(c), _t(q), _t(c_mask), _t(q_mask),
                                              tc_blk=8, tq_blk=8)
    ref = j_tiled(jp, *(jnp.asarray(v) for v in (c, q, c_mask, q_mask)), tc_blk=8, tq_blk=8,
                  interpret=True)
    assert ours.shape == (B, T_c, 4 * D) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=3e-5)
    assert bidaf_kernel.bidaf_attention_tiled.launches == before
    if q_len is not None:  # example 2's q is fully masked: C2Q is the plain mean of q
        np.testing.assert_allclose(ours[2, :, D:2 * D].numpy(),
                                   np.broadcast_to(q[2].mean(0), (T_c, D)), atol=1e-5)


@pytest.mark.parametrize("T_q,route", [(16, "cluster"), (512, "cluster"), (1024, "cluster"),
                                       (2048, "cluster"), (2049, "K9"), (4096, "K9")])
def test_bidaf_route(T_q, route):
    """``bidaf_attention_fused`` launches K2 on its cluster route while its
    plan's forward block fits a block's shared memory and K9 past it, at the
    model's attention width (T_c=32, D=256); K9 has a walk at every such
    shape: ceil(T_q / 64) ranks up to 6, c∘w_cq resident, a block that
    fits."""
    assert bidaf_kernel.bidaf_route(32, T_q, 256) == route
    plan = bidaf_kernel.tiled_plan(32, T_q, 256)
    assert plan.C == min(6, -(-T_q // 64)) and plan.resident
    assert plan.tq <= min(128, T_q) and plan.smem <= bidaf_kernel.SMEM_LIMIT_BYTES


def test_tiled_blocks_shrink_to_fit():
    """A context too long for a 128-column q tile walks narrower tiles (at
    T_c=600 with a_acc and P_acc in device memory, at T_c=48 beside c∘w_cq);
    one whose c∘w_cq does not fit beside the accumulators reads it from
    device memory; one that fits no block at all is refused."""
    plan = bidaf_kernel.tiled_plan(600, 4096, 256)
    assert plan.tq < 128 and plan.work > 0 and plan.smem <= bidaf_kernel.SMEM_LIMIT_BYTES
    plan = bidaf_kernel.tiled_plan(48, 4096, 256)
    assert plan.resident and plan.tq < 64 and plan.smem <= bidaf_kernel.SMEM_LIMIT_BYTES
    plan = bidaf_kernel.tiled_plan(64, 4096, 384)
    assert not plan.resident and plan.smem <= bidaf_kernel.SMEM_LIMIT_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        bidaf_kernel.tiled_plan(5000, 64, 256)


@pytest.mark.parametrize("feature,T,bound,k4_calls", [
    ("logmel", 29, None, [True]),   # K4 (log)
    ("mfcc", 31, 0, [False]),       # MFCC past mfcc_fused_fits: K4 (raw mel) + dB/DCT
    ("mfcc", 33, None, []),         # MFCC within the bound: K3
], ids=["logmel", "mfcc_long", "mfcc_whole"])
def test_waveform_to_features_fused_matches_jax(rng, monkeypatch, feature, T, bound, k4_calls):
    """The fused frontend's three branches against the JAX package's, with
    the MFCC bound lowered in both packages to reach the long branch."""
    if bound is not None:
        monkeypatch.setattr(j_melspec, "_MFCC_FUSED_MAX_BYTES", bound)
        monkeypatch.setattr(melspec_kernel, "_MFCC_FUSED_MAX_BYTES", bound)
    calls = _spy_log_mel(monkeypatch)
    consts = _consts()
    assert melspec_kernel.mfcc_fused_fits(T, WIN, 33, 12) == (bound is None)
    sig = _signal(rng, 3, T)
    ours = t_audio.waveform_to_features(_t(sig), consts, WIN, HOP, T, feature=feature, fused=True)
    ref = j_audio.waveform_to_features(jnp.asarray(sig), _j(consts), WIN, HOP, T,
                                       feature=feature, fused=True)
    assert calls == (k4_calls, k4_calls)  # both packages took the same branch
    tol = {"atol": 2e-5, "rtol": 1e-5} if feature == "logmel" else {"atol": 2e-4, "rtol": 2e-4}
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **tol)
    # the fused branches compute the unfused chain's function
    plain = t_audio.waveform_to_features(_t(sig), consts, WIN, HOP, T, feature=feature)
    np.testing.assert_allclose(ours.numpy(), plain.numpy(), **tol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("feature,frames", [("logmel", 11), ("mfcc", 19)],
                         ids=["logmel", "mfcc_long"])
def test_end_to_end_long_audio_branches_match_jax(rng, monkeypatch, feature, frames):
    """The tiny serving program with every kernel flag on, through K4's two
    modes: ``audio_features="logmel"``, and MFCC with the whole-example
    bound lowered in both packages (the 4096-frame configuration's branch)."""
    if feature == "mfcc":
        monkeypatch.setattr(j_melspec, "_MFCC_FUSED_MAX_BYTES", 0)
        monkeypatch.setattr(melspec_kernel, "_MFCC_FUSED_MAX_BYTES", 0)
    calls = _spy_log_mel(monkeypatch)
    cfg = tiny_test_config()
    d = dataclasses.replace(cfg.data, audio_features=feature, max_audio_frames=frames)
    m = dataclasses.replace(
        cfg.model, img_feat_dim=32, audio_feat_dim=d.n_mels if feature == "logmel" else d.n_mfcc,
        use_pallas_lstm=True, use_pallas_attention=True, use_pallas_melspec=True)
    cfg = dataclasses.replace(cfg, data=d, model=m)
    wv = random_word_vectors(rng, d.vocab_size, m.emb_dim)
    params, fe = j_init(jax.random.key(0), cfg, jnp.asarray(wv)), j_frontend_init(
        jax.random.key(1), cfg, vgg_spec=J_TINY)
    B = 3
    base = synthetic_batch(rng, cfg, batch_size=B)
    raw = {k: base[k] for k in ("text_ids", "word_mask", "sent_mask", "img_mask", "aud_mask")}
    raw["frames"] = (rng.random((B, d.max_keyframes, 12, 16, 3)) * 255).astype(np.uint8)
    raw["waveform"] = (rng.standard_normal((B, frames * d.hop_length + d.win_length)) * 0.1
                       ).astype(np.float32)
    raw["waveform"][1] = 0.0
    j_lp, j_picks = j_end_to_end(cfg, vgg_spec=J_TINY)(params, fe,
                                                      {k: jnp.asarray(v) for k, v in raw.items()})
    model = model_from_jax(_np(params), cfg, device="cpu")
    front = frontend_from_jax(_np(fe), cfg, TINY_SPEC, device="cpu")
    lp, picks = make_end_to_end_decode(cfg, TINY_SPEC)(
        model, front, {k: torch.from_numpy(v) for k, v in raw.items()})
    assert calls == ([feature == "logmel"],) * 2
    np.testing.assert_array_equal(picks.numpy(), np.asarray(j_picks))
    np.testing.assert_allclose(lp.numpy(), np.asarray(j_lp), atol=1e-5, rtol=1e-5)


def test_window_helpers_match_jax(rng):
    for n, w, s in [(5, 7, 3), (7, 7, 3), (20, 7, 3), (80, 32, 16), (33, 32, 16), (9, 4, 1)]:
        assert serving.transcript_windows(n, w, s) == j_serving.transcript_windows(n, w, s)
    picks = rng.integers(0, 7, size=(4, 3))
    scores = rng.standard_normal((4, 3))
    starts, lens = [0, 3, 6, 9], [7, 7, 7, 5]
    for k in (1, 3, 5):
        assert (serving.merge_window_picks(picks, scores, starts, lens, k)
                == j_serving.merge_window_picks(picks, scores, starts, lens, k))
    log_p = rng.standard_normal((4, 3, 7))
    np.testing.assert_array_equal(serving.picks_scores(log_p, picks),
                                  j_serving.picks_scores(log_p, picks))


@pytest.fixture(scope="module")
def long_corpus(tmp_path_factory):
    """Two videos whose 20-sentence transcripts exceed the tiny config's
    7-sentence bucket, and one that fits it."""
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_corpus", REPO / "examples" / "make_synthetic_corpus.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    long_dir, short_dir = tmp_path_factory.mktemp("long"), tmp_path_factory.mktemp("short")
    mod.make_corpus(str(long_dir), videos=2, sentences=20, frames=5, seconds=0.5, seed=1)
    mod.make_corpus(str(short_dir), videos=1, sentences=5, frames=4, seconds=0.5, seed=2)
    return sorted(str(p) for p in long_dir.iterdir()) + [str(next(short_dir.iterdir()))]


@pytest.mark.parametrize("serve_batch_size", [None, 2], ids=["one_batch", "serve_batch_2"])
def test_summarize_long_matches_jax(long_corpus, serve_batch_size):
    """Port and JAX Summarizers sharing weights return the same windowed
    summaries, string for string (three windows over 20 sentences, padded
    to batches of 2 with ``serve_batch_size``), and the short transcript
    takes the one-window branch, equal to ``summarize``."""
    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, img_feat_dim=32, audio_feat_dim=cfg.data.n_mfcc, use_pallas_lstm=True,
        use_pallas_attention=True, use_pallas_melspec=True))
    js = j_serving.Summarizer.init_random(cfg, seed=0, vgg_spec=J_TINY,
                                          serve_batch_size=serve_batch_size)
    ts = serving.Summarizer.from_jax_params(_np(js.params), _np(js.fe_params), js.word2idx, cfg,
                                            vgg_spec=TINY_SPEC, device="cpu",
                                            serve_batch_size=serve_batch_size)
    for vd in long_corpus:
        ours = ts.summarize_long(vd)
        assert ours == js.summarize_long(vd)
        assert isinstance(ours, str) and ours
    assert ts.summarize_long(long_corpus[-1]) == ts.summarize(long_corpus[-1])
    # other strides slide other windows, as in the JAX package
    assert ts.summarize_long(long_corpus[0], stride=2) == js.summarize_long(long_corpus[0], stride=2)
