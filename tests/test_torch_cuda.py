"""The port on the card against the JAX package on the host CPU, at the bench
configuration's full widths (VGG-16 at 224², hidden 128, vocab 20000,
T_s=32 x W=16, 16 keyframes, 512 audio frames) with B=2, f32 — the serving
program and one training step — and at the long-audio serving
configuration (``examples/configs/config6_sp_long_audio.json``: 4096 audio
frames, vocab 50000, one device) and with ``use_winograd_conv`` (K14), and
every kernel against its plain version at shapes the main paths do not
reach (partial blocks and tiles, widths past a block's threads, odd image
sizes, channel counts off the block sizes).

Needs an NVIDIA GPU with ``nvcc`` (the CUDA kernels are built on first use);
skipped elsewhere. Run on such a host with
``python -m pytest tests/test_torch_cuda.py -q``.

The JAX side runs its plain (scan) path, which equals its Pallas path in
f32; the port runs its CUDA kernels. TF32 is off on the card. Bounds:
picks equal; log-probs within 1e-4 (measured 4.8e-7 on an H100); VGG
features within 1e-4 (measured 4.7e-6 on values up to ~2); MFCCs within
5e-4 (measured 3.8e-5 on values up to ~100) — f32 sums in different orders.
One training step (drop_prob 0, adadelta): loss within 1e-5 and every
parameter and EMA leaf within 1e-5 after the step (an adadelta step moves a
parameter by at most lr·sqrt(10) ≈ 1.6e-3, and its error is at most lr
times the gradient's).
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmbidaf_tpu.config import Config, DataConfig, ModelConfig


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _assert_normwise(out, ref, tol, name=""):
    """Each output within ``atol + rtol·max|ref|`` (the backward kernels'
    stated bound)."""
    for i, (o, r) in enumerate(zip(out, ref)):
        err = (o - r).abs().max().item()
        assert err <= tol["atol"] + tol["rtol"] * r.abs().max().item(), (name, i, err)


def _bench_f32_config(kernels: bool) -> Config:
    data = DataConfig(max_sentences=32, max_words=16, max_keyframes=16, max_audio_frames=512,
                      vocab_size=20000, image_size=224)
    model = ModelConfig(hidden_size=128, img_feat_dim=4096, audio_feat_dim=40, drop_prob=0.0,
                        max_decode_steps=4, use_pallas_attention=kernels,
                        use_pallas_lstm=kernels, use_pallas_melspec=kernels)
    return Config(model=model, data=data)


@pytest.mark.cuda
def test_bench_width_parity_with_jax(cuda_device):
    from mmbidaf_tpu.data.frontend import apply_frontend as j_apply_frontend
    from mmbidaf_tpu.data.frontend import frontend_init as j_frontend_init
    from mmbidaf_tpu.data.frontend import make_end_to_end_decode as j_end_to_end
    from mmbidaf_tpu.data.synthetic import random_word_vectors, synthetic_batch
    from mmbidaf_tpu.models.mmbidaf import mmbidaf_init as j_init
    from mmbidaf_tpu_torch.data.frontend import apply_frontend, make_end_to_end_decode
    from mmbidaf_tpu_torch.interop.from_jax import frontend_from_jax, model_from_jax
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel, lstm_kernel, melspec_kernel
    from mmbidaf_tpu_torch.ops.vgg import VGG16_SPEC

    cfg, j_cfg = _bench_f32_config(kernels=True), _bench_f32_config(kernels=False)
    d = cfg.data
    rng = np.random.default_rng(0)
    wv = random_word_vectors(rng, d.vocab_size, cfg.model.emb_dim)
    params = j_init(jax.random.key(0), cfg, jnp.asarray(wv))
    fe = j_frontend_init(jax.random.key(1), cfg)
    base = synthetic_batch(rng, cfg, batch_size=2)
    raw = {k: base[k] for k in ("text_ids", "word_mask", "sent_mask", "img_mask", "aud_mask")}
    raw["frames"] = (rng.random((2, d.max_keyframes, 240, 320, 3)) * 255).astype(np.uint8)
    raw["waveform"] = (rng.standard_normal((2, d.max_audio_frames * d.hop_length + d.win_length))
                       * 0.1).astype(np.float32)
    raw_j = {k: jnp.asarray(v) for k, v in raw.items()}
    raw_t = {k: torch.from_numpy(v).to(cuda_device) for k, v in raw.items()}

    j_lp, j_picks = (np.asarray(a) for a in j_end_to_end(j_cfg)(params, fe, raw_j))
    model = model_from_jax(jax.tree.map(np.asarray, params), cfg, cuda_device)
    front = frontend_from_jax(jax.tree.map(np.asarray, fe), cfg, VGG16_SPEC, cuda_device)
    counts = [f.launches for f in (lstm_kernel.bilstm_cuda, bidaf_kernel.bidaf_attention_fused,
                                   melspec_kernel.mfcc_fused)]
    lp, picks = make_end_to_end_decode(cfg)(model, front, raw_t)
    after = [f.launches for f in (lstm_kernel.bilstm_cuda, bidaf_kernel.bidaf_attention_fused,
                                  melspec_kernel.mfcc_fused)]
    assert [a - b for a, b in zip(after, counts)] == [5, 2, 1]  # the kernels ran
    np.testing.assert_array_equal(picks.cpu().numpy(), j_picks)
    np.testing.assert_allclose(lp.cpu().numpy(), j_lp, atol=1e-4, rtol=1e-6)

    j_feats = j_apply_frontend(fe, raw_j, j_cfg)
    with torch.inference_mode():
        feats = apply_frontend(front, raw_t, cfg)
    np.testing.assert_allclose(feats["images"].cpu().numpy(), np.asarray(j_feats["images"]),
                               atol=1e-4)
    np.testing.assert_allclose(feats["audio"].cpu().numpy(), np.asarray(j_feats["audio"]),
                               atol=5e-4, rtol=1e-5)


@pytest.mark.cuda
def test_wrapper_launches_its_kernel_on_cuda_tensors(cuda_device):
    """On a CUDA tensor a wrapper launches its kernel (the count rises) —
    the plain version is only for CPU tensors."""
    from mmbidaf_tpu_torch.ops.cuda import lstm_kernel
    from mmbidaf_tpu_torch.ops.lstm import BiLSTMParams

    p = BiLSTMParams(6, 8, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    x = torch.randn(3, 5, 6, device=cuda_device)
    before = lstm_kernel.bilstm_cuda.launches
    out, _ = lstm_kernel.bilstm_cuda(p, x, torch.ones(3, 5, device=cuda_device))
    torch.cuda.synchronize()
    assert lstm_kernel.bilstm_cuda.launches == before + 1 and out.is_cuda
    with pytest.raises(ValueError):
        lstm_kernel.bilstm_cuda(p, x, torch.ones(3, 4, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,steps,in_dim,hidden", [
    (1030, 3, 8, 256),  # 16-row blocks with a partial last block; 4H=1024 > 512 threads
    (7, 40, 5, 32),     # 4-row blocks, a partial block, 4H=128 < a warp-multiple cap
])
def test_bilstm_kernel_generic_shapes(cuda_device, rows, steps, in_dim, hidden):
    from mmbidaf_tpu_torch.ops.cuda import lstm_kernel
    from mmbidaf_tpu_torch.ops.lstm import BiLSTMParams

    gen = torch.Generator(device=cuda_device).manual_seed(1)
    p = BiLSTMParams(in_dim, hidden, gen, cuda_device)
    x = torch.randn(rows, steps, in_dim, device=cuda_device, generator=gen)
    lengths = torch.randint(0, steps + 1, (rows,), device=cuda_device, generator=gen)
    mask = (torch.arange(steps, device=cuda_device)[None] < lengths[:, None]).float()
    out, (h, c) = lstm_kernel.bilstm_cuda(p, x, mask)
    ref, (rh, rc) = lstm_kernel.bilstm_reference(p, x, mask)
    for o, r in ((out, ref), (h, rh), (c, rc)):
        torch.testing.assert_close(o, r, **lstm_kernel.TOLERANCE)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T_c,T_q,D", [
    (2, 64, 100, 384),  # past K2's plan at this width (K9); D > 256 threads
    (3, 5, 33, 40),     # K2's cluster route: a partial q tile
])
def test_bidaf_kernel_generic_shapes(cuda_device, B, T_c, T_q, D):
    """The shapes K2's first body took: whichever route they take now
    computes K2's function."""
    from mmbidaf_tpu_torch.ops.bidaf import BiDAFParams
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel

    gen = torch.Generator(device=cuda_device).manual_seed(2)
    p = BiDAFParams(D, gen, cuda_device)
    c = torch.randn(B, T_c, D, device=cuda_device, generator=gen)
    q = torch.randn(B, T_q, D, device=cuda_device, generator=gen)
    c_mask = (torch.rand(B, T_c, device=cuda_device, generator=gen) > 0.3).float()
    q_mask = (torch.rand(B, T_q, device=cuda_device, generator=gen) > 0.3).float()
    q_mask[0] = 0.0
    route = bidaf_kernel.bidaf_route(T_c, T_q, D)
    before = dict(bidaf_kernel.bidaf_attention_fused.routes)
    out = bidaf_kernel.bidaf_attention_fused(p, c, q, c_mask, q_mask)
    torch.testing.assert_close(out, bidaf_kernel.bidaf_reference(p, c, q, c_mask, q_mask),
                               **bidaf_kernel.TOLERANCE)
    assert bidaf_kernel.bidaf_attention_fused.routes[route] == before[route] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,win,T", [(1024, 1024, 45), (64, 48, 1)])
def test_mfcc_kernel_generic_shapes(cuda_device, n_fft, win, T):
    """K3's FFT route: 513 bins, frames that overlap by more than a hop, a
    partial block of frames, a one-frame example."""
    from mmbidaf_tpu_torch.ops import audio
    from mmbidaf_tpu_torch.ops.cuda import melspec_kernel

    consts = audio.make_audio_frontend_consts(16000, n_fft, win, 40, 13, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    sig = torch.randn(3, (T - 1) * 160 + win, device=cuda_device, generator=gen) * 0.1
    frames = audio.frame_signal(sig, win, 160, T)
    out = melspec_kernel.mfcc_fused(frames, consts)
    torch.testing.assert_close(out, melspec_kernel.mfcc_reference(frames, consts),
                               **melspec_kernel.TOLERANCE)


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,win,n_mels,T,route", [
    (64, 48, 12, 37, "fft"),      # the tiny config's shape; a partial block of frames
    (512, 400, 64, 512, "fft"),   # the bench config
    (1024, 1024, 80, 45, "fft"),  # 513 bins; frames that overlap by more than a hop
    (400, 400, 40, 20, "dense"),  # n_fft not a power of two: the first body
])
def test_mfcc_routes(cuda_device, n_fft, win, n_mels, T, route):
    """K3 on each route against its plain version, the silent example
    exactly 0, twice the same bits, and only the route's counter rose."""
    from mmbidaf_tpu_torch.ops import audio
    from mmbidaf_tpu_torch.ops.cuda import melspec_kernel as mk

    consts = audio.make_audio_frontend_consts(16000, n_fft, win, n_mels, 13, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    sig = torch.randn(3, (T - 1) * 160 + win, device=cuda_device, generator=gen) * 0.1
    sig[1] = 0.0
    frames = audio.frame_signal(sig, win, 160, T)
    assert mk.mfcc_route(win, n_fft // 2 + 1) == route
    before = dict(mk.mfcc_fused.routes)
    out = mk.mfcc_fused(frames, consts)
    torch.testing.assert_close(out, mk.mfcc_reference(frames, consts), **mk.TOLERANCE)
    assert not out[1].any()
    assert torch.equal(out, mk.mfcc_fused(frames, consts))
    other = "dense" if route == "fft" else "fft"
    assert mk.mfcc_fused.routes[route] == before[route] + 2
    assert mk.mfcc_fused.routes[other] == before[other]


@pytest.mark.cuda
def test_mfcc_fft_route_on_a_wide_signal(cuda_device):
    """The bench shape on mel bands more than 60 dB apart: K3's FFT route
    against its plain version, and no farther from an f64 MFCC than the
    plain version or the dense route at the same n_fft; the silent
    example exactly 0; twice the same bits."""
    from mmbidaf_tpu_torch.ops import audio
    from mmbidaf_tpu_torch.ops.cuda import melspec_kernel as mk
    from mmbidaf_tpu_torch.tools.mfcc_variants import f64_mfcc, wide_signal

    T = 509
    consts = audio.make_audio_frontend_consts(16000, 512, 400, 64, 40, device=cuda_device)
    sig = wide_signal(np.random.default_rng(21), 3, (T - 1) * 160 + 400)
    sig[1] = 0.0
    frames = audio.frame_signal(torch.from_numpy(sig).to(cuda_device), 400, 160, T)
    out = mk.mfcc_fused(frames, consts)
    plain = mk.mfcc_reference(frames, consts)
    dense = mk._mfcc_launch(frames, consts, "dense")
    ref = f64_mfcc(frames, consts)
    dist = {k: np.abs(v.double().cpu().numpy() - ref).max()
            for k, v in (("fft", out), ("plain", plain), ("dense", dense))}
    assert dist["fft"] <= min(dist["plain"], dist["dense"]), dist
    torch.testing.assert_close(out, plain, **mk.TOLERANCE)
    assert not out[1].any()
    assert torch.equal(out, mk.mfcc_fused(frames, consts))


@pytest.mark.cuda
def test_mfcc_fft_refuses_a_basis_that_is_not_the_dft(cuda_device):
    """K3's FFT route, like K4's, raises before any launch on bases that
    are not a window's DFT basis of n_fft."""
    from mmbidaf_tpu_torch.ops import audio
    from mmbidaf_tpu_torch.ops.cuda import melspec_kernel as mk

    consts = audio.make_audio_frontend_consts(16000, 64, 48, 12, 8, device=cuda_device)
    consts["cos"] = consts["cos"].clone()
    consts["cos"][3, 2] += 1e-3
    before = (mk.mfcc_fused.launches, dict(mk.mfcc_fused.routes))
    with pytest.raises(ValueError, match="not the DFT basis"):
        mk.mfcc_fused(torch.randn(2, 3, 48, device=cuda_device), consts)
    assert (mk.mfcc_fused.launches, mk.mfcc_fused.routes) == before


@pytest.mark.cuda
@pytest.mark.parametrize("log", [True, False], ids=["log", "raw_mel"])
@pytest.mark.parametrize("n_fft,win,n_mels,T", [
    (1024, 1024, 80, 45),  # 513 bins > 512 threads; 80 mels > a warp; a partial frame tile
    (64, 48, 12, 1),       # a one-frame example
])
def test_log_mel_kernel_generic_shapes(cuda_device, log, n_fft, win, n_mels, T):
    """K4 against its plain version, with a silent example and leading dims
    other than [B, T] (a flat frame list)."""
    from mmbidaf_tpu_torch.ops import audio
    from mmbidaf_tpu_torch.ops.cuda import melspec_kernel as mk

    consts = audio.make_audio_frontend_consts(16000, n_fft, win, n_mels, 13, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    sig = torch.randn(3, (T - 1) * 160 + win, device=cuda_device, generator=gen) * 0.1
    sig[1] = 0.0
    frames = audio.frame_signal(sig, win, 160, T)
    before = mk.log_mel_fused.launches
    out = mk.log_mel_fused(frames, consts, log=log)
    ref = mk.log_mel_reference(frames, consts, log=log)
    tol = mk.LOG_MEL_TOLERANCE[log]
    if log:
        torch.testing.assert_close(out, ref, **tol)
    else:
        _assert_normwise([out], [ref], tol, "K4")
    flat = mk.log_mel_fused(frames.reshape(-1, win), consts, log=log)
    assert torch.equal(flat, out.reshape(-1, n_mels))
    assert mk.log_mel_fused.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("log", [True, False], ids=["log", "raw_mel"])
@pytest.mark.parametrize("n_fft,win,n_mels,T,route", [
    (64, 48, 12, 37, "fft"),      # the tiny config's shape; a partial block of frames
    (512, 400, 64, 512, "fft"),   # the bench and long-audio configs
    (1024, 1024, 80, 45, "fft"),  # 513 bins; frames that overlap by more than a hop
    (400, 400, 40, 20, "dense"),  # n_fft not a power of two
])
def test_log_mel_routes(cuda_device, log, n_fft, win, n_mels, T, route):
    """K4 on each route against its plain version (both modes), the silent
    example exact, and only the route's counter rose."""
    from mmbidaf_tpu_torch.ops import audio
    from mmbidaf_tpu_torch.ops.cuda import melspec_kernel as mk

    consts = audio.make_audio_frontend_consts(16000, n_fft, win, n_mels, 13, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    sig = torch.randn(3, (T - 1) * 160 + win, device=cuda_device, generator=gen) * 0.1
    sig[1] = 0.0
    frames = audio.frame_signal(sig, win, 160, T)
    assert mk.log_mel_route(win, n_fft // 2 + 1) == route
    before = dict(mk.log_mel_fused.routes)
    out = mk.log_mel_fused(frames, consts, log=log)
    ref = mk.log_mel_reference(frames, consts, log=log)
    tol = mk.LOG_MEL_TOLERANCE[log]
    if log:
        torch.testing.assert_close(out, ref, **tol)
    else:
        _assert_normwise([out], [ref], tol, "K4")
    silent = torch.zeros_like(out[1])
    assert torch.equal(out[1], torch.log(silent + 1e-6) if log else silent)
    other = "dense" if route == "fft" else "fft"
    assert mk.log_mel_fused.routes[route] == before[route] + 1
    assert mk.log_mel_fused.routes[other] == before[other]


@pytest.mark.cuda
def test_log_mel_fft_refuses_a_basis_that_is_not_the_dft(cuda_device):
    """Bases that are not a window's DFT basis of n_fft raise before any
    launch on the FFT route."""
    from mmbidaf_tpu_torch.ops import audio
    from mmbidaf_tpu_torch.ops.cuda import melspec_kernel as mk

    consts = audio.make_audio_frontend_consts(16000, 64, 48, 12, 8, device=cuda_device)
    consts["sin"] = consts["sin"].clone()
    consts["sin"][5, 7] += 1e-3
    frames = torch.randn(2, 3, 48, device=cuda_device)
    before = mk.log_mel_fused.launches
    with pytest.raises(ValueError, match="not the DFT basis"):
        mk.log_mel_fused(frames, consts)
    assert mk.log_mel_fused.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("B,T_c,T_q,D,tc_blk,tq_blk", [
    (2, 40, 300, 256, 16, 128),  # 5 ranks of 60 columns, 2 tiles each (tc_blk does nothing)
    (3, 7, 45, 20, 128, 8),      # a cluster of one: 6 tiles, the last of 5 columns
    (2, 64, 4096, 384, 128, 128),  # D > 256 threads; c∘w_cq read from device memory
    (2, 32, 1000, 256, 128, 64),   # 6 ranks of 167 columns, 3 tiles each (56 + 56 + 55)
    (3, 33, 1001, 40, 128, 48),    # ragged: the last rank's 166 columns, 4 tiles, the last of 40
    (2, 32, 4096, 256, 128, 128),  # the long-audio walk: 6 ranks of 11 tiles of 63
    (1, 600, 4096, 256, 128, 128),  # a long context: a_acc and P_acc spilled to device memory
    (3, 130, 301, 256, 128, 128),   # spilled, 5 ranks (the last of 57 columns), 4 tiles each
    (2, 200, 40, 64, 128, 16),      # a cluster of one, c∘w_cq from device memory
])
def test_bidaf_tiled_kernel_generic_shapes(cuda_device, B, T_c, T_q, D, tc_blk, tq_blk):
    """K9 against its plain version with fully masked rows and an
    all-masked example; two runs give the same bits; one launch a call and
    no device memory but the output and, where the plan spills its
    accumulators, their B·C·work floats."""
    from mmbidaf_tpu_torch.ops.bidaf import BiDAFParams
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel as bk

    gen = torch.Generator(device=cuda_device).manual_seed(6)
    p = BiDAFParams(D, gen, cuda_device)
    c = torch.randn(B, T_c, D, device=cuda_device, generator=gen)
    q = torch.randn(B, T_q, D, device=cuda_device, generator=gen)
    c_mask = (torch.rand(B, T_c, device=cuda_device, generator=gen) > 0.3).float()
    q_mask = (torch.rand(B, T_q, device=cuda_device, generator=gen) > 0.3).float()
    q_mask[0, : T_q // 2] = 0.0
    c_mask[-1] = 0.0  # the last example is all masked
    q_mask[-1] = 0.0
    bk.bidaf_attention_tiled(p, c, q, c_mask, q_mask, tc_blk=tc_blk, tq_blk=tq_blk)  # set-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda_device)
    before = (torch.cuda.memory_allocated(cuda_device), bk.bidaf_attention_tiled.launches)
    out = bk.bidaf_attention_tiled(p, c, q, c_mask, q_mask, tc_blk=tc_blk, tq_blk=tq_blk)
    torch.cuda.synchronize()
    # the caching allocator hands out multiples of 512 bytes
    grown = torch.cuda.max_memory_allocated(cuda_device) - before[0]
    plan = bk.tiled_plan(T_c, T_q, D, tq_blk)
    assert grown == sum(-(-n * 4 // 512) * 512 for n in (out.numel(), B * plan.C * plan.work) if n)
    assert bk.bidaf_attention_tiled.launches == before[1] + 1
    torch.testing.assert_close(out, bk.bidaf_tiled_reference(p, c, q, c_mask, q_mask),
                               **bk.TOLERANCE)
    again = bk.bidaf_attention_tiled(p, c, q, c_mask, q_mask, tc_blk=tc_blk, tq_blk=tq_blk)
    assert torch.equal(out, again)


@pytest.mark.cuda
def test_bidaf_tiled_plan_matches_the_card(cuda_device):
    """K9's Python plan is the C plan, the card holds a cluster of K9 at
    every such plan, and a shape no block holds is refused by both."""
    import ctypes

    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel as bk
    from mmbidaf_tpu_torch.ops.cuda import build

    lib = build.library()
    out = (ctypes.c_int * 6)()
    for T_c, T_q, D, tq_blk in ((32, 4096, 256, 128), (32, 2049, 256, 128), (32, 1, 256, 128),
                                (40, 300, 256, 128), (7, 45, 20, 8), (64, 4096, 384, 128),
                                (48, 4096, 256, 128), (2, 1000, 40, 64), (160, 16, 40, 128),
                                (114, 4096, 256, 128), (115, 4096, 256, 128), (600, 4096, 256, 128),
                                (1971, 4096, 128, 128), (200, 16, 256, 128), (4288, 64, 256, 128)):
        assert lib.mmb_bidaf_tiled_plan(T_c, T_q, D, tq_blk, out) == 0
        plan = bk.tiled_plan(T_c, T_q, D, tq_blk)
        want = [plan.C, plan.span, plan.tq, int(plan.resident), plan.smem, plan.work]
        assert list(out) == want, (T_c, T_q, D)
        assert lib.mmb_bidaf_tiled_forward_occupancy(T_c, T_q, D, tq_blk) > 0, (T_c, T_q, D)
    assert lib.mmb_bidaf_tiled_plan(5000, 64, 256, 128, out) != 0
    assert lib.mmb_bidaf_tiled_plan(4289, 64, 256, 128, out) != 0
    with pytest.raises(ValueError, match="no K9 plan"):
        bk.tiled_plan(5000, 64, 256)


@pytest.mark.cuda
def test_bidaf_fused_routes_long_queries_to_k9(cuda_device):
    """``bidaf_attention_fused`` one past K2's cluster plan (T_q=2049 at
    T_c=32, D=256) launches K9 and still computes K2's function."""
    from mmbidaf_tpu_torch.ops.bidaf import BiDAFParams
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel as bk

    T_q = 2049
    assert bk.bidaf_route(32, T_q - 1, 256) == "cluster" and bk.bidaf_route(32, T_q, 256) == "K9"
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    p = BiDAFParams(256, gen, cuda_device)
    c = torch.randn(2, 32, 256, device=cuda_device, generator=gen)
    q = torch.randn(2, T_q, 256, device=cuda_device, generator=gen)
    masks = torch.ones(2, 32, device=cuda_device), torch.ones(2, T_q, device=cuda_device)
    k2, k9 = bk.bidaf_attention_fused.launches, bk.bidaf_attention_tiled.launches
    routes = dict(bk.bidaf_attention_fused.routes)
    out = bk.bidaf_attention_fused(p, c, q, *masks)
    assert bk.bidaf_attention_fused.launches == k2 and bk.bidaf_attention_tiled.launches == k9 + 1
    assert bk.bidaf_attention_fused.routes == {"cluster": routes["cluster"], "K9": routes["K9"] + 1}
    torch.testing.assert_close(out, bk.bidaf_reference(p, c, q, *masks), **bk.TOLERANCE)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T_c,T_q,D", [
    (4, 200, 16, 256),  # the image block of 200 sentences: a cluster of one, spilled
    (2, 600, 512, 256),  # the audio block of 600 sentences: 6 ranks, spilled
])
def test_bidaf_fused_takes_long_contexts_through_k9(cuda_device, B, T_c, T_q, D):
    """``bidaf_attention_fused`` at a context past K2's plan and past K9's
    shared-memory accumulators (max_sentences past ~115) launches K9 with
    a_acc and P_acc in device memory and computes K2's function, a fully
    masked q row and c column included."""
    from mmbidaf_tpu_torch.ops.bidaf import BiDAFParams
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel as bk

    assert bk.bidaf_route(T_c, T_q, D) == "K9" and bk.tiled_plan(T_c, T_q, D).work > 0
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    p = BiDAFParams(D, gen, cuda_device)
    c = torch.randn(B, T_c, D, device=cuda_device, generator=gen)
    q = torch.randn(B, T_q, D, device=cuda_device, generator=gen)
    c_len = torch.randint(1, T_c + 1, (B,), device=cuda_device, generator=gen)
    c_mask = (torch.arange(T_c, device=cuda_device)[None] < c_len[:, None]).float()
    q_mask = torch.ones(B, T_q, device=cuda_device)
    q_mask[0] = 0.0
    c_mask[1] = 0.0
    k9 = bk.bidaf_attention_tiled.launches
    out = bk.bidaf_attention_fused(p, c, q, c_mask, q_mask)
    assert bk.bidaf_attention_tiled.launches == k9 + 1
    torch.testing.assert_close(out, bk.bidaf_reference(p, c, q, c_mask, q_mask), **bk.TOLERANCE)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T_c,T_q,D", [
    (4, 32, 16, 256),    # the serving image block: a cluster of one
    (4, 32, 512, 256),   # the serving audio block: 16 tiles of 32
    (2, 32, 2048, 256),  # the plan's edge: 16 tiles of 128
    (3, 7, 45, 20),      # two tiles, the last partial
])
def test_bidaf_cluster_route_serving_shapes(cuda_device, B, T_c, T_q, D):
    """K2 on its cluster route against its plain version with ragged masks,
    a fully masked q row (example 0) and a fully masked c column (example
    1); twice the same bits; K7's bits at cd = c, qd = q where K7 has a
    plan; only the cluster route's counter rose."""
    from mmbidaf_tpu_torch.ops.bidaf import BiDAFParams
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel as bk

    gen = torch.Generator(device=cuda_device).manual_seed(12)
    p = BiDAFParams(D, gen, cuda_device)
    with torch.no_grad():
        p.bias.fill_(0.25)
    c = torch.randn(B, T_c, D, device=cuda_device, generator=gen)
    q = torch.randn(B, T_q, D, device=cuda_device, generator=gen)
    c_len = torch.randint(1, T_c + 1, (B,), device=cuda_device, generator=gen)
    q_len = torch.randint(1, T_q + 1, (B,), device=cuda_device, generator=gen)
    c_mask = (torch.arange(T_c, device=cuda_device)[None] < c_len[:, None]).float()
    q_mask = (torch.arange(T_q, device=cuda_device)[None] < q_len[:, None]).float()
    q_mask[0] = 0.0
    c_mask[1] = 0.0
    assert bk.bidaf_route(T_c, T_q, D) == "cluster"
    before = (bk.bidaf_attention_fused.launches, dict(bk.bidaf_attention_fused.routes),
              bk.bidaf_attention_tiled.launches)
    out = bk.bidaf_attention_fused(p, c, q, c_mask, q_mask)
    torch.testing.assert_close(out, bk.bidaf_reference(p, c, q, c_mask, q_mask), **bk.TOLERANCE)
    assert torch.equal(out, bk.bidaf_attention_fused(p, c, q, c_mask, q_mask))
    if _has_drop_plan(T_c, T_q, D):  # K7's plan ends at T_q = 1088 here
        k7 = bk.bidaf_dropout_forward(c, q, c, q, c_mask, q_mask, p.w_c.float(), p.w_q.float(),
                                      p.w_cq.float(), p.bias.float().reshape(()))
        assert torch.equal(out, k7)
    routes = before[1]
    assert bk.bidaf_attention_fused.launches == before[0] + 2
    assert bk.bidaf_attention_fused.routes == {"cluster": routes["cluster"] + 2, "K9": routes["K9"]}
    assert bk.bidaf_attention_tiled.launches == before[2]


@pytest.mark.cuda
def test_bidaf_fused_plan_matches_the_card(cuda_device):
    """K2's Python plan is the C plan, the card holds a cluster of K2 at
    every such plan, and one past the plan's edge the C plan refuses."""
    import ctypes

    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel as bk
    from mmbidaf_tpu_torch.ops.cuda import build

    lib = build.library()
    out = (ctypes.c_int * 4)()
    for T_c, T_q, D in ((32, 16, 256), (32, 512, 256), (32, 1, 256), (5, 33, 40), (7, 45, 20),
                        (32, 1024, 256), (32, 1500, 256), (32, 2048, 256), (64, 512, 256)):
        assert lib.mmb_bidaf_fused_plan(T_c, T_q, D, out) == 0
        plan = bk.fused_plan(T_c, T_q, D)
        assert list(out) == [plan.C, plan.tq, plan.smem_fwd, plan.smem_bwd], (T_c, T_q, D)
        assert lib.mmb_bidaf_forward_occupancy(T_c, T_q, D) > 0, (T_c, T_q, D)
    assert lib.mmb_bidaf_fused_plan(32, 2049, 256, out) != 0


@pytest.mark.cuda
def test_long_audio_parity_with_jax(cuda_device):
    """The long-audio serving configuration (config6 on one device: 4096
    audio frames through K4's raw-mel branch, the audio attention through
    K9) at B=2, f32: the port on the card against JAX's plain path on the
    host CPU."""
    import dataclasses
    import json
    from pathlib import Path

    from mmbidaf_tpu.config import config_from_dict as j_config_from_dict
    from mmbidaf_tpu.data.frontend import frontend_init as j_frontend_init
    from mmbidaf_tpu.data.frontend import make_end_to_end_decode as j_end_to_end
    from mmbidaf_tpu.data.synthetic import random_word_vectors, synthetic_batch
    from mmbidaf_tpu.models.mmbidaf import mmbidaf_init as j_init
    from mmbidaf_tpu_torch.config import config_from_dict
    from mmbidaf_tpu_torch.data.frontend import make_end_to_end_decode
    from mmbidaf_tpu_torch.interop.from_jax import frontend_from_jax, model_from_jax
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel, lstm_kernel, melspec_kernel
    from mmbidaf_tpu_torch.ops.vgg import VGG16_SPEC

    spec = json.loads((Path(__file__).resolve().parents[1] / "examples" / "configs"
                       / "config6_sp_long_audio.json").read_text())
    spec["mesh"] = {**spec["mesh"], "sp_audio": False, "num_seq": 1}

    def flags(cfg, on):
        return dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype="float32", use_pallas_attention=on, use_pallas_lstm=on,
            use_pallas_melspec=on))

    j_cfg, cfg = flags(j_config_from_dict(spec), False), flags(config_from_dict(spec), True)
    d = cfg.data
    assert d.max_audio_frames == 4096
    rng = np.random.default_rng(0)
    wv = random_word_vectors(rng, d.vocab_size, cfg.model.emb_dim)
    params = j_init(jax.random.key(0), j_cfg, jnp.asarray(wv))
    fe = j_frontend_init(jax.random.key(1), j_cfg)
    base = synthetic_batch(rng, j_cfg, batch_size=2)
    raw = {k: base[k] for k in ("text_ids", "word_mask", "sent_mask", "img_mask", "aud_mask")}
    raw["frames"] = (rng.random((2, d.max_keyframes, 240, 320, 3)) * 255).astype(np.uint8)
    raw["waveform"] = (rng.standard_normal((2, d.max_audio_frames * d.hop_length + d.win_length))
                       * 0.1).astype(np.float32)
    j_lp, j_picks = (np.asarray(a) for a in j_end_to_end(j_cfg)(
        params, fe, {k: jnp.asarray(v) for k, v in raw.items()}))
    model = model_from_jax(jax.tree.map(np.asarray, params), cfg, cuda_device)
    front = frontend_from_jax(jax.tree.map(np.asarray, fe), cfg, VGG16_SPEC, cuda_device)
    fns = (lstm_kernel.bilstm_cuda, bidaf_kernel.bidaf_attention_fused,
           bidaf_kernel.bidaf_attention_tiled, melspec_kernel.log_mel_fused,
           melspec_kernel.mfcc_fused)
    counts = [f.launches for f in fns]
    lp, picks = make_end_to_end_decode(cfg)(
        model, front, {k: torch.from_numpy(v).to(cuda_device) for k, v in raw.items()})
    assert [f.launches - n for f, n in zip(fns, counts)] == [5, 1, 1, 1, 0]  # the kernels ran
    np.testing.assert_array_equal(picks.cpu().numpy(), j_picks)
    np.testing.assert_allclose(lp.cpu().numpy(), j_lp, atol=1e-4, rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,steps,in_dim,hidden,empty", [
    (1030, 3, 8, 256, None),  # 16-row clusters of 16 blocks, a partial last cluster: the largest slice
    (7, 40, 5, 32, None),     # 4-row clusters of 2 blocks, a partial cluster
    (37, 20, 6, 100, 3),      # H=100: slices of 12 and 13 units over 8 blocks
    (32, 512, 40, 128, 1),    # the audio tower's shape
    (9, 1, 5, 32, None),      # T=1: no step has an h_prev
    (1, 13, 5, 128, None),    # one row
    (6, 9, 5, 128, 2),        # a row of length 0
])
def test_train_lstm_kernels_generic_shapes(cuda_device, rows, steps, in_dim, hidden, empty):
    """K5 and K6 against their plain versions; each twice gives the same
    bits; a row of length 0 gets zero output and zero dgates."""
    from mmbidaf_tpu_torch.ops.cuda import lstm_kernel as lk
    from mmbidaf_tpu_torch.ops.lstm import BiLSTMParams

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    p = BiLSTMParams(in_dim, hidden, gen, cuda_device)
    x = torch.randn(rows, steps, in_dim, device=cuda_device, generator=gen)
    lengths = torch.randint(0, steps + 1, (rows,), device=cuda_device, generator=gen)
    if empty is not None:
        lengths[empty] = 0
    mask = (torch.arange(steps, device=cuda_device)[None] < lengths[:, None]).float()
    gates = lk._projection(p, x).contiguous()
    w_h = torch.stack([p.fwd.w_h, p.bwd.w_h]).contiguous()
    fwd = lk.bilstm_train_forward(gates, mask, w_h)
    for o, r in zip(fwd, lk.bilstm_train_forward_reference(gates, mask, w_h)):
        torch.testing.assert_close(o, r, **lk.TOLERANCE)
    assert all(torch.equal(a, b) for a, b in zip(fwd, lk.bilstm_train_forward(gates, mask, w_h)))
    args = (gates, mask, w_h, fwd[3], fwd[4],
            torch.randn(rows, steps, 2 * hidden, device=cuda_device, generator=gen),
            torch.randn(rows, 2 * hidden, device=cuda_device, generator=gen),
            torch.randn(rows, 2 * hidden, device=cuda_device, generator=gen))
    bwd = lk.bilstm_bptt(*args)
    _assert_normwise(bwd, lk.bilstm_bptt_reference(*args), lk.BPTT_TOLERANCE, "K6")
    assert all(torch.equal(a, b) for a, b in zip(bwd, lk.bilstm_bptt(*args)))
    if empty is not None:
        assert not fwd[0][empty].any() and not bwd[0][empty].any()


@pytest.mark.cuda
@pytest.mark.parametrize("rows,steps,hidden", [(32, 512, 128), (37, 20, 100), (1030, 3, 256)])
def test_train_forward_agrees_with_the_serving_kernel(cuda_device, rows, steps, hidden):
    """K1 runs K5's cluster body without the residual writes: at the same
    gates their out, h_last and c_last are the same bits."""
    from mmbidaf_tpu_torch.ops.cuda import lstm_kernel as lk
    from mmbidaf_tpu_torch.ops.lstm import BiLSTMParams

    gen = torch.Generator(device=cuda_device).manual_seed(6)
    p = BiLSTMParams(7, hidden, gen, cuda_device)
    x = torch.randn(rows, steps, 7, device=cuda_device, generator=gen)
    lengths = torch.randint(0, steps + 1, (rows,), device=cuda_device, generator=gen)
    mask = (torch.arange(steps, device=cuda_device)[None] < lengths[:, None]).float()
    out1, (h1, c1) = lk.bilstm_cuda(p, x, mask)
    w_h = torch.stack([p.fwd.w_h, p.bwd.w_h]).contiguous()
    out5, h5, c5, _, _ = lk.bilstm_train_forward(lk._projection(p, x).contiguous(), mask, w_h)
    for a, b in ((out5, out1), (h5, h1), (c5, c1)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,steps,empty", [
    (2048, 16, None),  # the word tower: 16-row clusters
    (64, 512, 1),      # the audio tower, a row of length 0 (fully masked)
    (16, 4096, None),  # the long-audio tower
    (7, 33, 3),        # a partial row group, a row of length 0
    (1, 9, None),      # one row
])
def test_bilstm_cluster_route_serving_shapes(cuda_device, rows, steps, empty):
    """K1's cluster route at the serving towers' shapes (H=128) against
    its plain version; twice the same bits; a fully masked row gives zero
    output and zero state; the route counter rose and the L2 one did not."""
    from mmbidaf_tpu_torch.ops.cuda import lstm_kernel as lk
    from mmbidaf_tpu_torch.ops.lstm import BiLSTMParams

    gen = torch.Generator(device=cuda_device).manual_seed(8)
    p = BiLSTMParams(8, 128, gen, cuda_device)
    x = torch.randn(rows, steps, 8, device=cuda_device, generator=gen)
    lengths = torch.randint(0, steps + 1, (rows,), device=cuda_device, generator=gen)
    if empty is not None:
        lengths[empty] = 0
    mask = (torch.arange(steps, device=cuda_device)[None] < lengths[:, None]).float()
    assert lk.serving_route(rows, 128) == "cluster"
    before = dict(lk.bilstm_cuda.routes)
    out, (h, c) = lk.bilstm_cuda(p, x, mask)
    ref, (rh, rc) = lk.bilstm_reference(p, x, mask)
    for o, r in ((out, ref), (h, rh), (c, rc)):
        torch.testing.assert_close(o, r, **lk.TOLERANCE)
    again, (h2, c2) = lk.bilstm_cuda(p, x, mask)
    assert torch.equal(out, again) and torch.equal(h, h2) and torch.equal(c, c2)
    assert lk.bilstm_cuda.routes == {"cluster": before["cluster"] + 2, "l2": before["l2"]}
    if empty is not None:
        assert not out[empty].any() and not h[empty].any() and not c[empty].any()


@pytest.mark.cuda
def test_bilstm_l2_route_past_the_cluster_plan(cuda_device):
    """H=512 has no cluster plan: K1 serves it by its L2 route (counted),
    against its plain version."""
    from mmbidaf_tpu_torch.ops.cuda import lstm_kernel as lk
    from mmbidaf_tpu_torch.ops.lstm import BiLSTMParams

    gen = torch.Generator(device=cuda_device).manual_seed(9)
    p = BiLSTMParams(6, 512, gen, cuda_device)
    x = torch.randn(5, 7, 6, device=cuda_device, generator=gen)
    mask = torch.ones(5, 7, device=cuda_device)
    mask[2, 4:] = 0.0
    assert lk.serving_route(5, 512) == "l2"
    before = dict(lk.bilstm_cuda.routes)
    out, (h, c) = lk.bilstm_cuda(p, x, mask)
    ref, (rh, rc) = lk.bilstm_reference(p, x, mask)
    for o, r in ((out, ref), (h, rh), (c, rc)):
        torch.testing.assert_close(o, r, **lk.TOLERANCE)
    assert lk.bilstm_cuda.routes == {"cluster": before["cluster"], "l2": before["l2"] + 1}


@pytest.mark.cuda
def test_lstm_cluster_plan_matches_the_card(cuda_device):
    """The Python plan is the C plan, up to its edge, and the card holds a
    cluster of each."""
    import ctypes

    from mmbidaf_tpu_torch.ops.cuda import build
    from mmbidaf_tpu_torch.ops.cuda import lstm_kernel as lk

    lib = build.library()
    for H in (8, 32, 100, 128, 256):
        for rows in (1, 5, 32, 1024, 1030):
            out = (ctypes.c_int * 7)()
            assert lib.mmb_lstm_cluster_plan(rows, H, out) == 0
            plan = lk.cluster_plan(rows, H)
            assert list(out) == [plan.C, plan.R, plan.U, plan.clusters, plan.blocks,
                                 plan.smem_fwd, plan.smem_bwd], (rows, H)
            assert lib.mmb_bilstm_forward_occupancy(rows, H) > 0, (rows, H)
            assert lib.mmb_bilstm_forward_train_occupancy(rows, H) > 0, (rows, H)
            assert lib.mmb_bilstm_backward_occupancy(rows, H) > 0, (rows, H)
    # the edge of the plan, where K1 turns to its L2 route
    for rows in (5, 200, 1024):
        h_max = max(H for H in range(1, 1025) if lk.serving_route(rows, H) == "cluster")
        out = (ctypes.c_int * 7)()
        assert lib.mmb_lstm_cluster_plan(rows, h_max, out) == 0, (rows, h_max)
        assert lib.mmb_lstm_cluster_plan(rows, h_max + 1, out) != 0, (rows, h_max + 1)
        assert lib.mmb_bilstm_forward_occupancy(rows, h_max) > 0, (rows, h_max)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,H", [(4, 512), (512, 400), (1024, 512), (64, 1024)])
def test_lstm_train_l2_route_past_the_cluster_plan(cuda_device, rows, H):
    """Widths with no cluster plan: K5 takes the L2 route and K6 the walk
    ``bptt_route`` names (the grid walk at 4 rows, else L2; counted), against
    their plain versions; K1 gives K5's bits; the L2 plan's mirror is the C
    plan and an SM holds a block of each kernel."""
    from mmbidaf_tpu_torch.ops.cuda import build
    from mmbidaf_tpu_torch.ops.cuda import lstm_kernel as lk
    from mmbidaf_tpu_torch.ops.lstm import BiLSTMParams

    lib = build.library()
    assert lk.train_route(rows, H) == "l2" and lib.mmb_lstm_l2_rows(rows, H) == lk.l2_rows(rows, H)
    for entry in ("mmb_bilstm_forward", "mmb_bilstm_forward_train", "mmb_bilstm_backward"):
        assert getattr(lib, f"{entry}_l2_occupancy")(rows, H) > 0
    gen = torch.Generator(device=cuda_device).manual_seed(20)
    T = 7
    p = BiLSTMParams(6, H, gen, cuda_device)
    with torch.no_grad():
        gates = lk._projection(p, torch.randn(rows, T, 6, device=cuda_device, generator=gen))
    w_h = torch.stack([p.fwd.w_h, p.bwd.w_h]).detach().contiguous()
    mask = torch.ones(rows, T, device=cuda_device)
    mask[1] = 0.0
    mask[2, 3:] = 0.0
    before = (dict(lk.bilstm_train_forward.routes), dict(lk.bilstm_bptt.routes))
    fwd = lk.bilstm_train_forward(gates, mask, w_h)
    for o, r in zip(fwd, lk.bilstm_train_forward_reference(gates, mask, w_h)):
        torch.testing.assert_close(o, r, **lk.TOLERANCE)
    k1 = torch.ops.mmbidaf.bilstm(gates, mask, w_h)
    assert all(torch.equal(a, b) for a, b in zip(k1, fwd[:3]))
    cot = [torch.randn(*s, device=cuda_device, generator=gen)
           for s in ((rows, T, 2 * H), (rows, 2 * H), (rows, 2 * H))]
    args = (gates, mask, w_h, fwd[3], fwd[4], *cot)
    got, ref = lk.bilstm_bptt(*args), lk.bilstm_bptt_reference(*args)
    for o, r in zip(got, ref):
        bound = lk.BPTT_TOLERANCE["atol"] + lk.BPTT_TOLERANCE["rtol"] * r.abs().max()
        assert (o - r).abs().max() <= bound
    assert not got[0][1].any()
    assert all(torch.equal(a, b) for a, b in zip(got, lk.bilstm_bptt(*args)))
    assert lk.bilstm_train_forward.routes["l2"] == before[0]["l2"] + 1
    route6 = lk.bptt_route(rows, H)
    assert lk.bilstm_bptt.routes[route6] == before[1][route6] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("rows,H,T", [
    (4, 512, 7),      # a few rows: one row group
    (32, 512, 1),     # T=1: no step has an h_prev, no exchange
    (32, 512, 7),
    (32, 512, 512),   # the audio tower of the hidden-512 model
    (64, 512, 33),    # the most rows the grid walk takes
    (7, 452, 20),     # 452 units: slices of 8 and 9 (of 7 and 8 at 64 blocks), chunks of 56 and 57
    (64, 1024, 7),    # past 12 units a block: the rule names the L2 walk
])
def test_lstm_bptt_grid_route(cuda_device, rows, H, T):
    """K6 on the route ``bptt_route`` names at few rows past the cluster plan
    (the grid walk: W_h resident across the card) against its plain version
    and against the L2 walk, with a ragged mask, an empty row and nonzero
    dh_last / dc_last; twice the same bits; the route counted; the C rule
    and plan equal their mirrors and the card runs a plan no larger."""
    import ctypes

    from mmbidaf_tpu_torch.ops.cuda import build
    from mmbidaf_tpu_torch.ops.cuda import lstm_kernel as lk
    from mmbidaf_tpu_torch.ops.lstm import BiLSTMParams

    lib = build.library()
    route = lk.bptt_route(rows, H)
    assert lk._BPTT_ROUTES[lib.mmb_lstm_bptt_route(rows, H, 0)] == route
    assert lk._BPTT_ROUTES[lib.mmb_lstm_bptt_route(rows, H, 1)] == route
    if route == "grid":
        shape, card = (ctypes.c_int * 10)(), (ctypes.c_int * 10)()
        assert lib.mmb_lstm_grid_plan(rows, H, 0, shape) == 0
        assert tuple(shape) == tuple(lk.grid_plan(rows, H)[:10])
        assert lib.mmb_lstm_grid_plan(rows, H, 1, card) == 0
        assert tuple(card) == tuple(lk.grid_plan(rows, H, card[0])[:10]) and card[9] <= shape[9]
        assert lib.mmb_bilstm_backward_grid_occupancy(rows, H, card[0]) >= 2 * card[2]
    gen = torch.Generator(device=cuda_device).manual_seed(26)
    p = BiLSTMParams(6, H, gen, cuda_device)
    with torch.no_grad():
        gates = lk._projection(p, torch.randn(rows, T, 6, device=cuda_device, generator=gen))
    w_h = torch.stack([p.fwd.w_h, p.bwd.w_h]).detach().contiguous()
    lengths = torch.randint(0, T + 1, (rows,), device=cuda_device, generator=gen)
    lengths[min(1, rows - 1)] = 0
    mask = (torch.arange(T, device=cuda_device)[None] < lengths[:, None]).float()
    fwd = lk.bilstm_train_forward(gates, mask, w_h)
    cot = [torch.randn(*s, device=cuda_device, generator=gen)
           for s in ((rows, T, 2 * H), (rows, 2 * H), (rows, 2 * H))]
    args = (gates, mask, w_h, fwd[3], fwd[4], *cot)
    before = dict(lk.bilstm_bptt.routes)
    got = lk.bilstm_bptt(*args)
    _assert_normwise(got, lk.bilstm_bptt_reference(*args), lk.BPTT_TOLERANCE, "K6")
    assert all(torch.equal(a, b) for a, b in zip(got, lk.bilstm_bptt(*args)))
    assert lk.bilstm_bptt.routes[route] == before[route] + 2
    assert not got[0][min(1, rows - 1)].any()
    _assert_normwise(got, lk.bilstm_bptt(*args, route="l2"), lk.BPTT_TOLERANCE, "K6 vs L2")


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,win,n_mels", [
    (4096, 4096, 64),   # K4's FFT route at 4 frames a block, K3's at 2
    (8192, 8192, 64),   # K4's FFT route at 2 frames a block, K3's dense one
    (1500, 1500, 64),   # the dense route at 16 frames a block
    (512, 400, 512),    # K3's DCT pass past 48 KB
])
def test_mel_window_routes(cuda_device, n_fft, win, n_mels):
    """K4 (both modes) and K3 at windows past win + bins = 1,815 against
    their plain versions, each on the route named; the plans' mirrors equal
    the C plans."""
    import ctypes

    from mmbidaf_tpu_torch.ops import audio
    from mmbidaf_tpu_torch.ops.cuda import build
    from mmbidaf_tpu_torch.ops.cuda import melspec_kernel as mk

    lib = build.library()
    bins = n_fft // 2 + 1
    consts = audio.make_audio_frontend_consts(16000, n_fft, win, n_mels, 13, device=cuda_device)
    nnz = mk.mel_nonzeros(consts["mel_fb"])[1].numel()
    out3 = (ctypes.c_int * 3)()
    for f64 in (False, True):
        plan = mk.fft_plan(n_fft, win, 160, n_mels, nnz, f64)
        rc = lib.mmb_log_mel_fft_plan(n_fft, win, 160, n_mels, nnz, int(f64), out3)
        assert (rc == 0) == (plan is not None) and (plan is None or tuple(out3) == tuple(plan))
    assert lib.mmb_mel_dense_frames(win, bins) == mk.dense_frames(win, bins)
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    T = 40
    sig = torch.randn(2, (T - 1) * 160 + win, device=cuda_device, generator=gen) * 0.1
    sig[1] = 0.0
    frames = audio.frame_signal(sig, win, 160, T)
    r4, r3 = mk.log_mel_route(win, bins), mk.mfcc_route(win, bins)
    before = (dict(mk.log_mel_fused.routes), dict(mk.mfcc_fused.routes))
    for log in (True, False):
        out = mk.log_mel_fused(frames, consts, log=log)
        ref = mk.log_mel_reference(frames, consts, log=log)
        tol = mk.LOG_MEL_TOLERANCE[log]
        if log:
            torch.testing.assert_close(out, ref, **tol)
        else:
            assert (out - ref).abs().max() <= tol["atol"] + tol["rtol"] * ref.abs().max()
    out = mk.mfcc_fused(frames, consts)
    torch.testing.assert_close(out, mk.mfcc_reference(frames, consts), **mk.TOLERANCE)
    assert not out[1].any()
    assert mk.log_mel_fused.routes[r4] == before[0][r4] + 2
    assert mk.mfcc_fused.routes[r3] == before[1][r3] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("B,T_c,T_q,D", [
    (2, 33, 100, 320),  # two register chunks of context rows; D > 256 threads; a partial tile
    (3, 5, 33, 40),     # a partial q tile
])
def test_bidaf_dropout_kernels_generic_shapes(cuda_device, B, T_c, T_q, D):
    """K7 and K8 against their plain versions with cd != c and fully masked
    rows; K8 twice gives the same bits."""
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel as bk

    gen = torch.Generator(device=cuda_device).manual_seed(5)
    rand = lambda *s: torch.randn(*s, device=cuda_device, generator=gen)  # noqa: E731
    c, q = rand(B, T_c, D), rand(B, T_q, D)
    cd = c * (torch.rand(c.shape, device=cuda_device, generator=gen) > 0.2).float() / 0.8
    qd = q * (torch.rand(q.shape, device=cuda_device, generator=gen) > 0.2).float() / 0.8
    c_mask = (torch.rand(B, T_c, device=cuda_device, generator=gen) > 0.3).float()
    q_mask = (torch.rand(B, T_q, device=cuda_device, generator=gen) > 0.3).float()
    q_mask[0] = 0.0
    c_mask[1] = 0.0
    ops = (c, q, cd, qd, c_mask, q_mask, rand(D) * 0.1, rand(D) * 0.1, rand(D) * 0.1,
           torch.tensor(-0.3, device=cuda_device))
    torch.testing.assert_close(bk.bidaf_dropout_forward(*ops), bk.bidaf_dropout_reference(*ops),
                               **bk.TOLERANCE)
    g = rand(B, T_c, 4 * D)
    bwd = bk.bidaf_dropout_backward(*ops, g)
    _assert_normwise(bwd, bk.bidaf_dropout_backward_reference(*ops, g), bk.BACKWARD_TOLERANCE, "K8")
    assert all(torch.equal(a, b) for a, b in zip(bwd, bk.bidaf_dropout_backward(*ops, g)))


def _has_drop_plan(T_c, T_q, D) -> bool:
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel as bk

    try:
        bk.drop_plan(T_c, T_q, D)
        return True
    except ValueError:
        return False


@pytest.mark.cuda
@pytest.mark.parametrize("B,T_c,T_q,D", [
    (3, 8, 70, 24),          # T_q not a multiple of the tile: 3 tiles of 24, 24, 22
    (3, 33, 20, 64),         # a cluster of one (T_q <= the tile); T_c = 33
    (3, 33, 512, 256),       # T_c = 33 over 16 tiles of 32
    (2, 32, "largest", 256), # the plan's largest accepted T_q (16 tiles, >= 1024 columns)
])
def test_bidaf_dropout_cluster_edges(cuda_device, B, T_c, T_q, D):
    """K7 and K8 at the cluster split's edges against their plain versions,
    with a fully masked q row (example 0), a fully masked c column (example
    1) and, where B=3, q masked past the first tile (example 2); each twice
    gives the same bits."""
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel as bk

    if T_q == "largest":
        T_q = max(t for t in range(1024, 2048) if _has_drop_plan(T_c, t, D))
    plan = bk.drop_plan(T_c, T_q, D)
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    rand = lambda *s: torch.randn(*s, device=cuda_device, generator=gen)  # noqa: E731
    c, q = rand(B, T_c, D), rand(B, T_q, D)
    cd = c * (torch.rand(c.shape, device=cuda_device, generator=gen) > 0.2).float() / 0.8
    qd = q * (torch.rand(q.shape, device=cuda_device, generator=gen) > 0.2).float() / 0.8
    c_mask = (torch.rand(B, T_c, device=cuda_device, generator=gen) > 0.3).float()
    q_mask = (torch.rand(B, T_q, device=cuda_device, generator=gen) > 0.3).float()
    q_mask[0] = 0.0
    c_mask[1] = 0.0
    if B > 2:
        q_mask[2, plan.tiles[0][1]:] = 0.0
    ops = (c, q, cd, qd, c_mask, q_mask, rand(D) * 0.1, rand(D) * 0.1, rand(D) * 0.1,
           torch.tensor(0.3, device=cuda_device))
    out = bk.bidaf_dropout_forward(*ops)
    torch.testing.assert_close(out, bk.bidaf_dropout_reference(*ops), **bk.TOLERANCE)
    assert torch.equal(out, bk.bidaf_dropout_forward(*ops))
    g = rand(B, T_c, 4 * D)
    bwd = bk.bidaf_dropout_backward(*ops, g)
    _assert_normwise(bwd, bk.bidaf_dropout_backward_reference(*ops, g), bk.BACKWARD_TOLERANCE, "K8")
    assert all(torch.equal(a, b) for a, b in zip(bwd, bk.bidaf_dropout_backward(*ops, g)))


@pytest.mark.cuda
def test_bidaf_drop_plan_matches_the_card(cuda_device):
    """The Python plan of K7 and K8 is the C plan, and the card holds a
    cluster of each kernel at every such plan."""
    import ctypes

    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel as bk
    from mmbidaf_tpu_torch.ops.cuda import build

    lib = build.library()
    largest = max(t for t in range(1024, 2048) if _has_drop_plan(32, t, 256))
    for T_c, T_q, D in ((32, 16, 256), (32, 512, 256), (33, 100, 320), (5, 33, 40), (7, 45, 20),
                        (32, 1, 256), (8, 70, 24), (32, 1024, 256), (32, largest, 256)):
        out = (ctypes.c_int * 4)()
        assert lib.mmb_bidaf_drop_plan(T_c, T_q, D, out) == 0
        plan = bk.drop_plan(T_c, T_q, D)
        assert list(out) == [plan.C, plan.tq, plan.smem_fwd, plan.smem_bwd], (T_c, T_q, D)
        assert lib.mmb_bidaf_forward_dropout_occupancy(T_c, T_q, D) > 0, (T_c, T_q, D)
        assert lib.mmb_bidaf_backward_occupancy(T_c, T_q, D) > 0, (T_c, T_q, D)
    assert lib.mmb_bidaf_drop_plan(32, largest + 1, 256, out) != 0


@pytest.mark.cuda
def test_bidaf_dropout_shape_with_no_plan_raises(cuda_device):
    """T_c=5000, T_q=64 at D=256: no cluster block of K8 and no block of
    K7's tiled walk fits, so K7 and K8 raise before launching anything
    (T_q=4096 at T_c=32 now takes the tiled route)."""
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel as bk

    B, T_c, T_q, D = 1, 5000, 64, 256
    z = lambda *s: torch.zeros(*s, device=cuda_device)  # noqa: E731
    ops = (z(B, T_c, D), z(B, T_q, D), z(B, T_c, D), z(B, T_q, D), z(B, T_c), z(B, T_q),
           z(D), z(D), z(D), z(()))
    before = (bk.bidaf_dropout_forward.launches, bk.bidaf_dropout_backward.launches)
    with pytest.raises(ValueError, match="no K7/K8 route"):
        bk.bidaf_dropout_forward(*ops)
    with pytest.raises(ValueError, match="no K7/K8 route"):
        bk.bidaf_dropout_backward(*ops, z(B, T_c, 4 * D))
    torch.cuda.synchronize()
    assert (bk.bidaf_dropout_forward.launches, bk.bidaf_dropout_backward.launches) == before


@pytest.mark.cuda
def test_bench_width_train_step_parity_with_jax(cuda_device):
    """One training step of the port on the card (f32, drop_prob 0, the
    K5-K8 kernels) against JAX's ``make_train_step`` on the host CPU, same
    weights and batch, bench widths, B=2."""
    import dataclasses

    from mmbidaf_tpu.data.synthetic import random_word_vectors, synthetic_batch
    from mmbidaf_tpu.models.mmbidaf import mmbidaf_init as j_init
    from mmbidaf_tpu.train.loop import init_train_state as j_init_state
    from mmbidaf_tpu.train.loop import make_train_step as j_make_step
    from mmbidaf_tpu_torch.config import config_from_dict
    from mmbidaf_tpu_torch.interop.from_jax import train_state_from_jax
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel, lstm_kernel
    from mmbidaf_tpu_torch.train.loop import make_train_step

    j_cfg = _bench_f32_config(kernels=False)
    cfg = config_from_dict(dataclasses.asdict(_bench_f32_config(kernels=True)))
    rng = np.random.default_rng(0)
    wv = random_word_vectors(rng, j_cfg.data.vocab_size, j_cfg.model.emb_dim)
    params = j_init(jax.random.key(0), j_cfg, jnp.asarray(wv))
    batch = synthetic_batch(rng, j_cfg, batch_size=2)
    j_state = j_init_state(jax.random.key(1), params, j_cfg)
    np_params = jax.tree.map(np.asarray, params)
    state = train_state_from_jax(np_params, np_params, cfg, cuda_device)
    j_state, j_m = j_make_step(j_cfg)(j_state, {k: jnp.asarray(v) for k, v in batch.items()})
    counts = [f.launches for f in (lstm_kernel.bilstm_train_forward, lstm_kernel.bilstm_bptt,
                                   bidaf_kernel.bidaf_dropout_forward,
                                   bidaf_kernel.bidaf_dropout_backward)]
    state, m = make_train_step(cfg)(state, {k: torch.from_numpy(v).to(cuda_device)
                                            for k, v in batch.items()})
    after = [f.launches for f in (lstm_kernel.bilstm_train_forward, lstm_kernel.bilstm_bptt,
                                  bidaf_kernel.bidaf_dropout_forward,
                                  bidaf_kernel.bidaf_dropout_backward)]
    assert [a - b for a, b in zip(after, counts)] == [5, 5, 2, 2]  # the kernels ran
    np.testing.assert_allclose(float(m["loss"]), float(j_m["loss"]), atol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(j_m["grad_norm"]), rtol=1e-4)
    for tree, module in ((j_state.params, state.params), (j_state.ema_params, state.ema_params)):
        ours = {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}
        from mmbidaf_tpu_torch.interop.from_jax import flatten_pytree

        for k, v in flatten_pytree(jax.tree.map(np.asarray, tree)).items():
            np.testing.assert_allclose(ours[k], v, atol=1e-5, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("train,model", [
    ({"remat_towers": True, "grad_accum_steps": 2}, {}),
    ({}, {"compute_dtype": "bfloat16"}),
], ids=["remat_accum", "bf16"])
def test_train_step_options_through_the_kernels(cuda_device, train, model):
    """The step options chip_smoke.py does not drive, at small widths: one
    drop-0 step through K5-K8 against one through the plain versions. f32
    (remat + accumulation): loss and parameters within 1e-5. bf16: the
    plain path keeps the LSTM state in bf16 where the kernels keep f32, so
    the losses agree to bf16 rounding (5e-2) and every gradient step is
    finite."""
    import dataclasses

    from mmbidaf_tpu_torch.config import tiny_test_config
    from mmbidaf_tpu_torch.data.synthetic import random_word_vectors, synthetic_batch
    from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_init
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel, lstm_kernel
    from mmbidaf_tpu_torch.train.loop import init_train_state, make_train_step

    results = []
    for kernels in (True, False):
        cfg = tiny_test_config()
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, **train),
            model=dataclasses.replace(cfg.model, use_pallas_lstm=kernels,
                                      use_pallas_attention=kernels, **model))
        rng = np.random.default_rng(8)
        wv = random_word_vectors(rng, cfg.data.vocab_size, cfg.model.emb_dim)
        state = init_train_state(mmbidaf_init(cfg, wv, cuda_device, seed=8), cfg)
        batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in synthetic_batch(rng, cfg, 4).items()}
        before = lstm_kernel.bilstm_bptt.launches + bidaf_kernel.bidaf_dropout_backward.launches
        state, m = make_train_step(cfg)(state, batch)
        ran = lstm_kernel.bilstm_bptt.launches + bidaf_kernel.bidaf_dropout_backward.launches - before
        assert (ran > 0) == kernels
        results.append((float(m["loss"]), {n: p.detach().cpu() for n, p in state.params.named_parameters()}))
    (lk, pk), (lp, pp) = results
    assert np.isfinite(lk) and all(bool(torch.isfinite(v).all()) for v in pk.values())
    if model.get("compute_dtype") == "bfloat16":
        assert abs(lk - lp) <= 5e-2
        return
    assert abs(lk - lp) <= 1e-5
    for n in pk:
        torch.testing.assert_close(pk[n], pp[n], atol=1e-5, rtol=0.0, msg=n)


def _conv_args(dev, gen, N, H, W, Cin, Cout, dtype):
    x = torch.randn(N, H, W, Cin, device=dev, generator=gen).to(dtype)
    w = (torch.randn(3, 3, Cin, Cout, device=dev, generator=gen) * (2.0 / (9 * Cin)) ** 0.5).to(dtype)
    return x, w, (torch.randn(Cout, device=dev, generator=gen) * 0.1).to(dtype)


def _k13_route(dtype, x, w):
    """The route K13 should take: TMA where both operands have C % 8 == 0
    and 16-byte aligned data, else cp.async; the scalar body in f32."""
    if dtype == torch.float32:
        return "scalar"
    ok = (x.shape[-1] % 8 == 0 and w.shape[-1] % 8 == 0 and x.data_ptr() % 16 == 0
          and w.data_ptr() % 16 == 0)
    return "tma" if ok else "cp.async"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("N,H,W,Cin,Cout", [
    (2, 13, 21, 64, 72),  # odd H and W: partial pixel tiles; Cout past one 64-channel block
    (3, 7, 9, 6, 10),     # one input-channel chunk, partly empty; Cout below a block
    (2, 9, 17, 40, 72),   # Cin not a multiple of the 16-channel chunk
    (1, 10, 12, 24, 200), # Cout past three blocks, ragged
    (2, 6, 11, 14, 18),   # Cin and Cout not multiples of 8: the elementwise loaders
    (4, 14, 14, 512, 512),  # a VGG-16 conv5 layer
    (3, 5, 9, 16, 24),    # W < 16 and H < 8: K13's TMA box runs past the image on every side
])
def test_conv3x3_kernels_generic_shapes(cuda_device, dtype, N, H, W, Cin, Cout):
    """K11, K12 and K13 against their plain version; each call is one
    launch; K13 takes the route its shape allows; K12 and K13 give the same
    bits twice."""
    from mmbidaf_tpu_torch.ops.cuda import conv_kernel as ck

    x, w, b = _conv_args(cuda_device, torch.Generator(device=cuda_device).manual_seed(9),
                         N, H, W, Cin, Cout, dtype)
    ref = ck.conv3x3_reference(x, w, b)
    for fn in (ck.conv3x3_same, ck.conv3x3_same_acc, ck.conv3x3_same_db):
        before = fn.launches
        out = fn(x, w, b)
        assert fn.launches == before + 1 and out.dtype == dtype
        torch.testing.assert_close(out.float(), ref.float(), **ck.TOLERANCE[dtype], msg=fn.__name__)
        if fn is not ck.conv3x3_same:
            assert torch.equal(fn(x, w, b), out), fn.__name__
    assert ck.conv3x3_same_db.route == _k13_route(dtype, x, w)
    no_relu = ck.conv3x3_same_acc(x, w, b, relu=False)
    torch.testing.assert_close(no_relu.float(), ck.conv3x3_reference(x, w, b, relu=False).float(),
                               **ck.TOLERANCE[dtype])
    if dtype == torch.bfloat16:  # odd Cin and Cout: K13 in bf16 takes them (the cp.async route)
        x5, w5, b7 = x[..., :5].contiguous(), w[:, :, :5, :7].contiguous(), b[:7].contiguous()
        torch.testing.assert_close(ck.conv3x3_same_db(x5, w5, b7).float(),
                                   ck.conv3x3_reference(x5, w5, b7).float(), **ck.TOLERANCE[dtype])
        assert ck.conv3x3_same_db.route == "cp.async"


def _offset_by_one(t):
    """``t``'s values in a contiguous tensor whose data starts one element
    into its storage (a pointer 2 bytes off 16-byte alignment in bf16)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case,N,H,W,Cin,Cout,route", [
    ("aligned", 2, 11, 19, 48, 40, "tma"),       # C % 8 == 0: TMA, ragged Cin chunk and Cout block
    ("odd_c", 2, 11, 19, 13, 20, "cp.async"),    # Cin off 8: element loads of x, cp.async of w
    ("odd_k", 2, 11, 19, 48, 20, "cp.async"),    # Cout off 8: cp.async of x, element loads of w
    ("x_offset", 2, 11, 19, 48, 40, "cp.async"),  # x one element into its storage
    ("w_offset", 2, 11, 19, 48, 40, "cp.async"),  # w one element into its storage
])
def test_conv3x3_k13_routes(cuda_device, case, N, H, W, Cin, Cout, route):
    """K13's TMA and cp.async routes (and K11's and K12's element loaders at
    the same shapes) against the plain version, in bf16."""
    from mmbidaf_tpu_torch.ops.cuda import conv_kernel as ck

    x, w, b = _conv_args(cuda_device, torch.Generator(device=cuda_device).manual_seed(12),
                         N, H, W, Cin, Cout, torch.bfloat16)
    if case == "x_offset":
        x = _offset_by_one(x)
    if case == "w_offset":
        w = _offset_by_one(w)
    ref = ck.conv3x3_reference(x, w, b).float()
    for fn in (ck.conv3x3_same, ck.conv3x3_same_acc, ck.conv3x3_same_db):
        torch.testing.assert_close(fn(x, w, b).float(), ref, **ck.TOLERANCE[torch.bfloat16],
                                   msg=fn.__name__)
    assert ck.conv3x3_same_db.route == route


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("N,H,W,C,K,relu", [
    (2, 13, 21, 64, 72, True),  # odd H and W (a partial last tile), K past one block (32 f32, 64 bf16)
    (3, 7, 5, 96, 40, False),   # a tile group spanning images; no ReLU
    (1, 1, 1, 3, 5, True),      # one pixel: a single tile, mostly halo
    (2, 9, 11, 40, 72, True),   # C not a multiple of the 32-channel chunk; K past a 64 block
    (1, 6, 10, 48, 200, True),  # K past three blocks, ragged
    (2, 5, 7, 20, 12, True),    # C and K not multiples of 8: the elementwise loaders
    (11, 3, 5, 16, 24, True),   # 6 tiles an image: a tile group spans six images
    (4, 14, 14, 512, 512, True),  # a VGG-16 conv5 layer
])
def test_winograd_kernel_generic_shapes(cuda_device, dtype, N, H, W, C, K, relu):
    """K14 against its plain version (V and U rounded to the dtype on both
    sides), and within conv tolerance of the direct conv in f32."""
    from mmbidaf_tpu_torch.ops.cuda import conv_kernel as ck
    from mmbidaf_tpu_torch.ops.cuda import winograd_kernel as wk

    x, w, b = _conv_args(cuda_device, torch.Generator(device=cuda_device).manual_seed(10),
                         N, H, W, C, K, dtype)
    before = wk.winograd_conv3x3_fused.launches
    out = wk.winograd_conv3x3_fused(x, w, b, relu=relu)
    assert wk.winograd_conv3x3_fused.launches == before + 1 and out.dtype == dtype
    torch.testing.assert_close(out.float(), wk.winograd_reference(x, w, b, relu=relu).float(),
                               **wk.TOLERANCE[dtype])
    if dtype == torch.float32:
        torch.testing.assert_close(out, ck.conv3x3_reference(x, w, b, relu=relu), atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,h,w,s", [(3, 37, 53, 24), (2, 20, 30, 33), (1, 16, 16, 16),
                                     (2, 100, 150, 224), (1, 1080, 1920, 224)])
def test_preprocess_kernel_generic_shapes(cuda_device, dtype, n, h, w, s):
    """K10 against its plain version: odd downscales (a partial last block of
    output rows, rows not 4-byte aligned), upscales, the identity resize,
    and 1080p frames (two output rows a block)."""
    from mmbidaf_tpu_torch.ops.cuda import preprocess_kernel as pk

    gen = torch.Generator(device=cuda_device).manual_seed(11)
    x = torch.randint(0, 256, (n, h, w, 3), device=cuda_device, generator=gen, dtype=torch.uint8)
    before = pk.preprocess_frames_fused.launches
    out = pk.preprocess_frames_fused(x, s, dtype)
    assert pk.preprocess_frames_fused.launches == before + 1
    assert out.dtype == dtype and out.shape == (n, s, s, 3)
    torch.testing.assert_close(out.float(), pk.preprocess_reference(x, s, dtype).float(),
                               **pk.TOLERANCE[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("pool", [False, True], ids=["inplace", "pool"])
@pytest.mark.parametrize("N,H,W,C,bias", [
    (2, 224, 224, 64, "same"),   # VGG-16 block 1
    (2, 112, 112, 128, "same"),  # block 2
    (3, 56, 56, 256, "same"),    # block 3
    (2, 28, 28, 512, "same"),    # block 4
    (5, 14, 14, 512, "same"),    # block 5
    (3, 13, 15, 64, "same"),     # odd sides: the last row and column left out of the pool
    (2, 9, 7, 3, "same"),        # C = 3: the scalar loop
    (2, 6, 10, 20, "f32"),       # C = 20: scalar in bf16, vectors in f32; an f32 bias
    (1, 2, 2, 8, "same"),        # one window
])
def test_conv_epilogue_kernel_bit_for_bit(cuda_device, dtype, pool, N, H, W, C, bias):
    """The epilogue kernel against the separate bias add, ReLU and
    ``max_pool2d`` on the same conv output (channels-last): bit for bit, in
    place without the pool (the output is ``y`` itself), ``y`` untouched
    with it; one launch a call."""
    from mmbidaf_tpu_torch.ops.cuda.conv_epilogue_kernel import conv_epilogue, conv_epilogue_reference

    gen = torch.Generator(device=cuda_device).manual_seed(N * H + C)
    y = (torch.randn(N, C, H, W, device=cuda_device, generator=gen) * 3).to(dtype)
    y = y.contiguous(memory_format=torch.channels_last)
    y[0, 0, 0, 0] = 0.0
    b = torch.randn(C, device=cuda_device, generator=gen)
    b = b if bias == "f32" else b.to(dtype)
    want = conv_epilogue_reference(y, b, pool)
    y0 = y.clone()
    before = conv_epilogue.launches
    got = conv_epilogue(y, b, pool)
    assert conv_epilogue.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)
    if pool:
        assert torch.equal(y, y0)
    else:
        assert got.data_ptr() == y.data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [False, True], ids=["inplace", "pool"])
def test_conv_epilogue_kernel_past_2_31_elements(cuda_device, pool):
    """A bf16 block-1 activation of 670 frames (2.15e9 elements, past
    2^31): the kernel's 64-bit offsets, bit for bit the separate passes."""
    from mmbidaf_tpu_torch.ops.cuda.conv_epilogue_kernel import conv_epilogue, conv_epilogue_reference

    gen = torch.Generator(device=cuda_device).manual_seed(31)
    y = torch.empty(670, 64, 224, 224, device=cuda_device, dtype=torch.bfloat16,
                    memory_format=torch.channels_last).normal_(generator=gen)
    assert y.numel() > 2 ** 31
    b = torch.randn(64, device=cuda_device, generator=gen).bfloat16()
    want = conv_epilogue_reference(y, b, pool)
    got = conv_epilogue(y, b, pool)
    assert torch.equal(got, want)
    del got, want, y
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_vgg_features_bf16_runs_no_layout_transform(cuda_device):
    """A profiler trace of one small bf16 VGG-16 ``vgg_features`` call on
    resized frames holds the epilogue kernel and no cuDNN layout transform
    (``nchwToNhwc`` / ``nhwcToNchw``), and no separate ReLU or pool pass."""
    from torch.profiler import ProfilerActivity, profile

    from mmbidaf_tpu_torch.ops.vgg import VGG, VGG16_SPEC, preprocess_frames, vgg_features

    gen = torch.Generator(device=cuda_device).manual_seed(17)
    params = VGG(VGG16_SPEC, 224, 4096, 3, gen, cuda_device).to(torch.bfloat16)
    frames = torch.randint(0, 256, (4, 240, 320, 3), device=cuda_device, generator=gen,
                           dtype=torch.uint8)
    with torch.inference_mode():
        imgs = preprocess_frames(frames, 224, torch.bfloat16)
        vgg_features(params, imgs)  # cuDNN chooses its algorithms outside the trace
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            vgg_features(params, imgs)
            torch.cuda.synchronize()
    names = {e.name for e in prof.events() if e.device_type.name == "CUDA"}
    assert any("conv_epilogue_vec_kernel" in n for n in names), sorted(names)
    bad = sorted(n for n in names if any(k in n for k in ("nchwToNhwc", "nhwcToNchw",
                                                          "max_pool", "clamp_min")))
    assert not bad, bad


@pytest.mark.cuda
@pytest.mark.parametrize("winograd,launches", [(False, 13), (True, 1)], ids=["direct", "winograd"])
def test_conv_epilogue_launches_a_frame_chunk(cuda_device, winograd, launches):
    """``conv_epilogue.launches`` moves 13 times a VGG-16 frame chunk on the
    direct route (one a conv) and once on the Winograd route (the stem;
    K14 keeps its own bias and ReLU): two chunks of two frames here."""
    from mmbidaf_tpu_torch.config import Config as PConfig
    from mmbidaf_tpu_torch.config import DataConfig as PDataConfig
    from mmbidaf_tpu_torch.config import ModelConfig as PModelConfig
    from mmbidaf_tpu_torch.data.frontend import cast_vgg_weights, frames_through_vgg, frontend_init
    from mmbidaf_tpu_torch.ops.cuda import winograd_kernel
    from mmbidaf_tpu_torch.ops.cuda.conv_epilogue_kernel import conv_epilogue
    from mmbidaf_tpu_torch.ops.vgg import VGG16_SPEC

    cfg = PConfig(model=PModelConfig(img_feat_dim=4096, compute_dtype="bfloat16", vgg_frame_chunk=2,
                                     use_winograd_conv=winograd, use_audio=False),
                  data=PDataConfig(max_keyframes=2, image_size=224))
    fe = cast_vgg_weights(frontend_init(cfg, VGG16_SPEC, cuda_device), "bfloat16")
    frames = torch.zeros(2, 2, 240, 320, 3, device=cuda_device, dtype=torch.uint8)
    before = (conv_epilogue.launches, winograd_kernel.winograd_conv3x3_fused.launches)
    with torch.inference_mode():
        feats = frames_through_vgg(fe, frames, cfg, VGG16_SPEC)
    assert feats.shape == (4, 4096)
    assert conv_epilogue.launches - before[0] == 2 * launches
    assert winograd_kernel.winograd_conv3x3_fused.launches - before[1] == (24 if winograd else 0)


@pytest.mark.cuda
def test_vgg_features_f32_ignore_the_tf32_flag(cuda_device):
    """f32 ``vgg_features`` at 224² with the process's cuDNN TF32 flag on
    (its default) equal the same call with TF32 forced off, within the
    features' 1e-4 bound: the direct convs pin full f32 themselves. The
    process's cuDNN flags are as they were afterwards."""
    from mmbidaf_tpu_torch.ops.vgg import VGG, VGG16_SPEC, vgg_features

    cudnn = torch.backends.cudnn
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    params = VGG(VGG16_SPEC, 224, 4096, 3, gen, cuda_device)
    imgs = torch.randn(2, 224, 224, 3, device=cuda_device, generator=gen)
    prior = cudnn.allow_tf32
    try:
        cudnn.allow_tf32 = True
        before = (cudnn.enabled, cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32)
        with torch.no_grad():
            free = vgg_features(params, imgs)
        assert (cudnn.enabled, cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32) == before
        cudnn.allow_tf32 = False
        with torch.no_grad():
            pinned = vgg_features(params, imgs)
    finally:
        cudnn.allow_tf32 = prior
    assert free.shape == (2, 4096) and bool(torch.isfinite(free).all())
    torch.testing.assert_close(free, pinned, atol=1e-4, rtol=0.0)


@pytest.mark.cuda
def test_bench_width_winograd_parity_with_jax(cuda_device):
    """The bench configuration with ``use_winograd_conv=True`` at B=2, f32:
    the port on the card (K14 for the twelve C_in >= 32 convs, K1-K3)
    against the JAX package's XLA Winograd on the host CPU."""
    import dataclasses

    from mmbidaf_tpu.data.frontend import frontend_init as j_frontend_init
    from mmbidaf_tpu.data.frontend import make_end_to_end_decode as j_end_to_end
    from mmbidaf_tpu.data.synthetic import random_word_vectors, synthetic_batch
    from mmbidaf_tpu.models.mmbidaf import mmbidaf_init as j_init
    from mmbidaf_tpu_torch.config import config_from_dict
    from mmbidaf_tpu_torch.data.frontend import make_end_to_end_decode
    from mmbidaf_tpu_torch.interop.from_jax import frontend_from_jax, model_from_jax
    from mmbidaf_tpu_torch.ops.cuda import winograd_kernel
    from mmbidaf_tpu_torch.ops.vgg import VGG16_SPEC

    def winograd(cfg):
        return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, use_winograd_conv=True))

    j_cfg = winograd(_bench_f32_config(kernels=False))
    cfg = config_from_dict(dataclasses.asdict(winograd(_bench_f32_config(kernels=True))))
    d = cfg.data
    rng = np.random.default_rng(0)
    wv = random_word_vectors(rng, d.vocab_size, cfg.model.emb_dim)
    params = j_init(jax.random.key(0), j_cfg, jnp.asarray(wv))
    fe = j_frontend_init(jax.random.key(1), j_cfg)
    base = synthetic_batch(rng, j_cfg, batch_size=2)
    raw = {k: base[k] for k in ("text_ids", "word_mask", "sent_mask", "img_mask", "aud_mask")}
    raw["frames"] = (rng.random((2, d.max_keyframes, 240, 320, 3)) * 255).astype(np.uint8)
    raw["waveform"] = (rng.standard_normal((2, d.max_audio_frames * d.hop_length + d.win_length))
                       * 0.1).astype(np.float32)
    j_lp, j_picks = (np.asarray(a) for a in j_end_to_end(j_cfg)(
        params, fe, {k: jnp.asarray(v) for k, v in raw.items()}))
    model = model_from_jax(jax.tree.map(np.asarray, params), cfg, cuda_device)
    front = frontend_from_jax(jax.tree.map(np.asarray, fe), cfg, VGG16_SPEC, cuda_device)
    before = winograd_kernel.winograd_conv3x3_fused.launches
    lp, picks = make_end_to_end_decode(cfg)(
        model, front, {k: torch.from_numpy(v).to(cuda_device) for k, v in raw.items()})
    assert winograd_kernel.winograd_conv3x3_fused.launches - before == 12  # one VGG-16 pass
    np.testing.assert_array_equal(picks.cpu().numpy(), j_picks)
    np.testing.assert_allclose(lp.cpu().numpy(), j_lp, atol=1e-4, rtol=1e-6)


@pytest.mark.cuda
def test_prefetch_uploads_on_a_side_stream(cuda_device):
    """``DevicePrefetcher`` with ``batch_uploader`` on the card: 40 batches
    of 8 MB, each read on the consumer's stream while that stream is still
    busy with products, arrive in order and equal their host batches (a
    batch read before its side-stream copy landed would not)."""
    from mmbidaf_tpu_torch.data.prefetch import DevicePrefetcher, batch_uploader

    rng = np.random.default_rng(0)
    host = [{"x": rng.standard_normal((2048, 1024)).astype(np.float32),
             "i": np.full((4,), i, np.int32)} for i in range(40)]
    busy = torch.randn(2048, 2048, device=cuda_device)
    with DevicePrefetcher(iter(host), batch_uploader(cuda_device), depth=3) as pf:
        for i, (nb, dev) in enumerate(pf):
            for _ in range(4):
                busy = torch.tanh(busy @ busy)
            assert dev["x"].is_cuda and int(nb["i"][0]) == i
            assert torch.equal(dev["x"], torch.from_numpy(nb["x"]).to(cuda_device))
            assert torch.equal(dev["i"].cpu(), torch.from_numpy(nb["i"]))
    assert i == 39


@pytest.mark.cuda
def test_raw_train_step_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """One drop-0 step on a raw corpus batch (tiny widths, n_fft 64): the
    frontend inside the step with K3 on its FFT route and K5-K8 on the card,
    against the plain versions on the CPU from the same JAX weights; K3's
    launch and route counters rise inside the step."""
    import dataclasses
    import importlib.util
    from pathlib import Path

    from mmbidaf_tpu.config import tiny_test_config as j_tiny
    from mmbidaf_tpu.data.frontend import frontend_init as j_frontend_init
    from mmbidaf_tpu.models.mmbidaf import mmbidaf_init as j_init
    from mmbidaf_tpu.ops.vgg import TINY_SPEC as J_TINY
    from mmbidaf_tpu_torch.config import tiny_test_config
    from mmbidaf_tpu_torch.data.pipeline import VideoCorpus, collate
    from mmbidaf_tpu_torch.data.vocab import vocab_from_corpus_dir
    from mmbidaf_tpu_torch.interop.from_jax import frontend_from_jax, train_state_from_jax
    from mmbidaf_tpu_torch.ops.cuda import melspec_kernel
    from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC
    from mmbidaf_tpu_torch.train.loop import make_train_step

    repo = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_corpus", repo / "examples" / "make_synthetic_corpus.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.make_corpus(str(tmp_path), videos=4, sentences=8, frames=5, seconds=0.3, seed=3)
    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, audio_feat_dim=cfg.data.n_mfcc, use_pallas_lstm=True,
        use_pallas_attention=True, use_pallas_melspec=True))
    j_cfg = j_tiny()
    j_cfg = dataclasses.replace(j_cfg, model=dataclasses.replace(
        j_cfg.model, audio_feat_dim=cfg.data.n_mfcc))
    w2i = vocab_from_corpus_dir(str(tmp_path))
    vc = VideoCorpus(str(tmp_path), cfg, w2i, require_summary=True)
    nb = collate([vc[i] for i in range(4)])
    wv = np.random.default_rng(0).standard_normal(
        (cfg.data.vocab_size, cfg.model.emb_dim)).astype(np.float32)
    params = jax.tree.map(np.asarray, j_init(jax.random.key(0), j_cfg, jnp.asarray(wv)))
    fe = jax.tree.map(np.asarray, j_frontend_init(jax.random.key(1), j_cfg, vgg_spec=J_TINY))
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        state = train_state_from_jax(params, params, cfg, device=dev)
        step = make_train_step(cfg, frontend_from_jax(fe, cfg, TINY_SPEC, device=dev), TINY_SPEC)
        melspec_kernel.mfcc_fused.launches = 0
        melspec_kernel.mfcc_fused.routes = {"fft": 0, "dense": 0}
        state, m = step(state, {k: torch.from_numpy(v).to(dev) for k, v in nb.items()})
        out[dev.type] = (float(m["loss"]), float(m["grad_norm"]),
                         {k: v.cpu() for k, v in state.params.state_dict().items()})
        if dev.type == "cuda":
            assert melspec_kernel.mfcc_fused.launches == 1
            assert melspec_kernel.mfcc_fused.routes == {"fft": 1, "dense": 0}
    (lc, gc, pc), (lp, gp, pp) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(lc, lp, rtol=1e-5)
    np.testing.assert_allclose(gc, gp, rtol=1e-4)
    for k, v in pp.items():
        torch.testing.assert_close(pc[k], v, atol=1e-5, rtol=0.0, msg=k)


def _serving_videos(root, cfg, n=3):
    """Short ragged videos at 12x16 whose sentences use the init_random
    vocabulary ("w<i>"), so their embeddings are distinct."""
    import wave as wave_mod

    from PIL import Image

    rng = np.random.default_rng(17)
    d = cfg.data
    dirs = []
    for v in range(n):
        vd = root / f"vid{v}"
        (vd / "frames").mkdir(parents=True)
        for i in range(2 + v):
            Image.fromarray((rng.random((12, 16, 3)) * 255).astype(np.uint8)).save(vd / "frames" / f"f{i}.png")
        n_samples = int((d.max_audio_frames * d.hop_length + d.win_length) * (0.3 + 0.3 * v))
        with wave_mod.open(str(vd / "audio.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(d.sample_rate)
            w.writeframes((rng.standard_normal(n_samples) * 8000).astype(np.int16).tobytes())
        (vd / "transcript.txt").write_text(
            " ".join(f"W{(7 * v + 2 * j) % 30} w{(7 * v + 2 * j + 1) % 30}." for j in range(3 + v)))
        dirs.append(str(vd))
    return dirs


def _serving_pair(cuda_device, **kw):
    """A tiny f32 Summarizer on the CPU (plain versions) and the same
    weights on the card (the kernels)."""
    import copy
    import dataclasses

    from mmbidaf_tpu_torch.config import tiny_test_config
    from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC
    from mmbidaf_tpu_torch.serving import Summarizer

    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, img_feat_dim=32, audio_feat_dim=cfg.data.n_mfcc, use_pallas_lstm=True,
        use_pallas_attention=True, use_pallas_melspec=True))
    cpu = Summarizer.init_random(cfg, seed=5, vgg_spec=TINY_SPEC, device="cpu", **kw)
    card = Summarizer(copy.deepcopy(cpu.model).to(cuda_device),
                      copy.deepcopy(cpu.frontend).to(cuda_device), cpu.word2idx, cfg, TINY_SPEC, **kw)
    return cfg, cpu, card


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_bucketed_serving_on_the_card_matches_the_cpu(cuda_device, tmp_path, mode):
    """Bucket-ladder serving through K1-K3 at rung shapes equals the plain
    versions on the CPU; the card batch records the same rung tuples."""
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel, lstm_kernel, melspec_kernel

    kw = {"serve_buckets": True, "mode": mode, "topk": 3}
    cfg, cpu, card = _serving_pair(cuda_device, **kw)
    dirs = _serving_videos(tmp_path, cfg)
    counters = (lstm_kernel.bilstm_cuda, bidaf_kernel.bidaf_attention_fused, melspec_kernel.mfcc_fused)
    before = [fn.launches for fn in counters]
    assert card.summarize_batch(dirs) == cpu.summarize_batch(dirs)
    assert card.summarize_batch(dirs[:1]) == cpu.summarize_batch(dirs[:1])
    assert all(fn.launches > n for fn, n in zip(counters, before))
    assert card.bucket_stats == cpu.bucket_stats
    card.warmup(frame_hw=(12, 16), batch_size=2, include_long=True)
    assert card.summarize(dirs[2]) == cpu.summarize(dirs[2])


@pytest.mark.cuda
def test_host_fetch_and_pipelined_batcher_on_the_card(cuda_device, tmp_path):
    """``HostFetch`` copies into pinned memory behind an event; the batcher
    at pipeline depth 1 (its completion thread fetching) and 0 answer as
    ``summarize`` does."""
    from concurrent.futures import ThreadPoolExecutor

    from mmbidaf_tpu_torch.serving import DynamicBatcher, HostFetch

    t = torch.arange(24, device=cuda_device, dtype=torch.int32).reshape(4, 6)
    fetch = HostFetch(t)
    assert fetch.host.is_pinned() and fetch.event is not None
    np.testing.assert_array_equal(fetch.numpy(), t.cpu().numpy())
    cfg, _, card = _serving_pair(cuda_device)
    dirs = _serving_videos(tmp_path, cfg)
    want = [card.summarize(vd) for vd in dirs]
    for depth in (1, 0):
        with DynamicBatcher(card, max_batch_size=2, max_wait_ms=50.0, pipeline_depth=depth) as b:
            with ThreadPoolExecutor(max_workers=3) as ex:
                assert list(ex.map(b.submit, dirs)) == want


def _oracle_tiny(cuda_device):
    """The torch oracle at tiny widths (seeded) and the port's f32 config
    with the kernel flags on; raw audio needs ``audio_feat_dim = n_mfcc``."""
    import dataclasses
    import importlib.util
    from pathlib import Path

    from mmbidaf_tpu_torch.config import tiny_test_config

    # by path: a host may have another top-level ``tests`` package installed
    spec = importlib.util.spec_from_file_location(
        "torch_model", Path(__file__).resolve().parent / "oracles" / "torch_model.py")
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, img_feat_dim=32, audio_feat_dim=cfg.data.n_mfcc, use_pallas_lstm=True,
        use_pallas_attention=True, use_pallas_melspec=True))
    m = cfg.model
    rng = np.random.default_rng(11)
    wv = rng.standard_normal((cfg.data.vocab_size, m.emb_dim)).astype(np.float32)
    torch.manual_seed(11)
    tm = oracle.MMBiDAF(torch.from_numpy(wv), m.hidden_size, img_feat_dim=m.img_feat_dim,
                        audio_feat_dim=m.audio_feat_dim, num_decode_steps=m.max_decode_steps,
                        mask_selected=m.mask_selected).eval()
    return cfg, tm


@pytest.mark.cuda
def test_from_torch_state_dict_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """The reference's state dict served on the card (K1-K3) and on the CPU
    (plain versions): the same summaries, and the card's launches rise."""
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel, lstm_kernel, melspec_kernel
    from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC
    from mmbidaf_tpu_torch.serving import Summarizer

    cfg, tm = _oracle_tiny(cuda_device)
    w2i = {f"w{i}": i for i in range(cfg.data.vocab_size)}
    dirs = _serving_videos(tmp_path, cfg)
    counters = (lstm_kernel.bilstm_cuda, bidaf_kernel.bidaf_attention_fused,
                melspec_kernel.mfcc_fused)
    got = {}
    for dev in ("cpu", cuda_device):
        s = Summarizer.from_torch_state_dict(tm.state_dict(), w2i, cfg, TINY_SPEC, seed=3,
                                             device=dev)
        before = [fn.launches for fn in counters]
        got[str(dev)] = s.summarize_batch(dirs)
        launched = [fn.launches - n for fn, n in zip(counters, before)]
        assert all(launched) if dev != "cpu" else not any(launched)
    assert got["cpu"] == got[str(cuda_device)]


@pytest.mark.cuda
def test_precompute_features_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """``precompute_features`` with one frontend on the card (K3) and on the
    CPU, over copies of a corpus: equal files, masks equal, features within
    ``test_bench_width_parity_with_jax``'s bounds (VGG 1e-4, MFCC 5e-4)."""
    import copy
    import importlib.util
    import shutil
    from pathlib import Path

    from mmbidaf_tpu_torch.data.frontend import frontend_init
    from mmbidaf_tpu_torch.ops.cuda import melspec_kernel
    from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC
    from mmbidaf_tpu_torch.tools.precompute_features import precompute

    cfg, _ = _oracle_tiny(cuda_device)
    repo = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_corpus", repo / "examples" / "make_synthetic_corpus.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.make_corpus(str(tmp_path / "cpu"), videos=5, sentences=6, ragged=True, frames=4,
                    seconds=0.3, seed=3, split=2)
    shutil.copytree(tmp_path / "cpu", tmp_path / "card")
    fe = frontend_init(cfg, TINY_SPEC, "cpu", seed=9)
    assert precompute(str(tmp_path / "cpu"), cfg, fe, TINY_SPEC, batch=2, log=lambda s: None) == 5
    before = melspec_kernel.mfcc_fused.launches
    assert precompute(str(tmp_path / "card"), cfg, copy.deepcopy(fe).to(cuda_device), TINY_SPEC,
                      batch=2, log=lambda s: None) == 5
    assert melspec_kernel.mfcc_fused.launches == before + 3
    for f in sorted((tmp_path / "cpu").rglob("features.npz")):
        a = np.load(f)
        b = np.load(tmp_path / "card" / f.relative_to(tmp_path / "cpu"))
        for k in ("img_mask", "aud_mask"):
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_allclose(b["images"], a["images"], atol=1e-4)
        np.testing.assert_allclose(b["audio"], a["audio"], atol=5e-4, rtol=1e-5)


def _port_bench_f32_config():
    """The bench widths in f32 with the three kernel flags on, in the port's
    own Config (the artifact's ``config.json`` loads through it)."""
    from mmbidaf_tpu_torch.config import Config as PConfig
    from mmbidaf_tpu_torch.config import DataConfig as PDataConfig
    from mmbidaf_tpu_torch.config import ModelConfig as PModelConfig

    data = PDataConfig(max_sentences=32, max_words=16, max_keyframes=16, max_audio_frames=512,
                       vocab_size=20000, image_size=224)
    model = PModelConfig(hidden_size=128, img_feat_dim=4096, audio_feat_dim=40, drop_prob=0.0,
                         max_decode_steps=4, use_pallas_attention=True, use_pallas_lstm=True,
                         use_pallas_melspec=True)
    return PConfig(model=model, data=data)


@pytest.mark.cuda
def test_f32_artifact_on_the_card_equals_the_live_path(cuda_device, tmp_path):
    """An f32 artifact at the bench widths (VGG-16 at 224², B=2), exported
    and loaded on the card and run with cuDNN's TF32 flag at its default
    (on): its picks equal the live f32 path's and its log-probs are within
    1e-5. The graph records the convolutions but not the full-f32 pin the
    live path sets around them; the loader sets it around each call."""
    from mmbidaf_tpu_torch.export import ExportedDecoder, _raw_specs, export_summarizer
    from mmbidaf_tpu_torch.serving import Summarizer

    cfg = _port_bench_f32_config()
    summ = Summarizer.init_random(cfg, seed=0, device=cuda_device)
    rng = np.random.default_rng(0)
    raw = {}
    for k, s in _raw_specs(cfg, 2, (240, 320)).items():
        if k == "text_ids":
            raw[k] = rng.integers(1, cfg.data.vocab_size, s.shape).astype(np.int32)
        elif k == "frames":
            raw[k] = (rng.random(s.shape) * 255).astype(np.uint8)
        elif k == "waveform":
            raw[k] = (rng.standard_normal(s.shape) * 0.1).astype(np.float32)
        else:
            m = np.ones(s.shape, np.float32)
            m[1, ..., s.shape[-1] // 2:] = 0.0
            raw[k] = m
    cudnn = torch.backends.cudnn
    prior = cudnn.allow_tf32
    try:
        cudnn.allow_tf32 = True
        export_summarizer(summ, str(tmp_path), batch_size=2, frame_hw=(240, 320))
        lp, picks = ExportedDecoder(str(tmp_path), device=cuda_device).decode_raw(raw)
        live_lp, live_picks = summ._decode_batch_device(summ._to_device(raw))
        assert cudnn.allow_tf32 and cudnn.conv.fp32_precision != "ieee"
    finally:
        cudnn.allow_tf32 = prior
    np.testing.assert_array_equal(picks, live_picks.cpu().numpy())
    np.testing.assert_allclose(lp, live_lp.cpu().numpy(), atol=1e-5, rtol=0.0)


@pytest.mark.cuda
def test_artifact_counts_launches_on_the_card_not_while_tracing(cuda_device, tmp_path):
    """Exporting on the card traces with fake tensors and launches nothing;
    each call of the loaded program launches K1 five times (one a BiLSTM
    layer), K2 twice, K3 once and the conv epilogue twice (one a conv of
    the tiny VGG), on their routes, and its picks equal the live path's."""
    import dataclasses

    from mmbidaf_tpu_torch.config import tiny_test_config
    from mmbidaf_tpu_torch.export import ExportedDecoder, _raw_specs, export_summarizer
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel, lstm_kernel, melspec_kernel
    from mmbidaf_tpu_torch.ops.cuda.conv_epilogue_kernel import conv_epilogue
    from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC
    from mmbidaf_tpu_torch.serving import Summarizer

    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, img_feat_dim=32, audio_feat_dim=cfg.data.n_mfcc, use_pallas_lstm=True,
        use_pallas_attention=True, use_pallas_melspec=True))
    summ = Summarizer.init_random(cfg, seed=3, vgg_spec=TINY_SPEC, device=cuda_device)
    fns = (lstm_kernel.bilstm_cuda, bidaf_kernel.bidaf_attention_fused, melspec_kernel.mfcc_fused,
           conv_epilogue)
    before = [fn.launches for fn in fns]
    export_summarizer(summ, str(tmp_path), batch_size=2, frame_hw=(12, 16))
    assert [fn.launches for fn in fns] == before
    dec = ExportedDecoder(str(tmp_path), device=cuda_device)
    raw = {k: (np.ones if k.endswith("_mask") else np.zeros)(s.shape, s.dtype)
           for k, s in _raw_specs(cfg, 2, (12, 16)).items()}
    raw["waveform"] = np.random.default_rng(0).standard_normal(raw["waveform"].shape).astype(np.float32)
    _, picks = dec.decode_raw(raw)
    assert [fn.launches - n for fn, n in zip(fns, before)] == [5, 2, 1, 2]
    _, live = summ._decode_batch_device(summ._to_device(raw))
    np.testing.assert_array_equal(picks, live.cpu().numpy())


# K7/K8's gate: every shape of the grid has a route; the listed shapes
# run against the plain versions on the route they name.
DROP_GATE_RUN = [(64, 64, 256), (64, 512, 256), (64, 64, 200), (32, 32, 256), (40, 16, 256),
                 (128, 512, 256), (32, 1089, 256), (32, 4096, 256)]


@pytest.mark.cuda
def test_bidaf_drop_routes_match_the_card(cuda_device):
    """Over the gate's grid (T_c x T_q x D), each shape's plans on its route
    equal the C plans, and the card holds its clusters."""
    import ctypes

    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel as bk
    from mmbidaf_tpu_torch.ops.cuda import build

    lib = build.library()
    for D in (200, 256):
        for T_c in (1, 8, 32, 33, 40, 48, 64, 65, 128):
            for T_q in (1, 16, 32, 64, 512, 1088, 1089, 2048, 4096):
                if bk.drop_route(T_c, T_q, D) == "cluster":
                    out, plan = (ctypes.c_int * 4)(), bk.drop_plan(T_c, T_q, D)
                    assert lib.mmb_bidaf_drop_plan(T_c, T_q, D, out) == 0
                    assert tuple(out) == (plan.C, plan.tq, plan.smem_fwd, plan.smem_bwd)
                    assert lib.mmb_bidaf_backward_occupancy(T_c, T_q, D) > 0
                else:
                    out, plan = (ctypes.c_int * 6)(), bk.tiled_plan(T_c, T_q, D, 128, drop=True)
                    assert lib.mmb_bidaf_tiled_drop_plan(T_c, T_q, D, out) == 0
                    assert tuple(out) == (plan.C, plan.span, plan.tq, int(plan.resident),
                                          plan.smem, plan.work)
                    assert lib.mmb_bidaf_tiled_forward_dropout_occupancy(T_c, T_q, D) > 0
                    bk._tiled_bwd_work(T_c, T_q, D)  # raises where K8's C plan is not the mirror


@pytest.mark.cuda
@pytest.mark.parametrize("drop", [0.0, 0.2])
@pytest.mark.parametrize("T_c,T_q,D", DROP_GATE_RUN)
def test_bidaf_dropout_gate_shapes(cuda_device, T_c, T_q, D, drop):
    """K7 and K8 at the gate's shapes on the route ``drop_route`` names,
    with an empty c row and an empty q row: K7 within ``TOLERANCE`` of its
    plain version, K8 normwise within ``BACKWARD_TOLERANCE`` of its plain
    version run in f64 (dbias cancels to ~0, and at long T_q the f32 plain
    version's own sums over T_q are off by the size of the bound); each
    twice bit for bit."""
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel as bk

    B = 4
    gen = torch.Generator(device=cuda_device).manual_seed(T_c + T_q + D)
    rand = lambda *s: torch.randn(*s, device=cuda_device, generator=gen)  # noqa: E731
    c, q = rand(B, T_c, D), rand(B, T_q, D)
    keep = lambda x: (torch.rand(x.shape, device=cuda_device, generator=gen) > drop).float() / (1 - drop)  # noqa: E731
    cd, qd = (c * keep(c), q * keep(q)) if drop else (c, q)
    c_mask = (torch.rand(B, T_c, device=cuda_device, generator=gen) > 0.2).float()
    q_mask = (torch.rand(B, T_q, device=cuda_device, generator=gen) > 0.2).float()
    c_mask[1] = 0.0
    q_mask[2] = 0.0
    ops = (c, q, cd, qd, c_mask, q_mask, rand(D) * 0.1, rand(D) * 0.1, rand(D) * 0.1,
           torch.tensor(0.25, device=cuda_device))
    route = bk.drop_route(T_c, T_q, D)
    before = (dict(bk.bidaf_dropout_forward.routes), dict(bk.bidaf_dropout_backward.routes))
    out, stats = bk.bidaf_dropout_forward(*ops, with_stats=True)
    assert (stats is None) == (route == "cluster")
    torch.testing.assert_close(out, bk.bidaf_dropout_reference(*ops), **bk.TOLERANCE)
    g = rand(B, T_c, 4 * D)
    bwd = bk.bidaf_dropout_backward(*ops, g, stats=stats)
    ref = bk.bidaf_dropout_backward_reference(*(x.double() for x in ops), g.double())
    _assert_normwise(bwd, [r.float() for r in ref], bk.BACKWARD_TOLERANCE, "K8")
    assert torch.equal(out, bk.bidaf_dropout_forward(*ops))
    assert all(torch.equal(a, b) for a, b in zip(bwd, bk.bidaf_dropout_backward(*ops, g, stats=stats)))
    assert bk.bidaf_dropout_forward.routes[route] == before[0][route] + 2
    assert bk.bidaf_dropout_backward.routes[route] == before[1][route] + 2
