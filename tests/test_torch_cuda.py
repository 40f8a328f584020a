"""The port on the card against the JAX package on the host CPU, at the bench
configuration's full widths (VGG-16 at 224², hidden 128, vocab 20000,
T_s=32 x W=16, 16 keyframes, 512 audio frames) with B=2, f32.

Needs an NVIDIA GPU with ``nvcc`` (the CUDA kernels are built on first use);
skipped elsewhere. Run on such a host with
``python -m pytest tests/test_torch_cuda.py -q``.

The JAX side runs its plain (scan) path, which equals its Pallas path in
f32; the port runs its three CUDA kernels. TF32 is off on the card. Bounds:
picks equal; log-probs within 1e-4 (measured 4.8e-7 on an H100); VGG
features within 1e-4 (measured 4.7e-6 on values up to ~2); MFCCs within
5e-4 (measured 3.8e-5 on values up to ~100) — f32 sums in different orders.
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
    (2, 64, 100, 384),  # two register chunks of context rows; D > 256 threads
    (3, 5, 33, 40),     # a partial q tile
])
def test_bidaf_kernel_generic_shapes(cuda_device, B, T_c, T_q, D):
    from mmbidaf_tpu_torch.ops.bidaf import BiDAFParams
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel

    gen = torch.Generator(device=cuda_device).manual_seed(2)
    p = BiDAFParams(D, gen, cuda_device)
    c = torch.randn(B, T_c, D, device=cuda_device, generator=gen)
    q = torch.randn(B, T_q, D, device=cuda_device, generator=gen)
    c_mask = (torch.rand(B, T_c, device=cuda_device, generator=gen) > 0.3).float()
    q_mask = (torch.rand(B, T_q, device=cuda_device, generator=gen) > 0.3).float()
    q_mask[0] = 0.0
    out = bidaf_kernel.bidaf_attention_fused(p, c, q, c_mask, q_mask)
    torch.testing.assert_close(out, bidaf_kernel.bidaf_reference(p, c, q, c_mask, q_mask),
                               **bidaf_kernel.TOLERANCE)


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,win,T", [(1024, 1024, 45), (64, 48, 1)])
def test_mfcc_kernel_generic_shapes(cuda_device, n_fft, win, T):
    """More frequency bins than threads in a block (513), a partial frame
    tile, a one-frame example."""
    from mmbidaf_tpu_torch.ops import audio
    from mmbidaf_tpu_torch.ops.cuda import melspec_kernel

    consts = audio.make_audio_frontend_consts(16000, n_fft, win, 40, 13, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    sig = torch.randn(3, (T - 1) * 160 + win, device=cuda_device, generator=gen) * 0.1
    frames = audio.frame_signal(sig, win, 160, T)
    out = melspec_kernel.mfcc_fused(frames, consts)
    torch.testing.assert_close(out, melspec_kernel.mfcc_reference(frames, consts),
                               **melspec_kernel.TOLERANCE)
