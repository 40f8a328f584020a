"""Analytic FLOP counts for the end-to-end pipeline → MFU reporting — the
port's copy of ``mmbidaf_tpu.utils.flops``.

Counts cover the dense work — convs + GEMMs (matmul-form resize,
DFT/mel/DCT, LSTM gate GEMMs, BiDAF similarity/attention products,
fc/fuse/decoder projections); elementwise and softmax FLOPs are excluded,
so the count is a slight UNDER-estimate and the reported MFU a slight
under-claim. One multiply-add = 2 FLOPs. The counts are the JAX package's,
term for term (``tests/test_torch_utils.py`` holds them equal); they count
the JAX package's arithmetic, so a kernel of the port that computes the
same function another way (K3's FFT for the DFT GEMMs) does fewer
operations than counted.

Cross-checked against ``torch.utils.flop_counter.FlopCounterMode`` on the
plain path in ``tests/test_torch_utils.py``.
"""

from __future__ import annotations

from typing import Sequence

from mmbidaf_tpu_torch.config import Config


def conv_stack_flops(spec: Sequence, image_size: int, fc_dim: int = 4096) -> float:
    """Per-image FLOPs of the VGG conv stack + fc1/fc2 (ops/vgg.py layout:
    3x3 same-pad convs, 'M' = 2x2/2 maxpool, features at fc2)."""
    flops = 0.0
    c_in, size = 3, image_size
    for item in spec:
        if item == "M":
            size //= 2
            continue
        c_out = int(item)
        flops += 2.0 * size * size * c_out * c_in * 9  # 3x3 kernel MACs x2
        c_in = c_out
    flat = c_in * size * size
    flops += 2.0 * flat * fc_dim      # fc1
    flops += 2.0 * fc_dim * fc_dim    # fc2
    return flops


def resize_flops(frame_hw: tuple[int, int], image_size: int) -> float:
    """Per-frame FLOPs of the separable matmul-form bilinear resize
    (ops/vgg.py::preprocess_frames): H-axis then W-axis contraction."""
    H, W = frame_hw
    s = image_size
    return 2.0 * s * H * W * 3 + 2.0 * s * s * W * 3


def audio_frontend_flops(cfg: Config) -> float:
    """Per-video FLOPs of the matmul-DFT MFCC chain (ops/audio.py):
    frames @ cos + frames @ sin, mel filterbank, DCT."""
    d = cfg.data
    T_a, win = d.max_audio_frames, d.win_length
    n_freq = d.n_fft // 2 + 1
    return (
        2.0 * T_a * win * n_freq * 2      # cos + sin GEMMs
        + 2.0 * T_a * n_freq * d.n_mels   # mel filterbank
        + 2.0 * T_a * d.n_mels * d.n_mfcc  # DCT
    )


def _bilstm_flops(rows: float, steps: int, in_dim: int, hidden: int,
                  num_layers: int = 1) -> float:
    """Gate-GEMM FLOPs of a (stacked) BiLSTM: per step per direction one
    [in+h] x 4h GEMM per row; layers past the first take 2h inputs."""
    total = 0.0
    for layer in range(num_layers):
        d_in = in_dim if layer == 0 else 2 * hidden
        total += 2.0 * rows * steps * 2 * (4 * hidden * (d_in + hidden))
    return total


def _bidaf_flops(T_c: int, T_q: int, h2: int) -> float:
    """Per-video FLOPs of one BiDAF block (ops/bidaf.py starter form):
    similarity products (c.w_c, q.w_q, (c*w_cq).q^T), a = s1.q,
    b = (s1.s2^T).c."""
    return (
        2.0 * (T_c * h2 + T_q * h2 + T_c * T_q * h2)  # similarity terms
        + 2.0 * T_c * T_q * h2                         # a = s1 @ q
        + 2.0 * (T_c * T_c * T_q + T_c * T_c * h2)     # b = (s1 @ s2^T) @ c
    )


def model_flops(cfg: Config) -> float:
    """Per-video forward/decode FLOPs of the model proper (towers +
    attention + fusion + pointer decoder), excluding the frontend."""
    m, d = cfg.model, cfg.data
    h, L = m.hidden_size, m.num_rnn_layers
    T_s, W, T_i, T_a = (d.max_sentences, d.max_words, d.max_keyframes,
                        d.max_audio_frames)
    h2 = 2 * h
    f = 0.0
    # embedding: projection emb->h + highway (2 GEMMs per layer), per word
    n_words = T_s * W
    f += 2.0 * n_words * m.emb_dim * h
    f += m.num_highway_layers * 2 * (2.0 * n_words * h * h)
    # towers
    f += _bilstm_flops(T_s, W, h, h, L)              # word-level
    f += _bilstm_flops(1, T_s, h2, h, L)             # sentence-level
    num_g = 0
    if m.use_images:
        f += _bilstm_flops(1, T_i, m.img_feat_dim, h, L)
        f += _bidaf_flops(T_s, T_i, h2)
        num_g += 1
    if m.use_audio:
        f += _bilstm_flops(1, T_a, m.audio_feat_dim, h, L)
        f += _bidaf_flops(T_s, T_a, h2)
        num_g += 1
    if num_g == 0:
        f += _bidaf_flops(T_s, T_s, h2)
        num_g = 1
    # fusion linear + modeling BiLSTM
    f += 2.0 * T_s * (num_g * 8 * h) * h2
    if m.fusion == "concat_linear_bilstm":
        f += _bilstm_flops(1, T_s, h2, h, L)
    # pointer decoder: hoisted M-keys GEMM + per-step cell/query/score
    a = h2  # attn_dim == m_dim == 2h (models/decoder.py)
    f += 2.0 * T_s * h2 * a
    per_step = (
        2.0 * 4 * h2 * (h2 + h2)   # LSTM cell gates
        + 2.0 * h2 * a             # h @ w_d
        + 2.0 * T_s * a            # v-dot over tanh(keys + query)
    )
    f += m.max_decode_steps * per_step
    return f


def e2e_decode_flops_per_video(cfg: Config, vgg_spec: Sequence,
                               frame_hw: tuple[int, int] = (240, 320)) -> float:
    """Per-video FLOPs of the full raw→summary pipeline (device frontend:
    resize + VGG + MFCC + embedding; then the model)."""
    d = cfg.data
    per_frame = resize_flops(frame_hw, d.image_size) + conv_stack_flops(
        vgg_spec, d.image_size, cfg.model.img_feat_dim)
    return d.max_keyframes * per_frame + audio_frontend_flops(cfg) + model_flops(cfg)


# Optimizer elementwise FLOPs per parameter per step (rough: EMA updates,
# squares, rsqrt-ish work). Dwarfed by the GEMM terms — included so the
# train-step count's stated scope is "everything dense plus param traffic".
_OPT_FLOPS_PER_PARAM = {"adadelta": 14.0, "adam": 12.0, "sgd": 2.0}


def train_step_flops(cfg: Config, batch_size: int, n_params: int) -> float:
    """Analytic FLOPs of one train step on FEATURE batches (towers +
    attention + fusion + teacher-forced decoder + NLL, then backprop and the
    optimizer update).

    backward ≈ 2× forward (each GEMM spawns a dL/dX and a dL/dW GEMM of
    equal cost), so step ≈ 3× forward GEMM FLOPs, plus per-param optimizer
    + EMA + global-norm-clip elementwise work. Rematerialized towers
    (TrainConfig.remat_towers) re-run tower forwards inside backprop;
    that recompute is NOT counted, keeping the count an under-estimate."""
    fwd = batch_size * model_flops(cfg)
    opt = _OPT_FLOPS_PER_PARAM.get(cfg.train.optimizer, 0.0) * n_params
    ema = (3.0 * n_params) if cfg.train.ema_decay else 0.0
    clip = 3.0 * n_params if cfg.train.max_grad_norm else 0.0
    return 3.0 * fwd + opt + ema + clip


# Published dense bf16 tensor-core peak (TFLOP/s) of one card, keyed by
# substrings of ``torch.cuda.get_device_name()``, lower case. The serving
# program runs bf16 (``build_bench_config``), so this is the denominator of
# its MFU. H100 SXM5 80GB ("NVIDIA H100 80GB HBM3"): NVIDIA's H100 Tensor
# Core GPU datasheet and architecture whitepaper, peak BF16 tensor 1,978.9
# TFLOP/s with sparsity, halved for dense.
_PEAK_BF16_TFLOPS = (
    ("h100 80gb hbm3", 989.4),
)


def peak_bf16_tflops(device_name: str) -> float | None:
    """Per-card dense bf16 peak for a ``torch.cuda.get_device_name()``
    string, or None when unknown (the CPU, another card: no MFU)."""
    name = device_name.lower()
    for key, peak in _PEAK_BF16_TFLOPS:
        if key in name:
            return peak
    return None
