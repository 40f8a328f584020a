"""Operations, bytes and peaks: the yardstick of the rate and roofline
metrics, frozen here.

The FLOP counts are ``mmbidaf_tpu_torch/utils/flops.py``'s, term for term,
over the configuration as a dict: dense work only (convs and GEMMs: the
matmul-form resize, DFT/mel/DCT, LSTM gate GEMMs, BiDAF products, the
fusion and decoder projections), one multiply-add two FLOPs; a train step
three forwards plus the optimizer's, the EMA's and the clip's elementwise
work a parameter. The bounds of K1, K5 and K6 are ``chip_smoke.py``'s:
the recurrent product's operations, each input read and each output
written once, at the f32 peak and HBM's rate; K1's projection GEMM runs
outside the kernel (cuBLAS) and is not in its bound.
"""

from __future__ import annotations

import math

# Published peaks of one card, by a substring of ``torch.cuda.get_device_name()``
# (lower case): NVIDIA H100 SXM5 80GB data sheet, dense. bf16 tensor 1,978.9
# TFLOP/s with sparsity, halved; f32 outside the tensor cores 67 TFLOP/s;
# HBM3 3.35 TB/s.
PEAKS = {"h100 80gb hbm3": {"bf16": 989.4e12, "f32": 67e12, "hbm": 3.35e12}}

VGG16 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M")

# The port's hand kernels by substrings of their CUDA symbols (csrc/*.cu).
# K1 (serving) and K5 (training) share their bodies: the cluster route and
# the L2 route (PR 20's ``bilstm_kernel<R, kTrain>``).
KERNELS = {
    "K1": ("bilstm_cluster_kernel", "bilstm_kernel<"),
    "K2": ("bidaf_fwd_cluster_kernel", "bidaf_tiled_cluster_kernel"),
    "K3": ("logmel_fft_kernel", "logmel_tile_kernel", "mfcc_dct_kernel"),
    "K5": ("bilstm_cluster_kernel", "bilstm_kernel<"),
    "K6": ("lstm_z_kernel", "bilstm_bptt_cluster_kernel", "bilstm_bptt_l2_kernel",
           "lstm_dwh_partial_kernel", "sum_partials_kernel"),
    "K7": ("bidaf_drop_fwd_cluster_kernel", "bidaf_tiled_cluster_kernel"),
    "K8": ("bidaf_drop_bwd_cluster_kernel", "sum_over_batch_kernel", "bidaf_tiled_bwd_"),
}


def peaks(device_name: str) -> dict | None:
    name = device_name.lower()
    for key, p in PEAKS.items():
        if key in name:
            return p
    return None


def is_kernel(name: str, kernel: str) -> bool:
    return any(s in name for s in KERNELS[kernel])


# --------------------------------------------------------------------------
# FLOP counts.
# --------------------------------------------------------------------------

def conv_stack_flops(image_size: int, fc_dim: int, spec=VGG16) -> float:
    flops, c_in, size = 0.0, 3, image_size
    for item in spec:
        if item == "M":
            size //= 2
            continue
        flops += 2.0 * size * size * item * c_in * 9
        c_in = item
    flat = c_in * size * size
    return flops + 2.0 * flat * fc_dim + 2.0 * fc_dim * fc_dim


def resize_flops(frame_hw, image_size: int) -> float:
    H, W = frame_hw
    s = image_size
    return 2.0 * s * H * W * 3 + 2.0 * s * s * W * 3


def audio_frontend_flops(d: dict) -> float:
    n_freq = d["n_fft"] // 2 + 1
    T_a, win = d["max_audio_frames"], d["win_length"]
    return (2.0 * T_a * win * n_freq * 2 + 2.0 * T_a * n_freq * d["n_mels"]
            + 2.0 * T_a * d["n_mels"] * d["n_mfcc"])


def bilstm_flops(rows: float, steps: int, in_dim: int, hidden: int, layers: int = 1) -> float:
    total = 0.0
    for layer in range(layers):
        d_in = in_dim if layer == 0 else 2 * hidden
        total += 2.0 * rows * steps * 2 * (4 * hidden * (d_in + hidden))
    return total


def bidaf_flops(T_c: int, T_q: int, h2: int) -> float:
    return (2.0 * (T_c * h2 + T_q * h2 + T_c * T_q * h2) + 2.0 * T_c * T_q * h2
            + 2.0 * (T_c * T_c * T_q + T_c * T_c * h2))


def model_flops(cfg: dict) -> float:
    """A video's forward and decode, the frontend excluded."""
    m, d = cfg["model"], cfg["data"]
    h, L = m["hidden_size"], m["num_rnn_layers"]
    T_s, W, T_i, T_a = d["max_sentences"], d["max_words"], d["max_keyframes"], d["max_audio_frames"]
    h2 = 2 * h
    n_words = T_s * W
    f = 2.0 * n_words * m["emb_dim"] * h
    f += m["num_highway_layers"] * 2 * (2.0 * n_words * h * h)
    f += bilstm_flops(T_s, W, h, h, L) + bilstm_flops(1, T_s, h2, h, L)
    num_g = 0
    if m["use_images"]:
        f += bilstm_flops(1, T_i, m["img_feat_dim"], h, L) + bidaf_flops(T_s, T_i, h2)
        num_g += 1
    if m["use_audio"]:
        f += bilstm_flops(1, T_a, m["audio_feat_dim"], h, L) + bidaf_flops(T_s, T_a, h2)
        num_g += 1
    if num_g == 0:
        f += bidaf_flops(T_s, T_s, h2)
        num_g = 1
    f += 2.0 * T_s * (num_g * 8 * h) * h2
    if m["fusion"] == "concat_linear_bilstm":
        f += bilstm_flops(1, T_s, h2, h, L)
    f += 2.0 * T_s * h2 * h2
    per_step = 2.0 * 4 * h2 * (h2 + h2) + 2.0 * h2 * h2 + 2.0 * T_s * h2
    return f + m["max_decode_steps"] * per_step


def serve_flops_per_video(cfg: dict, frame_hw) -> float:
    d = cfg["data"]
    per_frame = resize_flops(frame_hw, d["image_size"]) + conv_stack_flops(
        d["image_size"], cfg["model"]["img_feat_dim"])
    return d["max_keyframes"] * per_frame + audio_frontend_flops(d) + model_flops(cfg)


_OPT_FLOPS_PER_PARAM = {"adadelta": 14.0, "adam": 12.0, "sgd": 2.0}


def train_step_flops(cfg: dict, batch: int, n_params: int) -> float:
    t = cfg["train"]
    opt = _OPT_FLOPS_PER_PARAM.get(t["optimizer"], 0.0) * n_params
    ema = 3.0 * n_params if t["ema_decay"] else 0.0
    clip = 3.0 * n_params if t["max_grad_norm"] else 0.0
    return 3.0 * batch * model_flops(cfg) + opt + ema + clip


# --------------------------------------------------------------------------
# Kernel bounds.
# --------------------------------------------------------------------------

def lstm_towers(cfg: dict, batch: int) -> list[tuple[int, int]]:
    """``(rows, steps)`` of the five BiLSTM towers of a batch."""
    d, m = cfg["data"], cfg["model"]
    towers = [(batch * d["max_sentences"], d["max_words"]), (batch, d["max_sentences"])]
    if m["use_images"]:
        towers.append((batch, d["max_keyframes"]))
    if m["use_audio"]:
        towers.append((batch, d["max_audio_frames"]))
    return towers + [(batch, d["max_sentences"])]


def _bound_s(flops: float, nbytes: float, p: dict) -> float:
    return max(flops / p["f32"], nbytes / p["hbm"])


def k1_bound_s(cfg: dict, batch: int, p: dict) -> float:
    """K1's least time a serving batch: the recurrence of both directions;
    gates, mask and W_h read, outputs and the last h / c written (f32)."""
    hid = cfg["model"]["hidden_size"]
    G = 4 * hid
    total = 0.0
    for rows, steps in lstm_towers(cfg, batch):
        n = rows * steps
        total += _bound_s(2 * 2 * n * hid * G,
                          4 * (n * (2 * G + 1 + 2 * hid) + 2 * hid * G + 4 * rows * hid), p)
    return total


def k5_k6_bound_s(cfg: dict, batch: int, p: dict) -> float:
    """K5's and K6's least time a train step: K5 as K1 plus the residual
    writes; K6 three recurrent products (z, dz·W_hᵀ, dW_h) over the saved
    gates, residuals and output cotangents."""
    hid = cfg["model"]["hidden_size"]
    G = 4 * hid
    total = 0.0
    for rows, steps in lstm_towers(cfg, batch):
        n = rows * steps
        rec = 2 * 2 * n * hid * G
        total += _bound_s(rec, 4 * (n * (2 * G + 1 + 6 * hid) + 2 * hid * G + 4 * rows * hid), p)
        total += _bound_s(3 * rec, 4 * (n * (4 * G + 1 + 6 * hid) + 4 * hid * G + 4 * rows * hid), p)
    return total


def n_params(cfg: dict) -> int:
    """Parameters of the model (the GloVe table included), from the layout."""
    from reference.mmbidaf_ref import model_layout

    return sum(math.prod(s) for _, s, _, _ in model_layout(cfg))
