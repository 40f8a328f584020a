"""Plain float32 PyTorch reference of the MMBiDAF programs the benchmark times.

It is written from the model's definition (the CS224N BiDAF lineage the
model comes from: GloVe + projection + highway, BiLSTM encoders with
packed-sequence semantics, trilinear BiDAF attention with product-form
Q2C, a sentence-pointer LSTM decoder) and from the parameter layout the
benchmark hands to both sides (``model_layout``, ``vgg_layout``). It
imports nothing of the program under test and reuses none of its
constants: the resize weights, the mel filterbank and the DCT are worked
out here from their definitions, in float64.

Every product goes through a ``Prec``: ``Prec("f32")`` is the serving
reference; ``"tf32"`` and ``"fp8"`` round the operands of each product the
way those formats would (round to nearest with 10 mantissa bits; e4m3 with
one scale a tensor), which is how the benchmark's controls compute "the
reference in the next lower precision". Rounding passes gradients straight
through. ``Prec("f64")`` computes in float64: the training reference takes
its loss and gradient so, from the float32 weights, and keeps the weights,
the optimizer's state and the EMA in float32 as the configuration stores
them. (At initialisation the gradient is a sum that nearly cancels, so a
float32 gradient is off by up to ~1e-5 of the median leaf's norm on some
seeds, a plain float32 reference as much as the program.)

The serving path is the frontend (resize, VGG-16, MFCC), the embedding,
the five BiLSTM towers, the two BiDAF blocks, the fusion and the greedy
decoder; the training path is one step of teacher-forced NLL, its
gradient, the global-norm clip, Adadelta and the EMA shadow. On the card,
callers run it inside ``ieee_f32()`` so that no float32 product uses TF32.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

NEG = -1e30
VGG16 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M")
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
ADADELTA_RHO, ADADELTA_EPS = 0.9, 1e-6


# --------------------------------------------------------------------------
# Precision of products.
# --------------------------------------------------------------------------

def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    v = x.contiguous().view(torch.int32)
    return ((v + 0x0FFF + ((v >> 13) & 1)) & ~0x1FFF).view(torch.float32)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Prec:
    """Products with their operands rounded to ``kind`` ("f32", "f64":
    untouched); ``dtype`` is what the training reference computes in."""

    def __init__(self, kind: str = "f32"):
        self.kind = kind
        self._round = {"f32": None, "f64": None, "tf32": _round_tf32, "fp8": _round_fp8}[kind]
        self.dtype = torch.float64 if kind == "f64" else torch.float32

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self._round is None:
            return x
        return x + (self._round(x.detach().float()) - x).detach()

    def mm(self, a, b):
        return self.q(a) @ self.q(b)

    def einsum(self, eq, *xs):
        return torch.einsum(eq, *(self.q(x) for x in xs))

    def conv3x3(self, x, w, b):
        return F.conv2d(self.q(x), self.q(w), b, padding=1)


F32 = Prec("f32")
F64 = Prec("f64")


@contextlib.contextmanager
def ieee_f32():
    """float32 matmuls and cuDNN convolutions in full float32 (no TF32)."""
    mm, conv = torch.backends.cuda.matmul, torch.backends.cudnn.conv
    before = mm.fp32_precision, conv.fp32_precision
    mm.fp32_precision, conv.fp32_precision = "ieee", "ieee"
    try:
        yield
    finally:
        mm.fp32_precision, conv.fp32_precision = before


# --------------------------------------------------------------------------
# Parameter layout (shared with the benchmark's weight maker).
# --------------------------------------------------------------------------

def _check_supported(cfg: dict) -> None:
    m = cfg["model"]
    if m["num_rnn_layers"] != 1 or m["fusion"] != "concat_linear_bilstm":
        raise ValueError("the reference covers one-layer towers and concat_linear_bilstm fusion")
    if cfg["data"]["audio_features"] != "mfcc" or m.get("vgg_variant", "vgg16") != "vgg16":
        raise ValueError("the reference covers MFCC audio features and VGG-16")


def model_layout(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """``(name, shape, init, scale)`` of every model parameter: ``init`` is
    ``uniform`` (on ±scale), ``normal`` (std scale) or ``glove`` (normal,
    rows 0 and 1 zero). Names are the program's parameter paths."""
    _check_supported(cfg)
    m, d = cfg["model"], cfg["data"]
    h, e = m["hidden_size"], m["emb_dim"]
    out = [("embedding.table", (d["vocab_size"], e), "glove", 0.4),
           ("embedding.proj_w", (e, h), "uniform", 1 / math.sqrt(e))]
    for i in range(m["num_highway_layers"]):
        for part in ("gate", "transform"):
            out += [(f"embedding.highway.layers.{i}.{part}_w", (h, h), "uniform", 1 / math.sqrt(h)),
                    (f"embedding.highway.layers.{i}.{part}_b", (h,), "uniform", 1 / math.sqrt(h))]

    def lstm(prefix, d_in, hid):
        s = 1 / math.sqrt(hid)
        return [(f"{prefix}.w_x", (d_in, 4 * hid), "uniform", s),
                (f"{prefix}.w_h", (hid, 4 * hid), "uniform", s),
                (f"{prefix}.b", (4 * hid,), "uniform", s)]

    def bilstm(prefix, d_in):
        return lstm(f"{prefix}.fwd", d_in, h) + lstm(f"{prefix}.bwd", d_in, h)

    def bidaf(prefix):
        s = math.sqrt(6.0 / (2 * h + 1))
        return [(f"{prefix}.{k}", (2 * h,), "uniform", s) for k in ("w_c", "w_q", "w_cq")] + [
            (f"{prefix}.bias", (), "uniform", 0.1)]

    s2 = 1 / math.sqrt(2 * h)
    out += bilstm("word_lstm", h) + bilstm("sent_lstm", 2 * h)
    out += lstm("decoder.lstm", 2 * h, 2 * h)
    out += [("decoder.w_m", (2 * h, 2 * h), "uniform", s2), ("decoder.w_d", (2 * h, 2 * h), "uniform", s2),
            ("decoder.v", (2 * h,), "uniform", s2), ("decoder.start", (2 * h,), "uniform", s2)]
    num_g = 0
    if m["use_images"]:
        out += bilstm("img_lstm", m["img_feat_dim"]) + bidaf("att_img")
        num_g += 1
    if m["use_audio"]:
        out += bilstm("aud_lstm", m["audio_feat_dim"]) + bidaf("att_aud")
        num_g += 1
    if num_g == 0:
        out += bidaf("att_self")
        num_g = 1
    fuse_in = num_g * 8 * h
    out += [("fuse_w", (fuse_in, 2 * h), "uniform", 1 / math.sqrt(fuse_in)),
            ("fuse_b", (2 * h,), "uniform", 1 / math.sqrt(fuse_in))]
    out += bilstm("model_lstm", 2 * h)
    return out


def vgg_layout(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """The VGG-16 frontend's parameters (OIHW convs, fc weights ``[in, out]``,
    fc1 reading the NCHW flatten)."""
    _check_supported(cfg)
    size, c_in, out, i = cfg["data"]["image_size"], 3, [], 0
    for item in VGG16:
        if item == "M":
            size //= 2
            continue
        out += [(f"convs.{i}.w", (item, c_in, 3, 3), "normal", math.sqrt(2.0 / (9 * c_in))),
                (f"convs.{i}.b", (item,), "uniform", 1 / math.sqrt(9 * c_in))]
        c_in, i = item, i + 1
    flat, fc = size * size * c_in, cfg["model"]["img_feat_dim"]
    return out + [("fc1_w", (flat, fc), "uniform", 1 / math.sqrt(flat)),
                  ("fc1_b", (fc,), "uniform", 1 / math.sqrt(flat)),
                  ("fc2_w", (fc, fc), "uniform", 1 / math.sqrt(fc)),
                  ("fc2_b", (fc,), "uniform", 1 / math.sqrt(fc))]


# --------------------------------------------------------------------------
# Frontend.
# --------------------------------------------------------------------------

def resize_weights(dst: int, src: int) -> np.ndarray:
    """``[dst, src]`` weights of an antialiased bilinear (triangle) resize
    with half-pixel centres: the triangle is widened by ``src/dst`` when
    shrinking, and each output's weights sum to one (float64)."""
    scale = dst / src
    width = max(1.0, 1.0 / scale)
    centre = (np.arange(dst) + 0.5) / scale - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(centre[:, None] - np.arange(src)[None, :]) / width)
    return w / w.sum(axis=1, keepdims=True)


def preprocess(frames: torch.Tensor, size: int, P: Prec) -> torch.Tensor:
    """``[N, H, W, 3]`` uint8 → ``[N, 3, S, S]`` resized, scaled to [0, 1]
    and ImageNet-normalised."""
    dev = frames.device
    _, hgt, wid, _ = frames.shape
    rh = torch.tensor(resize_weights(size, hgt), dtype=torch.float32, device=dev)
    rw = torch.tensor(resize_weights(size, wid), dtype=torch.float32, device=dev)
    x = frames.float() / 255.0
    x = P.einsum("nhwc,kw->nhkc", x, rw)
    x = P.einsum("nhkc,sh->nskc", x, rh)
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def vgg16(w: dict, images: torch.Tensor, P: Prec) -> torch.Tensor:
    """``[N, 3, S, S]`` → fc2-ReLU features ``[N, fc]``."""
    x, i = images, 0
    for item in VGG16:
        if item == "M":
            x = F.max_pool2d(x, 2, 2)
        else:
            x = torch.relu(P.conv3x3(x, w[f"convs.{i}.w"], w[f"convs.{i}.b"]))
            i += 1
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(P.mm(x, w["fc1_w"]) + w["fc1_b"])
    return torch.relu(P.mm(x, w["fc2_w"]) + w["fc2_b"])


def _mel_scale(f):
    """Slaney's mel scale: linear to 1 kHz, logarithmic above."""
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _mel_inverse(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), m * 200.0 / 3)


def mel_filters(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float | None) -> np.ndarray:
    """``[n_fft//2+1, n_mels]`` triangles on the Slaney scale, each of unit area."""
    fmax = sr / 2.0 if fmax is None else fmax
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    pts = _mel_inverse(np.linspace(_mel_scale(fmin), _mel_scale(fmax), n_mels + 2))
    fb = np.zeros((freqs.size, n_mels))
    for k in range(n_mels):
        lo, mid, hi = pts[k], pts[k + 1], pts[k + 2]
        tri = np.minimum((freqs - lo) / (mid - lo), (hi - freqs) / (hi - mid))
        fb[:, k] = np.maximum(0.0, tri) * 2.0 / (hi - lo)
    return fb


def dct2_ortho(n_in: int, n_out: int) -> np.ndarray:
    """``[n_in, n_out]`` orthonormal DCT-II."""
    n, k = np.arange(n_in)[:, None], np.arange(n_out)[None, :]
    mat = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in)) * np.sqrt(2.0 / n_in)
    mat[:, 0] /= np.sqrt(2.0)
    return mat


def mfcc(wave: torch.Tensor, d: dict, frames: int) -> torch.Tensor:
    """``[B, N]`` waveform → ``[B, frames, n_mfcc]`` MFCCs: Hann (periodic)
    windows of ``win_length`` at ``hop_length``, zero-padded to ``n_fft``,
    power spectrum, Slaney mel filters, dB against each example's maximum
    (floored 80 dB below it), orthonormal DCT-II. Computed in float64."""
    win, hop, n_fft = d["win_length"], d["hop_length"], d["n_fft"]
    x = wave.double().unfold(1, win, hop)[:, :frames]
    n = torch.arange(win, dtype=torch.float64, device=wave.device)
    x = x * (0.5 - 0.5 * torch.cos(2 * math.pi * n / win))
    power = torch.fft.rfft(x, n=n_fft).abs() ** 2
    fb = torch.tensor(mel_filters(d["sample_rate"], n_fft, d["n_mels"], d["fmin"], d["fmax"]),
                      device=wave.device)
    db = 10.0 * torch.log10(torch.clamp_min(power @ fb, 1e-10))
    db = torch.clamp_min(db - db.amax(dim=(1, 2), keepdim=True), -80.0)
    dct = torch.tensor(dct2_ortho(d["n_mels"], d["n_mfcc"]), device=wave.device)
    return (db @ dct).float()


def frontend(vgg_w: dict, raw: dict, cfg: dict, P: Prec, block: int = 64) -> dict:
    """Raw batch → feature batch: frames through resize and VGG-16 in blocks
    of ``block`` frames (products in ``P``), waveform through the MFCC (in
    float64 whatever ``P``), text and masks as they are."""
    d = cfg["data"]
    out = {k: raw[k] for k in ("text_ids", "word_mask", "sent_mask", "img_mask", "aud_mask")}
    frames = raw["frames"]
    B, T_i = frames.shape[:2]
    flat = frames.reshape(B * T_i, *frames.shape[2:])
    feats = torch.cat([vgg16(vgg_w, preprocess(flat[i:i + block], d["image_size"], P), P)
                       for i in range(0, flat.shape[0], block)])
    out["images"] = feats.reshape(B, T_i, -1) * raw["img_mask"][:, :, None]
    out["audio"] = mfcc(raw["waveform"], d, raw["aud_mask"].shape[1]) * raw["aud_mask"][:, :, None]
    return out


# --------------------------------------------------------------------------
# Model.
# --------------------------------------------------------------------------

def _lstm_dir(w: dict, prefix: str, x, mask, P: Prec, reverse: bool):
    """One direction with packed-sequence semantics: a masked step keeps the
    carried state and emits zeros. Gate order i, f, g, o."""
    B, T, _ = x.shape
    gates = P.mm(x, w[f"{prefix}.w_x"]) + w[f"{prefix}.b"]
    w_h = w[f"{prefix}.w_h"]
    hid = w_h.shape[0]
    h = x.new_zeros(B, hid)
    c = x.new_zeros(B, hid)
    outs = [None] * T
    order = range(T - 1, -1, -1) if reverse else range(T)
    for t in order:
        z = gates[:, t] + P.mm(h, w_h)
        i, f, g, o = z.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = mask[:, t, None]
        h = m * h_new + (1 - m) * h
        c = m * c_new + (1 - m) * c
        outs[t] = h_new * m
    return torch.stack(outs, dim=1), h


def bilstm(w: dict, prefix: str, x, mask, P: Prec):
    """``(out [B, T, 2h], h_last [B, 2h])``, forward direction first."""
    of, hf = _lstm_dir(w, f"{prefix}.fwd", x, mask, P, False)
    ob, hb = _lstm_dir(w, f"{prefix}.bwd", x, mask, P, True)
    return torch.cat([of, ob], -1), torch.cat([hf, hb], -1)


def _masked(logits, mask):
    return mask * logits + (1 - mask) * NEG


def bidaf(w: dict, prefix: str, c, q, c_mask, q_mask, P: Prec, c_drop=None, q_drop=None):
    """``G = [c; a; c∘a; c∘b]``: trilinear similarity (on the dropped copies
    in training), row softmax over q, column softmax over c, ``a = s1·q``,
    ``b = (s1·s2ᵀ)·c``."""
    cd = c if c_drop is None else c * c_drop
    qd = q if q_drop is None else q * q_drop
    S = (P.mm(cd, w[f"{prefix}.w_c"][:, None]) + P.mm(qd, w[f"{prefix}.w_q"][:, None]).transpose(1, 2)
         + P.einsum("bcd,bqd->bcq", cd * w[f"{prefix}.w_cq"], qd) + w[f"{prefix}.bias"])
    s1 = torch.softmax(_masked(S, q_mask[:, None, :]), dim=2)
    s2 = torch.softmax(_masked(S, c_mask[:, :, None]), dim=1)
    a = P.einsum("bcq,bqd->bcd", s1, q)
    b = P.einsum("bcd,bde->bce", P.einsum("bcq,bkq->bck", s1, s2), c)
    return torch.cat([c, a, c * a, c * b], dim=-1)


def fused_reps(w: dict, batch: dict, cfg: dict, P: Prec, drops: dict | None = None):
    """Everything before the decoder → ``M [B, T_s, 2h]``."""
    m = cfg["model"]
    drops = drops or {}
    ids, word_mask, sent_mask = batch["text_ids"].long(), batch["word_mask"], batch["sent_mask"]
    B, T_s, W = ids.shape
    emb = w["embedding.table"][ids]
    if "emb" in drops:
        emb = emb * drops["emb"]
    x = P.mm(emb, w["embedding.proj_w"])
    for i in range(m["num_highway_layers"]):
        pre = f"embedding.highway.layers.{i}"
        g = torch.sigmoid(P.mm(x, w[f"{pre}.gate_w"]) + w[f"{pre}.gate_b"])
        t = torch.relu(P.mm(x, w[f"{pre}.transform_w"]) + w[f"{pre}.transform_b"])
        x = g * t + (1 - g) * x
    h = x.shape[-1]
    _, h_last = bilstm(w, "word_lstm", x.reshape(B * T_s, W, h), word_mask.reshape(B * T_s, W), P)
    text, _ = bilstm(w, "sent_lstm", h_last.reshape(B, T_s, 2 * h), sent_mask, P)
    gs = []
    for use, feats, mask, lstm, att, key in (
            (m["use_images"], "images", "img_mask", "img_lstm", "att_img", "img"),
            (m["use_audio"], "audio", "aud_mask", "aud_lstm", "att_aud", "aud")):
        if use:
            enc, _ = bilstm(w, lstm, batch[feats], batch[mask], P)
            gs.append(bidaf(w, att, text, enc, sent_mask, batch[mask], P, *drops.get(key, (None, None))))
    if not gs:
        gs.append(bidaf(w, "att_self", text, text, sent_mask, sent_mask, P, *drops.get("self", (None, None))))
    fused = torch.relu(P.mm(torch.cat(gs, dim=-1), w["fuse_w"]) + w["fuse_b"])
    M, _ = bilstm(w, "model_lstm", fused, sent_mask, P)
    return M


def decode(w: dict, M, sent_mask, steps: int, mask_selected: bool, P: Prec, feed=None):
    """Pointer decoder → ``(log_probs [B, K, T_s], picks [B, K])``: greedy
    (first maximum), or fed the given ``feed [B, K]`` (teacher forcing, or
    the served picks when judging them). Picked sentences leave the pool."""
    B, T_s, d = M.shape
    keys = P.mm(M, w["decoder.w_m"])
    h = M.new_zeros(B, d)
    c = M.new_zeros(B, d)
    inp = w["decoder.start"].expand(B, d)
    selected = M.new_zeros(B, T_s)
    rows = torch.arange(B, device=M.device)
    log_ps, picks = [], []
    for k in range(steps):
        z = P.mm(inp, w["decoder.lstm.w_x"]) + w["decoder.lstm.b"] + P.mm(h, w["decoder.lstm.w_h"])
        i, f, g, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        scores = P.mm(torch.tanh(keys + P.mm(h, w["decoder.w_d"])[:, None, :]), w["decoder.v"])
        avail = sent_mask * (1 - selected) if mask_selected else sent_mask
        log_p = torch.log_softmax(_masked(scores, avail), dim=-1)
        pick = log_p.argmax(dim=-1)
        nxt = pick if feed is None else feed[:, k].long()
        inp = M[rows, nxt]
        if mask_selected:
            selected = selected.index_put((rows, nxt), M.new_ones(()))
        log_ps.append(log_p)
        picks.append(pick)
    return torch.stack(log_ps, 1), torch.stack(picks, 1)


def serve(model_w: dict, vgg_w: dict, raw: dict, cfg: dict, feed=None,
          prec: Prec = F32, block: int = 64):
    """The serving program on a raw batch → ``(log_probs, picks)``. ``prec``
    rounds the products where the served configuration computes in its
    lower precision (resize, VGG, towers, attention, fusion); the MFCC and
    the decoder stay in float32 as served."""
    with torch.no_grad():
        feats = frontend(vgg_w, raw, cfg, prec, block)
        M = fused_reps(model_w, feats, cfg, prec)
        return decode(model_w, M, raw["sent_mask"], cfg["model"]["max_decode_steps"],
                      cfg["model"]["mask_selected"], F32, feed)


# --------------------------------------------------------------------------
# Training.
# --------------------------------------------------------------------------

def draw_dropout(batch: dict, cfg: dict, gen: torch.Generator) -> dict:
    """One step's dropout keep-masks, scaled by ``1/keep``, drawn from
    ``gen`` in the order the trained program draws them: the GloVe rows,
    then each BiDAF block's c and q (images, then audio)."""
    m = cfg["model"]
    keep = 1.0 - m["drop_prob"]
    ids = batch["text_ids"]
    B, T_s, W = ids.shape
    D = 2 * m["hidden_size"]

    def draw(shape):
        return (torch.rand(shape, generator=gen, device=ids.device) < keep).float() / keep

    out = {"emb": draw((B, T_s, W, m["emb_dim"]))}
    q_lens = {}
    if m["use_images"]:
        q_lens["img"] = batch["img_mask"].shape[1]
    if m["use_audio"]:
        q_lens["aud"] = batch["aud_mask"].shape[1]
    if not q_lens:
        q_lens["self"] = T_s
    for key, T_q in q_lens.items():
        out[key] = (draw((B, T_s, D)), draw((B, T_q, D)))
    return out


class Trainer:
    """Training from ``weights`` (copied, float32): per step the
    teacher-forced mean NLL and its gradient over every leaf but the GloVe
    table, computed in ``prec.dtype`` (products in ``prec``), then in
    float32 the global-norm clip, Adadelta (ρ 0.9, ε 1e-6) at a constant
    rate and the EMA shadow with optax's warm-up of the decay.
    ``dropout_seed`` seeds a generator on the weights' device, drawn as the
    trained program draws."""

    def __init__(self, weights: dict, cfg: dict, dropout_seed: int, prec: Prec = F64):
        t = cfg["train"]
        if t["optimizer"] != "adadelta" or t["lr_schedule"] != "constant" or t["warmup_steps"] or t["l2_wd"]:
            raise ValueError("the reference trains with Adadelta at a constant rate, no decay")
        self.cfg, self.prec = cfg, prec
        self.lr, self.clip, self.decay = t["lr"], t["max_grad_norm"], t["ema_decay"]
        self.w = {k: v.detach().clone() for k, v in weights.items()}
        self.names = [k for k in self.w if k != "embedding.table"]
        self.ema = {k: self.w[k].clone() for k in self.names}
        self.e_g = {k: torch.zeros_like(self.w[k]) for k in self.names}
        self.e_x = {k: torch.zeros_like(self.w[k]) for k in self.names}
        self.count = 0
        dev = weights["embedding.table"].device
        self.gen = torch.Generator(device=dev).manual_seed(dropout_seed)

    def loss(self, w: dict, batch: dict, drops: dict | None) -> torch.Tensor:
        m = self.cfg["model"]
        M = fused_reps(w, batch, self.cfg, self.prec, drops)
        log_p, _ = decode(w, M, batch["sent_mask"], m["max_decode_steps"], m["mask_selected"],
                          self.prec, feed=batch["targets"])
        gold = log_p.gather(-1, batch["targets"].long()[..., None])[..., 0]
        tm = batch["target_mask"]
        return -(gold * tm).sum() / torch.clamp(tm.sum(), min=1.0)

    def step(self, batch: dict) -> tuple[float, dict]:
        """One update → ``(loss, the clipped gradient by leaf, in float32)``."""
        dt = self.prec.dtype
        drops = draw_dropout(batch, self.cfg, self.gen) if self.cfg["model"]["drop_prob"] > 0 else None
        w = {k: v.detach().to(dt).requires_grad_(k in self.names) for k, v in self.w.items()}
        wide = {k: v.to(dt) if v.is_floating_point() else v for k, v in batch.items()}
        loss = self.loss(w, wide, drops)
        grads = torch.autograd.grad(loss, [w[k] for k in self.names], allow_unused=True)
        grads = [torch.zeros_like(w[k]) if g is None else g for k, g in zip(self.names, grads)]
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads))
            if norm >= self.clip:
                grads = [g / norm * self.clip for g in grads]
            grads = [g.float() for g in grads]
            for k, g in zip(self.names, grads):
                self.e_g[k].mul_(ADADELTA_RHO).add_((1 - ADADELTA_RHO) * g * g)
                u = torch.sqrt(self.e_x[k] + ADADELTA_EPS) / torch.sqrt(self.e_g[k] + ADADELTA_EPS) * g
                self.e_x[k].mul_(ADADELTA_RHO).add_((1 - ADADELTA_RHO) * u * u)
                self.w[k].add_(-self.lr * u)
            self.count += 1
            d = min(np.float32(self.decay), np.float32(1.0 + self.count) / np.float32(10.0 + self.count))
            for k in self.names:
                self.ema[k].mul_(float(d)).add_(self.w[k], alpha=float(np.float32(1.0) - d))
        return float(loss.detach()), dict(zip(self.names, grads))
