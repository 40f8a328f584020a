"""Full MMBiDAF model, the port of ``mmbidaf_tpu.models.mmbidaf`` (inference).

    text_ids ─ GloVe+highway ─ word BiLSTM ─ final-state pool ─ sentence BiLSTM → text_enc
    images   ─ img BiLSTM → img_enc        audio ─ aud BiLSTM → aud_enc
    G_ti = BiDAF(text_enc, img_enc),  G_ta = BiDAF(text_enc, aud_enc)  (text-only: self-attention)
    concat → linear → relu → modeling BiLSTM → M → pointer decoder

Kernel dispatch follows the JAX flags: ``use_pallas_lstm`` runs every BiLSTM
layer through the hand kernel (``ops/cuda/lstm_kernel.py``),
``use_pallas_attention`` the BiDAF blocks (``ops/cuda/bidaf_kernel.py``);
with a flag off the plain port of the JAX non-kernel path runs.

Under ``compute_dtype="bfloat16"`` the towers' parameters and the batch's
float features are cast to bf16 (``_cast_compute``). The kernels return
f32, and where an f32 result meets a bf16 weight the product is taken in
f32 (``ops.common.mm``), the dtype JAX promotes to. ``M`` is returned in
f32 and the decoder uses the uncast f32 parameters, as in the JAX package.
"""

from __future__ import annotations

import copy
import math
from typing import Mapping

import numpy as np
import torch
from torch import nn

from mmbidaf_tpu_torch import resolve_device
from mmbidaf_tpu_torch.config import Config
from mmbidaf_tpu_torch.models.decoder import Decoder, decoder_apply
from mmbidaf_tpu_torch.models.embedding import Embedding, embedding_apply
from mmbidaf_tpu_torch.ops.bidaf import BiDAFParams, bidaf_apply
from mmbidaf_tpu_torch.ops.common import mm, uniform_param, zeros_param
from mmbidaf_tpu_torch.ops.lstm import bilstm_apply, stacked_bilstm_apply, stacked_bilstm_init

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig.compute_dtype`` → torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported compute_dtype {name!r}: expected one of {list(_DTYPES)}") from None


class MMBiDAF(nn.Module):
    """Parameter container whose names are the JAX pytree paths
    (``word_lstm.fwd.w_x``, ``att_img.w_cq``, ``decoder.lstm.w_h``, ...)."""

    def __init__(self, cfg: Config, word_vectors: np.ndarray, generator: torch.Generator, device):
        super().__init__()
        m = cfg.model
        h, L = m.hidden_size, m.num_rnn_layers
        g, dev = generator, device
        self.embedding = Embedding(word_vectors, h, m.num_highway_layers, g, dev)
        self.word_lstm = stacked_bilstm_init(h, h, L, g, dev)
        self.sent_lstm = stacked_bilstm_init(2 * h, h, L, g, dev)
        self.decoder = Decoder(2 * h, 2 * h, g, dev)
        num_g = 0
        if m.use_images:
            self.img_lstm = stacked_bilstm_init(m.img_feat_dim, h, L, g, dev)
            self.att_img = BiDAFParams(2 * h, g, dev)
            num_g += 1
        if m.use_audio:
            self.aud_lstm = stacked_bilstm_init(m.audio_feat_dim, h, L, g, dev)
            self.att_aud = BiDAFParams(2 * h, g, dev)
            num_g += 1
        if num_g == 0:  # text-only: sentence self-attention
            self.att_self = BiDAFParams(2 * h, g, dev)
            num_g = 1
        fuse_in = num_g * 8 * h
        self.fuse_w = uniform_param((fuse_in, 2 * h), 1.0 / math.sqrt(fuse_in), g, dev)
        self.fuse_b = zeros_param((2 * h,), dev)
        if m.fusion == "concat_linear_bilstm":
            self.model_lstm = stacked_bilstm_init(2 * h, h, L, g, dev)


def mmbidaf_init(cfg: Config, word_vectors: np.ndarray, device="cpu", seed: int = 0) -> MMBiDAF:
    """Random model with the JAX ``mmbidaf_init`` shapes, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the numbers
    differ from JAX's; weights carried from JAX go through ``interop.from_jax``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return MMBiDAF(cfg, word_vectors, gen, dev)


def encode_text(params, text_ids, word_mask, sent_mask, bilstm_fn=bilstm_apply) -> torch.Tensor:
    """Hierarchical text tower → sentence encodings ``[B, T_s, 2h]``. The
    word BiLSTM runs over all ``B*T_s`` sentences at once; an empty
    sentence keeps the zero state, so its pooled vector is zero."""
    B, T_s, W = text_ids.shape
    emb = embedding_apply(params.embedding, text_ids)  # [B, T_s, W, h]
    h = emb.shape[-1]
    _, (h_n, _) = bilstm_fn(params.word_lstm, emb.reshape(B * T_s, W, h),
                            word_mask.reshape(B * T_s, W))
    out, _ = bilstm_fn(params.sent_lstm, h_n.reshape(B, T_s, 2 * h), sent_mask)
    return out


def fuse_and_model(params, gs: list, sent_mask, bilstm_fn=bilstm_apply,
                   fusion: str = "concat_linear_bilstm") -> torch.Tensor:
    """Concat the attention outputs → linear+relu → modeling BiLSTM
    (``concat_linear``: no modeling recurrence)."""
    g = torch.cat(gs, dim=-1) if len(gs) > 1 else gs[0]
    fused = torch.relu(mm(g, params.fuse_w) + params.fuse_b)
    if fusion == "concat_linear":
        return fused * sent_mask[:, :, None]
    if fusion != "concat_linear_bilstm":
        raise ValueError(f"unknown fusion {fusion!r}")
    M, _ = bilstm_fn(params.model_lstm, fused, sent_mask)
    return M


def _bidaf(att_params, c, q, c_mask, q_mask, cfg: Config) -> torch.Tensor:
    if cfg.model.use_pallas_attention:
        from mmbidaf_tpu_torch.ops.cuda.bidaf_kernel import bidaf_attention_fused

        return bidaf_attention_fused(att_params, c, q, c_mask, q_mask)
    return bidaf_apply(att_params, c, q, c_mask, q_mask)


def _cast_compute(params: MMBiDAF, batch: Mapping[str, torch.Tensor], dtype: torch.dtype):
    """Float params and batch features in the compute dtype (masks too, as in
    JAX; ids stay integer; the raw waveform stays f32). The cast copy of the
    parameters lives for one call."""
    cast = lambda x: x.to(dtype) if x.dtype == torch.float32 else x
    return (
        copy.deepcopy(params).to(dtype),
        {k: v if k == "waveform" else cast(v) for k, v in batch.items()},
    )


def mmbidaf_fused_reps(params: MMBiDAF, batch: Mapping[str, torch.Tensor], cfg: Config) -> torch.Tensor:
    """Everything up to the fused sentence reps ``M [B, T_s, 2h]`` (f32)."""
    m = cfg.model
    compute_dtype = torch_dtype(m.compute_dtype)
    if compute_dtype != torch.float32:
        params, batch = _cast_compute(params, batch, compute_dtype)
    if m.use_pallas_lstm:
        from mmbidaf_tpu_torch.ops.cuda.lstm_kernel import bilstm_cuda

        def bilstm_fn(p, x, mask):
            return stacked_bilstm_apply(p, x, mask, bilstm_fn=bilstm_cuda)
    else:
        bilstm_fn = bilstm_apply

    text_enc = encode_text(params, batch["text_ids"], batch["word_mask"],
                           batch["sent_mask"], bilstm_fn)
    sent_mask = batch["sent_mask"]
    gs = []
    if m.use_images:
        img_enc, _ = bilstm_fn(params.img_lstm, batch["images"], batch["img_mask"])
        gs.append(_bidaf(params.att_img, text_enc, img_enc, sent_mask, batch["img_mask"], cfg))
    if m.use_audio:
        aud_enc, _ = bilstm_fn(params.aud_lstm, batch["audio"], batch["aud_mask"])
        gs.append(_bidaf(params.att_aud, text_enc, aud_enc, sent_mask, batch["aud_mask"], cfg))
    if not gs:
        gs.append(_bidaf(params.att_self, text_enc, text_enc, sent_mask, sent_mask, cfg))
    return fuse_and_model(params, gs, sent_mask, bilstm_fn, fusion=m.fusion).float()


def mmbidaf_decode(params: MMBiDAF, batch: Mapping[str, torch.Tensor], cfg: Config,
                   mode: str = "greedy") -> tuple[torch.Tensor, torch.Tensor]:
    """Inference → ``(log_probs [B, K, T_s], picks [B, K])``, greedy."""
    if mode in ("topk", "beam"):
        raise NotImplementedError(f"{mode!r} decoding is not ported yet")
    if mode != "greedy":
        raise ValueError(f"unknown decode mode {mode!r}")
    M = mmbidaf_fused_reps(params, batch, cfg)
    return decoder_apply(
        params.decoder, M, batch["sent_mask"], num_steps=cfg.model.max_decode_steps,
        mask_selected=cfg.model.mask_selected,
    )
