"""Full MMBiDAF model, the port of ``mmbidaf_tpu.models.mmbidaf``.

    text_ids ─ GloVe+highway ─ word BiLSTM ─ final-state pool ─ sentence BiLSTM → text_enc
    images   ─ img BiLSTM → img_enc        audio ─ aud BiLSTM → aud_enc
    G_ti = BiDAF(text_enc, img_enc),  G_ta = BiDAF(text_enc, aud_enc)  (text-only: self-attention)
    concat → linear → relu → modeling BiLSTM → M → pointer decoder

Kernel dispatch follows the JAX flags: ``use_pallas_lstm`` runs every BiLSTM
layer through the hand kernels (``ops/cuda/lstm_kernel.py``),
``use_pallas_attention`` the BiDAF blocks (``ops/cuda/bidaf_kernel.py``);
with a flag off the plain port of the JAX non-kernel path runs. A
``torch.Generator`` passed to ``mmbidaf_fused_reps`` / ``mmbidaf_apply``
means training, as an rng does in JAX: the trainable kernels (K5/K6 for the
LSTMs, K7/K8 for attention) and dropout at ``drop_prob`` on the GloVe rows
and inside the BiDAF similarities. Every dropout mask is drawn before the
towers run, so ``TrainConfig.remat_towers`` (``torch.utils.checkpoint``)
recomputes with the same masks.

Under ``compute_dtype="bfloat16"`` the towers' parameters and the batch's
float features are cast to bf16 (``_cast_compute``, differentiable, so
gradients reach the f32 parameters). The kernels return f32, and where an
f32 result meets a bf16 weight the product is taken in f32
(``ops.common.mm``), the dtype JAX promotes to. ``M`` is returned in f32
and the decoder uses the uncast f32 parameters, as in the JAX package.
"""

from __future__ import annotations

import math
import types
from typing import Mapping

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mmbidaf_tpu_torch import resolve_device
from mmbidaf_tpu_torch.config import Config
from mmbidaf_tpu_torch.models.decoder import Decoder, decoder_apply, decoder_beam_search
from mmbidaf_tpu_torch.models.embedding import Embedding, embedding_apply
from mmbidaf_tpu_torch.ops.bidaf import BiDAFParams, bidaf_apply
from mmbidaf_tpu_torch.ops.common import dropout_mask, mm, uniform_param, zeros_param
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


def mmbidaf_init(cfg: Config, word_vectors: np.ndarray, device="cuda", seed: int = 0) -> MMBiDAF:
    """Random model with the JAX ``mmbidaf_init`` shapes, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the numbers
    differ from JAX's; weights carried from JAX go through ``interop.from_jax``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return MMBiDAF(cfg, word_vectors, gen, dev)


def encode_text(params, text_ids, word_mask, sent_mask, bilstm_fn=bilstm_apply,
                emb_drop: torch.Tensor | None = None) -> torch.Tensor:
    """Hierarchical text tower → sentence encodings ``[B, T_s, 2h]``. The
    word BiLSTM runs over all ``B*T_s`` sentences at once; an empty
    sentence keeps the zero state, so its pooled vector is zero."""
    B, T_s, W = text_ids.shape
    emb = embedding_apply(params.embedding, text_ids, emb_drop)  # [B, T_s, W, h]
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


def _bidaf(att_params, c, q, c_mask, q_mask, cfg: Config, train: bool, drops=None) -> torch.Tensor:
    """One BiDAF block: the inference kernel, or in training the trainable
    kernel pair (``drops is None``: drop_prob 0) or the dropout pair fed the
    dropped ``cd``/``qd``; the plain path with its flag off. ``drops`` is the
    ``(c_drop, q_drop)`` pair of scaled keep masks."""
    if cfg.model.use_pallas_attention:
        from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel

        if not train:
            return bidaf_kernel.bidaf_attention_fused(att_params, c, q, c_mask, q_mask)
        if drops is None:
            return bidaf_kernel.bidaf_attention_fused_trainable(att_params, c, q, c_mask, q_mask)
        c_drop, q_drop = drops
        return bidaf_kernel.bidaf_attention_fused_dropout(
            att_params, c, q, c * c_drop.to(c.dtype), q * q_drop.to(q.dtype), c_mask, q_mask)
    return bidaf_apply(att_params, c, q, c_mask, q_mask, *(drops or (None, None)))


def _cast_tree(module: nn.Module, dtype: torch.dtype):
    """The module's parameters cast to ``dtype`` by differentiable ``.to``,
    under the same attribute paths (``ModuleList`` → list)."""
    ns = types.SimpleNamespace()
    for name, p in module.named_parameters(recurse=False):
        setattr(ns, name, p.to(dtype))
    for name, child in module.named_children():
        if isinstance(child, nn.ModuleList):
            setattr(ns, name, [_cast_tree(c, dtype) for c in child])
        else:
            setattr(ns, name, _cast_tree(child, dtype))
    return ns


def _cast_compute(params: MMBiDAF, batch: Mapping[str, torch.Tensor], dtype: torch.dtype):
    """Float params and batch features in the compute dtype (masks too, as in
    JAX; ids stay integer; the raw waveform stays f32). The cast parameters
    live for one call and keep the autograd path to the f32 originals."""
    cast = lambda x: x.to(dtype) if x.dtype == torch.float32 else x  # noqa: E731
    return (
        _cast_tree(params, dtype),
        {k: v if k == "waveform" else cast(v) for k, v in batch.items()},
    )


def draw_dropout_masks(batch: Mapping[str, torch.Tensor], cfg: Config,
                       generator: torch.Generator, rows: tuple | None = None) -> dict:
    """Every dropout mask of one training forward, drawn up front from
    ``generator`` in a fixed order: the GloVe rows (``emb``) and the c / q
    operands of each BiDAF similarity (``img``, ``aud`` or ``self``). With
    ``rows = (start, stop, total)`` (a data-parallel rank's rows of a batch
    of ``total``) each mask is drawn for the whole batch and cut to the
    rows, so every rank draws what one process draws on the whole batch."""
    m, drop = cfg.model, cfg.model.drop_prob
    ids = batch["text_ids"]
    dev = ids.device
    B, T_s, W = ids.shape
    D = 2 * m.hidden_size
    start, stop, B = rows if rows is not None else (0, B, B)

    def draw(shape):
        return dropout_mask(shape, drop, generator, dev)[start:stop]

    masks = {"emb": draw((B, T_s, W, m.emb_dim))}
    q_lens = {}
    if m.use_images:
        q_lens["img"] = batch["img_mask"].shape[1]
    if m.use_audio:
        q_lens["aud"] = batch["aud_mask"].shape[1]
    if not q_lens:
        q_lens["self"] = T_s
    for name, T_q in q_lens.items():
        masks[name] = (draw((B, T_s, D)), draw((B, T_q, D)))
    return masks


def mmbidaf_fused_reps(params: MMBiDAF, batch: Mapping[str, torch.Tensor], cfg: Config,
                       generator: torch.Generator | None = None, audio_g_fn=None,
                       rows: tuple | None = None) -> torch.Tensor:
    """Everything up to the fused sentence reps ``M [B, T_s, 2h]`` (f32). A
    ``generator`` means training: trainable kernels, dropout at
    ``drop_prob`` drawn from it (``rows``: see ``draw_dropout_masks``), and
    ``remat_towers`` if set. ``audio_g_fn`` (``parallel.sp_tower.
    make_sp_audio_tower``, under ``MeshConfig.sp_audio``) replaces the audio
    tower with the sequence-parallel chain; the batch then carries the raw
    ``waveform`` in place of ``audio`` features."""
    m = cfg.model
    train = generator is not None
    masks = (draw_dropout_masks(batch, cfg, generator, rows)
             if train and m.drop_prob > 0.0 else {})
    compute_dtype = torch_dtype(m.compute_dtype)
    if compute_dtype != torch.float32:
        params, batch = _cast_compute(params, batch, compute_dtype)
    if m.use_pallas_lstm:
        from mmbidaf_tpu_torch.ops.cuda import lstm_kernel

        layer = lstm_kernel.bilstm_cuda_trainable if train else lstm_kernel.bilstm_cuda

        def bilstm_fn(p, x, mask):
            return stacked_bilstm_apply(p, x, mask, bilstm_fn=layer)
    else:
        bilstm_fn = bilstm_apply

    # Training-only rematerialization: each tower's activations are dropped
    # after the forward and recomputed in the backward (same masks: drawn above).
    if train and cfg.train.remat_towers:
        def run(fn, *args):
            return checkpoint(fn, *args, use_reentrant=False)
    else:
        def run(fn, *args):
            return fn(*args)

    sent_mask = batch["sent_mask"]
    text_enc = run(lambda ids, wm, sm: encode_text(params, ids, wm, sm, bilstm_fn, masks.get("emb")),
                   batch["text_ids"], batch["word_mask"], sent_mask)

    def tower(lstm, att, name):
        def fn(t_enc, feats, mask):
            enc, _ = bilstm_fn(lstm, feats, mask)
            return _bidaf(att, t_enc, enc, sent_mask, mask, cfg, train, masks.get(name))
        return fn

    gs = []
    if m.use_images:
        gs.append(run(tower(params.img_lstm, params.att_img, "img"), text_enc,
                      batch["images"], batch["img_mask"]))
    if m.use_audio and audio_g_fn is not None:
        # the SP chain carries its own collectives: no remat inside it
        gs.append(audio_g_fn(params, text_enc, batch, masks.get("aud")))
    elif m.use_audio:
        gs.append(run(tower(params.aud_lstm, params.att_aud, "aud"), text_enc,
                      batch["audio"], batch["aud_mask"]))
    if not gs:
        gs.append(_bidaf(params.att_self, text_enc, text_enc, sent_mask, sent_mask, cfg, train,
                         masks.get("self")))
    return fuse_and_model(params, gs, sent_mask, bilstm_fn, fusion=m.fusion).float()


def mmbidaf_apply(params: MMBiDAF, batch: Mapping[str, torch.Tensor], cfg: Config,
                  generator: torch.Generator | None = None, audio_g_fn=None,
                  rows: tuple | None = None) -> torch.Tensor:
    """Teacher-forced forward → log-probs ``[B, K, T_s]`` (the training
    forward with a ``generator``; the eval loss without one)."""
    M = mmbidaf_fused_reps(params, batch, cfg, generator, audio_g_fn, rows)
    log_p, _ = decoder_apply(
        params.decoder, M, batch["sent_mask"], targets=batch["targets"],
        num_steps=cfg.model.max_decode_steps, teacher_forcing=True,
        mask_selected=cfg.model.mask_selected,
    )
    return log_p


def mmbidaf_decode(params: MMBiDAF, batch: Mapping[str, torch.Tensor], cfg: Config,
                   mode: str = "greedy", topk: int = 4,
                   generator: torch.Generator | None = None, audio_g_fn=None,
                   rows: tuple | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Inference → ``(log_probs [B, K, T_s], picks [B, K])``: greedy, top-k
    sampling from the top ``topk`` sentences (noise from ``generator``; with
    ``rows``, drawn for the whole batch and cut to a data-parallel rank's
    rows), or ``mode="beam"``, beam search of width ``topk``, which returns
    the best beam's total log-prob ``[B]`` in the place of the per-step
    log-probs."""
    if mode not in ("greedy", "topk", "beam"):
        raise ValueError(f"unknown decode mode {mode!r}: expected 'greedy', 'beam', or 'topk'")
    M = mmbidaf_fused_reps(params, batch, cfg, audio_g_fn=audio_g_fn)
    m = cfg.model
    if mode == "beam":
        return decoder_beam_search(params.decoder, M, batch["sent_mask"], num_steps=m.max_decode_steps,
                                   beam_size=topk, mask_selected=m.mask_selected)
    return decoder_apply(
        params.decoder, M, batch["sent_mask"], num_steps=m.max_decode_steps,
        mask_selected=m.mask_selected, mode=mode, topk=topk, generator=generator, rows=rows,
    )
