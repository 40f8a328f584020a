"""Sentence-pointer LSTM decoder, as ``mmbidaf_tpu.models.decoder``.

The decoder LSTM (hidden = d) takes the fused representation of the
previously picked sentence (a learned ``start`` vector first); pointer
scores are additive attention ``v · tanh(M W_m + h W_d)``, the key
projection ``M W_m`` hoisted out of the step loop; picked sentences are
masked out when ``mask_selected``. The log-softmax runs in M's dtype (f32 on
the serving path). Three ways to pick:

- greedy takes the FIRST maximum (``torch.argmax``, like ``jnp.argmax``);
  teacher forcing feeds the gold indices instead;
- top-k (``decoder_apply(mode="topk")``) samples from the renormalised
  top ``topk`` sentences by Gumbel-max (``topk_pick``), as
  ``jax.random.categorical`` does, with one ``[B, T_s]`` draw a step from a
  ``torch.Generator``; the draws cannot equal JAX's, the rule does;
- beam search (``decoder_beam_search``) keeps the best ``beam_size``
  sequences, ties broken as ``jax.lax.top_k`` breaks them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from mmbidaf_tpu_torch.ops.common import mm, uniform_param
from mmbidaf_tpu_torch.ops.lstm import LSTMParams, lstm_cell
from mmbidaf_tpu_torch.ops.masked import mask_logits


class Decoder(nn.Module):
    """``lstm.{w_x,w_h,b}``, ``w_m``, ``w_d [m_dim, attn_dim]``, ``v [attn_dim]``,
    ``start [m_dim]``."""

    def __init__(self, m_dim: int, attn_dim: int, generator: torch.Generator, device):
        super().__init__()
        bound_m = 1.0 / math.sqrt(m_dim)
        self.lstm = LSTMParams(m_dim, m_dim, generator, device)
        self.w_m = uniform_param((m_dim, attn_dim), bound_m, generator, device)
        self.w_d = uniform_param((m_dim, attn_dim), bound_m, generator, device)
        self.v = uniform_param((attn_dim,), 1.0 / math.sqrt(attn_dim), generator, device)
        self.start = uniform_param((m_dim,), bound_m, generator, device)


def _step(params: Decoder, M_keys, inp, h, c, avail):
    """One decoder step → ``(h, c, log_p [rows, T_s])``."""
    h, c = lstm_cell(mm(inp, params.lstm.w_x) + params.lstm.b, h, c, params.lstm.w_h)
    scores = mm(torch.tanh(M_keys + mm(h, params.w_d)[:, None, :]), params.v)
    return h, c, F.log_softmax(mask_logits(scores, avail), dim=-1)


def gumbel_noise(shape, generator: torch.Generator, dtype: torch.dtype) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, u uniform on [tiny, 1), drawn
    from ``generator`` on its device (``jax.random.gumbel``'s low mode)."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(dtype).tiny)))


def topk_pick(log_p: torch.Tensor, topk: int, gumbel: torch.Tensor) -> torch.Tensor:
    """One top-k sample a row of ``log_p [B, T_s]``, given its Gumbel noise:
    keep ``log_p >= sort(log_p)[:, -topk]`` (ties at the k-th value stay in
    the set), then ``argmax(gumbel + kept)`` — ``jax.random.categorical``
    on the truncated log-probs."""
    kth = torch.sort(log_p, dim=-1).values[:, -topk][:, None]
    trunc = torch.where(log_p >= kth, log_p, torch.full_like(log_p, -math.inf))
    return torch.argmax(gumbel + trunc, dim=-1)


def decoder_apply(
    params: Decoder,
    M: torch.Tensor,
    sent_mask: torch.Tensor,
    targets: torch.Tensor | None = None,
    num_steps: int = 4,
    teacher_forcing: bool = False,
    mask_selected: bool = True,
    mode: str = "greedy",
    topk: int = 4,
    generator: torch.Generator | None = None,
    rows: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode ``num_steps`` pointers over ``M [B, T_s, d]`` →
    ``(log_probs [B, K, T_s], picks [B, K] int32)``. ``mode="topk"`` samples
    from the top ``topk`` sentences with noise from ``generator``; with
    ``rows = (start, stop, total)`` (a data-parallel rank's rows) the noise
    is drawn for all ``total`` rows and cut to these."""
    if mode not in ("greedy", "topk"):
        raise ValueError(f"unknown decode mode {mode!r}")
    if mode == "topk" and generator is None:
        raise ValueError("topk decoding needs a torch.Generator")
    if teacher_forcing and targets is None:
        raise ValueError("teacher forcing needs targets")
    B, T_s, d = M.shape
    dtype = M.dtype
    sent_mask = sent_mask.to(dtype)
    M_keys = mm(M, params.w_m)  # [B, T_s, a], hoisted out of the loop
    start, stop, total = rows if rows is not None else (0, B, B)
    rows = torch.arange(B, device=M.device)
    h = torch.zeros(B, d, dtype=dtype, device=M.device)
    c = torch.zeros_like(h)
    inp = params.start.to(dtype).expand(B, d)
    selected = torch.zeros(B, T_s, dtype=dtype, device=M.device)
    log_probs, picks = [], []
    for k in range(num_steps):
        avail = sent_mask * (1.0 - selected) if mask_selected else sent_mask
        h, c, log_p = _step(params, M_keys, inp, h, c, avail)
        if mode == "topk":
            pick = topk_pick(log_p, topk, gumbel_noise((total, T_s), generator, dtype)[start:stop])
        else:
            pick = torch.argmax(log_p, dim=-1)
        feed = targets[:, k].long() if teacher_forcing else pick
        inp = M[rows, feed]
        if mask_selected:
            selected = selected.index_put((rows, feed), torch.ones((), dtype=dtype, device=M.device))
        log_probs.append(log_p)
        picks.append(pick.to(torch.int32))
    return torch.stack(log_probs, dim=1), torch.stack(picks, dim=1)


def decoder_beam_search(
    params: Decoder,
    M: torch.Tensor,
    sent_mask: torch.Tensor,
    num_steps: int = 4,
    beam_size: int = 4,
    mask_selected: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Beam-search pointer decode → ``(seq_log_prob [B], picks [B, K] int32)``
    of the best beam.

    Beams ride the batch axis (``[B·Bm, …]``); only beam 0 is live at step
    0. Each step takes the top ``Bm`` of the ``Bm·T_s`` continuations and
    reorders h, c, the selected mask and the pick history by parent beam.
    The top ``Bm`` come from a stable descending sort, so equal scores keep
    the lower flat index first, as ``jax.lax.top_k`` does (masked sentences
    all score about -1e30, so ties are common); the best beam is the first
    maximum."""
    B, T_s, d = M.shape
    Bm = beam_size
    dtype, dev = M.dtype, M.device
    Mx = M.repeat_interleave(Bm, dim=0)  # [B·Bm, T_s, d]
    M_keys = mm(Mx, params.w_m)
    maskx = sent_mask.to(dtype).repeat_interleave(Bm, dim=0)
    rows = torch.arange(B * Bm, device=dev)
    h = torch.zeros(B * Bm, d, dtype=dtype, device=dev)
    c = torch.zeros_like(h)
    inp = params.start.to(dtype).expand(B * Bm, d)
    selected = torch.zeros(B * Bm, T_s, dtype=dtype, device=dev)
    scores = torch.full((B, Bm), -math.inf, device=dev)
    scores[:, 0] = 0.0
    hist = torch.zeros(B * Bm, num_steps, dtype=torch.int32, device=dev)
    base = torch.arange(B, device=dev)[:, None] * Bm
    for k in range(num_steps):
        avail = maskx * (1.0 - selected) if mask_selected else maskx
        h, c, log_p = _step(params, M_keys, inp, h, c, avail)
        flat = (scores.reshape(B * Bm, 1) + log_p).reshape(B, Bm * T_s)
        top, idx = torch.sort(flat, dim=1, descending=True, stable=True)
        scores, idx = top[:, :Bm], idx[:, :Bm]
        src = (base + idx // T_s).reshape(-1)
        pick = (idx % T_s).reshape(-1)
        h, c, selected, hist = h[src], c[src], selected[src], hist[src]
        hist[:, k] = pick.to(torch.int32)
        if mask_selected:
            selected[rows, pick] = 1.0
        inp = Mx[rows, pick]
    best = torch.argmax(scores, dim=1)
    b = torch.arange(B, device=dev)
    return scores[b, best], hist.reshape(B, Bm, num_steps)[b, best]
