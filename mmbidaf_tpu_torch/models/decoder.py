"""Sentence-pointer LSTM decoder, as ``mmbidaf_tpu.models.decoder.decoder_apply``.

The decoder LSTM (hidden = d) takes the fused representation of the
previously picked sentence (a learned ``start`` vector first); pointer
scores are additive attention ``v · tanh(M W_m + h W_d)``, the key
projection ``M W_m`` hoisted out of the step loop; picked sentences are
masked out when ``mask_selected``. The log-softmax runs in M's dtype (f32 on
the serving path). Greedy picks take the FIRST maximum (``torch.argmax``,
like ``jnp.argmax``); teacher forcing feeds the gold indices instead. Top-k
sampling and beam search are not ported yet.
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


def decoder_apply(
    params: Decoder,
    M: torch.Tensor,
    sent_mask: torch.Tensor,
    targets: torch.Tensor | None = None,
    num_steps: int = 4,
    teacher_forcing: bool = False,
    mask_selected: bool = True,
    mode: str = "greedy",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode ``num_steps`` pointers over ``M [B, T_s, d]`` →
    ``(log_probs [B, K, T_s], picks [B, K] int32)``."""
    if mode == "topk":
        raise NotImplementedError("top-k pointer decoding is not ported yet")
    if mode != "greedy":
        raise ValueError(f"unknown decode mode {mode!r}")
    if teacher_forcing and targets is None:
        raise ValueError("teacher forcing needs targets")
    B, T_s, d = M.shape
    dtype = M.dtype
    sent_mask = sent_mask.to(dtype)
    M_keys = mm(M, params.w_m)  # [B, T_s, a], hoisted out of the loop
    rows = torch.arange(B, device=M.device)
    h = torch.zeros(B, d, dtype=dtype, device=M.device)
    c = torch.zeros_like(h)
    inp = params.start.to(dtype).expand(B, d)
    selected = torch.zeros(B, T_s, dtype=dtype, device=M.device)
    log_probs, picks = [], []
    for k in range(num_steps):
        h, c = lstm_cell(mm(inp, params.lstm.w_x) + params.lstm.b, h, c, params.lstm.w_h)
        scores = mm(torch.tanh(M_keys + mm(h, params.w_d)[:, None, :]), params.v)
        avail = sent_mask * (1.0 - selected) if mask_selected else sent_mask
        log_p = F.log_softmax(mask_logits(scores, avail), dim=-1)
        pick = torch.argmax(log_p, dim=-1)
        feed = targets[:, k].long() if teacher_forcing else pick
        inp = M[rows, feed]
        if mask_selected:
            selected = selected.index_put((rows, feed), torch.ones((), dtype=dtype, device=M.device))
        log_probs.append(log_p)
        picks.append(pick.to(torch.int32))
    return torch.stack(log_probs, dim=1), torch.stack(picks, dim=1)
