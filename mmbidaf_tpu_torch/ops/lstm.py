"""Bidirectional LSTM with pack_padded semantics — the port of
``mmbidaf_tpu.ops.lstm`` (the JAX ``lax.scan`` path, used when
``use_pallas_lstm`` is off; the hand kernel lives in ``ops/cuda/lstm_kernel.py``).

- The input projection ``x @ W_x + b`` for all steps is one GEMM up front;
  the step loop does ``h @ W_h`` plus the gate math, gate order i, f, g, o.
- Masked steps freeze the carried (h, c) and emit zeros; the reverse
  direction runs over the flipped *padded* time axis (the mask freezes the
  zero state across leading pads, which equals starting at ``len-1``).
  Fully masked rows keep the zero state.

Params per direction (JAX layout): ``w_x [in, 4h]``, ``w_h [h, 4h]``,
``b [4h]`` (torch's ``bias_ih + bias_hh`` summed).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from mmbidaf_tpu_torch.ops.common import mm, uniform_param, zeros_param


class LSTMParams(nn.Module):
    """One direction: ``w_x [in, 4h]``, ``w_h [h, 4h]``, ``b [4h]``."""

    def __init__(self, in_dim: int, hidden: int, generator: torch.Generator, device):
        super().__init__()
        bound = 1.0 / math.sqrt(hidden)  # torch nn.LSTM default init range
        self.w_x = uniform_param((in_dim, 4 * hidden), bound, generator, device)
        self.w_h = uniform_param((hidden, 4 * hidden), bound, generator, device)
        self.b = zeros_param((4 * hidden,), device)


class BiLSTMParams(nn.Module):
    """``fwd`` / ``bwd`` directions — the JAX ``bilstm_init`` pytree."""

    def __init__(self, in_dim: int, hidden: int, generator: torch.Generator, device):
        super().__init__()
        self.fwd = LSTMParams(in_dim, hidden, generator, device)
        self.bwd = LSTMParams(in_dim, hidden, generator, device)


class StackedBiLSTMParams(nn.Module):
    """``layers.{k}`` — the JAX ``{"layers": [...]}`` pytree (num_layers > 1)."""

    def __init__(self, in_dim: int, hidden: int, num_layers: int,
                 generator: torch.Generator, device):
        super().__init__()
        self.layers = nn.ModuleList(
            BiLSTMParams(in_dim if k == 0 else 2 * hidden, hidden, generator, device)
            for k in range(num_layers)
        )


def stacked_bilstm_init(in_dim: int, hidden: int, num_layers: int,
                        generator: torch.Generator, device) -> nn.Module:
    """``nn.LSTM(num_layers=L, bidirectional=True)`` params: the flat
    :class:`BiLSTMParams` for one layer (as JAX), ``layers`` for deeper stacks."""
    if num_layers < 1:
        raise ValueError(f"num_layers must be >= 1, got {num_layers}")
    if num_layers == 1:
        return BiLSTMParams(in_dim, hidden, generator, device)
    return StackedBiLSTMParams(in_dim, hidden, num_layers, generator, device)


def lstm_cell(gates: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              w_h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One step given precomputed input gates ``x_t @ w_x + b``. i,f,g,o order."""
    z = gates + mm(h, w_h)
    i, f, g, o = z.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_scan(params: LSTMParams, x: torch.Tensor, mask: torch.Tensor,
              reverse: bool = False) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One direction over ``x [B, T, D]`` with ``mask [B, T]`` →
    ``(out [B, T, h], (h_last [B, h], c_last [B, h]))``; the state is
    computed in ``x.dtype`` as in the JAX scan."""
    B, T, _ = x.shape
    h_dim = params.w_h.shape[0]
    dtype = x.dtype
    gates_all = mm(x, params.w_x) + params.b  # [B, T, 4h], one GEMM
    mask_t = mask.to(dtype)
    if reverse:
        gates_all = gates_all.flip(1)
        mask_t = mask_t.flip(1)
    h = torch.zeros(B, h_dim, dtype=dtype, device=x.device)
    c = torch.zeros_like(h)
    outs = []
    for t in range(T):
        h_new, c_new = lstm_cell(gates_all[:, t], h, c, params.w_h)
        m = mask_t[:, t, None]
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        outs.append(h_new * m)
    out = torch.stack(outs, dim=1)
    if reverse:
        out = out.flip(1)
    return out, (h, c)


def bilstm_apply(params: nn.Module, x: torch.Tensor, mask: torch.Tensor):
    """``(out [B, T, 2h], (h_last, c_last) [B, 2h])``; ``out[..., :h]`` is the
    forward direction. Stacked params run layer by layer and return the last
    layer's outputs and states."""
    if hasattr(params, "layers"):
        return stacked_bilstm_apply(params, x, mask)
    out_f, (h_f, c_f) = lstm_scan(params.fwd, x, mask, reverse=False)
    out_b, (h_b, c_b) = lstm_scan(params.bwd, x, mask, reverse=True)
    return torch.cat([out_f, out_b], -1), (torch.cat([h_f, h_b], -1), torch.cat([c_f, c_b], -1))


def stacked_bilstm_apply(params: nn.Module, x: torch.Tensor, mask: torch.Tensor,
                         bilstm_fn=None):
    """Run a (possibly stacked) BiLSTM. ``bilstm_fn`` runs one layer — a
    hand kernel's wrapper on the kernel path. No inter-layer dropout: the
    JAX model calls its stacked towers without it, in training too."""
    fn = bilstm_fn if bilstm_fn is not None else bilstm_apply
    if not hasattr(params, "layers"):
        return fn(params, x, mask)
    out, state = x, None
    for layer in params.layers:
        out, state = fn(layer, out, mask)
    return out, state
