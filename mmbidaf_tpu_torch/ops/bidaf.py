"""BiDAF attention, as ``mmbidaf_tpu.ops.bidaf`` (the plain path used when
``use_pallas_attention`` is off; the hand kernels are ``ops/cuda/bidaf_kernel.py``).

For context ``c [B, T_c, D]`` and query ``q [B, T_q, D]``:

    S  = c·w_c 1ᵀ + 1 (q·w_q)ᵀ + (c∘w_cq)·qᵀ + b     (trilinear)
    s1 = softmax_row(S masked by q_mask)            # over T_q
    s2 = softmax_col(S masked by c_mask)            # over T_c
    a  = s1·q,   b = s1·s2ᵀ·c                       # C2Q, product-form Q2C
    G  = [c; a; c∘a; c∘b]  ∈ [B, T_c, 4D]

Training dropout hits c and q only inside the similarity, as in the JAX
package (``similarity_matrix`` drops its own copies): the caller passes
scaled keep masks (``ops.common.dropout_mask``), drawn before any
checkpointed region, and the outputs use the undropped c and q.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from mmbidaf_tpu_torch.ops.common import einsum, mm, uniform_param, zeros_param
from mmbidaf_tpu_torch.ops.masked import masked_softmax


class BiDAFParams(nn.Module):
    """``w_c``, ``w_q``, ``w_cq`` ``[dim]`` and a scalar ``bias``; ``dim`` is the
    per-sequence feature size (2h)."""

    def __init__(self, dim: int, generator: torch.Generator, device):
        super().__init__()
        bound = math.sqrt(6.0 / (dim + 1))  # xavier_uniform_ on [dim, 1]
        self.w_c = uniform_param((dim,), bound, generator, device)
        self.w_q = uniform_param((dim,), bound, generator, device)
        self.w_cq = uniform_param((dim,), bound, generator, device)
        self.bias = zeros_param((), device)


def similarity_matrix(params, c: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Trilinear similarity ``S [B, T_c, T_q]``."""
    s0 = mm(c, params.w_c)[:, :, None]
    s1 = mm(q, params.w_q)[:, None, :]
    s2 = einsum("bcd,bqd->bcq", c * params.w_cq, q)
    return s0 + s1 + s2 + params.bias


def attend(S: torch.Tensor, c: torch.Tensor, q: torch.Tensor,
           c_mask: torch.Tensor, q_mask: torch.Tensor) -> torch.Tensor:
    """Both masked softmaxes of ``S``, C2Q and Q2C → ``G [B, T_c, 4D]``."""
    s_row = masked_softmax(S, q_mask[:, None, :], dim=2)
    s_col = masked_softmax(S, c_mask[:, :, None], dim=1)
    a = einsum("bcq,bqd->bcd", s_row, q)
    b = einsum("bcq,bkq,bkd->bcd", s_row, s_col, c)
    return torch.cat([c, a, c * a, c * b], dim=-1)


def bidaf_apply(params, c: torch.Tensor, q: torch.Tensor,
                c_mask: torch.Tensor, q_mask: torch.Tensor,
                c_drop: torch.Tensor | None = None,
                q_drop: torch.Tensor | None = None) -> torch.Tensor:
    """Full BiDAF block → ``G [B, T_c, 4D]``. ``c_drop`` / ``q_drop`` are
    scaled keep masks applied to c and q inside the similarity only."""
    cd = c if c_drop is None else c * c_drop.to(c.dtype)
    qd = q if q_drop is None else q * q_drop.to(q.dtype)
    return attend(similarity_matrix(params, cd, qd), c, q, c_mask, q_mask)
