"""Masked softmax exactly as ``mmbidaf_tpu.ops.masked``: the multiplicative
``mask*x + (1-mask)*(-1e30)`` fill before the softmax (not ``-inf``, not a
``where``) — a fully masked row then softmaxes to the uniform distribution,
as in the reference."""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def mask_logits(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``mask*logits + (1-mask)*(-1e30)`` with mask broadcast to logits."""
    mask = torch.broadcast_to(mask, logits.shape).to(logits.dtype)
    return mask * logits + (1.0 - mask) * NEG_INF


def masked_softmax(
    logits: torch.Tensor, mask: torch.Tensor, dim: int = -1, log_softmax: bool = False
) -> torch.Tensor:
    """Softmax over ``dim`` treating ``mask==0`` positions as -1e30."""
    masked = mask_logits(logits, mask)
    if log_softmax:
        return F.log_softmax(masked, dim=dim)
    return F.softmax(masked, dim=dim)
