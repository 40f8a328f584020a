"""Text embedding, as ``mmbidaf_tpu.models.embedding``: frozen GloVe lookup →
(training: dropout) → linear projection (no bias) → highway."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from mmbidaf_tpu_torch.ops.common import mm, uniform_param
from mmbidaf_tpu_torch.ops.highway import Highway, highway_apply


class Embedding(nn.Module):
    """``table [V, emb_dim]`` (frozen), ``proj_w [emb_dim, hidden]``, ``highway``."""

    def __init__(self, word_vectors: np.ndarray, hidden_size: int, num_highway_layers: int,
                 generator: torch.Generator, device):
        super().__init__()
        table = torch.tensor(np.asarray(word_vectors, np.float32), device=device)
        self.table = nn.Parameter(table, requires_grad=False)
        emb_dim = table.shape[1]
        self.proj_w = uniform_param((emb_dim, hidden_size), 1.0 / math.sqrt(emb_dim),
                                    generator, device)
        self.highway = Highway(num_highway_layers, hidden_size, generator, device)


def embedding_apply(params: Embedding, token_ids: torch.Tensor,
                    drop_mask: torch.Tensor | None = None) -> torch.Tensor:
    """``token_ids [...]`` → embeddings ``[..., hidden]``. ``drop_mask``
    (``ops.common.dropout_mask`` of shape ``[..., emb_dim]``, training) drops
    the raw GloVe rows before the projection, as the reference's
    ``Embedding.forward``. The table is frozen: no gradient reaches it."""
    emb = params.table.detach()[token_ids.long()]
    if drop_mask is not None:
        emb = emb * drop_mask.to(emb.dtype)
    return highway_apply(params.highway, mm(emb, params.proj_w))
