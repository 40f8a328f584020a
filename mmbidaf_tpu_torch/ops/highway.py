"""Highway network, as ``mmbidaf_tpu.ops.highway``: per layer
``g = σ(x W_g + b_g)``, ``t = relu(x W_t + b_t)``, ``x ← g∘t + (1−g)∘x``.
Weights are ``[in, out]`` (the JAX layout), so the forward is ``x @ W``."""

from __future__ import annotations

import math

import torch
from torch import nn

from mmbidaf_tpu_torch.ops.common import mm, uniform_param, zeros_param


class HighwayLayer(nn.Module):
    def __init__(self, dim: int, generator: torch.Generator, device):
        super().__init__()
        bound = 1.0 / math.sqrt(dim)
        self.gate_w = uniform_param((dim, dim), bound, generator, device)
        self.gate_b = zeros_param((dim,), device)
        self.transform_w = uniform_param((dim, dim), bound, generator, device)
        self.transform_b = zeros_param((dim,), device)


class Highway(nn.Module):
    """Parameters at ``highway.layers.{i}.{gate_w,gate_b,transform_w,transform_b}``."""

    def __init__(self, num_layers: int, dim: int, generator: torch.Generator, device):
        super().__init__()
        self.layers = nn.ModuleList(
            HighwayLayer(dim, generator, device) for _ in range(num_layers)
        )


def highway_apply(params: Highway, x: torch.Tensor) -> torch.Tensor:
    for layer in params.layers:
        g = torch.sigmoid(mm(x, layer.gate_w) + layer.gate_b)
        t = torch.relu(mm(x, layer.transform_w) + layer.transform_b)
        x = g * t + (1.0 - g) * x
    return x
