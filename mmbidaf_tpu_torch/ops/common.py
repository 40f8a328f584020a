"""Helpers shared by the port's ops: JAX-style dtype promotion for products,
seeded parameter construction, and dropout masks from an explicit generator.

``torch.matmul`` raises on mixed bf16 / f32 operands, where JAX promotes
them to f32. Under ``compute_dtype="bfloat16"`` the JAX model meets such
products wherever an f32 kernel output feeds a bf16 weight (e.g. the
sentence BiLSTM's ``x @ W_x`` and the fusion linear), so every product in
the port goes through :func:`mm` / :func:`einsum`, which reproduce JAX's
result dtype.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch import nn


def promote(*xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Cast tensors to their common dtype (JAX's bf16 × f32 → f32 rule)."""
    dtype = functools.reduce(torch.promote_types, (x.dtype for x in xs))
    return tuple(x.to(dtype) for x in xs)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with JAX's dtype promotion."""
    a, b = promote(a, b)
    return a @ b


def einsum(eq: str, *xs: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with JAX's dtype promotion."""
    return torch.einsum(eq, *promote(*xs))


@contextlib.contextmanager
def full_f32_convs(dtype: torch.dtype):
    """For an f32 ``dtype``: cuDNN runs the block's convolutions in full f32,
    whatever the process's TF32 flags, and its own setting is restored on
    exit; cuDNN stays on and no other flag changes. Other dtypes: a no-op.

    ``torch.backends.cudnn.allow_tf32`` defaults to True, so a bare f32
    ``F.conv2d`` on the card runs in TF32 (about three decimal digits) where
    the JAX reference computes in f32. ``torch.backends.cudnn.flags(
    allow_tf32=False)`` is no cure: its other arguments take their defaults
    too, ``enabled=False`` first, so cuDNN would be off inside it. The
    per-operator setting ``cudnn.conv.fp32_precision`` touches the
    convolutions alone, and reading it never trips the legacy flag's
    mixed-API error."""
    if dtype != torch.float32:
        yield
        return
    conv = torch.backends.cudnn.conv
    before = conv.fp32_precision
    conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision = before


def uniform_param(shape, bound: float, generator: torch.Generator, device) -> nn.Parameter:
    """``U(-bound, bound)`` parameter drawn from ``generator`` on ``device``.
    Parameters are made without gradients; ``train.loop.init_train_state``
    turns them on for the trainable ones."""
    w = torch.empty(shape, device=device).uniform_(-bound, bound, generator=generator)
    return nn.Parameter(w, requires_grad=False)


def normal_param(shape, std: float, generator: torch.Generator, device) -> nn.Parameter:
    w = torch.empty(shape, device=device).normal_(0.0, std, generator=generator)
    return nn.Parameter(w, requires_grad=False)


def zeros_param(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, device=device), requires_grad=False)


def dropout_mask(shape, drop_prob: float, generator: torch.Generator, device) -> torch.Tensor:
    """Scaled keep mask ``bernoulli(1 - drop_prob) / (1 - drop_prob)`` of
    ``shape`` drawn from ``generator``: multiplying by it is inverted
    dropout. The JAX package draws its masks from ``jax.random``; the two
    streams differ, so tests compare statistics or inject masks."""
    keep = 1.0 - drop_prob
    u = torch.rand(shape, generator=generator, device=device)
    return (u < keep).float() / keep
