"""Weights made on the device from the seed, in two draws (one uniform, one
normal) sliced into the leaves of a layout (``reference.mmbidaf_ref``'s
``model_layout`` / ``vgg_layout``), then handed to the program and to the
reference alike."""

from __future__ import annotations

import math

import torch

from pbench.traffic import sub_seed


def make(layout: list, seed: int, purpose: str, device) -> dict[str, torch.Tensor]:
    """``{name: float32 tensor}`` for ``layout``'s ``(name, shape, init, scale)``."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, purpose))
    size = lambda shape: math.prod(shape)  # noqa: E731
    n_uni = sum(size(s) for _, s, init, _ in layout if init == "uniform")
    n_nrm = sum(size(s) for _, s, init, _ in layout if init != "uniform")
    uni = torch.rand(n_uni, generator=gen, device=device)
    nrm = torch.randn(n_nrm, generator=gen, device=device)
    out, iu, in_ = {}, 0, 0
    for name, shape, init, scale in layout:
        n = size(shape)
        if init == "uniform":
            out[name] = uni[iu:iu + n].view(shape).mul_(2 * scale).sub_(scale)
            iu += n
        else:
            out[name] = nrm[in_:in_ + n].view(shape).mul_(scale)
            in_ += n
            if init == "glove":
                out[name][:2] = 0.0
    return out


def load_into(module: torch.nn.Module, weights: dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``module``'s parameters, which must carry exactly
    these names and shapes."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"parameter names differ: program only {sorted(set(params) - set(weights))}, "
                         f"benchmark only {sorted(set(weights) - set(params))}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: program {tuple(p.shape)}, benchmark {tuple(weights[name].shape)}")
            p.copy_(weights[name])
