"""VGG keyframe featurizer, the port of ``mmbidaf_tpu.ops.vgg``.

The conv stack runs channels-last from end to end: ``preprocess_frames``
writes contiguous NHWC images, which ``permute`` turns into a channels-last
NCHW view without a copy, and the conv weights (OIHW) are held
channels-last, so cuDNN runs its NHWC GEMMs with no layout transform around
them. Each direct conv runs through ``torch.nn.functional.conv2d`` (cuDNN
on the card) without its bias; the epilogue kernel
(``ops/cuda/conv_epilogue_kernel.py``) then adds the bias and applies the
ReLU in place, or, after a block's last conv, writes the 2x2 max pool of
that in the same pass. The JAX package's direct convs are XLA convs
outside any Pallas kernel, so the convs themselves have no hand kernel
here either. f32 convs run in full f32 whatever the process's TF32 flag
(``ops.common.full_f32_convs``), as the JAX reference computes them. With
``winograd=True`` every conv with C_in >= 32 runs Winograd F(2x2,3x3)
through K14 (``ops/cuda/winograd_kernel.py``), bias and ReLU inside it, as
the JAX package's ``vgg_features`` runs ``ops/winograd.py`` there; the
3-channel stem stays on the direct conv and its epilogue, and the pools
after K14 are ``F.max_pool2d`` on the same channels-last storage. K14 reads
and writes NHWC, so no layout copy comes between it and the convs and
pools around it. The fc1 input is the NCHW flatten, as ``vgg.py`` does for
torchvision weight compatibility (``reshape`` copies block 5's output into
that order).

The resize is the JAX package's matmul form: two contractions against
``resize_matrix`` weights, which reproduce ``jax.image.resize``'s
antialiased half-pixel bilinear kernel in numpy (``F.interpolate`` is not
guaranteed to equal it).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmbidaf_tpu_torch.ops.common import (einsum, full_f32_convs, mm, normal_param, uniform_param,
                                          zeros_param)
from mmbidaf_tpu_torch.ops.cuda import conv_epilogue_kernel, winograd_kernel
from mmbidaf_tpu_torch.utils.profiling import span

# torchvision vgg16 config "D": numbers = out-channels of 3x3 convs, "M" = maxpool.
VGG16_SPEC: tuple = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                     512, 512, 512, "M", 512, 512, 512, "M")
# torchvision vgg19 config "E" (one extra conv per 256/512 block).
VGG19_SPEC: tuple = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
                     512, 512, 512, 512, "M", 512, 512, 512, 512, "M")
# Tiny spec for unit tests (2 blocks).
TINY_SPEC: tuple = (8, "M", 16, "M")

# ModelConfig.vgg_variant values.
VARIANTS: tuple = ("tiny", "vgg16", "vgg19")


def spec_for_variant(name: str) -> tuple:
    """``ModelConfig.vgg_variant`` → conv spec (the fc layers are the same
    for every variant)."""
    specs = {"tiny": TINY_SPEC, "vgg16": VGG16_SPEC, "vgg19": VGG19_SPEC}
    try:
        return specs[name]
    except KeyError:
        raise ValueError(f"unknown vgg_variant {name!r}: expected one of {VARIANTS}") from None


IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class Conv(nn.Module):
    """``w [O, I, 3, 3]`` (OIHW; the JAX package keeps HWIO) in
    channels-last storage, which loading (a copy into it), ``.to(dtype)``
    and ``torch.save`` keep, ``b [O]``."""

    def __init__(self, c_in: int, c_out: int, generator: torch.Generator, device):
        super().__init__()
        fan_in = 3 * 3 * c_in
        w = normal_param((c_out, c_in, 3, 3), math.sqrt(2.0 / fan_in), generator, device)
        self.w = nn.Parameter(w.contiguous(memory_format=torch.channels_last), requires_grad=False)
        self.b = zeros_param((c_out,), device)


class VGG(nn.Module):
    """``convs.{i}.{w,b}``, ``fc1_w [flat, fc]``, ``fc1_b``, ``fc2_w``, ``fc2_b``;
    He-normal convs, uniform fc layers (shapes as ``vgg.py::vgg_init``)."""

    def __init__(self, spec: Sequence, image_size: int, fc_dim: int, in_channels: int,
                 generator: torch.Generator, device):
        super().__init__()
        convs = []
        c_in, size = in_channels, image_size
        for item in spec:
            if item == "M":
                size //= 2
                continue
            convs.append(Conv(c_in, item, generator, device))
            c_in = item
        self.convs = nn.ModuleList(convs)
        flat = size * size * c_in
        self.fc1_w = uniform_param((flat, fc_dim), 1.0 / math.sqrt(flat), generator, device)
        self.fc1_b = zeros_param((fc_dim,), device)
        self.fc2_w = uniform_param((fc_dim, fc_dim), 1.0 / math.sqrt(fc_dim), generator, device)
        self.fc2_b = zeros_param((fc_dim,), device)


def vgg_features(params: VGG, images: torch.Tensor, spec: Sequence = VGG16_SPEC,
                 winograd: bool = False) -> torch.Tensor:
    """``[N, H, W, 3]`` float images → ``[N, fc_dim]`` fc2-ReLU features;
    ``winograd`` sends every conv with C_in >= 32 to K14. A VGG that
    ``parallel.mesh.shard_frontend`` split over the mesh's ``model`` axis
    (its ``tp``) runs the classifier Megatron-style: the local fc1 columns,
    ReLU, the local fc2 rows, then one all-reduce before fc2's bias."""
    x = vgg_fc2_partial(params, images, spec, winograd)
    tp = getattr(params, "tp", None)
    if tp is not None:
        # tensor-parallel classifier (parallel.mesh.shard_frontend): this
        # rank's fc1 columns and fc2 rows; one sum of the partial products
        x = tp.all_reduce(x)
    return vgg_fc2_finish(params, x)


def vgg_fc2_finish(params: VGG, x: torch.Tensor) -> torch.Tensor:
    """fc2's bias and ReLU on its (summed) product."""
    with span("frontend.vgg.classifier"):
        return torch.relu(x + params.fc2_b)


def vgg_blocks(spec: Sequence) -> list[tuple]:
    """``spec`` cut after each ``"M"``: each block's convs and its pool."""
    blocks, cur = [], []
    for item in spec:
        cur.append(item)
        if item == "M":
            blocks.append(tuple(cur))
            cur = []
    return blocks + [tuple(cur)] if cur else blocks


def vgg_fc2_partial(params: VGG, images: torch.Tensor, spec: Sequence = VGG16_SPEC,
                    winograd: bool = False) -> torch.Tensor:
    """The stack up to fc2's product, before its bias: ``[N, fc_dim]``; on a
    split classifier this rank's partial product, which the ranks along
    ``model`` sum. Each block runs in a span ``frontend.vgg.block<k>``."""
    # contiguous NHWC images: a view; any other storage is copied once
    x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    ci = 0
    for k, block in enumerate(vgg_blocks(spec), 1):
        with span(f"frontend.vgg.block{k}"):
            pooled = False  # the block's pool already taken by the epilogue
            for item, nxt in zip(block, block[1:] + (None,)):
                if item == "M":
                    if not pooled:
                        x = F.max_pool2d(x, 2, 2)
                    continue
                conv = params.convs[ci]
                if winograd and conv.w.shape[1] >= 32:
                    # OIHW → HWIO view; NHWC in and out, a no-op .contiguous()
                    # on the channels-last activations
                    x = winograd_kernel.winograd_conv3x3_fused(
                        x.permute(0, 2, 3, 1).contiguous(), conv.w.permute(2, 3, 1, 0), conv.b,
                        relu=True).permute(0, 3, 1, 2)
                else:
                    with full_f32_convs(x.dtype):
                        x = F.conv2d(x, conv.w, None, padding=1)
                    pooled = nxt == "M"
                    x = conv_epilogue_kernel.conv_epilogue(x, conv.b, pooled)
                ci += 1
    with span("frontend.vgg.classifier"):
        x = x.reshape(x.shape[0], -1)  # NCHW flatten order (torchvision classifier)
        x = torch.relu(mm(x, params.fc1_w) + params.fc1_b)
        return mm(x, params.fc2_w)


def resize_matrix(dst: int, src: int) -> np.ndarray:
    """``[dst, src]`` separable bilinear resize weights, equal to
    ``jax.image.resize(eye(src), (dst, src), "bilinear")``: the triangle
    kernel, widened by ``src/dst`` when downsampling (antialias), half-pixel
    centres, column sums normalized to one — JAX's ``compute_weight_mat``
    op for op in float32. ``jax.image.resize`` runs that arithmetic under
    jit, where XLA's fused multiply-adds move weights by up to 7e-6."""
    if dst == src:
        return np.eye(src, dtype=np.float32)
    f32 = np.float32
    inv_scale = f32(1.0 / (dst / src))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(dst, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(src, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))  # [src, dst]
    total = np.sum(weights, axis=0, keepdims=True, dtype=f32)
    weights = np.where(
        np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, f32(1.0)),
        f32(0.0),
    )
    inside = (sample_f >= f32(-0.5)) & (sample_f <= f32(src - 0.5))
    weights = np.where(inside[None, :], weights, f32(0.0))
    return np.ascontiguousarray(weights.T.astype(f32))


def preprocess_frames(frames_uint8: torch.Tensor, image_size: int,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Raw ``[N, H, W, 3] uint8`` frames → normalized ``[N, S, S, 3]`` in
    ``dtype``, contiguous: the separable resize as two contractions (the
    /255 scale folded into the W-axis matrix), then ImageNet normalization."""
    _, h, w, _ = frames_uint8.shape
    dev = frames_uint8.device
    s = image_size
    with span("frontend.resize"):
        with span("frontend.resize.weights"):  # rebuilt on the host every call
            rw = torch.from_numpy(resize_matrix(s, w) / np.float32(255.0)).to(dev, dtype)
            rh = torch.from_numpy(resize_matrix(s, h)).to(dev, dtype)
            mean = torch.from_numpy(IMAGENET_MEAN).to(dev, dtype)
            std = torch.from_numpy(IMAGENET_STD).to(dev, dtype)
        x = frames_uint8.to(dtype)
        x = einsum("nhwc,kw->nhkc", x, rw)  # W axis first (smaller temporary)
        x = einsum("nhkc,sh->nskc", x, rh)
        # (x - mean) / std written as contiguous NHWC (the contraction's own
        # output is strided), the channels-last layout the VGG runs in
        out = torch.empty(x.shape, dtype=x.dtype, device=dev)
        torch.sub(x, mean, out=out)
        return out.div_(std)
