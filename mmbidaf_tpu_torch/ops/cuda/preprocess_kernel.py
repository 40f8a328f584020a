"""K10: the fused frame-preprocess kernel (``csrc/preprocess.cu``) and its
plain version.

Port of ``mmbidaf_tpu/ops/pallas/preprocess_kernel.py::preprocess_frames_fused``:
raw ``[N, H, W, 3] uint8`` frames → normalized ``[N, S, S, 3]`` in one pass —
the u8 widening, both separable bilinear resize contractions, /255 and the
ImageNet normalization — computed in f32 and cast once to ``dtype``, as the
Pallas kernel does. The resize weights are the port's numpy
``ops.vgg.resize_matrix``: ``rh [S, H]``, and the W-axis matrix per channel
with /255 and 1/std folded in, ``rw3[c, w, k] = rw[k, w] / (255·std_c)``
(the dense ``[S, W]`` matrix; the TPU's kron-expanded ``[3W, 3S]`` form was
a lane-layout device the GPU does not need); mean/std is subtracted last.

The plain version is ``ops.vgg.preprocess_frames`` in f32, cast to
``dtype``. ``preprocess_frames_fused`` is the wrapper: on a CPU tensor it
runs the plain version, on a CUDA tensor it launches the kernel or raises;
``preprocess_frames_fused.launches`` counts launches. The JAX package keeps
the einsum form on its serving path, and so does the port: K10 runs in the
kernel-parity tool.

Tolerance of kernel vs plain on the card (``TOLERANCE``, by output dtype):
the kernel contracts H first and folds 1/std into the weights, the plain
version contracts W first and divides last; on outputs up to 2.7 the f32
results differ by a few ulps, so f32 ``atol = 1e-4``. In bf16 both round
such values, which can land one bf16 ulp (at most 2⁻⁷ of the value) apart.
Measured on an H100 at 64 frames of 240x320 -> 224: 1.2e-6 in f32, one ulp
(7.8e-3 on values up to 2.56) in bf16.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mmbidaf_tpu_torch.ops.cuda import build
from mmbidaf_tpu_torch.ops.vgg import IMAGENET_MEAN, IMAGENET_STD, preprocess_frames, resize_matrix

TOLERANCE = {torch.float32: {"atol": 1e-4, "rtol": 0.0},
             torch.bfloat16: {"atol": 1e-4, "rtol": 2.0 ** -7}}


def preprocess_reference(frames_uint8: torch.Tensor, image_size: int,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of K10: ``ops.vgg.preprocess_frames`` in f32, cast once."""
    return preprocess_frames(frames_uint8, image_size, torch.float32).to(dtype)


@functools.lru_cache(maxsize=4)
def _consts(s: int, h: int, w: int, device: torch.device):
    """(rh [S, H], rw3 [3, W, S], bias [3]) f32 on ``device``."""
    scale = (np.float32(1.0) / (np.float32(255.0) * IMAGENET_STD)).astype(np.float32)
    rw3 = resize_matrix(s, w)[None, :, :] * scale[:, None, None]  # [3, S, W]
    bias = (IMAGENET_MEAN / IMAGENET_STD).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (resize_matrix(s, h), rw3.transpose(0, 2, 1), bias))


def preprocess_frames_fused(frames_uint8: torch.Tensor, image_size: int,
                            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Raw ``[N, H, W, 3] uint8`` frames → normalized ``[N, S, S, 3]`` in
    ``dtype`` (f32 or bf16) through the hand kernel."""
    if frames_uint8.device.type == "cpu":
        return preprocess_reference(frames_uint8, image_size, dtype)
    if frames_uint8.device.type != "cuda":
        raise ValueError(f"preprocess_frames_fused: unsupported device {frames_uint8.device}")
    if dtype not in TOLERANCE:
        raise ValueError(f"preprocess_frames_fused: dtype must be f32 or bf16, got {dtype}")
    n, h, w, _ = frames_uint8.shape
    dev = frames_uint8.device
    s = image_size
    build.check_tensor(frames_uint8, "frames", (n, h, w, 3), dev, torch.uint8)
    rh, rw3, bias = _consts(s, h, w, dev)
    out = torch.empty(n, s, s, 3, device=dev, dtype=dtype)
    lib = build.library()
    rc = lib.mmb_preprocess_frames(
        frames_uint8.data_ptr(), rh.data_ptr(), rw3.data_ptr(), bias.data_ptr(), out.data_ptr(),
        n, h, w, s, int(dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check_launch(lib, rc, "mmb_preprocess_frames")
    preprocess_frames_fused.launches += 1
    return out


preprocess_frames_fused.launches = 0
