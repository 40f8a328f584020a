"""K10: the fused frame-preprocess kernel (``csrc/preprocess.cu``) and its
plain version.

Port of ``mmbidaf_tpu/ops/pallas/preprocess_kernel.py::preprocess_frames_fused``:
raw ``[N, H, W, 3] uint8`` frames → normalized ``[N, S, S, 3]`` in one pass —
the u8 widening, both separable bilinear resize contractions, /255 and the
ImageNet normalization — computed in f32 and cast once to ``dtype``, as the
Pallas kernel does. The resize weights are the port's numpy
``ops.vgg.resize_matrix`` in banded form (:func:`band_taps`: each output
row's first input index and its ``T`` weights, ``T`` the widest band of
the matrix); the W-axis weights per channel carry /255 and 1/std,
``ww[c, k, i] = rw[k, first_w[k] + i] / (255·std_c)`` (the TPU's
kron-expanded ``[3W, 3S]`` form was a lane-layout device the GPU does not
need); mean/std is subtracted last. :func:`preprocess_plan` sizes a block:
``rows`` output rows (8 where they fit) and the input rows a tile of them
reads.

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
from typing import NamedTuple

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


def band_taps(dst: int, src: int) -> tuple[np.ndarray, np.ndarray]:
    """``resize_matrix(dst, src)`` in banded form: ``first [dst]`` int32, the
    first input index of each output row, and ``weights [dst, T]`` f32, the
    row's entries ``first .. first + T - 1``, ``T`` the widest band of any
    row (from its first to its last nonzero). ``first`` is held to ``src -
    T`` so every tap is a real input index; the entries of the window
    outside a row's band are its exact zeros, so the dense matrix rebuilt
    from the two is ``resize_matrix``, bit for bit."""
    m = resize_matrix(dst, src)
    nz = m != 0
    has = nz.any(axis=1)
    lo = np.where(has, nz.argmax(axis=1), 0)
    hi = np.where(has, src - 1 - nz[:, ::-1].argmax(axis=1), 0)
    taps = int((hi - lo + 1)[has].max()) if has.any() else 1
    first = np.minimum(lo, src - taps).astype(np.int32)
    weights = np.take_along_axis(m, first[:, None] + np.arange(taps)[None, :], axis=1)
    return first, np.ascontiguousarray(weights, dtype=np.float32)


class PreprocessPlan(NamedTuple):
    """How K10 cuts an ``S``-row output: blocks of ``rows`` output rows, the
    most input rows one such tile reads (``band_rows``), and the dynamic
    shared memory a block, in bytes (``csrc/preprocess.cu::launch``)."""
    rows: int
    band_rows: int
    smem: int


@functools.lru_cache(maxsize=16)
def preprocess_plan(s: int, h: int, w: int) -> PreprocessPlan:
    """The most output rows a block (8, 4, 2 or 1; ``csrc/preprocess.cu``
    takes at most 8) whose ``t [rows][3W]`` f32 and input band fit a block's
    shared memory. Raises ``ValueError`` where one row does not."""
    first, wh = band_taps(s, h)
    taps = wh.shape[1]
    w3 = 3 * w
    for rows in (8, 4, 2, 1):
        band = max(int(first[i:i + rows].max() - first[i:i + rows].min()) + taps
                   for i in range(0, s, rows))
        smem = -(-4 * rows * w3 // 16) * 16 + band * w3 + 32
        if smem <= build.SMEM_LIMIT_BYTES:
            return PreprocessPlan(rows, band, smem)
    raise ValueError(f"preprocess_frames_fused: {h}x{w} -> {s} needs {smem} bytes of shared "
                     f"memory for one output row, over the {build.SMEM_LIMIT_BYTES} a block has")


@functools.lru_cache(maxsize=4)
def _consts(s: int, h: int, w: int, device: torch.device):
    """(first_h [S] int32, wh [S, Th], first_w [S] int32, ww [3, S, Tw], bias
    [3] f32) on ``device``: the banded resize weights, the W-axis ones per
    channel with 1/(255·std_c) folded in, and mean/std."""
    scale = (np.float32(1.0) / (np.float32(255.0) * IMAGENET_STD)).astype(np.float32)
    first_h, wh = band_taps(s, h)
    first_w, rw = band_taps(s, w)
    ww = rw[None, :, :] * scale[:, None, None]  # [3, S, Tw]
    bias = (IMAGENET_MEAN / IMAGENET_STD).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (first_h, wh, first_w, ww, bias))


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
    plan = preprocess_plan(s, h, w)
    first_h, wh, first_w, ww, bias = _consts(s, h, w, dev)
    out = torch.empty(n, s, s, 3, device=dev, dtype=dtype)
    lib = build.library()
    rc = lib.mmb_preprocess_frames(
        frames_uint8.data_ptr(), first_h.data_ptr(), wh.data_ptr(), first_w.data_ptr(),
        ww.data_ptr(), bias.data_ptr(), out.data_ptr(), n, h, w, s, wh.shape[1], ww.shape[2],
        plan.rows, plan.band_rows, int(dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check_launch(lib, rc, "mmb_preprocess_frames")
    preprocess_frames_fused.launches += 1
    return out


preprocess_frames_fused.launches = 0
