"""K3: the MFCC kernel (``csrc/mfcc.cu``) and its plain version.

Port of ``mmbidaf_tpu/ops/pallas/melspec_kernel.py::mfcc_fused``: windowed
DFT → power → mel → dB with the reference at each WHOLE example's maximum →
clamp at −80 dB → DCT, f32 ``[B, T, win] → [B, T, n_mfcc]``. The frames may
be a strided view of the waveform (``ops.audio.frame_signal``): the kernel
reads them through their strides, so only the last stride must be 1.

``mfcc_fused`` is the wrapper: on a CPU tensor it runs
:func:`mfcc_reference`, on a CUDA tensor it launches the kernel or raises.
Tolerance of kernel vs plain on the card: both sum the 400-term DFT
products in f32 in different orders; the dB values are ``10·log10`` of
powers, so a relative power error ε becomes ≈ 4.3·ε dB, and the DCT sums 64
such values. On MFCCs up to ~120 in magnitude the largest error measured on
an H100 was 3.1e-5 (4 ulps at 120), so ``atol = 5e-4, rtol = 1e-5``.
"""

from __future__ import annotations

import torch

from mmbidaf_tpu_torch.ops import audio
from mmbidaf_tpu_torch.ops.cuda import build

TOLERANCE = {"atol": 5e-4, "rtol": 1e-5}

# The JAX package's whole-example bound (melspec_kernel.py::mfcc_fused_fits),
# kept so that the port takes the fused path for exactly the same shapes.
_MFCC_FUSED_MAX_BYTES = 8 * 1024 * 1024


def mfcc_fused_fits(num_frames: int, win_length: int, n_bins: int, n_mels: int) -> bool:
    """Whether the whole-example MFCC kernel takes these shapes."""
    per_example = 4 * num_frames * (win_length + 3 * n_bins + n_mels)
    return per_example <= _MFCC_FUSED_MAX_BYTES


def mfcc_reference(frames: torch.Tensor, consts: dict) -> torch.Tensor:
    """Plain PyTorch version: ``ops.audio.mfcc`` in f32."""
    return audio.mfcc(frames.float(), consts)


def mfcc_fused(frames: torch.Tensor, consts: dict) -> torch.Tensor:
    """MFCC of ``frames [B, T, win]`` through the hand kernel.
    ``mfcc_fused.launches`` counts launches (one per call; the kernel runs
    as two passes)."""
    if frames.device.type == "cpu":
        return mfcc_reference(frames, consts)
    if frames.device.type != "cuda":
        raise ValueError(f"mfcc_fused: unsupported device {frames.device}")
    frames = frames.float()  # as the TPU kernel's frames.astype(f32); a no-op for f32
    if frames.stride(-1) != 1:
        frames = frames.contiguous()
    dev = frames.device
    B, T, win = frames.shape
    bins = consts["cos"].shape[1]
    n_mels = consts["mel_fb"].shape[1]
    n_mfcc = consts["dct"].shape[1]
    if frames.device != consts["cos"].device:
        raise ValueError("mfcc_fused: frames and consts are on different devices")
    for name, shape in (("cos", (win, bins)), ("sin", (win, bins)),
                        ("mel_fb", (bins, n_mels)), ("dct", (n_mels, n_mfcc))):
        build.check_tensor(consts[name], name, shape, dev)
    logmel = torch.empty(B, T, n_mels, device=dev)
    tile_max = torch.empty(B, T, device=dev)
    out = torch.empty(B, T, n_mfcc, device=dev)
    lib = build.library()
    rc = lib.mmb_mfcc_forward(
        frames.data_ptr(), frames.stride(0), frames.stride(1),
        consts["cos"].data_ptr(), consts["sin"].data_ptr(), consts["mel_fb"].data_ptr(),
        consts["dct"].data_ptr(), logmel.data_ptr(), tile_max.data_ptr(), out.data_ptr(),
        B, T, win, bins, n_mels, n_mfcc, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check_launch(lib, rc, "mmb_mfcc_forward")
    mfcc_fused.launches += 1
    return out


mfcc_fused.launches = 0
