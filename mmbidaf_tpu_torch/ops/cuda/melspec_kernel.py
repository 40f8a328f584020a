"""K3 and K4: the MFCC and tiled mel kernels (``csrc/mfcc.cu``) and their
plain versions.

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

K4 is the port of ``melspec_kernel.py::log_mel_fused``: the same windowed
DFT → power → mel on frame tiles, then ``log(mel + 1e-6)`` (``log=True``,
the ``audio_features="logmel"`` frontend) or the raw mel (``log=False``, the
MFCC path past ``mfcc_fused_fits``, whose dB and DCT tail is plain tensor
code in ``ops/audio.py``). Any leading dims, f32 out ``[..., n_mels]``; the
TPU kernel's padding of the frame axis to a tile multiple has no
counterpart: the last tile is masked. ``log_mel_fused`` is the wrapper, on
the same rules as ``mfcc_fused``. Tolerances of kernel vs plain on the
card, ``LOG_MEL_TOLERANCE`` by mode: ``log=False`` is a raw power sum whose
values span many decades, so it is held normwise, within
``atol + rtol·max|ref|``; ``log=True`` is held elementwise: a relative mel
error ε moves ``log(mel + 1e-6)`` by at most ε, and the values reach ~14,
so K3's bound scaled to that range, ``atol = 5e-5, rtol = 1e-5``. Measured
on an H100 at the long-audio and log-mel shapes: 6.0e-8 on raw mels up to
0.63 (1e-7 of the scale) and 4.8e-7 on log-mels (half an ulp at 14).
"""

from __future__ import annotations

import torch

from mmbidaf_tpu_torch.ops import audio
from mmbidaf_tpu_torch.ops.cuda import build

TOLERANCE = {"atol": 5e-4, "rtol": 1e-5}
# K4, by ``log``: True elementwise, False normwise (see the module docstring).
LOG_MEL_TOLERANCE = {True: {"atol": 5e-5, "rtol": 1e-5}, False: {"atol": 0.0, "rtol": 1e-5}}

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


def log_mel_reference(frames: torch.Tensor, consts: dict, log: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K4: ``ops.audio.log_mel`` (``log``) or
    ``ops.audio.melspectrogram`` in f32."""
    frames = frames.float()
    return audio.log_mel(frames, consts) if log else audio.melspectrogram(frames, consts)


def log_mel_fused(frames: torch.Tensor, consts: dict, log: bool = True) -> torch.Tensor:
    """``[..., win] → [..., n_mels]`` through the hand kernel: natural-log mel
    (``log=True``) or the raw mel power. ``log_mel_fused.launches`` counts
    launches."""
    if frames.device.type == "cpu":
        return log_mel_reference(frames, consts, log)
    if frames.device.type != "cuda":
        raise ValueError(f"log_mel_fused: unsupported device {frames.device}")
    *lead, win = frames.shape
    # [B, T, win] views (frame_signal's) keep their strides; other ranks are
    # reshaped to [rows, T, win], which copies only where the view needs it.
    x = frames.float()
    x = x.reshape(1, -1, win) if x.dim() < 3 else x.reshape(-1, *x.shape[-2:])
    if x.stride(-1) != 1:
        x = x.contiguous()
    dev = x.device
    B, T, _ = x.shape
    bins = consts["cos"].shape[1]
    n_mels = consts["mel_fb"].shape[1]
    for name, shape in (("cos", (win, bins)), ("sin", (win, bins)), ("mel_fb", (bins, n_mels))):
        build.check_tensor(consts[name], name, shape, dev)
    out = torch.empty(B, T, n_mels, device=dev)
    lib = build.library()
    rc = lib.mmb_log_mel_forward(
        x.data_ptr(), x.stride(0), x.stride(1), consts["cos"].data_ptr(),
        consts["sin"].data_ptr(), consts["mel_fb"].data_ptr(), out.data_ptr(),
        B, T, win, bins, n_mels, int(log), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check_launch(lib, rc, "mmb_log_mel_forward")
    log_mel_fused.launches += 1
    return out.reshape(*lead, n_mels)


log_mel_fused.launches = 0
