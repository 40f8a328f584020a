"""K3 and K4: the MFCC and tiled mel kernels (``csrc/mfcc.cu``) and their
plain versions.

Port of ``mmbidaf_tpu/ops/pallas/melspec_kernel.py::mfcc_fused``: windowed
DFT → power → mel → dB with the reference at each WHOLE example's maximum →
clamp at −80 dB → DCT, f32 ``[B, T, win] → [B, T, n_mfcc]``. The frames may
be a strided view of the waveform (``ops.audio.frame_signal``): the kernel
reads them through their strides, so only the last stride must be 1.

``mfcc_fused`` is the wrapper: on a CPU tensor it runs
:func:`mfcc_reference`, on a CUDA tensor it launches the kernel or raises,
through the custom op ``torch.ops.mmbidaf.mfcc`` (K4's wrapper through
``torch.ops.mmbidaf.log_mel``): one node in an exported program, whose CUDA
implementation alone launches and moves the counters, and whose FFT
operands (window, twiddles, mel ranges) are built and cached there, on the
real tensors.
K3 has two routes, picked by :func:`mfcc_route` (K4's rule, with the FFT
route to n_fft 4096: its f64 scratch and twiddles take twice K4's bytes)
and counted in ``mfcc_fused.routes``: ``fft``
(``csrc/mfcc.cu::logmel_fft_kernel<kDb>``: K4's FFT body in f64 with a dB
epilogue and the block maxima) and ``dense`` (the DFT as two products, any
``n_fft``); both end in the same DCT pass, which takes up to 1,815 mels. The
FFT route takes the same operands as K4's (:func:`_fft_operands`, with the
basis check that raises) and f64 twiddles.
Tolerance of kernel vs plain on the card: the plain version sums the
400-term DFT products in f32, the kernel runs a real FFT in f64 (or, on the
dense route, the same products in another order); the dB values are
``10·log10`` of powers, so a relative power error ε becomes ≈ 4.3·ε dB, and
the DCT sums 64 such values. An f32 DFT's rounding is relative to each
frame's energy, so weak mel bands far below a frame's peak carry the
largest errors. On white noise (MFCCs up to ~120) the largest error
measured on an H100 was 3.1e-5 (dense body) and 7.6e-5 (FFT route). On a
loud sine over weak noise with a quiet stretch (mel bands more than 60 dB
apart, B=64 at the bench shape) an f64 MFCC on the host put the plain
version 6.0e-4 and the dense route 6.0e-4 from it, the FFT route 2.7e-4,
and the FFT route 5.3e-4 from the plain version: the plain version's own
error sets the bound, so ``atol = 1e-3, rtol = 1e-5`` (it was 5e-4 while
only white noise was held).

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

K4 has two routes, picked by :func:`log_mel_route` from the shapes before
the launch and counted in ``log_mel_fused.routes``: ``fft`` where
``n_fft = 2·(bins − 1)`` is a power of two from 16 to 8192 and ``win <=
n_fft`` (the configurations' 512), ``dense`` (the DFT as two products, any
``n_fft``) otherwise. Each route's frames a block are chosen at launch, the
most whose block fits its shared memory (:func:`fft_plan`: 8, 4, 2 or 1;
:func:`dense_frames`: 32, 16, …, 1); a shape that no block holds raises
before any launch. The FFT route rests on the bases being a window's
DFT basis of ``n_fft`` (``ops/audio.py::make_audio_frontend_consts``:
``cos = window[:, None] · cos(2πnk/n_fft)``, the frame zero-padded at the
end), so ``frames @ cos`` and ``frames @ sin`` are the real and imaginary
parts of ``rfft(window · frame, n=n_fft)``. It takes the window from
``cos[:, 0]`` and checks once per consts tensor (cached) that ``cos`` and
``sin`` are that window's basis within f32 rounding; it raises otherwise,
so a caller's other basis is never replaced by the FFT. Its mel product
runs over each mel column's nonzero bins (:func:`mel_nonzeros`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from mmbidaf_tpu_torch.ops import audio
from mmbidaf_tpu_torch.ops.cuda import build

TOLERANCE = {"atol": 1e-3, "rtol": 1e-5}
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


def mfcc_route(win: int, bins: int) -> str:
    """K3's route for ``[win, bins]`` bases, by K4's rule
    (:func:`log_mel_route`) with the FFT route to ``MFCC_FFT_SIZES``:
    ``"fft"`` or ``"dense"``."""
    return _route(win, bins, MFCC_FFT_SIZES)


def mfcc_fused(frames: torch.Tensor, consts: dict) -> torch.Tensor:
    """MFCC of ``frames [B, T, win]`` through the hand kernel, on the route
    :func:`mfcc_route` picks, through the custom op ``torch.ops.mmbidaf.mfcc``
    (one node in an exported program). ``mfcc_fused.launches`` counts
    launches (one per call; the kernel runs as two passes),
    ``mfcc_fused.routes`` those of each route; both move only where the
    kernel launches."""
    build.check_device(frames, "mfcc_fused")
    return torch.ops.mmbidaf.mfcc(frames, consts["cos"], consts["sin"], consts["mel_fb"],
                                  consts["dct"])


@torch.library.custom_op("mmbidaf::mfcc", mutates_args=(), device_types="cpu")
def mfcc_op(frames: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, mel_fb: torch.Tensor,
            dct: torch.Tensor) -> torch.Tensor:
    """K3 as a custom op: ``frames [B, T, win]`` (a strided view will do)
    and the frontend's bases → f32 ``[B, T, n_mfcc]``. On the CPU, the plain
    version."""
    consts = {"cos": cos, "sin": sin, "mel_fb": mel_fb, "dct": dct}
    return mfcc_reference(frames, consts).contiguous()


@mfcc_op.register_kernel("cuda")
def _mfcc_cuda(frames, cos, sin, mel_fb, dct):
    consts = {"cos": cos, "sin": sin, "mel_fb": mel_fb, "dct": dct}
    route = mfcc_route(frames.shape[-1], cos.shape[1])
    out = _mfcc_launch(frames, consts, route)
    mfcc_fused.launches += 1
    mfcc_fused.routes[route] += 1
    return out


@mfcc_op.register_fake
def _mfcc_fake(frames, cos, sin, mel_fb, dct):
    B, T, _ = frames.shape
    return frames.new_empty(B, T, dct.shape[1], dtype=torch.float32)


def _mfcc_launch(frames: torch.Tensor, consts: dict, route: str) -> torch.Tensor:
    """One launch of K3 on ``route`` for CUDA ``frames [B, T, win]``, the
    operands checked (the wrapper's body, outside its counters)."""
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
    if dct_smem_bytes(n_mels) + 4 > build.SMEM_LIMIT_BYTES:
        raise ValueError(f"mfcc_fused: the DCT pass's block of {DCT_FRAMES} frames of {n_mels} "
                         f"mels needs {dct_smem_bytes(n_mels)} bytes of shared memory, more than "
                         f"{build.SMEM_LIMIT_BYTES}")
    if route == "fft":
        window, twiddle, ranges, weights = _fft_operands(consts, torch.float64)
        F = _fft_plan_or_raise(2 * (bins - 1), win, frames.stride(1), n_mels, weights.numel(),
                               True, "mfcc_fused").frames
    else:
        F = _dense_frames_or_raise(win, bins, "mfcc_fused")
    logmel = torch.empty(B, T, n_mels, device=dev)
    out = torch.empty(B, T, n_mfcc, device=dev)
    tile_max = torch.empty(B, -(-T // F), device=dev)  # a maximum a block of the first pass
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "fft":
        rc = lib.mmb_mfcc_fft_forward(
            frames.data_ptr(), frames.stride(0), frames.stride(1), window.data_ptr(),
            twiddle.data_ptr(), weights.data_ptr(), ranges.data_ptr(), consts["dct"].data_ptr(),
            logmel.data_ptr(), tile_max.data_ptr(), out.data_ptr(),
            B, T, win, 2 * (bins - 1), n_mels, weights.numel(), n_mfcc, stream,
        )
        build.check_launch(lib, rc, "mmb_mfcc_fft_forward")
    else:
        rc = lib.mmb_mfcc_forward(
            frames.data_ptr(), frames.stride(0), frames.stride(1),
            consts["cos"].data_ptr(), consts["sin"].data_ptr(), consts["mel_fb"].data_ptr(),
            consts["dct"].data_ptr(), logmel.data_ptr(), tile_max.data_ptr(), out.data_ptr(),
            B, T, win, bins, n_mels, n_mfcc, stream,
        )
        build.check_launch(lib, rc, "mmb_mfcc_forward")
    return out


mfcc_fused.launches = 0
mfcc_fused.routes = {"fft": 0, "dense": 0}


def log_mel_reference(frames: torch.Tensor, consts: dict, log: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K4: ``ops.audio.log_mel`` (``log``) or
    ``ops.audio.melspectrogram`` in f32."""
    frames = frames.float()
    return audio.log_mel(frames, consts) if log else audio.melspectrogram(frames, consts)


# The FFT route: n_fft a power of two in this range, win <= n_fft; K4's
# (csrc/mfcc.cu::kFftMaxN) and K3's, whose f64 block holds to 4096 (kFftMaxN64).
FFT_SIZES = (16, 8192)
MFCC_FFT_SIZES = (16, 4096)
# The most frames a block of the first pass: the FFT route's (csrc/mfcc.cu::
# kFftFrames, a warp a frame) and the dense route's; K3 keeps one maximum a
# block for its DCT pass, which takes DCT_FRAMES frames a block.
FFT_FRAMES, DENSE_FRAMES, DCT_FRAMES = 8, 32, 32


def dense_smem_bytes(win: int, bins: int, frames: int = DENSE_FRAMES) -> int:
    """Shared memory a block of the dense route asks for (``csrc/mfcc.cu::
    dense_smem_bytes``): ``frames`` frames and their spectra, 32 warp
    maxima."""
    return 4 * (frames * (win + bins) + 32)


def dense_frames(win: int, bins: int) -> int:
    """The dense route's frames a block (``csrc/mfcc.cu::dense_frames``): the
    most of 32, 16, …, 1 whose block fits ``build.SMEM_LIMIT_BYTES``; 0 where
    not even one frame fits (win + bins past ~58,000)."""
    F = DENSE_FRAMES
    while F >= 1 and dense_smem_bytes(win, bins, F) > build.SMEM_LIMIT_BYTES:
        F //= 2
    return F


def dct_smem_bytes(n_mels: int) -> int:
    """Shared memory a block of K3's DCT pass asks for: DCT_FRAMES rows of
    dB mels (and one static float beside them, within the limit)."""
    return 4 * DCT_FRAMES * n_mels


class FftPlan(NamedTuple):
    """The FFT route's block (``csrc/mfcc.cu::fft_geometry``): ``frames`` a
    block, the mel weights ``staged`` in shared memory (their count, or 0),
    and its dynamic shared memory in bytes."""
    frames: int
    staged: int
    smem: int


def _zstride(log2m: int) -> int:
    sh = log2m - 4 if log2m > 4 else 0
    return (1 << log2m) + ((1 << log2m) >> sh)


def fft_smem_bytes(n_fft: int, win: int, ld: int, n_mels: int, staged: int, f64: bool,
                   frames: int) -> int:
    """Shared memory of a block of the FFT route (``csrc/mfcc.cu::
    fft_smem_bytes``) at ``frames`` frames a block."""
    M = n_fft // 2
    cbytes = 16 if f64 else 8
    r4 = lambda n: (n + 3) & ~3  # noqa: E731
    return (cbytes * (2 * M + frames * _zstride(M.bit_length() - 1)) + 16 * n_mels + 4 * r4(win)
            + 4 * r4(frames * (M + 1)) + 4 * r4(staged) + 4 * ((frames - 1) * ld + win))


def fft_plan(n_fft: int, win: int, hop: int, n_mels: int, nnz: int, f64: bool = False):
    """The FFT route's block for these operands, as ``csrc/mfcc.cu::
    fft_geometry`` plans it: frames ``hop`` apart are staged as their span
    where they overlap or abut (else one by one, ``win`` apart); the most
    frames of 8, 4, 2, 1 whose block fits, the mel weights staged where they
    fit beside the rest; ``None`` where the route does not take them."""
    lo, hi = MFCC_FFT_SIZES if f64 else FFT_SIZES
    if not (lo <= n_fft <= hi and n_fft & (n_fft - 1) == 0 and 1 <= win <= n_fft) \
            or n_mels <= 0 or nnz < 0:
        return None
    ld = hop if 0 < hop <= win else win
    for F in (8, 4, 2, 1):
        with_weights = fft_smem_bytes(n_fft, win, ld, n_mels, nnz, f64, F)
        staged = nnz if with_weights <= build.SMEM_LIMIT_BYTES else 0
        smem = fft_smem_bytes(n_fft, win, ld, n_mels, staged, f64, F)
        if smem <= build.SMEM_LIMIT_BYTES:
            return FftPlan(F, staged, smem)
    return None


def _dense_frames_or_raise(win: int, bins: int, name: str) -> int:
    F = dense_frames(win, bins)
    if F == 0:
        raise ValueError(f"{name}: no route for [{win}, {bins}] bases: the dense route's block of "
                         f"one frame needs {dense_smem_bytes(win, bins, 1)} bytes of shared memory, "
                         f"more than {build.SMEM_LIMIT_BYTES}")
    return F


def _fft_plan_or_raise(n_fft: int, win: int, hop: int, n_mels: int, nnz: int, f64: bool,
                       name: str) -> FftPlan:
    plan = fft_plan(n_fft, win, hop, n_mels, nnz, f64)
    if plan is None:
        raise ValueError(f"{name}: the FFT route's block of one frame at n_fft={n_fft}, win={win}, "
                         f"{n_mels} mels needs more than {build.SMEM_LIMIT_BYTES} bytes of shared "
                         f"memory")
    return plan


# cos/sin vs the window's DFT basis, within this share of max|window| (f32
# rounding of the basis and of its product with the window: 2^-23 at most).
_BASIS_RTOL = 2.0 ** -21


def _route(win: int, bins: int, sizes: tuple[int, int]) -> str:
    n_fft = 2 * (bins - 1)
    lo, hi = sizes
    pow2 = n_fft > 0 and n_fft & (n_fft - 1) == 0
    return "fft" if pow2 and lo <= n_fft <= hi and 1 <= win <= n_fft else "dense"


def log_mel_route(win: int, bins: int) -> str:
    """K4's route for ``[win, bins]`` bases: ``"fft"`` where ``n_fft = 2·(bins
    − 1)`` is a power of two in ``FFT_SIZES`` and ``win <= n_fft``, else
    ``"dense"``."""
    return _route(win, bins, FFT_SIZES)


def dft_basis_error(cos: torch.Tensor, sin: torch.Tensor) -> float:
    """The largest distance of ``cos``/``sin [win, bins]`` from the DFT basis of
    ``n_fft = 2·(bins − 1)`` with the window ``cos[:, 0]`` folded in, as a
    share of ``max|window|`` (computed in f64)."""
    c, s = cos.detach().double().cpu().numpy(), sin.detach().double().cpu().numpy()
    win, bins = c.shape
    n_fft = 2 * (bins - 1)
    window = c[:, 0]
    nk = (np.arange(win)[:, None] * np.arange(bins)[None, :]) % n_fft  # exact angles
    ang = 2.0 * np.pi * nk / n_fft
    err = max(np.abs(c - window[:, None] * np.cos(ang)).max(),
              np.abs(s + window[:, None] * np.sin(ang)).max())
    return float(err / max(np.abs(window).max(), np.finfo(np.float32).tiny))


def mel_nonzeros(mel_fb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The filterbank's nonzeros as the FFT route reads them: int32 ``[n_mels,
    4]``, each mel column's first and last nonzero bin (``(0, -1)`` for an
    all-zero column) and the offset of its weights in the packed list, and
    the f32 weights of each column from its first to its last nonzero bin,
    packed column by column; both on ``mel_fb``'s device."""
    fb = mel_fb.detach().cpu()
    nz = fb != 0
    bins, n_mels = nz.shape
    k = torch.arange(bins)[:, None].expand(bins, n_mels)
    hi = torch.where(nz, k, -1).amax(0)
    lo = torch.where(hi < 0, 0, torch.where(nz, k, bins).amin(0))
    width = hi - lo + 1
    off = torch.cumsum(width, 0) - width
    ranges = torch.stack([lo, hi, off, torch.zeros_like(lo)], 1).to(torch.int32)
    weights = torch.cat([fb[lo[m]:hi[m] + 1, m] for m in range(n_mels)])
    return ranges.contiguous().to(mel_fb.device), weights.float().contiguous().to(mel_fb.device)


def twiddles(n_fft: int, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The FFT route's twiddles, ``[n_fft, 2]`` (real, imaginary) in ``dtype``
    (f32 for K4, f64 for K3), computed in f64 with ``W_n = e^{-2πi/n}``: for
    each radix-2 stage of the
    ``n_fft/2``-point FFT with butterfly span ``2·half``, ``W_{2·half}^pos``
    at ``half + pos`` (``pos < half``; row 0 is unused, 1), then
    ``W_{n_fft}^k`` at ``n_fft/2 + k`` for the real-FFT split (``k <
    n_fft/2``)."""
    M = n_fft // 2
    ang = np.zeros(n_fft)
    half = 1
    while half < M:
        ang[half:2 * half] = -np.pi * np.arange(half) / half
        half *= 2
    ang[M:] = -2.0 * np.pi * np.arange(M) / n_fft
    return torch.from_numpy(np.stack([np.cos(ang), np.sin(ang)], 1)).to(device, dtype)


_WINDOWS = WeakIdKeyDictionary()  # cos -> (versions of cos and sin, sin's id, window)
_NONZEROS = WeakIdKeyDictionary()  # mel_fb -> (its version, ranges, weights)
_TWIDDLES: dict = {}              # (n_fft, device, dtype) -> twiddles


def _version(t: torch.Tensor) -> int:
    """``t``'s version counter; an inference tensor (made or loaded under
    ``torch.inference_mode``, as weights may be) tracks none and counts as
    unchanged."""
    return -1 if t.is_inference() else t._version


def _fft_operands(consts: dict, dtype: torch.dtype = torch.float32) -> tuple[torch.Tensor, ...]:
    """The FFT route's window, twiddles (in ``dtype``), mel ranges and packed
    mel weights for ``consts``, cached per tensor; raises ``ValueError`` if
    ``cos``/``sin`` are not the window's DFT basis."""
    cos, sin, mel_fb = consts["cos"], consts["sin"], consts["mel_fb"]
    key = (_version(cos), _version(sin), id(sin))
    hit = _WINDOWS.get(cos)
    if hit is None or hit[0] != key:
        err = dft_basis_error(cos, sin)
        if not err <= _BASIS_RTOL:
            raise ValueError(f"the FFT route: cos/sin are not the DFT basis of n_fft="
                             f"{2 * (cos.shape[1] - 1)} with the window cos[:, 0] (off by "
                             f"{err:.3e} of max|window|, bound {_BASIS_RTOL:.3e}); the FFT "
                             f"route computes only that basis")
        hit = (key, cos[:, 0].contiguous())
        _WINDOWS[cos] = hit
    nonzeros = _NONZEROS.get(mel_fb)
    if nonzeros is None or nonzeros[0] != _version(mel_fb):
        nonzeros = (_version(mel_fb), *mel_nonzeros(mel_fb))
        _NONZEROS[mel_fb] = nonzeros
    key = (2 * (cos.shape[1] - 1), cos.device, dtype)
    if key not in _TWIDDLES:
        _TWIDDLES[key] = twiddles(*key)
    return hit[1], _TWIDDLES[key], *nonzeros[1:]


def log_mel_fused(frames: torch.Tensor, consts: dict, log: bool = True) -> torch.Tensor:
    """``[..., win] → [..., n_mels]`` through the hand kernel: natural-log mel
    (``log=True``) or the raw mel power, on the route :func:`log_mel_route`
    picks, through the custom op ``torch.ops.mmbidaf.log_mel`` (one node in
    an exported program). ``log_mel_fused.launches`` counts launches,
    ``log_mel_fused.routes`` those of each route; both move only where the
    kernel launches."""
    build.check_device(frames, "log_mel_fused")
    return torch.ops.mmbidaf.log_mel(frames, consts["cos"], consts["sin"], consts["mel_fb"], log)


log_mel_fused.launches = 0
log_mel_fused.routes = {"fft": 0, "dense": 0}


@torch.library.custom_op("mmbidaf::log_mel", mutates_args=(), device_types="cpu")
def log_mel_op(frames: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, mel_fb: torch.Tensor,
               log: bool) -> torch.Tensor:
    """K4 as a custom op: ``frames [..., win]`` and the frontend's bases →
    f32 ``[..., n_mels]``, the log mel (``log``) or the raw mel. On the CPU,
    the plain version."""
    consts = {"cos": cos, "sin": sin, "mel_fb": mel_fb}
    return log_mel_reference(frames, consts, log).contiguous()


@log_mel_op.register_kernel("cuda")
def _log_mel_cuda(frames, cos, sin, mel_fb, log):
    *lead, win = frames.shape
    # [B, T, win] views (frame_signal's) keep their strides; other ranks are
    # reshaped to [rows, T, win], which copies only where the view needs it.
    x = frames.float()
    x = x.reshape(1, -1, win) if x.dim() < 3 else x.reshape(-1, *x.shape[-2:])
    if x.stride(-1) != 1:
        x = x.contiguous()
    dev = x.device
    B, T, _ = x.shape
    bins = cos.shape[1]
    n_mels = mel_fb.shape[1]
    consts = {"cos": cos, "sin": sin, "mel_fb": mel_fb}
    for name, shape in (("cos", (win, bins)), ("sin", (win, bins)), ("mel_fb", (bins, n_mels))):
        build.check_tensor(consts[name], name, shape, dev)
    route = log_mel_route(win, bins)
    if route == "fft":
        window, twiddle, ranges, weights = _fft_operands(consts)
        _fft_plan_or_raise(2 * (bins - 1), win, x.stride(1), n_mels, weights.numel(), False,
                           "log_mel_fused")
    else:
        _dense_frames_or_raise(win, bins, "log_mel_fused")
    out = torch.empty(B, T, n_mels, device=dev)
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "fft":
        rc = lib.mmb_log_mel_fft_forward(
            x.data_ptr(), x.stride(0), x.stride(1), window.data_ptr(), twiddle.data_ptr(),
            weights.data_ptr(), ranges.data_ptr(), out.data_ptr(),
            B, T, win, 2 * (bins - 1), n_mels, weights.numel(), int(log), stream,
        )
        build.check_launch(lib, rc, "mmb_log_mel_fft_forward")
    else:
        rc = lib.mmb_log_mel_forward(
            x.data_ptr(), x.stride(0), x.stride(1), cos.data_ptr(), sin.data_ptr(),
            mel_fb.data_ptr(), out.data_ptr(), B, T, win, bins, n_mels, int(log), stream,
        )
        build.check_launch(lib, rc, "mmb_log_mel_forward")
    log_mel_fused.launches += 1
    log_mel_fused.routes[route] += 1
    return out.reshape(*lead, n_mels)


@log_mel_op.register_fake
def _log_mel_fake(frames, cos, sin, mel_fb, log):
    return frames.new_empty(*frames.shape[:-1], mel_fb.shape[1], dtype=torch.float32)
