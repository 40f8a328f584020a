"""Audio frontend: framing → windowed matmul-DFT (or the Stockham FFT) → mel
→ dB → DCT (MFCC), the port of ``mmbidaf_tpu.ops.audio``.

The numpy constant functions are the JAX module's, line for line (they are
numpy there too), so the port's constants are bitwise equal to the
reference's — the tests check that. Mel filterbank: librosa's Slaney scale
and area normalization; MFCC is DCT-II (ortho) over power-dB mel with the
dB reference at each example's maximum, as in the JAX package.

The fused path (``fused=True``, ``ModelConfig.use_pallas_melspec``) goes
through the hand-written kernels of ``ops/cuda/melspec_kernel.py``: the
whole-example MFCC kernel K3 while ``mfcc_fused_fits`` holds, else (the
4096-frame long-audio configuration) the tiled mel kernel K4 with the dB and
DCT tail here; ``audio_features="logmel"`` takes K4's log mode.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mmbidaf_tpu_torch import resolve_device
from mmbidaf_tpu_torch.ops.common import mm

# ---------------------------------------------------------------------------
# Host-side (numpy) basis construction.
# ---------------------------------------------------------------------------


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (librosa/scipy ``sym=False`` convention)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def dft_basis(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT matrices ``[n_fft, n_fft//2 + 1]`` for rfft-as-matmul."""
    n_bins = n_fft // 2 + 1
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = -2.0 * np.pi * t * k / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney mel scale (librosa default, htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    safe_f = np.maximum(f, 1e-10)  # avoid log(0) in the unselected branch
    return np.where(f >= min_log_hz, min_log_mel + np.log(safe_f / min_log_hz) / logstep, mels)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(
    sample_rate: int, n_fft: int, n_mels: int, fmin: float = 0.0, fmax: float | None = None
) -> np.ndarray:
    """Triangular mel filterbank ``[n_fft//2+1, n_mels]``, slaney-normalized."""
    fmax = fmax if fmax is not None else sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fb = np.zeros((n_bins, n_mels), dtype=np.float64)
    for m in range(n_mels):
        lo, ctr, hi = mel_pts[m], mel_pts[m + 1], mel_pts[m + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
        fb[:, m] *= 2.0 / (hi - lo)  # slaney area normalization
    return fb.astype(np.float32)


def dct_matrix(n_in: int, n_out: int) -> np.ndarray:
    """DCT-II with ortho norm, ``[n_in, n_out]`` (scipy.fft.dct type 2)."""
    n = np.arange(n_in)[:, None]
    k = np.arange(n_out)[None, :]
    mat = 2.0 * np.cos(np.pi * k * (2 * n + 1) / (2 * n_in))
    mat[:, 0] *= np.sqrt(1.0 / (4 * n_in))
    mat[:, 1:] *= np.sqrt(1.0 / (2 * n_in))
    return mat.astype(np.float32)


def make_audio_frontend_consts(
    sample_rate: int, n_fft: int, win_length: int, n_mels: int, n_mfcc: int,
    fmin: float = 0.0, fmax: float | None = None, device="cuda",
) -> dict[str, torch.Tensor]:
    """All constant matrices of the frontend, as f32 tensors on ``device``
    (the card unless the caller asks for the CPU).
    The Hann window and the win_length → n_fft zero pad are folded into the
    DFT bases, so the power spectrum is exactly two GEMMs."""
    window = hann_window(win_length)
    cos_b, sin_b = dft_basis(n_fft)
    consts = {
        "cos": (window[:, None] * cos_b[:win_length, :]).astype(np.float32),
        "sin": (window[:, None] * sin_b[:win_length, :]).astype(np.float32),
        "mel_fb": mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax),
        "dct": dct_matrix(n_mels, n_mfcc),
    }
    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(dev) for k, v in consts.items()}


# ---------------------------------------------------------------------------
# Device-side pipeline.
# ---------------------------------------------------------------------------


def frame_signal(signal: torch.Tensor, win_length: int, hop_length: int,
                 num_frames: int) -> torch.Tensor:
    """``[B, N] → [B, T, win]`` frames at a fixed hop, as a strided view of
    the waveform (no copy; the MFCC kernel reads it through its strides).
    The waveform must cover ``num_frames`` (callers pad it)."""
    need = (num_frames - 1) * hop_length + win_length
    if signal.shape[1] < need:
        raise ValueError(
            f"waveform has {signal.shape[1]} samples; {num_frames} frames need {need}"
        )
    return signal.unfold(1, win_length, hop_length)[:, :num_frames]


def power_spectrum(frames: torch.Tensor, consts: dict, fft: str = "matmul") -> torch.Tensor:
    """Windowed rfft-as-matmul power spectrum ``[B, T, win] → [B, T, bins]``.

    ``fft="stockham"`` computes the same quantity with the radix-2 Stockham
    FFT (``DataConfig.audio_fft``), the JAX package's accuracy-first path:
    O(N log N) elementwise passes in f32 in place of the two products."""
    if fft == "stockham":
        return stockham_power_spectrum(frames, consts)
    if fft != "matmul":
        raise ValueError(f"unknown fft {fft!r} (matmul | stockham)")
    re = mm(frames, consts["cos"])
    im = mm(frames, consts["sin"])
    return re * re + im * im


def stockham_stages(n_fft: int) -> list:
    """Per-stage twiddle constants (n, m, wr, wi) for the autosort radix-2
    Stockham FFT — no bit reversal: every stage is a reshape + butterfly +
    twiddle multiply (numpy, as in the JAX package)."""
    stages = []
    n = n_fft
    while n > 1:
        m = n // 2
        ang = -2.0 * np.pi * np.arange(m) / n
        stages.append((n, m,
                       np.cos(ang).astype(np.float32)[:, None],
                       np.sin(ang).astype(np.float32)[:, None]))
        n = m
    return stages


@functools.lru_cache(maxsize=8)
def _stockham_consts(n_fft: int, win: int, device: torch.device):
    """The zero-padded window and each stage's twiddles as tensors on ``device``."""
    window = np.zeros(n_fft, np.float32)
    window[:win] = hann_window(win)
    stages = [(n, m, torch.from_numpy(wr).to(device), torch.from_numpy(wi).to(device))
              for n, m, wr, wi in stockham_stages(n_fft)]
    return torch.from_numpy(window).to(device), stages


def stockham_power_spectrum(frames: torch.Tensor, consts: dict) -> torch.Tensor:
    """Windowed power spectrum via the Stockham FFT: ``[..., win] →
    [..., n_fft//2+1]``. The Hann window and the win → n_fft zero pad fold
    into the first touch, mirroring the folded-window matmul-DFT consts."""
    n_bins = consts["cos"].shape[1]
    n_fft = 2 * (n_bins - 1)
    if n_fft & (n_fft - 1):
        raise ValueError(f"stockham needs a power-of-two n_fft, got {n_fft}")
    win = frames.shape[-1]
    window, stages = _stockham_consts(n_fft, win, frames.device)
    lead = frames.shape[:-1]
    N = int(np.prod(lead))
    re = torch.nn.functional.pad(frames.reshape(N, win), (0, n_fft - win)) * window
    im = torch.zeros_like(re)
    s = 1
    for n, m, wr, wi in stages:
        ar = re.reshape(N, n, s)[:, :m]
        ai = im.reshape(N, n, s)[:, :m]
        br = re.reshape(N, n, s)[:, m:]
        bi = im.reshape(N, n, s)[:, m:]
        # butterfly: top = a + b ; bottom = (a - b) * w
        dr, di = ar - br, ai - bi
        re = torch.stack([ar + br, dr * wr - di * wi], dim=2).reshape(N, n_fft)
        im = torch.stack([ai + bi, dr * wi + di * wr], dim=2).reshape(N, n_fft)
        s *= 2
    out = re[:, :n_bins] ** 2 + im[:, :n_bins] ** 2
    return out.reshape(*lead, n_bins)


def melspectrogram(frames: torch.Tensor, consts: dict, fft: str = "matmul") -> torch.Tensor:
    return mm(power_spectrum(frames, consts, fft=fft), consts["mel_fb"])


def log_power(s: torch.Tensor) -> torch.Tensor:
    """``10*log10(max(s, 1e-10))``."""
    return 10.0 * torch.log10(torch.clamp_min(s, 1e-10))


def power_to_db(s: torch.Tensor, top_db: float = 80.0,
                ref: torch.Tensor | None = None) -> torch.Tensor:
    """librosa.power_to_db with ref = max over each example's spectrogram
    (pass ``ref`` when the max comes from elsewhere: the sequence-parallel
    frontend's max over every rank's frames)."""
    log_spec = log_power(s)
    if ref is None:
        ref = log_spec.amax(dim=(-2, -1), keepdim=True)
    return torch.clamp_min(log_spec - ref, -top_db)


def log_mel(frames: torch.Tensor, consts: dict, eps: float = 1e-6,
            fft: str = "matmul") -> torch.Tensor:
    """Natural-log mel (the common NN frontend variant)."""
    return torch.log(melspectrogram(frames, consts, fft=fft) + eps)


def mfcc(frames: torch.Tensor, consts: dict, fft: str = "matmul") -> torch.Tensor:
    """MFCC: DCT-II(ortho) over power-dB mel (per-example max reference)."""
    return mm(power_to_db(melspectrogram(frames, consts, fft=fft)), consts["dct"])


def waveform_to_features(
    signal: torch.Tensor,
    consts: dict,
    win_length: int,
    hop_length: int,
    num_frames: int,
    feature: str = "mfcc",
    fused: bool = False,
    fft: str = "matmul",
) -> torch.Tensor:
    """``[B, N] → [B, T, n_feat]``. ``fused=True`` takes the hand-written
    kernels with the JAX package's dispatch: ``logmel`` → K4 (log); MFCC →
    K3 while ``mfcc_fused_fits`` holds, else K4's raw mel, then dB and DCT.
    ``fft="stockham"`` drops ``fused``, as the JAX package does: the
    accuracy-first FFT runs on the plain chain, through no kernel."""
    if fft not in ("matmul", "stockham"):
        raise ValueError(f"unknown fft {fft!r} (matmul | stockham)")
    if feature not in ("mfcc", "logmel"):
        raise ValueError(f"unknown feature {feature!r}")
    frames = frame_signal(signal, win_length, hop_length, num_frames)
    if fused and fft == "matmul":
        from mmbidaf_tpu_torch.ops.cuda.melspec_kernel import (
            log_mel_fused,
            mfcc_fused,
            mfcc_fused_fits,
        )

        if feature == "logmel":
            return log_mel_fused(frames, consts, log=True)
        if mfcc_fused_fits(num_frames, win_length,
                           consts["cos"].shape[1], consts["mel_fb"].shape[1]):
            return mfcc_fused(frames, consts)
        return mm(power_to_db(log_mel_fused(frames, consts, log=False)), consts["dct"])
    if feature == "mfcc":
        return mfcc(frames, consts, fft=fft)
    return log_mel(frames, consts, fft=fft)
