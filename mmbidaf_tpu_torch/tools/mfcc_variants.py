"""K3's FFT route (the serving MFCC) against a variant of its design, on one
card: the evidence behind its f64 FFT.

The variant is built from a copy of ``csrc/`` with one change (``mfcc.cu``
only, with ``nvcc`` into ``mmbidaf_tpu_torch/_build/variants/``):

- ``f32``: K3's FFT in f32 on f32 twiddles, as K4 runs it (the sources run
  K3's in f64).

Both run at the bench shape (B=64, T=512, n_fft 512, win 400, hop 160, 64
mels, 40 MFCCs) on white noise x 0.1 and on :func:`wide_signal` (mel bands
more than 60 dB apart), each with a silent example: the CUDA-event time of
one call (the median of five means of 20 calls), the max abs distance from
the plain version and from :func:`f64_mfcc`, and whether the silent
example is exactly 0.

    python -m mmbidaf_tpu_torch.tools.mfcc_variants [--out F]

Needs an NVIDIA GPU with ``nvcc``; exits non-zero without one. The wide
signal and the f64 MFCC are also what ``chip_smoke.py`` and the tests hold
K3 to.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys

import numpy as np
import torch

from mmbidaf_tpu_torch.ops import audio
from mmbidaf_tpu_torch.ops.cuda import build
from mmbidaf_tpu_torch.ops.cuda import melspec_kernel as mk

VARIANTS = {
    "f32": {"mfcc.cu": [("template <> struct FftReal<kDb> { using T = double; };",
                         "template <> struct FftReal<kDb> { using T = float; };")]},
}
TWIDDLE_DTYPE = {"f32": torch.float32}
_ENTRY = "mmb_mfcc_fft_forward"


def wide_signal(rng, batch: int, n: int, sample_rate: int = 16000) -> np.ndarray:
    """f32 waveforms ``[batch, n]`` whose mel bands span more than 60 dB: a
    loud low sine (0.5 at 220 Hz) over weak noise (1e-3), with a quiet
    stretch (1e-5) from a third to half of the waveform."""
    sig = 0.5 * np.sin(2.0 * np.pi * 220.0 * np.arange(n) / sample_rate)
    sig = sig + 1e-3 * rng.standard_normal((batch, n))
    sig[:, n // 3:n // 2] = 1e-5 * rng.standard_normal((batch, n // 2 - n // 3))
    return sig.astype(np.float32)


def f64_mfcc(frames, consts) -> np.ndarray:
    """The MFCC of ``frames [B, T, win]`` in f64 on the host: the f64 Hann
    window, ``numpy.fft.rfft``, the filterbank and DCT widened to f64, the
    dB against each example's maximum, clamped at -80."""
    x = np.asarray(frames.double().cpu() if isinstance(frames, torch.Tensor) else frames,
                   np.float64)
    win, n_fft = x.shape[-1], 2 * (consts["cos"].shape[1] - 1)
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win) / win)
    power = np.abs(np.fft.rfft(x * window, n=n_fft)) ** 2
    log_spec = 10.0 * np.log10(np.maximum(power @ consts["mel_fb"].double().cpu().numpy(), 1e-10))
    db = np.maximum(log_spec - log_spec.max(axis=(1, 2), keepdims=True), -80.0)
    return db @ consts["dct"].double().cpu().numpy()


def build_variant(name: str) -> ctypes.CDLL:
    """The variant's K3 in a library of its own."""
    out = build.BUILD_DIR / "variants" / f"mfcc_{name}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC, out)
    for fname, edits in VARIANTS[name].items():
        text = (out / fname).read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {fname} does not hold the text to replace once")
            text = text.replace(old, new)
        (out / fname).write_text(text)
    lib_path = out / "lib.so"
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-o", str(lib_path), str(out / "mfcc.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    fn = getattr(lib, _ENTRY)
    fn.argtypes = list(build.SIGNATURES[_ENTRY])
    fn.restype = ctypes.c_int
    return lib


def run_variant(lib, frames: torch.Tensor, consts: dict, twiddle_dtype) -> torch.Tensor:
    """One call of a variant's K3 FFT route on f32 ``frames [B, T, win]``
    whose last stride is 1."""
    B, T, win = frames.shape
    n_mels, n_mfcc = consts["dct"].shape
    window, twiddle, ranges, weights = mk._fft_operands(consts, twiddle_dtype)
    logmel = torch.empty(B, T, n_mels, device=frames.device)
    tile_max = torch.empty(B, -(-T // mk.FFT_FRAMES), device=frames.device)
    out = torch.empty(B, T, n_mfcc, device=frames.device)
    rc = getattr(lib, _ENTRY)(
        frames.data_ptr(), frames.stride(0), frames.stride(1), window.data_ptr(),
        twiddle.data_ptr(), weights.data_ptr(), ranges.data_ptr(), consts["dct"].data_ptr(),
        logmel.data_ptr(), tile_max.data_ptr(), out.data_ptr(), B, T, win,
        2 * (consts["cos"].shape[1] - 1), n_mels, weights.numel(), n_mfcc,
        torch.cuda.current_stream(frames.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{_ENTRY} failed to launch: cudaError {rc}")
    return out


def _events_ms(fn, iters: int = 20, reps: int = 5) -> float:
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mfcc_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    B, T, win, hop = 64, 512, 400, 160
    consts = audio.make_audio_frontend_consts(16000, 512, win, 64, 40, device=dev)
    rng = np.random.default_rng(5)
    n = (T - 1) * hop + win
    signals = {"noise": (rng.standard_normal((B, n)) * 0.1).astype(np.float32),
               "wide": wide_signal(rng, B, n)}
    libs = {name: build_variant(name) for name in VARIANTS}
    rows = []
    for kind, sig in signals.items():
        sig[1] = 0.0
        frames = audio.frame_signal(torch.from_numpy(sig).to(dev), win, hop, T)
        plain = mk.mfcc_reference(frames, consts)
        ref = f64_mfcc(frames, consts)
        runs = {"sources": lambda: mk._mfcc_launch(frames, consts, "fft")}
        for name, lib in libs.items():
            runs[name] = lambda lib=lib, name=name: run_variant(lib, frames, consts, TWIDDLE_DTYPE[name])
        for name, run in runs.items():
            out = run()
            row = {"variant": name, "signal": kind, "ms": _events_ms(run),
                   "vs_plain": (out - plain).abs().max().item(),
                   "vs_f64": float(np.abs(out.double().cpu().numpy() - ref).max()),
                   "silent_exact": not out[1].any().item()}
            rows.append(row)
            print(json.dumps(row), flush=True)
        print(json.dumps({"variant": "plain", "signal": kind,
                          "vs_f64": float(np.abs(plain.double().cpu().numpy() - ref).max())}),
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
