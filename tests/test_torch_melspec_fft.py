"""K4's and K3's FFT routes on the CPU (``ops/cuda/melspec_kernel.py``):
what they rest on, and what the wrappers hand the kernels.

- The identity: the frontend's bases fold a periodic Hann window and a zero
  pad at the end into the DFT (``ops/audio.py::make_audio_frontend_consts``),
  so the power of ``torch.fft.rfft(window · frame, n=n_fft)``, with the
  window taken from ``consts["cos"][:, 0]``, is ``ops/audio.py::power_spectrum``
  (and the JAX package's, on the same numpy inputs), at the bench shape
  (n_fft 512, win 400, hop 160).
- The route rule (``log_mel_route``), the basis check (``dft_basis_error``),
  the twiddle table, and the filterbank's nonzeros (``mel_nonzeros``) at the
  bench, long-audio, test and card-test configurations.
- The kernel's FFT, step for step in numpy (``csrc/mfcc.cu::frame_power_fft``:
  bit-reversed load of ``z[n] = x[2n] + i·x[2n+1]``, radix-2 stages, the
  real-FFT split), against ``numpy.fft.rfft``, on K4's f32 twiddles and on
  K3's f64 ones.
- K3's FFT route step for step (``logmel_fft_kernel<kDb>``: the FFT in f64,
  the mel product over each column's nonzero bins in f32 fused
  multiply-adds, the dB, the maxima of blocks of 8 frames, then
  ``mfcc_dct_kernel``: the example's maximum, the -80 dB clamp and the DCT)
  against JAX's ``mfcc_fused`` (Pallas, interpret mode) and the port's plain
  ``audio.mfcc`` at the bench shape (B=2, T=509: a partial last block of
  frames, a silent example), on white noise and on a signal whose mel bands
  span more than 60 dB (a loud low sine over weak noise, with a quiet
  stretch; ``tools/mfcc_variants.py::wide_signal``), and against an f64
  MFCC (``mfcc_variants.f64_mfcc``: ``numpy.fft.rfft``, f64 window): the
  FFT route is closer to it than either dense f32 reference.

Tolerances: f32 on both sides, sums in other orders. Powers and mels are
held normwise at ``LOG_MEL_TOLERANCE[False]`` (``rtol = 1e-5`` of the
largest value), log-mels elementwise at ``LOG_MEL_TOLERANCE[True]``, as the
card holds K4 against its plain version. The emulation runs in f64 on the
f32 twiddle table and is held at 2e-6 of the largest power (f32 twiddles,
~6e-8 each, through up to 10 stages), on the f64 table at 1e-12. K3's
emulation is held against JAX and the plain version at K3's ``TOLERANCE``
(atol 1e-3, rtol 1e-5, the card's): on the wide signal both dense f32
references are themselves up to 7.3e-4 (JAX) and 5.9e-4 (plain) from the
f64 MFCC, where the emulation is 2.6e-4 from it (measured here), and the
emulation must be the closest of the three to the f64 MFCC.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmbidaf_tpu.ops import audio as j_audio
from mmbidaf_tpu.ops.pallas.melspec_kernel import mfcc_fused as j_mfcc_fused
from mmbidaf_tpu_torch.ops import audio
from mmbidaf_tpu_torch.ops.cuda import melspec_kernel as mk
from mmbidaf_tpu_torch.ops.cuda import build
from mmbidaf_tpu_torch.tools import mfcc_variants
from mmbidaf_tpu_torch.tools.mfcc_variants import f64_mfcc, wide_signal

# (sample rate, n_fft, win, n_mels): the bench and long-audio configurations
# (DataConfig's defaults), the tiny test config, the card tests' shapes.
CONFIGS = [(16000, 512, 400, 64), (16000, 64, 48, 12), (16000, 1024, 1024, 80),
           (16000, 400, 400, 40), (16000, 64, 48, 40), (16000, 2048, 2000, 128)]


def _consts(sr, n_fft, win, n_mels):
    return audio.make_audio_frontend_consts(sr, n_fft, win, n_mels, 13, device="cpu")


def _frames(rng, B, T, win, hop):
    sig = (rng.standard_normal((B, (T - 1) * hop + win)) * 0.1).astype(np.float32)
    sig[1] = 0.0  # a silent example
    return sig, audio.frame_signal(torch.from_numpy(sig), win, hop, T)


def _assert_normwise(out, ref, tol):
    err = (out - ref).abs().max().item()
    assert err <= tol["atol"] + tol["rtol"] * ref.abs().max().item(), err


def _rfft_power(frames, consts):
    """The FFT route's power spectrum: the window from ``cos[:, 0]``, the
    frame zero-padded at the end to n_fft."""
    n_fft = 2 * (consts["cos"].shape[1] - 1)
    return torch.fft.rfft(frames * consts["cos"][:, 0], n=n_fft).abs().square()


def test_rfft_power_is_the_matmul_power_spectrum_at_the_bench_shape():
    rng = np.random.default_rng(0)
    consts = _consts(16000, 512, 400, 64)
    _, frames = _frames(rng, 3, 24, 400, 160)
    _assert_normwise(_rfft_power(frames, consts), audio.power_spectrum(frames, consts),
                     mk.LOG_MEL_TOLERANCE[False])


def test_rfft_log_mel_is_the_plain_log_mel_at_the_bench_shape():
    rng = np.random.default_rng(1)
    consts = _consts(16000, 512, 400, 64)
    _, frames = _frames(rng, 3, 24, 400, 160)
    mel = _rfft_power(frames, consts) @ consts["mel_fb"]
    _assert_normwise(mel, audio.melspectrogram(frames, consts), mk.LOG_MEL_TOLERANCE[False])
    torch.testing.assert_close(torch.log(mel + 1e-6), mk.log_mel_reference(frames, consts),
                               **mk.LOG_MEL_TOLERANCE[True])


def test_rfft_power_is_the_jax_power_spectrum_at_the_bench_shape():
    rng = np.random.default_rng(2)
    consts = _consts(16000, 512, 400, 64)
    sig, frames = _frames(rng, 3, 24, 400, 160)
    j_frames = jnp.stack([jnp.asarray(sig[:, t * 160:t * 160 + 400]) for t in range(24)], 1)
    j_consts = {k: jnp.asarray(v.numpy()) for k, v in consts.items()}
    ref = torch.from_numpy(np.array(j_audio.power_spectrum(j_frames, j_consts)))
    _assert_normwise(_rfft_power(frames, consts), ref, mk.LOG_MEL_TOLERANCE[False])


@pytest.mark.parametrize("win,bins,route", [
    (400, 257, "fft"), (48, 33, "fft"), (1024, 513, "fft"), (2000, 1025, "fft"), (16, 9, "fft"),
    (400, 201, "dense"),   # n_fft 400: no power of two
    (4096, 2049, "fft"),    # n_fft 4096: 4 frames a block
    (8, 5, "dense"),        # n_fft 8: under its smallest size
    (600, 257, "dense"),    # win past n_fft
])
def test_log_mel_route(win, bins, route):
    assert mk.log_mel_route(win, bins) == route


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "-".join(map(str, c)))
def test_the_frontend_bases_pass_the_basis_check(cfg):
    consts = _consts(*cfg)
    assert mk.dft_basis_error(consts["cos"], consts["sin"]) <= mk._BASIS_RTOL


def test_fft_operands_of_inference_tensors():
    """Bases made (or weights loaded) under ``torch.inference_mode`` track no
    version counter: the FFT operands are built from them and cached once
    per tensor all the same, equal to those of ordinary tensors."""
    with torch.inference_mode():
        frozen = _consts(16000, 512, 400, 64)
    plain = _consts(16000, 512, 400, 64)
    got = mk._fft_operands(frozen, torch.float64)
    assert mk._fft_operands(frozen, torch.float64)[0] is got[0]  # cached
    for a, b in zip(got, mk._fft_operands(plain, torch.float64)):
        torch.testing.assert_close(a, b, atol=0.0, rtol=0.0)


def test_other_bases_fail_the_basis_check():
    """A perturbed entry, the zero pad at the start instead of the end, and
    the basis of another n_fft are not the window's DFT basis of n_fft."""
    consts = _consts(16000, 512, 400, 64)
    cos, sin = consts["cos"], consts["sin"]
    bent = sin.clone()
    bent[7, 9] += 1e-4
    assert mk.dft_basis_error(cos, bent) > mk._BASIS_RTOL
    window = torch.from_numpy(audio.hann_window(400))
    c512, s512 = (torch.from_numpy(b) for b in audio.dft_basis(512))
    front = (window[:, None] * c512[112:], window[:, None] * s512[112:])
    assert mk.dft_basis_error(*front) > mk._BASIS_RTOL
    c510, s510 = (torch.from_numpy(b) for b in audio.dft_basis(510))
    other = torch.zeros(400, 257), torch.zeros(400, 257)
    other[0][:, :256], other[1][:, :256] = window[:, None] * c510[:400], window[:, None] * s510[:400]
    assert mk.dft_basis_error(*other) > mk._BASIS_RTOL


@pytest.mark.parametrize("n_fft", [16, 512, 2048])
def test_twiddles(n_fft):
    """Each stage's table W_{2·half}^pos at half + pos, then the split's
    W_{n_fft}^k at n_fft/2 + k."""
    tw = mk.twiddles(n_fft, "cpu").double().numpy()
    tw = tw[:, 0] + 1j * tw[:, 1]
    M = n_fft // 2
    assert tw.shape == (n_fft,)
    half = 1
    while half < M:
        np.testing.assert_allclose(tw[half:2 * half], np.exp(-1j * np.pi * np.arange(half) / half),
                                   atol=6e-8, rtol=0)
        half *= 2
    np.testing.assert_allclose(tw[M:], np.exp(-2j * np.pi * np.arange(M) / n_fft), atol=6e-8, rtol=0)


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "-".join(map(str, c)))
def test_mel_nonzeros_cover_the_filterbank(cfg):
    """Each column's range holds every nonzero of ``mel_filterbank``, starts
    and ends on one, and the packed weights rebuild the filterbank."""
    fb = _consts(*cfg)["mel_fb"]
    ranges, weights = mk.mel_nonzeros(fb)
    assert ranges.dtype == torch.int32 and ranges.shape == (fb.shape[1], 4)
    rebuilt = torch.zeros_like(fb)
    offset = 0
    for m, (lo, hi, off, _) in enumerate(ranges.tolist()):
        nz = torch.nonzero(fb[:, m]).flatten().tolist()
        if not nz:
            assert (lo, hi) == (0, -1)
            continue
        assert (lo, hi) == (nz[0], nz[-1]) and off == offset
        rebuilt[lo:hi + 1, m] = weights[off:off + hi - lo + 1]
        offset += hi - lo + 1
    assert weights.numel() == offset
    assert torch.equal(rebuilt, fb)


def _kernel_fft_power(x, wnd, win, n_fft, dtype=torch.float32):
    """``csrc/mfcc.cu::frame_power_fft`` step for step in f64, on the
    wrapper's twiddle table in ``dtype`` (K4's f32, K3's f64), for frames
    ``x [..., >= win]``."""
    M = n_fft // 2
    log2m = M.bit_length() - 1
    tw = mk.twiddles(n_fft, "cpu", dtype).double().numpy()
    tw = tw[:, 0] + 1j * tw[:, 1]
    x = np.asarray(x, np.float64)
    xs = np.zeros((*x.shape[:-1], n_fft))
    xs[..., :win] = x[..., :win] * wnd[:win]
    n = np.arange(M)
    rev = np.array([int(format(i, f"0{log2m}b")[::-1], 2) for i in n])
    z = np.zeros((*x.shape[:-1], M), complex)
    z[..., rev] = xs[..., 0::2] + 1j * xs[..., 1::2]
    j = np.arange(M // 2)
    for s in range(log2m):
        half = 1 << s
        pos = j & (half - 1)
        i0 = ((j >> s) << (s + 1)) + pos
        i1 = i0 + half
        p, q = z[..., i0], z[..., i1] * tw[half + pos]
        z[..., i0], z[..., i1] = p + q, p - q
    k = np.arange(M + 1)
    p, q = z[..., k & (M - 1)], z[..., (M - k) & (M - 1)]
    e = 0.5 * (p + np.conj(q))
    o = -0.5j * (p - np.conj(q))
    w = np.where(k < M, tw[M + np.minimum(k, M - 1)], -1.0)
    return np.abs(e + w * o) ** 2


@pytest.mark.parametrize("n_fft,win", [(16, 16), (64, 48), (128, 100), (256, 256), (512, 400),
                                       (1024, 1024), (2048, 2000)])
def test_the_kernels_fft_is_the_rfft_power(n_fft, win):
    rng = np.random.default_rng(n_fft)
    x = rng.standard_normal(win)
    wnd = audio.hann_window(win).astype(np.float64)
    ref = np.abs(np.fft.rfft(x * wnd, n=n_fft)) ** 2
    got = _kernel_fft_power(x, wnd, win, n_fft)
    np.testing.assert_allclose(got, ref, atol=2e-6 * ref.max(), rtol=0)


@pytest.mark.parametrize("n_fft,win", [(16, 16), (512, 400), (2048, 2000)])
def test_k3s_f64_fft_is_the_rfft_power(n_fft, win):
    rng = np.random.default_rng(n_fft + 1)
    x = rng.standard_normal(win)
    wnd = audio.hann_window(win).astype(np.float64)
    ref = np.abs(np.fft.rfft(x * wnd, n=n_fft)) ** 2
    got = _kernel_fft_power(x, wnd, win, n_fft, torch.float64)
    np.testing.assert_allclose(got, ref, atol=1e-12 * ref.max(), rtol=0)


# ---------------------------------------------------------------------------
# K3's FFT route, step for step.
# ---------------------------------------------------------------------------

SR, N_FFT, WIN, HOP, N_MELS, N_MFCC = 16000, 512, 400, 160, 64, 40  # the bench's audio
K3_FRAMES = 8  # frames a block of the first pass (csrc/mfcc.cu::kFftFrames)


def _fma32(a, b, c):
    """f32 ``fmaf(a, b, c)``: the product is exact in f64, one rounding to f32."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def _k3_fft_mfcc(frames, consts):
    """``mfcc_fused``'s FFT route on ``frames [B, T, win]`` (numpy f32), step
    for step: the power spectrum in f64 (stored as f32), the mel product
    over each column's nonzero bins in ascending k, the dB, each block's
    maximum, then the DCT pass."""
    B, T, win = frames.shape
    n_fft = 2 * (consts["cos"].shape[1] - 1)
    wnd = consts["cos"][:, 0].double().numpy()
    pw = _kernel_fft_power(frames.reshape(-1, win), wnd, win, n_fft, torch.float64)
    pw = pw.astype(np.float32)
    ranges, weights = mk.mel_nonzeros(consts["mel_fb"])
    weights = weights.numpy()
    acc = np.zeros((pw.shape[0], ranges.shape[0]), np.float32)
    for m, (lo, hi, off, _) in enumerate(ranges.tolist()):
        for k in range(lo, hi + 1):
            acc[:, m] = _fma32(pw[:, k], weights[off + k - lo], acc[:, m])
    ln10 = np.float32(2.302585093)
    db = np.float32(10.0) * (np.log(np.maximum(acc, np.float32(1e-10))) / ln10)
    db = db.reshape(B, T, -1)
    blocks = -(-T // K3_FRAMES)
    padded = np.full((B, blocks * K3_FRAMES, db.shape[-1]), -np.inf, np.float32)
    padded[:, :T] = db
    block_max = padded.reshape(B, blocks, -1).max(axis=-1)
    clamped = np.maximum(db - block_max.max(axis=1)[:, None, None], np.float32(-80.0))
    dct = consts["dct"].numpy()
    out = np.zeros((B, T, dct.shape[1]), np.float32)
    for m in range(dct.shape[0]):
        out = _fma32(clamped[:, :, m:m + 1], dct[m], out)
    return out


def _k3_signal(rng, B, T, kind):
    """White noise x 0.1, or ``mfcc_variants.wide_signal`` (a loud low sine
    over weak noise, with a quiet stretch from a third to half of the
    waveform); example 1 silent."""
    n = (T - 1) * HOP + WIN
    sig = (rng.standard_normal((B, n)) * 0.1).astype(np.float32) if kind == "noise" else \
        wide_signal(rng, B, n, SR)
    sig[1] = 0.0
    return sig


def test_the_wide_signal_spans_60_db():
    """Its mel bands span more than 60 dB below the example's maximum (the
    quiet stretch more than 80), so weak bands far below each frame's peak
    reach the DCT."""
    consts = _consts(SR, N_FFT, WIN, N_MELS)
    sig = _k3_signal(np.random.default_rng(0), 2, 509, "wide")
    frames = audio.frame_signal(torch.from_numpy(sig), WIN, HOP, 509)
    log_spec = audio.log_power(audio.melspectrogram(frames[0], consts))
    loud = log_spec[:150]  # before the quiet stretch
    assert (log_spec.max() - loud.min()).item() > 60.0
    assert (log_spec.max() - log_spec[200:240].max()).item() > 80.0


@pytest.mark.parametrize("kind", ["noise", "wide"])
def test_k3_fft_route_matches_jax_and_the_plain_mfcc(kind):
    rng = np.random.default_rng(0)
    B, T = 2, 509  # T: a partial last block of 8 frames
    consts = audio.make_audio_frontend_consts(SR, N_FFT, WIN, N_MELS, N_MFCC, device="cpu")
    assert mk.mfcc_route(WIN, N_FFT // 2 + 1) == "fft"
    sig = _k3_signal(rng, B, T, kind)
    frames = audio.frame_signal(torch.from_numpy(sig), WIN, HOP, T)
    emu = _k3_fft_mfcc(frames.numpy(), consts)
    j_consts = {k: jnp.asarray(v.numpy()) for k, v in consts.items()}
    jx = np.asarray(j_mfcc_fused(j_audio.frame_signal(jnp.asarray(sig), WIN, HOP, T), j_consts,
                                 interpret=True))
    plain = mk.mfcc_fused(frames, consts).numpy()  # the wrapper's plain version on the CPU
    assert not emu[1].any() and not plain[1].any()  # the silent example is exactly 0
    np.testing.assert_allclose(emu, jx, **mk.TOLERANCE)
    np.testing.assert_allclose(emu, plain, **mk.TOLERANCE)
    ref = f64_mfcc(frames, consts)
    dist = {name: np.abs(v[0] - ref[0]).max() for name, v in (("fft", emu), ("jax", jx),
                                                                ("plain", plain))}
    if kind == "wide":
        assert dist["fft"] <= min(dist["jax"], dist["plain"]), dist
    assert dist["fft"] <= mk.TOLERANCE["atol"] / 2, dist


@pytest.mark.parametrize("win,bins,route", [
    (400, 257, "fft"), (48, 33, "fft"), (1024, 513, "fft"), (16, 9, "fft"),
    (400, 201, "dense"), (4096, 2049, "fft"), (8, 5, "dense"), (600, 257, "dense"),
])
def test_mfcc_route(win, bins, route):
    """K3 takes K4's rule to n_fft 4096: the FFT route for a power-of-two
    n_fft from 16 and win <= n_fft, the dense one otherwise."""
    assert mk.mfcc_route(win, bins) == route == mk.log_mel_route(win, bins)


@pytest.mark.parametrize("variant", sorted(mfcc_variants.VARIANTS))
def test_mfcc_variants_edit_the_sources_once(variant):
    """Each variant of ``tools/mfcc_variants.py`` finds every text it
    replaces exactly once in the checkout's sources."""
    for fname, edits in mfcc_variants.VARIANTS[variant].items():
        text = (build.CSRC / fname).read_text()
        assert [text.count(old) for old, _ in edits] == [1] * len(edits), fname


def test_mfcc_variants_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert mfcc_variants.main([]) == 1
