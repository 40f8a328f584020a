#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (built for H100, sm_90a).

Run from the repository root:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:
  1. device: the ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
  2. build: the three CUDA kernels, with ``nvcc``, from ``mmbidaf_tpu_torch/csrc``;
  3. kernels: each kernel against its plain PyTorch version on the card at the
     main path's shapes and at a small ragged shape (fully masked rows, a
     silent audio example), max error against the module's stated bound, and
     the median time of each (CUDA events);
  4. the serving slice at the bench configuration (``bench.py::build_bench_config``:
     VGG-16 at 224², hidden 128, vocab 20000, T_s=32 x W=16, 16 keyframes,
     512 audio frames, K=4, bf16, all three kernel flags on):
     (a) ``make_end_to_end_decode`` on a seeded raw batch of B=64 (frames
         240x320), checked and timed (videos/s);
     (b) ``Summarizer.summarize_batch`` answering 8 requests on a synthetic
         corpus written by ``examples/make_synthetic_corpus.py``;
     (c) every kernel's launch counter rose during (a) and (b);
     (d) an f32 copy of the (a) batch through the kernels and through the
         plain versions (TF32 off for both): equal picks, close log-probs.
The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. The random weights come from seeds.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
B = 64  # the bench batch
FRAME_HW = (240, 320)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, iters: int, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls,
    on CUDA events, after two warm-up calls."""
    import torch

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


def bench_config():
    from mmbidaf_tpu_torch.config import Config, DataConfig, ModelConfig

    data = DataConfig(max_sentences=32, max_words=16, max_keyframes=16, max_audio_frames=512,
                      vocab_size=20000, image_size=224)
    model = ModelConfig(hidden_size=128, img_feat_dim=4096, audio_feat_dim=40, drop_prob=0.0,
                        max_decode_steps=4, compute_dtype="bfloat16",
                        use_pallas_attention=True, use_pallas_lstm=True,
                        use_pallas_melspec=True)
    return Config(model=model, data=data)


def ragged_mask(rng, n: int, t: int, lo: int = 1, empty_row: int | None = None) -> np.ndarray:
    lengths = rng.integers(lo, t + 1, size=n)
    lengths[0] = t
    if empty_row is not None:
        lengths[empty_row] = 0
    return (np.arange(t)[None] < lengths[:, None]).astype(np.float32)


def raw_batch(cfg, rng) -> dict[str, np.ndarray]:
    """The layout of ``bench.py::make_raw_batch``: ragged transcripts, random
    uint8 keyframes, a noise waveform (one silent track)."""
    d, m = cfg.data, cfg.model
    T_s, W = d.max_sentences, d.max_words
    sent_mask = ragged_mask(rng, B, T_s, lo=max(m.max_decode_steps, 2))
    word_mask = (np.arange(W)[None, None] < rng.integers(1, W + 1, size=(B, T_s))[:, :, None])
    word_mask = word_mask.astype(np.float32) * sent_mask[:, :, None]
    text_ids = np.where(word_mask > 0, rng.integers(2, d.vocab_size, size=(B, T_s, W)), 0)
    n_samples = d.max_audio_frames * d.hop_length + d.win_length
    waveform = (rng.standard_normal((B, n_samples)) * 0.1).astype(np.float32)
    waveform[1] = 0.0
    return {
        "text_ids": text_ids.astype(np.int32),
        "word_mask": word_mask,
        "sent_mask": sent_mask,
        "img_mask": ragged_mask(rng, B, d.max_keyframes),
        "aud_mask": ragged_mask(rng, B, d.max_audio_frames),
        "frames": (rng.random((B, d.max_keyframes, *FRAME_HW, 3)) * 255).astype(np.uint8),
        "waveform": waveform,
    }


def phase_kernels(dev, cfg) -> list[dict]:
    """Each kernel against its plain version: bench shapes plus a small ragged
    one. Returns the per-kernel records of the JSON line (launches filled in
    later from the main path's run)."""
    import torch

    from mmbidaf_tpu_torch.ops import audio
    from mmbidaf_tpu_torch.ops.bidaf import BiDAFParams
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel, lstm_kernel, melspec_kernel
    from mmbidaf_tpu_torch.ops.lstm import BiLSTMParams

    rng = np.random.default_rng(7)
    gen = torch.Generator(device=dev).manual_seed(7)
    h, d = cfg.model.hidden_size, cfg.data
    T_s, W = d.max_sentences, d.max_words

    def t(x):
        return torch.from_numpy(x).to(dev)

    def leaves(x):
        return [y for v in x for y in leaves(v)] if isinstance(x, tuple) else [x]

    def compare(name, out, ref, tol):
        err = 0.0
        for o, r in zip(leaves(out), leaves(ref), strict=True):
            check(o.shape == r.shape and o.dtype == r.dtype,
                  f"{name}: {o.shape}/{o.dtype} vs {r.shape}/{r.dtype}")
            check(bool(torch.isfinite(o).all()), f"{name}: non-finite kernel output")
            e = (o - r).abs()
            bound = tol["atol"] + tol["rtol"] * r.abs()
            check(bool((e <= bound).all()), f"{name}: max abs err {e.max().item():.3e} over the bound")
            err = max(err, e.max().item())
        return err

    records = []

    # K1: the five BiLSTM towers at bench shapes (rows, steps, input width), then small.
    lstm_shapes = [("word", B * T_s, W, h), ("sentence", B, T_s, 2 * h),
                   ("image", B, d.max_keyframes, cfg.model.img_feat_dim),
                   ("audio", B, d.max_audio_frames, cfg.model.audio_feat_dim),
                   ("modeling", B, T_s, 2 * h), ("small-ragged", 5, 7, 6)]
    err, ms, plain_ms = 0.0, 0.0, 0.0
    for tag, rows, steps, width in lstm_shapes:
        hid = h if tag != "small-ragged" else 8
        p = BiLSTMParams(width, hid, gen, dev)
        x = t(rng.standard_normal((rows, steps, width)).astype(np.float32))
        m = t(ragged_mask(rng, rows, steps, lo=0, empty_row=1))
        e = compare(f"bilstm[{tag}]", lstm_kernel.bilstm_cuda(p, x, m), lstm_kernel.bilstm_reference(p, x, m),
                    lstm_kernel.TOLERANCE)
        out = lstm_kernel.bilstm_cuda(p, x, m)
        check(not out[0][1].any() and not out[1][0][1].any(), f"bilstm[{tag}]: fully masked row not zero")
        err = max(err, e)
        if tag != "small-ragged":
            k = time_ms(lambda: lstm_kernel.bilstm_cuda(p, x, m), iters=10)
            pl = time_ms(lambda: lstm_kernel.bilstm_reference(p, x, m), iters=2, reps=3)
            ms, plain_ms = ms + k, plain_ms + pl
            print(f"  K1 bilstm {tag:9s} rows={rows:5d} T={steps:4d} in={width:5d}: "
                  f"max_abs_err={e:.3e} kernel={k:.4f} ms plain={pl:.4f} ms", flush=True)
        else:
            print(f"  K1 bilstm {tag}: max_abs_err={e:.3e}", flush=True)
    records.append({"name": "bilstm", "route": "cuda", "source": "mmbidaf_tpu_torch/csrc/lstm.cu",
                    "replaces": "mmbidaf_tpu/ops/pallas/lstm_kernel.py:25", "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms})
    print(f"K1 bilstm: bound {lstm_kernel.TOLERANCE}, max_abs_err={err:.3e}, "
          f"per batch (5 towers) kernel={ms:.4f} ms plain={plain_ms:.4f} ms", flush=True)

    # K2: image (T_q=16) and audio (T_q=512) attention at bench shapes, then small.
    D = 2 * h
    err, ms, plain_ms = 0.0, 0.0, 0.0
    for tag, bb, tc, tq, dd in [("image", B, T_s, d.max_keyframes, D),
                                ("audio", B, T_s, d.max_audio_frames, D),
                                ("small-ragged", 3, 7, 45, 20)]:
        p = BiDAFParams(dd, gen, dev)
        with torch.no_grad():
            p.bias.fill_(0.25)
        c = t(rng.standard_normal((bb, tc, dd)).astype(np.float32))
        q = t(rng.standard_normal((bb, tq, dd)).astype(np.float32))
        cm = t(ragged_mask(rng, bb, tc, lo=0, empty_row=1))
        qm = t(ragged_mask(rng, bb, tq, lo=0, empty_row=2))
        e = compare(f"bidaf[{tag}]", bidaf_kernel.bidaf_attention_fused(p, c, q, cm, qm),
                    bidaf_kernel.bidaf_reference(p, c, q, cm, qm), bidaf_kernel.TOLERANCE)
        err = max(err, e)
        if tag != "small-ragged":
            k = time_ms(lambda: bidaf_kernel.bidaf_attention_fused(p, c, q, cm, qm), iters=20)
            pl = time_ms(lambda: bidaf_kernel.bidaf_reference(p, c, q, cm, qm), iters=20)
            ms, plain_ms = ms + k, plain_ms + pl
            print(f"  K2 bidaf {tag:5s} B={bb} T_c={tc} T_q={tq} D={dd}: max_abs_err={e:.3e} "
                  f"kernel={k:.4f} ms plain={pl:.4f} ms", flush=True)
        else:
            print(f"  K2 bidaf {tag}: max_abs_err={e:.3e}", flush=True)
    try:
        big = torch.zeros(1, 32, D, device=dev)
        bidaf_kernel.bidaf_attention_fused(BiDAFParams(D, gen, dev), big, torch.zeros(1, 1024, D, device=dev),
                                           torch.ones(1, 32, device=dev), torch.ones(1, 1024, device=dev))
        fail("bidaf: a T_q=1024 shape past the shared-memory bound was not refused")
    except ValueError as e:
        print(f"  K2 bidaf refuses T_q=1024: {e}", flush=True)
    records.append({"name": "bidaf_attention", "route": "cuda", "source": "mmbidaf_tpu_torch/csrc/bidaf.cu",
                    "replaces": "mmbidaf_tpu/ops/pallas/bidaf_kernel.py:31", "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms})
    print(f"K2 bidaf: bound {bidaf_kernel.TOLERANCE}, max_abs_err={err:.3e}, "
          f"per batch (2 calls) kernel={ms:.4f} ms plain={plain_ms:.4f} ms", flush=True)

    # K3: the bench's MFCC (B=64, T=512, win 400, n_fft 512), then small; one silent example each.
    err = 0.0
    for tag, bb, steps in [("bench", B, d.max_audio_frames), ("small-ragged", 3, 37)]:
        consts = audio.make_audio_frontend_consts(d.sample_rate, d.n_fft, d.win_length, d.n_mels,
                                                  d.n_mfcc, d.fmin, d.fmax, device=dev)
        sig = rng.standard_normal((bb, (steps - 1) * d.hop_length + d.win_length)).astype(np.float32) * 0.1
        sig[1] = 0.0
        frames = audio.frame_signal(t(sig), d.win_length, d.hop_length, steps)
        out = melspec_kernel.mfcc_fused(frames, consts)
        e = compare(f"mfcc[{tag}]", out, melspec_kernel.mfcc_reference(frames, consts),
                    melspec_kernel.TOLERANCE)
        check(not out[1].any(), f"mfcc[{tag}]: the silent example is not all zero")
        err = max(err, e)
        if tag == "bench":
            ms = time_ms(lambda: melspec_kernel.mfcc_fused(frames, consts), iters=20)
            plain_ms = time_ms(lambda: melspec_kernel.mfcc_reference(frames, consts), iters=20)
            print(f"  K3 mfcc B={bb} T={steps}: max_abs_err={e:.3e} kernel={ms:.4f} ms "
                  f"plain={plain_ms:.4f} ms", flush=True)
        else:
            print(f"  K3 mfcc {tag}: max_abs_err={e:.3e}", flush=True)
    records.append({"name": "mfcc", "route": "cuda", "source": "mmbidaf_tpu_torch/csrc/mfcc.cu",
                    "replaces": "mmbidaf_tpu/ops/pallas/melspec_kernel.py:87", "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms})
    print(f"K3 mfcc: bound {melspec_kernel.TOLERANCE}, max_abs_err={err:.3e}, "
          f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms", flush=True)
    return records


def check_decode(lp, picks, raw, cfg, tag: str) -> None:
    K, T_s = cfg.model.max_decode_steps, cfg.data.max_sentences
    check(tuple(lp.shape) == (B, K, T_s) and tuple(picks.shape) == (B, K),
          f"{tag}: shapes {lp.shape} {picks.shape}")
    check(bool(np.isfinite(lp).all()), f"{tag}: non-finite log-probs")
    check(bool(((picks >= 0) & (picks < T_s)).all()), f"{tag}: picks out of range")
    sm = raw["sent_mask"]
    for b in range(B):
        check(all(sm[b, p] == 1 for p in picks[b]), f"{tag}: row {b} picked a padded sentence")
        check(len(set(picks[b].tolist())) == K, f"{tag}: row {b} repeated a pick")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs the card")
    sys.path.insert(0, ROOT)
    from mmbidaf_tpu_torch.data.frontend import make_end_to_end_decode
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel, build, lstm_kernel, melspec_kernel
    from mmbidaf_tpu_torch.serving import Summarizer

    # 1. device. TF32 is off for both products and convolutions: every f32
    # comparison below is held at f32.
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    name = torch.cuda.get_device_name(0)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}); "
          f"matmul.allow_tf32=False cudnn.allow_tf32=False", flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s (nvcc, sm_90a)", flush=True)

    # 3. kernels against their plain versions
    cfg = bench_config()
    records = phase_kernels(dev, cfg)

    # 4. the slice at the bench config
    t0 = time.perf_counter()
    s = Summarizer.init_random(cfg, seed=0, device=dev, serve_batch_size=4)
    torch.cuda.synchronize()
    print(f"slice: bench config, random weights from seed 0, init "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(0)
    raw_np = raw_batch(cfg, rng)
    raw = {k: torch.from_numpy(v).to(dev) for k, v in raw_np.items()}
    end_to_end = make_end_to_end_decode(cfg)
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_corpus", os.path.join(ROOT, "examples", "make_synthetic_corpus.py"))
    corpus_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(corpus_mod)

    counters = (lstm_kernel.bilstm_cuda, bidaf_kernel.bidaf_attention_fused, melspec_kernel.mfcc_fused)
    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    # (a) the end-to-end program at B=64
    lp, picks = end_to_end(s.model, s.frontend, raw)
    torch.cuda.synchronize()
    check_decode(lp.cpu().numpy(), picks.cpu().numpy(), raw_np, cfg, "end-to-end bf16")
    batch_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        end_to_end(s.model, s.frontend, raw)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
    t_batch = statistics.median(batch_s)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"(a) end-to-end B={B}: median batch {t_batch * 1e3:.2f} ms over 5 -> "
          f"{B / t_batch:.2f} videos/s on {card}; peak memory {peak_gb:.2f} GB", flush=True)
    # (b) 8 requests through the serving API
    with tempfile.TemporaryDirectory() as tmp:
        corpus_mod.make_corpus(tmp, videos=8, sentences=12, frames=10, seconds=4.0, seed=0)
        dirs = sorted(os.path.join(tmp, v) for v in os.listdir(tmp))
        t0 = time.perf_counter()
        summaries = s.summarize_batch(dirs)
        dt = time.perf_counter() - t0
    check(len(summaries) == 8 and all(isinstance(x, str) and x for x in summaries),
          "summarize_batch: empty or missing summaries")
    print(f"(b) summarize_batch: 8 requests answered in {dt:.2f} s; first: {summaries[0][:80]!r}", flush=True)
    # (c) the main path went through every kernel
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"(c) launches during (a)+(b): {launches}", flush=True)
    for rec, fn in zip(records, counters):
        check(fn.launches > 0, f"{fn.__name__} was never launched on the main path")
        rec["launches"] = fn.launches

    # (d) f32: kernels vs plain versions, same weights, same batch
    cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32"))
    plain = dataclasses.replace(cfg32, model=dataclasses.replace(
        cfg32.model, use_pallas_lstm=False, use_pallas_attention=False, use_pallas_melspec=False))
    fe32 = s.frontend
    fe32.vgg.float()  # in place: the served bf16 VGG weights, exactly, in f32
    lp_k, picks_k = make_end_to_end_decode(cfg32)(s.model, fe32, raw)
    lp_p, picks_p = make_end_to_end_decode(plain)(s.model, fe32, raw)
    lp_k, lp_p = lp_k.cpu().numpy(), lp_p.cpu().numpy()
    check_decode(lp_k, picks_k.cpu().numpy(), raw_np, cfg, "end-to-end f32 kernels")
    check(bool((picks_k == picks_p).all()), "f32: kernel and plain picks differ")
    valid = lp_p > -1e29
    dmax = float(np.abs(lp_k - lp_p)[valid].max())
    check(dmax <= 1e-3, f"f32: kernel vs plain log-probs differ by {dmax:.3e} > 1e-3")
    print(f"(d) f32 B={B}: picks equal; log-prob max abs diff {dmax:.3e} (bound 1e-3)", flush=True)

    leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
    check(not leaked, f"jax was imported: {leaked[:5]}")

    print(card, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
