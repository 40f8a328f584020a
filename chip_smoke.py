#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (built for H100, sm_90a).

Run from the repository root:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:
  1. device: the ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``,
     and cuDNN's TF32 flag, which must be its default (on): the script does
     not switch it off, so its f32 phases run the convs as a user's process
     does (``vgg_features`` and the conv plain version pin full f32 themselves);
  2. build: the CUDA kernels, with ``nvcc`` (one per source, in parallel),
     from ``mmbidaf_tpu_torch/csrc``;
  3. kernels: each kernel against its plain PyTorch version on the card at the
     main paths' shapes and at a small ragged shape (fully masked rows, a
     silent audio example, dropped BiDAF operands cd != c), max error against
     the module's stated bound, the median time of each and of one PyTorch
     library call computing the same function where there is one (CUDA
     events), its bound from the H100's published peaks, and for K1-K9 that
     two runs agree bit for bit; K2 on its cluster route at the image and
     audio towers with its plan, K7's bits at cd = c, qd = q, its device
     time, ptxas's report, and T_q one past the plan's edge handed to K9;
     K3 on its FFT route at the bench shape on white noise and on a signal
     whose mel bands span more than 60 dB (held against an f64 MFCC with
     the plain version and the dense route), its dense route at n_fft=400,
     the silent example exactly 0, the device time of each pass, ptxas's
     report and the FFT body's shared memory; K1's route (cluster) and
     cluster plan per tower, its kernel alone in microseconds a step at the
     audio (B=64, T=512) and long-audio (B=16, T=4096) towers, ptxas's
     registers, spills and shared memory of its kernels, and its L2 route
     at H=512; K5-K8's device time from ``torch.profiler``, their cluster
     plans and ptxas's reports; K4 (tiled mel, both modes) on its FFT
     route at the long-audio and log-mel shapes, its dense route at a small
     n_fft=400 shape, the silent example exact, ptxas's reports and the FFT
     body's shared memory; K9 at the long-audio attention shape and a
     small ragged one (twice bit for bit) with its walk plan, device time,
     achieved TFLOP/s and ptxas's report, and, for the record, beside K2
     at T_q=512 and 2048 (B=16); the VGG's conv epilogue at each VGG-16
     block shape of the (a) batch's frame chunk (bf16, channels-last), in
     place and pooled, equal to its plain version, its time beside the
     separate passes' and its byte bound;
  4. the serving slice at the bench configuration (``bench.py::build_bench_config``:
     VGG-16 at 224², hidden 128, vocab 20000, T_s=32 x W=16, 16 keyframes,
     512 audio frames, K=4, bf16, all three kernel flags on):
     (a) ``make_end_to_end_decode`` on a seeded raw batch of B=64 (frames
         240x320), checked and timed (videos/s), and a ``torch.profiler``
         breakdown of three batches;
     (b) ``Summarizer.summarize_batch`` answering 8 requests on a synthetic
         corpus written by ``examples/make_synthetic_corpus.py`` (the port's copy);
     (c) K1-K3's launch counters rose during (a) and (b), K1's and K2's on
         their cluster routes only, K3's on its FFT route only; the conv
         epilogue's rose 13 times a VGG pass (13 x the frame chunks of the
         first (a) batch);
     (d) an f32 copy of the (a) batch through the kernels and through the
         plain versions (full f32 convs for both; the conv epilogue's and
         K14's plain versions too, so that no VGG kernel runs on the plain
         side): equal picks, close log-probs;
  5. the training step at the ``bench_train.py --pallas`` configuration (the
     bench widths, B=32, f32, drop_prob 0.2, adadelta lr 0.5, clip 5.0,
     flat updates, EMA 0.999, the LSTM and attention kernel flags on) on one
     fixed ``synthetic_batch``:
     (a) TRAIN_STEPS steps of ``make_train_step``: finite loss and grad norm
         every step, the mean loss of the last 10 below that of the first 10,
         K5-K8's launch counters rose; the median step time (steps/s,
         videos/s) beside the card's name and power limit, and a
         ``torch.profiler`` breakdown of three steps;
     (b) at drop_prob 0, one step from the same state through the kernels
         and through the plain versions: loss, grad norm and every
         parameter after the step within TRAIN_PARITY_ATOL;
  6. long-video serving at the long-audio configuration
     (``examples/configs/config6_sp_long_audio.json`` on one device: 4096
     audio frames, vocab 50000, bf16, the three kernel flags on):
     (a) ``make_end_to_end_decode`` on a seeded raw batch of B=16, checked
         and timed; K1, K2, K4 and K9 ran, K3 did not; K1 on its cluster
         route only, K2's wrapper on its cluster route (the image tower) and
         K9 (the audio tower), K4 on its FFT route only;
     (b) ``Summarizer.summarize_long`` answering 2 requests with 41 s of
         audio and 80 transcript sentences (four windows), and
         ``summarize`` 1 more;
     (c) an f32 copy of the (a) batch at B=2 through the kernels and
         through the plain versions: equal picks, close log-probs;
     (d) the log-mel configuration (the bench config with
         ``audio_features="logmel"``): one B=64 batch through K4's log mode
         (its FFT route only), and f32 kernels vs plain at B=2: equal picks;
  7. the Winograd VGG frontend and the kernel-parity tool:
     (a) ``mmbidaf_tpu_torch.tools.kernel_parity`` in-process at batch 32:
         every kernel against its plain version at serving shapes, K11-K14
         at VGG-16's conv1_2, conv3_2 and conv5_x; every row must pass
         (K10-K13's launches are counted over this run, their path);
     (b) K10-K14 alone at the shapes their paths use (K10 and K11-K13 the
         tool's, K14 VGG-16's twelve C_in >= 32 convs at 256 frames): CUDA-event
         time, the plain version's, cuDNN's conv + bias + ReLU (K11-K14), the
         bound and the max error; K10 in f32 and bf16, twice bit for bit,
         its plan and device time beside its library yardstick
         (``F.interpolate`` antialiased on the widened frames, channels-last,
         plus one elementwise pass) and ptxas's report; per layer, K11-K14's achieved TFLOP/s
         and share of the bound, and the route K13 took (TMA or cp.async);
         K11-K13's and cuDNN's device time per call from ``torch.profiler``
         (no host launch overhead in it);
         ptxas's registers, spills and shared memory for the tensor-core
         bodies of K11-K14, from the build log;
     (c) the bench config with ``use_winograd_conv=True``:
         ``make_end_to_end_decode`` on a seeded raw batch of B=16 (256
         keyframes), checked and timed; K14 runs 12 times a VGG pass and the
         direct conv only for the stem, K1 and K2 on their cluster routes
         only, K3 on its FFT route only; the frontend alone and a profile;
     (d) ``Summarizer.summarize_batch`` answering 4 requests under it;
     (e) an f32 copy of a B=2 batch through the kernels and through the
         plain versions (K14's too): equal picks, close log-probs; and, for
         information, the bf16 distance between Winograd and direct features.
  8. the trainer on a real corpus at the training configuration of phase 5
     (VGG-16 at 224², 16 keyframes, 512 MFCC frames, B=32, f32, drop 0.2):
     a corpus of CORPUS_TRAIN training and CORPUS_DEV dev videos written by
     the port's ``examples/make_synthetic_corpus.py`` (32 sentences, 16 frames, every
     MFCC frame real);
     (a) ``train.cli.main([... "--data_dir", ...])`` for CORPUS_STEPS steps with
         an eval and a checkpoint at the last: raw frames and waveforms, the
         frozen VGG-16 and K3 (FFT route only) inside each step; K3, K5-K8
         launched inside the steps; finite losses; the median step time
         (synchronised; first step excluded) and the loop's (host decode
         included) with videos/s beside the card's name and power limit, the
         peak memory, and a ``torch.profiler`` breakdown of three steps;
     (b) at drop_prob 0, one raw-batch step from the same state through the
         kernels (K3 included) and through the plain versions: loss, grad
         norm and every parameter within TRAIN_PARITY_ATOL;
     (c) PREFETCH_STEPS steps with ``--prefetch 2`` and without: the logged
         losses and the final parameters equal bit for bit;
     (d) ``Summarizer.from_run(run_dir, seed=cfg.train.seed)`` answers the dev
         videos, K1-K3 launch, and its f32 picks through the kernels equal
         those through the plain versions.
  9. the serving stack at the bench configuration (bf16, B=8) on a corpus of
     240x320 videos: ``tools/load_test.py``'s quarter, half and full tiers
     (with gold summaries), videos whose lengths are each diagonal rung
     level of the default ladders, and two of 80 sentences; K1-K3's
     launches are counted over (a)-(d), on their cluster / FFT routes only:
     (a) in a fresh process each, a bucketed ``Summarizer``'s first request
         cold and after ``warmup((240, 320), batch_size=8)`` (which must
         shorten it); in this one, warmup, then a batch at each rung level
         and at the caps, timed, K1-K3 launched by each, no kernel plan
         checked that warmup had not; in f32, the picks of the kernels, the
         plain versions, the bucketed and the cap shapes all equal;
     (b) greedy, beam (width 4) and top-k (k=4) batch times at the caps,
         the host's dispatch time of a batch against its whole; in f32,
         beam's kernel picks equal the plain ones and width 1 equals
         greedy; top-k valid and equal under one seed; ``summarize_long``
         with ladders on the 80-sentence videos;
     (c) ``tools/load_test.run_sweep`` against ``tools/serve.py``'s stack in
         this process: five configurations, 8 clients, LOAD_REQUESTS
         requests, dynamic batch 8, every answer equal to
         ``Summarizer.summarize``'s; p50/p95/p99 and videos/s; then the
         batcher alone on decoded rows at pipeline depth 1 and 0;
     (d) ``infer.main`` on the tiers with ``--bucket_eval --prefetch 2``,
         greedy and beam: finite ROUGE over every video.
 10. the host side users bring data and weights through:
     (a) the native decode runtime (``mmbidaf_tpu_torch/native``, built with
         ``g++``): its codecs; it must have built where ``g++`` is present;
         phase 9's image decodes counted natively and through PIL (with the
         PNG codec, none through PIL); phase 9's full-tier PNG frames
         decoded natively equal PIL's pixels, and frames/s through PIL and
         the native pool at 1 and 4 threads;
     (b) the torch oracle (``tests/oracles/torch_model.py``) at the bench
         widths, saved as ``{"model_state": ...}``, converted by
         ``tools/convert_torch_checkpoint.py`` and served by
         ``Summarizer.from_run`` in f32 with the kernels on: greedy picks
         equal to the oracle's own forward on a B=8 feature batch, the
         log-prob distance, and K1-K3 launched on raw videos;
     (c) ``tools/precompute_features.py``'s ``precompute`` over phase 8's
         corpus (time, videos/s, K3 launched), then FEATURE_STEPS steps of
         ``train.cli --data_dir`` on the ``features.npz`` files: K5-K8
         launched, the frontend not, the step time beside phase 8's;
     (d) the bench audio config with ``audio_fft="stockham"``: its MFCC's
         distance from an f64 MFCC beside the matmul path's (plain and K3),
         the time of each, and no kernel launched on the Stockham path;
     (e) the (c) run's ``tb/`` event file parses with valid CRCs and holds
         ``log.jsonl``'s scalars.
 11. frozen serving artifacts (``mmbidaf_tpu_torch/export.py``), after the
     custom ops' dispatch cost (K1 and K2 at small shapes, host µs a call
     through ``torch.ops.mmbidaf`` against the CUDA implementation called
     directly):
     (a) the bench configuration at B=64, bf16, random weights from seed 0:
         exported (its time, the artifact's and each file's size, no kernel
         launched while tracing), then in a fresh process
         (``--artifact-decode``) loaded and run on phase 4's seeded batch:
         the first call cold, the median batch over 5 beside phase 4a's,
         K1-K3 launched 5 / 2 / 1 a batch on their cluster / FFT routes, no
         module of the model's code (nor jax) imported, picks equal to
         ``make_end_to_end_decode``'s;
     (b) an f32 copy at B=2, cuDNN's TF32 flag at its default: picks equal
         to the live f32 path's, log-probs within 1e-5;
     (c) beam (width 4) at B=8 against the live beam decode; a bucketed
         greedy artifact at B=8 over phase 9's rung-level videos and its
         full tier: ``ExportedSummarizer.summarize_batch`` answers equal the
         live bucketed ``Summarizer``'s, each level used, each level's batch
         timed beside the live program's in turns, and the first request
         cold and after ``warmup()`` in fresh processes
         (``--artifact-first-request``);
     (d) the long-audio configuration and the Winograd one at B=2: K1, K2
         with K9 and K4 launched (not K3), K14 12 times a VGG pass; picks
         equal to the live program's;
     (e) ``tools/export_artifact.py --random --vgg vgg16 --verify``,
         ``infer --artifact`` on phase 9's tiers (finite ROUGE), and
         ``tools/serve.py --artifact --dynamic_batch 8 --warmup 240x320`` in a
         subprocess answering ``tools/load_test.py``'s requests, every answer
         equal to ``ExportedSummarizer.summarize``'s, ``/healthz`` showing the
         artifact.
 12. the mesh layouts (``parallel/``) at world size 1 through NCCL (one
     card; a process group from ``parallel.mesh.initialize_distributed`` on a
     ``file://`` store), every collective a one-rank NCCL call:
     (a) the bench configuration's ``Summarizer(data_parallel=True)`` at
         B=64 bf16, timed beside phase 4(a), K1-K3's launches and routes;
     (b) f32 at B=8: ``data_parallel``, ``tp_vgg`` at ``num_model=1`` and
         both together, log-probs and picks bit for bit those of the
         Summarizer without a mesh;
     (c) the long-audio configuration with ``sp_audio`` at ``num_seq=1``
         (the SP chain: plain MFCC, wavefront BiLSTM, ring BiDAF): f32 B=2
         picks equal to the path without a mesh, kernels off (the SP chain's
         functions) and on; bf16 B=16 timed beside phase 6(a);
     (d) ``make_train_step`` with the mesh at the phase-5 configuration:
         two steps at drop 0.2 bit for bit the steps without it, then its
         median step and the step's without a mesh, timed in turns;
         ``train.cli`` on the synthetic stream with and without
         ``--num_data 1`` in turns, and ``train.cli --num_data 1 --sp_audio
         --num_seq 1 --tp_vgg --num_model 1`` on phase 8's corpus (raw
         waveforms, not its ``features.npz``) beside phase 8, K5-K8 counted
         inside their steps.
 13. mesh artifacts, the daemon under a mesh and the device-op profiler, at
     world size 1 through NCCL (``file://`` stores):
     (a) the bench configuration (B=64, bf16) exported as a data-parallel
         artifact and as a DP x TP one (``tp_vgg`` at ``num_model=1``: the
         classifier's head and tail programs, the all-reduce between them),
         each loaded and run in a fresh process of its own group: picks and
         log-probs equal to the live DP path (distance 0), the median batch
         beside phase 12a's and 4a's, K1-K3 launched 5 / 2 / 1 a batch on
         their cluster / FFT routes;
     (b) ``tools/serve.py --data_parallel`` in a process of its own over the
         DP artifact (``--dynamic_batch 64``) and over a run at the bench
         configuration (``--serve_batch_size 8 --dynamic_batch 8``), each
         with ``--warmup 240x320`` and MESH_REQUESTS requests from 4
         clients over phase 9's tiers: every answer equal to
         ``summarize``'s, ``/healthz``'s ``parallelism`` printed, exit 0 on
         SIGTERM;
     (c) ``tools/device_profile.py`` at the bench shapes, serve and train
         (kernels on): the top of each table, K1-K3 and K5-K8 with device
         time, the serving MFU (``utils.flops`` over ``peak_bf16_tflops``).
 14. the published capability configs trained on the card, K7/K8's routes,
     the held-out quality run and the tower ablation:
     (a) ``examples/configs/config1…4_*.json`` at their published widths
         (hidden 128, T_s=64, W=32, 64 keyframes, 512 frames, vocab 50000,
         drop 0.2; B=32) and config6 with ``sp_audio`` off (T_q=4096,
         B=16), the three kernel flags on, ``make_train_step`` on a seeded
         feature batch: CAPABILITY_STEPS steps with finite losses and the
         last below the first, K5-K8 launched, K7/K8 on the routes
         ``drop_route`` names for each tower, the median step beside the
         card's name and power limit, and one f32 drop-0 step through the
         kernels equal to one through the plain versions;
     (b) every (T_c, T_q, D) of the gate's grid has a K7/K8 route whose
         plans equal the C plans and whose clusters the card holds;
         DROP_GATE_RUN's shapes at drop 0 and 0.2: K7 against its plain
         version, K8 against its plain version run in f64, each twice bit
         for bit, on the route named; at drop 0.2 CUDA-event times, the
         plain versions', the bound, the tiled K8's device time by kernel;
         NO_ROUTE refused before any launch; ptxas's report of the tiled
         kernels;
     (c) ``experiments.quality_run`` at docs/QUALITY.md's size (VGG-16 at
         224², 512 MFCC frames, bf16, kernel flags on, 208 train / 32 dev
         learnable videos, B=32, QUALITY_STEPS steps): the curve, and the
         last held-out pick overlap and ROUGE-L at least QUALITY_BAR;
     (d) ``experiments.ablation_sweep`` at ABLATION_STEPS steps a config:
         its table beside docs/runs/ablation_r5.json's quality columns;
         gated only on finite losses.
 15. the drivers and demos (``mmbidaf_tpu_torch/{experiments,examples}``),
     each called through its ``main`` with the flags of DRIVER_RUNS (the
     bench shapes, few timed calls), one JSON line a driver (its seconds,
     the hand kernels it launched, its result): ``conv_profile`` (cuDNN
     bf16 and the int8 im2col product per VGG-16 layer, the 4096³ GEMMs,
     the whole stack), ``winograd_profile``, ``winograd_pallas_profile``
     (K14 against cuDNN per deep layer), ``preprocess_profile`` (K10 within
     its f32 tolerance of the plain resize), ``fft_ab`` (K4 on its FFT route
     at n_fft 512, 2048 and 4096), ``e2e_breakdown`` (B=32),
     ``train_breakdown --pallas``, ``beam_ab``, ``bucket_ab``,
     ``prefetch_ab --pallas``; then ``parity_demo`` (the oracle's
     checkpoint, the kernels on: picks equal) and ``parallel_demo`` at
     world size 1 through NCCL (the artifact's summaries equal the live
     ones); K1-K8, K10 and K14 each launched in the phase.
 16. every shape the JAX kernels take, and the two models they open:
     (a) K5/K6's gate: the L2 plan's and K6's route rule's mirrors
         (``lstm_kernel.l2_rows``, ``bptt_route``) equal to the C ones; H in
         LSTM_GATE_H x (rows, T) in LSTM_GATE_SHAPES against the plain
         versions (TOLERANCE, BPTT_TOLERANCE normwise), K1 bit for bit K5,
         each launch on the route ``train_route`` (K5) or ``bptt_route``
         (K6) names, every route used, ptxas's report of the L2 bodies and
         the grid walk, the card's grid plan; then K5/K6 at the hidden-512
         model's five training towers (B=32; K5 on the L2 route, K6 on the
         grid walk at the four 32-row towers and beside it on the L2 walk at
         every tower, each walk timed alone too) beside the plain versions,
         cuDNN and the bound (the JSON records ``bilstm_train_forward[l2]``,
         ``bilstm_bptt[l2]``, ``bilstm_bptt[grid]``);
     (b) K4/K3's gate: the FFT plans and the dense route's frames a block
         equal to the C plans; n_fft 4096, 8192, 16384 (win = n_fft) and
         windows 1000, 1500, 3000, 6000 (n_fft = win): K4 in both modes on
         512 frames (16 at 16384) and K3 on 128 with a silent example,
         against the plain versions, each on the route named; K3 at 512
         mels (its DCT pass past 48 KB); K4 at 4096 timed (the record
         ``log_mel[n_fft 4096]``) beside the dense route at that shape;
     (c) the hidden-512 model (the bench config, ``hidden_size=512``):
         serving B=64 bf16 (K1 on its L2 route, K2/K9 at D=1024, K3),
         timed, its profile, f32 picks at B=8 equal through the kernels and
         the plain versions; TRAIN512_STEPS steps of the bench_train step
         at B=32, f32, drop 0.2 (K5 on the L2 route only; K6 on the grid
         walk at the four 32-row towers and the L2 walk at the word tower;
         K7/K8 at D=1024), finite and falling losses, the step's time and
         profile;
         one drop-0 step through the kernels equal to one through the plain
         versions within TRAIN_PARITY_ATOL;
     (d) the long-audio model (config6, ``sp_audio`` off) with ``n_fft =
         win_length = 4096``, B=16: MFCC (K4 raw + the dB/DCT tail; K3 not
         run) and log-mel (K4 log), K4 on its FFT route only, timed; f32
         picks at B=2 equal through the kernels and the plain versions.
The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. The random weights come from seeds.
"""

from __future__ import annotations

import ast
import contextlib
import copy
import dataclasses
import http.client
import importlib.util
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
B = 64  # the bench batch
B_TRAIN = 32  # the bench_train.py batch
B_LONG = 16  # the long-audio serving batch
FRAME_HW = (240, 320)
TRAIN_STEPS = 150
# Kernel path vs plain path after one f32 training step at drop_prob 0
# (loss, grad norm and every parameter). An adadelta step moves a parameter
# by at most lr·sqrt(10)·1e-3 = 1.6e-3 and its error is at most lr times the
# gradient's; measured on an H100: 7.5e-9 on the parameters, 0 on the loss.
TRAIN_PARITY_ATOL = 1e-5
B_WINO = 16  # the Winograd serving batch (256 keyframes)
# Phase 8's corpus and run lengths.
CORPUS_TRAIN, CORPUS_DEV = 64, 16
CORPUS_STEPS = 20
PREFETCH_STEPS = 8
# Phase 9's corpus (videos a length tier, videos at each diagonal rung level,
# sentences of the two long videos) and the load test's requests a config.
PER_TIER, LEVEL_VIDEOS, LONG_SENTENCES = 4, 8, 80
LOAD_REQUESTS = 48
BATCHER_BATCHES = 12
# Phase 13's requests to each daemon under a mesh.
MESH_REQUESTS = 16
# Phase 10's decode timing runs and train steps on precomputed features.
DECODE_REPS = 5
FEATURE_STEPS = 12
# Published peaks of one H100 SXM (NVIDIA data sheet): f32 outside the
# tensor cores, bf16 on the tensor cores (dense), and HBM3 bandwidth. A
# bound counts operations at the peak of the units their operands are for.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


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
    from mmbidaf_tpu_torch.utils.bench_config import build_bench_config

    return build_bench_config(quick=False)


def long_config():
    """The long-audio serving model (``config6_sp_long_audio.json``) on one
    device: the sequence-parallel layout off, the three kernel flags on."""
    from mmbidaf_tpu_torch.config import config_from_json

    cfg = config_from_json(os.path.join(ROOT, "examples", "configs", "config6_sp_long_audio.json"))
    model = dataclasses.replace(cfg.model, use_pallas_attention=True, use_pallas_lstm=True,
                                use_pallas_melspec=True)
    mesh = dataclasses.replace(cfg.mesh, sp_audio=False, num_seq=1)
    return dataclasses.replace(cfg, model=model, mesh=mesh)


def logmel_config():
    """The bench configuration with log-mel audio features (64 mels)."""
    cfg = bench_config()
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, audio_features="logmel"),
                               model=dataclasses.replace(cfg.model, audio_feat_dim=cfg.data.n_mels))


def train_config(drop_prob: float = 0.2, kernels: bool = True):
    """``bench_train.py --pallas``: the bench widths in f32 with dropout,
    adadelta and flat updates (``TrainConfig`` defaults: lr 0.5, clip 5.0,
    EMA 0.999)."""
    cfg = bench_config()
    model = dataclasses.replace(cfg.model, compute_dtype="float32", drop_prob=drop_prob,
                                use_pallas_attention=kernels, use_pallas_lstm=kernels)
    train = dataclasses.replace(cfg.train, batch_size=B_TRAIN, optimizer="adadelta",
                                flat_updates=True, remat_towers=False)
    return dataclasses.replace(cfg, model=model, train=train)


def bound(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS) -> tuple[float, float]:
    """(ms for ``flops`` at ``peak`` (default the f32 one), ms for ``nbytes``
    at HBM rate)."""
    return flops / peak * 1e3, nbytes / PEAK_HBM_BYTES * 1e3


def bound_fields(parts: list[tuple[float, float]]) -> dict:
    """``bound_ms`` (sum over the main path's calls of the larger of the two
    times) and which of the two bounds it."""
    ops = sum(o for o, _ in parts)
    mem = sum(m for _, m in parts)
    return {"bound_ms": sum(max(o, m) for o, m in parts),
            "bound_by": "operations" if ops >= mem else "bytes"}


def spectrum_flops(frames: int, n_fft: int, win_length: int, mel_fb) -> float:
    """The least operations of ``frames`` windowed power spectra and their mel
    product (K3's and K4's common work): the window, a real ``n_fft``-point
    FFT (2.5·N·log2 N), |·|² over the bins, and the mel product over the
    filterbank's nonzeros (each bin lies in at most two triangles)."""
    nnz = int((mel_fb != 0).sum())
    return frames * (win_length + 2.5 * n_fft * math.log2(n_fft) + 3 * (n_fft // 2 + 1) + 2 * nnz)


def resize_flops(frames: int, h: int, w: int, s: int) -> float:
    """The least operations of ``frames`` u8 ``h x w x 3`` frames resized to
    ``s x s`` and normalized (K10's work): the two contractions over the
    banded bilinear matrices' nonzeros (at most three taps a row when
    downscaling by less than 2x), and one subtract per output (the /255 and
    1/std scales fold into the W-axis matrix)."""
    from mmbidaf_tpu_torch.ops.vgg import resize_matrix

    nnz_h = int((resize_matrix(s, h) != 0).sum())
    nnz_w = int((resize_matrix(s, w) != 0).sum())
    return frames * (2 * nnz_h * 3 * w + 2 * nnz_w * 3 * s + 3 * s * s)


@contextlib.contextmanager
def cudnn_rnn_full_f32():
    """cuDNN's LSTM in full f32, as the kernels (the process leaves cuDNN's
    TF32 flag on)."""
    import torch

    rnn = torch.backends.cudnn.rnn
    precision, rnn.fp32_precision = rnn.fp32_precision, "ieee"
    try:
        yield
    finally:
        rnn.fp32_precision = precision


def lstm_library_call(rows, steps, width, hid, mask, dev, backward: bool):
    """One cuDNN ``nn.LSTM`` call (bidirectional, packed sequence; every row
    has length >= 1) on the same shape, to be run under
    ``cudnn_rnn_full_f32``: the forward, or with ``backward`` the gradient
    of its output w.r.t. the input and weights (which also computes the
    ``dx``/``dW_x``/``db`` products that K6 leaves outside, see
    ``lstm_input_grads_call``)."""
    import torch
    from torch.nn.utils.rnn import pack_padded_sequence

    lstm = torch.nn.LSTM(width, hid, batch_first=True, bidirectional=True).to(dev)
    lengths = mask.sum(1).clamp(min=1).long().cpu()
    x = torch.randn(rows, steps, width, device=dev, requires_grad=backward)
    packed = pack_padded_sequence(x, lengths, batch_first=True, enforce_sorted=False)
    if not backward:
        def forward():
            with torch.no_grad():
                return lstm(packed)
        return forward
    out, _ = lstm(packed)
    g = torch.randn_like(out.data)
    inputs = [x, *lstm.parameters()]
    return lambda: torch.autograd.grad(out.data, inputs, g, retain_graph=True)


def lstm_input_grads_call(rows, steps, width, hid, dev):
    """The products that cuDNN's backward call computes beside the BPTT and
    that the port leaves to autograd through the projection: dx = dgates ·
    W_xᵀ, dW_x = xᵀ · dgates, db = Σ dgates, both directions at once."""
    import torch

    x = torch.randn(rows * steps, width, device=dev)
    w_x = torch.randn(width, 8 * hid, device=dev)
    dg = torch.randn(rows * steps, 8 * hid, device=dev)
    return lambda: (dg @ w_x.T, x.T @ dg, dg.sum(0))


def ragged_mask(rng, n: int, t: int, lo: int = 1, empty_row: int | None = None) -> np.ndarray:
    lengths = rng.integers(lo, t + 1, size=n)
    lengths[0] = t
    if empty_row is not None:
        lengths[empty_row] = 0
    return (np.arange(t)[None] < lengths[:, None]).astype(np.float32)


def raw_batch(cfg, rng, batch: int = B) -> dict[str, np.ndarray]:
    """The layout of ``bench.py::make_raw_batch``: ragged transcripts, random
    uint8 keyframes, a noise waveform (one silent track)."""
    d, m = cfg.data, cfg.model
    T_s, W = d.max_sentences, d.max_words
    sent_mask = ragged_mask(rng, batch, T_s, lo=max(m.max_decode_steps, 2))
    word_mask = (np.arange(W)[None, None] < rng.integers(1, W + 1, size=(batch, T_s))[:, :, None])
    word_mask = word_mask.astype(np.float32) * sent_mask[:, :, None]
    text_ids = np.where(word_mask > 0, rng.integers(2, d.vocab_size, size=(batch, T_s, W)), 0)
    n_samples = d.max_audio_frames * d.hop_length + d.win_length
    waveform = (rng.standard_normal((batch, n_samples)) * 0.1).astype(np.float32)
    waveform[1] = 0.0
    return {
        "text_ids": text_ids.astype(np.int32),
        "word_mask": word_mask,
        "sent_mask": sent_mask,
        "img_mask": ragged_mask(rng, batch, d.max_keyframes),
        "aud_mask": ragged_mask(rng, batch, d.max_audio_frames),
        "frames": (rng.random((batch, d.max_keyframes, *FRAME_HW, 3)) * 255).astype(np.uint8),
        "waveform": waveform,
    }


def _leaves(x):
    return [y for v in x for y in _leaves(v)] if isinstance(x, (tuple, list)) else [x]


def compare(name, out, ref, tol, normwise: bool = False) -> float:
    """Max abs error of ``out`` against ``ref``; fails past ``atol + rtol·|ref|``
    elementwise, or with ``normwise`` past ``atol + rtol·max|ref|`` of each
    output (the backward kernels' sums, whose terms cancel). With
    ``normwise`` each output's error and largest magnitude are printed."""
    import torch

    err, stats = 0.0, []
    for i, (o, r) in enumerate(zip(_leaves(out), _leaves(ref), strict=True)):
        check(o.shape == r.shape and o.dtype == r.dtype,
              f"{name}: {o.shape}/{o.dtype} vs {r.shape}/{r.dtype}")
        check(bool(torch.isfinite(o).all()), f"{name}: non-finite kernel output")
        o, r = o.float(), r.float()  # bf16 outputs are compared in f32
        e = (o - r).abs()
        scale = r.abs().max() if normwise else r.abs()
        bnd = tol["atol"] + tol["rtol"] * scale
        stats.append(f"{e.max().item():.2e}/{r.abs().max().item():.2e}")
        check(bool((e <= bnd).all()),
              f"{name}: output {i}: max abs err {e.max().item():.3e} (max |ref| "
              f"{r.abs().max().item():.3e}) over the bound")
        err = max(err, e.max().item())
    if normwise:
        print(f"    {name}: max abs err / max |ref| per output: {' '.join(stats)}", flush=True)
    return err


def lstm_shapes(cfg, batch: int):
    """The five BiLSTM towers of one batch (tag, rows, steps, input width),
    then a small ragged one."""
    h, d = cfg.model.hidden_size, cfg.data
    return [("word", batch * d.max_sentences, d.max_words, h),
            ("sentence", batch, d.max_sentences, 2 * h),
            ("image", batch, d.max_keyframes, cfg.model.img_feat_dim),
            ("audio", batch, d.max_audio_frames, cfg.model.audio_feat_dim),
            ("modeling", batch, d.max_sentences, 2 * h), ("small-ragged", 5, 7, 6)]


def k1_step_times(dev) -> dict:
    """K1's kernel alone (its cluster route, on unit-normal gates as the
    projection hands them over; ``tools/lstm_variants.py``'s operands, H=128)
    at the audio tower (B=64, T=512) and the long-audio tower (B=16,
    T=4096): microseconds a step, CUDA events. The wrapper's counters do not
    move: these launches time the kernel, outside the main path."""
    from mmbidaf_tpu_torch.ops.cuda import build, lstm_kernel
    from mmbidaf_tpu_torch.tools import lstm_variants

    lib = build.library()
    out = {}
    for tag, rows, steps in (("audio", B, bench_config().data.max_audio_frames),
                             ("long-audio", B_LONG, long_config().data.max_audio_frames)):
        gates, mask, w_h = lstm_variants.operands(rows, steps, dev)
        k = time_ms(lambda: lstm_variants.run_k1(lib, gates, mask, w_h), iters=max(2, 4096 // steps))
        plan = lstm_kernel.cluster_plan(rows, lstm_variants.H)
        out[tag] = k * 1e3 / steps
        print(f"  K1 kernel alone, {tag} tower rows={rows} T={steps}: {k:.4f} ms, "
              f"{out[tag]:.3f} us a step (C={plan.C} R={plan.R}, {plan.blocks} blocks)", flush=True)
    return out


def phase_kernels(dev, cfg) -> list[dict]:
    """K1-K3 against their plain versions: bench shapes plus a small ragged
    one. Returns the per-kernel records of the JSON line (launches filled in
    later from the serving path's run)."""
    import torch

    from mmbidaf_tpu_torch.ops import audio
    from mmbidaf_tpu_torch.ops.bidaf import BiDAFParams
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel, build, lstm_kernel, melspec_kernel
    from mmbidaf_tpu_torch.ops.lstm import BiLSTMParams
    from mmbidaf_tpu_torch.tools.mfcc_variants import f64_mfcc, wide_signal

    rng = np.random.default_rng(7)
    gen = torch.Generator(device=dev).manual_seed(7)
    h, d = cfg.model.hidden_size, cfg.data

    def t(x):
        return torch.from_numpy(x).to(dev)

    records, plans = [], {}

    # K1: the five BiLSTM towers at bench shapes (rows, steps, input width), then small.
    err, ms, plain_ms, lib_ms, parts = 0.0, 0.0, 0.0, 0.0, []
    for tag, rows, steps, width in lstm_shapes(cfg, B):
        hid = h if tag != "small-ragged" else 8
        p = BiLSTMParams(width, hid, gen, dev)
        x = t(rng.standard_normal((rows, steps, width)).astype(np.float32))
        m = t(ragged_mask(rng, rows, steps, lo=0, empty_row=1))
        route = lstm_kernel.serving_route(rows, hid)
        check(route == "cluster", f"bilstm[{tag}]: K1 took its {route} route at the bench widths")
        e = compare(f"bilstm[{tag}]", lstm_kernel.bilstm_cuda(p, x, m), lstm_kernel.bilstm_reference(p, x, m),
                    lstm_kernel.TOLERANCE)
        out = lstm_kernel.bilstm_cuda(p, x, m)
        check(not out[0][1].any() and not out[1][0][1].any(), f"bilstm[{tag}]: fully masked row not zero")
        check(torch.equal(out[0], lstm_kernel.bilstm_cuda(p, x, m)[0]), f"K1[{tag}]: two runs differ")
        err = max(err, e)
        plan = lstm_kernel.cluster_plan(rows, hid)
        plans[tag] = plan
        plan_s = f"{route} route, plan C={plan.C} R={plan.R} U={plan.U} blocks={plan.blocks}"
        if tag != "small-ragged":
            k = time_ms(lambda: lstm_kernel.bilstm_cuda(p, x, m), iters=10)
            pl = time_ms(lambda: lstm_kernel.bilstm_reference(p, x, m), iters=2, reps=3)
            with cudnn_rnn_full_f32():
                lb = time_ms(lstm_library_call(rows, steps, width, hid, m, dev, backward=False), iters=5)
            ms, plain_ms, lib_ms = ms + k, plain_ms + pl, lib_ms + lb
            G = 4 * hid  # projection GEMM + recurrence; x, weights, mask in, out and h/c out
            parts.append(bound(2 * rows * steps * width * 2 * G + 2 * 2 * rows * steps * hid * G,
                               4 * (rows * steps * (width + 1 + 2 * hid) + 2 * (width + hid + 1) * G
                                    + 4 * rows * hid)))
            print(f"  K1 bilstm {tag:9s} rows={rows:5d} T={steps:4d} in={width:5d}: {plan_s}; "
                  f"max_abs_err={e:.3e} kernel={k:.4f} ms plain={pl:.4f} ms cudnn={lb:.4f} ms; "
                  f"deterministic", flush=True)
        else:
            print(f"  K1 bilstm {tag}: {plan_s}; max_abs_err={e:.3e}; deterministic", flush=True)
    # past the cluster plan (H=512) K1 takes its L2 route (same function)
    p = BiLSTMParams(6, 512, gen, dev)
    x, m = t(rng.standard_normal((5, 7, 6)).astype(np.float32)), t(ragged_mask(rng, 5, 7, lo=0, empty_row=1))
    routes = dict(lstm_kernel.bilstm_cuda.routes)
    e = compare("bilstm[H=512]", lstm_kernel.bilstm_cuda(p, x, m), lstm_kernel.bilstm_reference(p, x, m),
                lstm_kernel.TOLERANCE)
    check(lstm_kernel.bilstm_cuda.routes == {"cluster": routes["cluster"], "l2": routes["l2"] + 1},
          "bilstm: H=512 did not take K1's L2 route")
    print(f"  K1 bilstm H=512 (no cluster plan) takes the l2 route: max_abs_err={e:.3e}", flush=True)
    us = k1_step_times(dev)
    records.append({"name": "bilstm", "route": "cuda", "source": "mmbidaf_tpu_torch/csrc/lstm.cu",
                    "kernel": "bilstm_cluster_kernel<R, false> (csrc/lstm_cluster.cuh)",
                    "replaces": "mmbidaf_tpu/ops/pallas/lstm_kernel.py:25", "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms, **bound_fields(parts), "library_ms": lib_ms,
                    "us_a_step": us})
    print(f"K1 bilstm: bound {lstm_kernel.TOLERANCE}, max_abs_err={err:.3e}, "
          f"per batch (5 towers) kernel={ms:.4f} ms plain={plain_ms:.4f} ms cudnn={lib_ms:.4f} ms "
          f"roofline={records[-1]['bound_ms']:.4f} ms", flush=True)
    print_lstm_resources(plans, "K1")

    # K2: image (T_q=16) and audio (T_q=512) attention at bench shapes on its
    # cluster route, then small.
    D = 2 * h
    err, ms, plain_ms, dev_ms, parts, k2_plans = 0.0, 0.0, 0.0, 0.0, [], {}
    for tag, bb, tc, tq, dd in [("image", B, d.max_sentences, d.max_keyframes, D),
                                ("audio", B, d.max_sentences, d.max_audio_frames, D),
                                ("small-ragged", 3, 7, 45, 20)]:
        p = BiDAFParams(dd, gen, dev)
        with torch.no_grad():
            p.bias.fill_(0.25)
        c = t(rng.standard_normal((bb, tc, dd)).astype(np.float32))
        q = t(rng.standard_normal((bb, tq, dd)).astype(np.float32))
        cm = t(ragged_mask(rng, bb, tc, lo=0, empty_row=1))
        qm = t(ragged_mask(rng, bb, tq, lo=0, empty_row=2))
        route = bidaf_kernel.bidaf_route(tc, tq, dd)
        check(route == "cluster", f"bidaf[{tag}]: K2 took its {route} route")
        routes = dict(bidaf_kernel.bidaf_attention_fused.routes)
        out = bidaf_kernel.bidaf_attention_fused(p, c, q, cm, qm)
        check(bidaf_kernel.bidaf_attention_fused.routes["cluster"] == routes["cluster"] + 1,
              f"bidaf[{tag}]: the cluster route was not counted")
        e = compare(f"bidaf[{tag}]", out, bidaf_kernel.bidaf_reference(p, c, q, cm, qm),
                    bidaf_kernel.TOLERANCE)
        check(torch.equal(out, bidaf_kernel.bidaf_attention_fused(p, c, q, cm, qm)),
              f"K2[{tag}]: two runs differ")
        k7 = bidaf_kernel.bidaf_dropout_forward(c, q, c, q, cm, qm, p.w_c, p.w_q, p.w_cq,
                                                p.bias.reshape(()))
        check(torch.equal(out, k7), f"K2[{tag}]: not K7's bits at cd = c, qd = q")
        err = max(err, e)
        plan = bidaf_kernel.fused_plan(tc, tq, dd)
        k2_plans[tag] = plan
        plan_s = (f"cluster route, plan C={plan.C} tile={plan.tq} blocks={bb * plan.C} "
                  f"smem {plan.smem_fwd} B")
        if tag != "small-ragged":
            k = time_ms(lambda: bidaf_kernel.bidaf_attention_fused(p, c, q, cm, qm), iters=20)
            kd = device_ms(lambda: bidaf_kernel.bidaf_attention_fused(p, c, q, cm, qm))
            pl = time_ms(lambda: bidaf_kernel.bidaf_reference(p, c, q, cm, qm), iters=20)
            ms, plain_ms, dev_ms = ms + k, plain_ms + pl, dev_ms + kd
            parts.append(bound(bb * (4 * tc * tq * dd + 2 * tc * tc * (tq + dd)),
                               4 * bb * (tc * dd + tq * dd + tc + tq + tc * 4 * dd) + 4 * (3 * dd + 1)))
            print(f"  K2 bidaf {tag:5s} B={bb} T_c={tc} T_q={tq} D={dd}: {plan_s}; max_abs_err={e:.3e} "
                  f"kernel={k:.4f} ms (device {kd:.4f}) plain={pl:.4f} ms; deterministic; K7's bits",
                  flush=True)
        else:
            print(f"  K2 bidaf {tag}: {plan_s}; max_abs_err={e:.3e}; deterministic; K7's bits",
                  flush=True)
    # one past K2's plan (T_q=2049 at T_c=32, D=256) the wrapper launches K9 (same function)
    edge = max(t for t in range(d.max_audio_frames, 4097) if bidaf_kernel.bidaf_route(32, t, D) == "cluster")
    p = BiDAFParams(D, gen, dev)
    c, q = t(rng.standard_normal((2, 32, D)).astype(np.float32)), t(rng.standard_normal((2, edge + 1, D)).astype(np.float32))
    cm, qm = t(ragged_mask(rng, 2, 32)), t(ragged_mask(rng, 2, edge + 1))
    k2, k9 = bidaf_kernel.bidaf_attention_fused.launches, bidaf_kernel.bidaf_attention_tiled.launches
    routes = dict(bidaf_kernel.bidaf_attention_fused.routes)
    e = compare(f"bidaf[T_q={edge + 1}]", bidaf_kernel.bidaf_attention_fused(p, c, q, cm, qm),
                bidaf_kernel.bidaf_reference(p, c, q, cm, qm), bidaf_kernel.TOLERANCE)
    check(bidaf_kernel.bidaf_attention_fused.launches == k2
          and bidaf_kernel.bidaf_attention_tiled.launches == k9 + 1
          and bidaf_kernel.bidaf_attention_fused.routes["K9"] == routes["K9"] + 1,
          f"bidaf: T_q={edge + 1} was not handed from K2 to K9")
    print(f"  K2 bidaf: the plan's edge at T_c=32, D={D} is T_q={edge}; T_q={edge + 1} goes to K9: "
          f"max_abs_err={e:.3e}", flush=True)
    print_resources("3", (("K2", "bidaf_fwd_cluster_kernel"),))
    records.append({"name": "bidaf_attention", "route": "cuda", "source": "mmbidaf_tpu_torch/csrc/bidaf.cu",
                    "kernel": "bidaf_fwd_cluster_kernel (K7's cluster body, kDrop = false)",
                    "replaces": "mmbidaf_tpu/ops/pallas/bidaf_kernel.py:31", "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms, **bound_fields(parts), "library_ms": None,
                    "device_ms": dev_ms})
    print(f"K2 bidaf: bound {bidaf_kernel.TOLERANCE}, max_abs_err={err:.3e}, "
          f"per batch (2 calls) kernel={ms:.4f} ms (device {dev_ms:.4f}) plain={plain_ms:.4f} ms "
          f"roofline={records[-1]['bound_ms']:.4f} ms", flush=True)

    # K3: the bench's MFCC (B=64, T=512, win 400, n_fft 512) on its FFT route,
    # on white noise and on the wide signal, then small shapes on both
    # routes; one silent example each.
    consts = audio.make_audio_frontend_consts(d.sample_rate, d.n_fft, d.win_length, d.n_mels,
                                              d.n_mfcc, d.fmin, d.fmax, device=dev)
    # n_fft=400 is no power of two: the dense route (not on the main paths)
    dense = audio.make_audio_frontend_consts(d.sample_rate, 400, 400, 40, 13, device=dev)
    err = 0.0
    for tag, bb, steps, cst in [("bench", B, d.max_audio_frames, consts), ("wide", B, d.max_audio_frames, consts),
                                ("small-ragged", 3, 37, consts), ("small-dense", 3, 37, dense)]:
        win = cst["cos"].shape[0]
        n = (steps - 1) * d.hop_length + win
        if tag == "wide":
            sig = wide_signal(rng, bb, n, d.sample_rate)
        else:
            sig = rng.standard_normal((bb, n)).astype(np.float32) * 0.1
        sig[1] = 0.0
        frames = audio.frame_signal(t(sig), win, d.hop_length, steps)
        route = melspec_kernel.mfcc_route(win, cst["cos"].shape[1])
        check(route == ("dense" if tag == "small-dense" else "fft"), f"K3[{tag}]: the {route} route")
        routes = dict(melspec_kernel.mfcc_fused.routes)
        out = melspec_kernel.mfcc_fused(frames, cst)
        check(melspec_kernel.mfcc_fused.routes[route] == routes[route] + 1, f"K3[{tag}]: {route} not counted")
        plain = melspec_kernel.mfcc_reference(frames, cst)
        if tag == "wide":
            # the FFT route, the plain version and the dense route at this
            # n_fft (outside the counters) against an f64 MFCC on the host
            ref = f64_mfcc(frames, cst)
            other = melspec_kernel._mfcc_launch(frames, cst, "dense")
            dist = {k: float(np.abs(v.double().cpu().numpy() - ref).max())
                    for k, v in (("fft", out), ("plain", plain), ("dense", other))}
            print(f"  K3 mfcc wide signal, max abs distance from an f64 MFCC: fft {dist['fft']:.3e}, "
                  f"plain {dist['plain']:.3e}, dense route {dist['dense']:.3e}; fft vs plain "
                  f"{(out - plain).abs().max().item():.3e}", flush=True)
            check(dist["fft"] <= min(dist["plain"], dist["dense"]),
                  "K3[wide]: the FFT route is farther from the f64 MFCC than a dense f32 DFT")
        e = compare(f"mfcc[{tag}]", out, plain, melspec_kernel.TOLERANCE)
        check(not out[1].any(), f"mfcc[{tag}]: the silent example is not all zero")
        check(torch.equal(out, melspec_kernel.mfcc_fused(frames, cst)), f"K3[{tag}]: two runs differ")
        err = max(err, e)
        if tag == "bench":
            ms = time_ms(lambda: melspec_kernel.mfcc_fused(frames, consts), iters=20)
            plain_ms = time_ms(lambda: melspec_kernel.mfcc_reference(frames, consts), iters=20)
            passes = device_ms_by_kernel(lambda: melspec_kernel.mfcc_fused(frames, consts),
                                         ("logmel_fft_kernel", "mfcc_dct_kernel"))
            # the dB, tile max and DCT on top of the mel spectrum
            parts = [bound(spectrum_flops(bb * steps, d.n_fft, d.win_length, consts["mel_fb"])
                           + bb * steps * (2 * d.n_mels + 2 * d.n_mels * d.n_mfcc),
                           4 * (sig.size + sum(v.numel() for v in consts.values())
                                + bb * steps * d.n_mfcc))]
            dev3 = sum(passes.values())
            print(f"  K3 mfcc B={bb} T={steps}: {route} route; max_abs_err={e:.3e} kernel={ms:.4f} ms "
                  f"(device {dev3:.4f}: FFT pass {passes['logmel_fft_kernel']:.4f}, DCT pass "
                  f"{passes['mfcc_dct_kernel']:.4f}, {passes['mfcc_dct_kernel'] / dev3:.1%}) "
                  f"plain={plain_ms:.4f} ms; silent example exact; deterministic", flush=True)
        else:
            print(f"  K3 mfcc {tag}: {route} route; max_abs_err={e:.3e}; silent example exact; "
                  f"deterministic", flush=True)
    print_resources("3", (("K3 fft", "logmel_fft_kernel"), ("K3 dense", "logmel_tile_kernel"),
                          ("K3", "mfcc_dct_kernel")),
                    keep=lambda inst: inst == "-" or inst.startswith("<0"))  # <0…>: K3's first passes
    nnz = melspec_kernel.mel_nonzeros(consts["mel_fb"])[1].numel()
    smem = build.library().mmb_log_mel_fft_smem_bytes(d.n_fft, d.win_length, d.hop_length, d.n_mels, nnz, 1)
    print(f"  K3 fft: dynamic smem a block {smem} B (f64 FFT; n_fft={d.n_fft}, win={d.win_length}, "
          f"hop={d.hop_length}, {d.n_mels} mels, {nnz} mel weights staged; a warp a frame)", flush=True)
    records.append({"name": "mfcc", "route": "cuda", "source": "mmbidaf_tpu_torch/csrc/mfcc.cu",
                    "kernel": "logmel_fft_kernel<kDb> (f64 frame_power_fft) + mfcc_dct_kernel",
                    "replaces": "mmbidaf_tpu/ops/pallas/melspec_kernel.py:87", "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms, **bound_fields(parts), "library_ms": None,
                    "device_ms": dev3})
    print(f"K3 mfcc: bound {melspec_kernel.TOLERANCE}, max_abs_err={err:.3e}, "
          f"kernel={ms:.4f} ms (device {dev3:.4f}) plain={plain_ms:.4f} ms "
          f"roofline={records[-1]['bound_ms']:.4f} ms", flush=True)
    return records


def phase_long_kernels(dev) -> list[dict]:
    """K4 and K9 against their plain versions: the long-audio configuration's
    shapes (K4 raw mel at B=16 x 4096 frames, K9 at T_c=32, T_q=4096, D=256),
    the log-mel bench shape (K4 log at B=64 x 512 frames), and small ragged
    shapes (a silent example; partial c and q blocks with fully masked rows).
    K9 runs twice and must agree bit for bit. Returns the records of the
    JSON line (launches filled in by phase 6)."""
    import torch

    from mmbidaf_tpu_torch.ops import audio
    from mmbidaf_tpu_torch.ops.bidaf import BiDAFParams
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel as bk
    from mmbidaf_tpu_torch.ops.cuda import build
    from mmbidaf_tpu_torch.ops.cuda import melspec_kernel as mk

    rng = np.random.default_rng(13)
    gen = torch.Generator(device=dev).manual_seed(13)
    d = long_config().data

    def t(x):
        return torch.from_numpy(x).to(dev)

    consts = audio.make_audio_frontend_consts(d.sample_rate, d.n_fft, d.win_length, d.n_mels,
                                              d.n_mfcc, d.fmin, d.fmax, device=dev)
    # n_fft=400 is no power of two: the dense route (not on the main paths)
    dense = audio.make_audio_frontend_consts(d.sample_rate, 400, 400, 40, 13, device=dev)
    bins = consts["cos"].shape[1]
    err, ms, plain_ms, parts = 0.0, 0.0, 0.0, []
    for tag, bb, steps, log in [("long-audio", B_LONG, d.max_audio_frames, False),
                                ("logmel", B, bench_config().data.max_audio_frames, True),
                                ("small-ragged", 3, 37, True),
                                ("small-ragged", 3, 37, False),
                                ("small-dense", 3, 37, True),
                                ("small-dense", 3, 37, False)]:
        cst = dense if tag == "small-dense" else consts
        win = cst["cos"].shape[0]
        sig = rng.standard_normal((bb, (steps - 1) * d.hop_length + win)).astype(np.float32) * 0.1
        sig[1] = 0.0
        frames = audio.frame_signal(t(sig), win, d.hop_length, steps)
        route = mk.log_mel_route(win, cst["cos"].shape[1])
        check(route == ("dense" if tag == "small-dense" else "fft"), f"K4[{tag}]: the {route} route")
        routes = dict(mk.log_mel_fused.routes)
        out = mk.log_mel_fused(frames, cst, log=log)
        check(mk.log_mel_fused.routes[route] == routes[route] + 1, f"K4[{tag}]: {route} not counted")
        name = f"log_mel[{tag}, log={log}]"
        e = compare(name, out, mk.log_mel_reference(frames, cst, log=log),
                    mk.LOG_MEL_TOLERANCE[log], normwise=not log)
        silent = torch.zeros_like(out[1])
        silent = torch.log(silent + 1e-6) if log else silent
        check(torch.equal(out[1], silent), f"{name}: the silent example is not exactly {silent[0, 0].item()}")
        check(torch.equal(out, mk.log_mel_fused(frames, cst, log=log)), f"{name}: two runs differ")
        err = max(err, e)
        if tag.startswith("small"):
            print(f"  K4 {name}: {route} route; max_abs_err={e:.3e}; silent example exact; "
                  f"deterministic", flush=True)
            continue
        k = time_ms(lambda: mk.log_mel_fused(frames, consts, log=log), iters=10)
        pl = time_ms(lambda: mk.log_mel_reference(frames, consts, log=log), iters=10)
        ms, plain_ms = ms + k, plain_ms + pl
        n = bb * steps
        parts.append(bound(spectrum_flops(n, d.n_fft, d.win_length, consts["mel_fb"]) + n * d.n_mels * log,
                           4 * (sig.size + 2 * d.win_length * bins + bins * d.n_mels + n * d.n_mels)))
        print(f"  K4 {name} B={bb} T={steps}: {route} route; max_abs_err={e:.3e} kernel={k:.4f} ms "
              f"plain={pl:.4f} ms bound={max(parts[-1]):.4f} ms; silent example exact; deterministic",
              flush=True)
    rec4 = {"name": "log_mel", "route": "cuda", "source": "mmbidaf_tpu_torch/csrc/mfcc.cu",
            "kernel": "logmel_fft_kernel<kLogMel / kMelPower> (frame_power_fft)",
            "replaces": "mmbidaf_tpu/ops/pallas/melspec_kernel.py:24", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, **bound_fields(parts), "library_ms": None}
    print(f"K4 log_mel: bounds {mk.LOG_MEL_TOLERANCE}, max_abs_err={err:.3e}, long-audio + logmel "
          f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms roofline={rec4['bound_ms']:.4f} ms", flush=True)
    print_resources("3", (("K4 fft", "logmel_fft_kernel"), ("K4 dense", "logmel_tile_kernel")),
                    keep=lambda inst: not inst.startswith("<0"))  # <0…>: K3's first passes
    nnz = mk.mel_nonzeros(consts["mel_fb"])[1].numel()
    smem = build.library().mmb_log_mel_fft_smem_bytes(d.n_fft, d.win_length, d.hop_length, d.n_mels, nnz, 0)
    print(f"  K4 fft: dynamic smem a block {smem} B (n_fft={d.n_fft}, win={d.win_length}, "
          f"hop={d.hop_length}, {d.n_mels} mels, {nnz} mel weights staged; a warp a frame)", flush=True)

    D = 2 * long_config().model.hidden_size
    err, ms, plain_ms, parts = 0.0, 0.0, 0.0, []
    # long-audio: the main path's shape (timed into the JSON record); at B=2
    # and a 600-sentence context (a_acc and P_acc spilled to device memory)
    # for the record only; small-ragged checked only
    for tag, bb, tc, tq, dd, blocks in [("long-audio", B_LONG, 32, d.max_audio_frames, D, (128, 128)),
                                        ("long-audio", 2, 32, d.max_audio_frames, D, (128, 128)),
                                        ("long-context", 1, 600, d.max_audio_frames, D, (128, 128)),
                                        ("small-ragged", 3, 7, 45, 20, (4, 16))]:
        p = BiDAFParams(dd, gen, dev)
        with torch.no_grad():
            p.bias.fill_(0.25)
        c = t(rng.standard_normal((bb, tc, dd)).astype(np.float32))
        q = t(rng.standard_normal((bb, tq, dd)).astype(np.float32))
        cm = t(ragged_mask(rng, bb, tc, lo=0, empty_row=1 if bb > 1 else None))
        qm = t(ragged_mask(rng, bb, tq, lo=0, empty_row=2 if bb > 2 else None))
        run = lambda: bk.bidaf_attention_tiled(p, c, q, cm, qm, *blocks)  # noqa: E731
        out = run()
        e = compare(f"bidaf_tiled[{tag}]", out, bk.bidaf_tiled_reference(p, c, q, cm, qm), bk.TOLERANCE)
        check(torch.equal(out, run()), f"K9[{tag}]: two runs differ")
        err = max(err, e)
        plan = bk.tiled_plan(tc, tq, dd, blocks[1])
        plan_s = (f"plan C={plan.C} span={plan.span} tile={plan.tq} ({-(-plan.span // plan.tq)} "
                  f"tiles a rank) blocks={bb * plan.C} "
                  f"{'c∘w_cq resident' if plan.resident else 'c∘w_cq from device memory'}, "
                  f"smem {plan.smem} B, "
                  f"{f'a_acc/P_acc spilled ({4 * bb * plan.C * plan.work} B)' if plan.work else 'no scratch'}")
        if tag == "small-ragged":
            print(f"  K9 bidaf_tiled {tag} tq_blk={blocks[1]}: {plan_s}; max_abs_err={e:.3e}; "
                  f"deterministic", flush=True)
            continue
        k = time_ms(run, iters=20)
        kd = device_ms(run)
        pl = time_ms(lambda: bk.bidaf_tiled_reference(p, c, q, cm, qm), iters=20)
        flops = bb * (4 * tc * tq * dd + 2 * tc * tc * (tq + dd))
        bd = bound(flops, 4 * bb * (tc * dd + tq * dd + tc + tq + tc * 4 * dd) + 4 * (3 * dd + 1))
        main = tag == "long-audio" and bb == B_LONG
        if main:
            ms, plain_ms = ms + k, plain_ms + pl
            parts.append(bd)
        print(f"  K9 bidaf_tiled {tag} B={bb} T_c={tc} T_q={tq} D={dd}{'' if main else ' (record only)'}: "
              f"{plan_s}; max_abs_err={e:.3e} kernel={k:.4f} ms {achieved(flops, k, bd)} (device "
              f"{kd:.4f} ms {achieved(flops, kd, bd)}) plain={pl:.4f} ms; deterministic", flush=True)
    # for the record: K9 beside K2 where both run (the route stays K2's to T_q = 2048)
    for tq in (512, 2048):
        p = BiDAFParams(D, gen, dev)
        c = t(rng.standard_normal((B_LONG, 32, D)).astype(np.float32))
        q = t(rng.standard_normal((B_LONG, tq, D)).astype(np.float32))
        cm, qm = t(ragged_mask(rng, B_LONG, 32)), t(ragged_mask(rng, B_LONG, tq))
        check(bk.bidaf_route(32, tq, D) == "cluster", f"K2 does not take T_q={tq}")
        k9 = time_ms(lambda: bk.bidaf_attention_tiled(p, c, q, cm, qm), iters=20)
        k2 = time_ms(lambda: bk.bidaf_attention_fused(p, c, q, cm, qm), iters=20)
        k9d = device_ms(lambda: bk.bidaf_attention_tiled(p, c, q, cm, qm))
        k2d = device_ms(lambda: bk.bidaf_attention_fused(p, c, q, cm, qm))
        e = (bk.bidaf_attention_tiled(p, c, q, cm, qm) - bk.bidaf_attention_fused(p, c, q, cm, qm)).abs().max()
        print(f"  K9 beside K2 at B={B_LONG} T_c=32 T_q={tq} D={D} (record only): K9 {k9:.4f} ms "
              f"(device {k9d:.4f}), K2 {k2:.4f} ms (device {k2d:.4f}); max |K9 - K2| {e.item():.3e}",
              flush=True)
    print_resources("3", (("K9", "bidaf_tiled_cluster_kernel"),))
    rec9 = {"name": "bidaf_attention_tiled", "route": "cuda",
            "source": "mmbidaf_tpu_torch/csrc/bidaf_tiled.cu",
            "kernel": "bidaf_tiled_cluster_kernel<true, false, false> (a cluster an example, each rank walking q tiles)",
            "replaces": "mmbidaf_tpu/ops/pallas/bidaf_tiled_kernel.py:37", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, **bound_fields(parts), "library_ms": None}
    print(f"K9 bidaf_tiled: bound {bk.TOLERANCE}, max_abs_err={err:.3e}, kernel={ms:.4f} ms "
          f"plain={plain_ms:.4f} ms roofline={rec9['bound_ms']:.4f} ms", flush=True)
    return [rec4, rec9]


def phase_train_kernels(dev, cfg) -> list[dict]:
    """K5-K8 against their plain versions at the training path's shapes
    (bench widths, B=32: five towers, two attention blocks with dropped
    operands), plus a small ragged shape; K5-K8 run twice and must agree
    bit for bit. Returns the records of the JSON line."""
    import torch

    from mmbidaf_tpu_torch.ops.common import dropout_mask
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel as bk
    from mmbidaf_tpu_torch.ops.cuda import lstm_kernel as lk
    from mmbidaf_tpu_torch.ops.lstm import BiLSTMParams

    rng = np.random.default_rng(11)
    gen = torch.Generator(device=dev).manual_seed(11)
    h, d = cfg.model.hidden_size, cfg.data

    def t(x):
        return torch.from_numpy(x).to(dev)

    def normal(*shape):
        return t(rng.standard_normal(shape).astype(np.float32))

    # K5 / K6 on the gates of random BiLSTM layers.
    rec5 = {"err": 0.0, "ms": 0.0, "plain": 0.0, "lib": 0.0, "dev": 0.0, "lib_dev": 0.0, "parts": []}
    rec6 = {"err": 0.0, "ms": 0.0, "plain": 0.0, "lib": 0.0, "dev": 0.0, "lib_dev": 0.0, "parts": []}
    gemm = {"ms": 0.0, "dev": 0.0}
    plans = {}
    for tag, rows, steps, width in lstm_shapes(cfg, B_TRAIN):
        hid = h if tag != "small-ragged" else 8
        G = 4 * hid
        p = BiLSTMParams(width, hid, gen, dev)
        m = t(ragged_mask(rng, rows, steps, lo=0, empty_row=1))
        with torch.no_grad():
            gates = lk._projection(p, normal(rows, steps, width)).contiguous()
        w_h = torch.stack([p.fwd.w_h, p.bwd.w_h]).contiguous()
        fwd = lk.bilstm_train_forward(gates, m, w_h)
        e5 = compare(f"bilstm_train[{tag}]", fwd, lk.bilstm_train_forward_reference(gates, m, w_h),
                     lk.TOLERANCE)
        check(not fwd[0][1].any() and not fwd[3][:, :, 1].any(), f"K5[{tag}]: masked row not zero")
        again = lk.bilstm_train_forward(gates, m, w_h)
        check(all(torch.equal(a, b) for a, b in zip(fwd, again)), f"K5[{tag}]: two runs differ")
        _, _, _, h_seq, c_seq = fwd
        dout, dh, dc = normal(rows, steps, 2 * hid), normal(rows, 2 * hid), normal(rows, 2 * hid)
        bwd_args = (gates, m, w_h, h_seq, c_seq, dout, dh, dc)
        bwd = lk.bilstm_bptt(*bwd_args)
        e6 = compare(f"bilstm_bptt[{tag}]", bwd, lk.bilstm_bptt_reference(*bwd_args), lk.BPTT_TOLERANCE,
                     normwise=True)
        check(not bwd[0][1].any(), f"K6[{tag}]: dgates of the empty row not zero")
        again = lk.bilstm_bptt(*bwd_args)
        check(all(torch.equal(a, b) for a, b in zip(bwd, again)), f"K6[{tag}]: two runs differ")
        rec5["err"], rec6["err"] = max(rec5["err"], e5), max(rec6["err"], e6)
        plan = lk.cluster_plan(rows, hid)
        plans[tag] = plan
        plan_s = f"cluster plan C={plan.C} R={plan.R} U={plan.U} blocks={plan.blocks}"
        if tag == "small-ragged":
            print(f"  K5/K6 {tag}: {plan_s}; max_abs_err K5={e5:.3e} K6={e6:.3e}; "
                  f"K5 and K6 deterministic", flush=True)
            continue
        k5 = time_ms(lambda: lk.bilstm_train_forward(gates, m, w_h), iters=10)
        k6 = time_ms(lambda: lk.bilstm_bptt(*bwd_args), iters=10)
        d5 = device_ms(lambda: lk.bilstm_train_forward(gates, m, w_h))
        d6 = device_ms(lambda: lk.bilstm_bptt(*bwd_args))
        p5 = time_ms(lambda: lk.bilstm_train_forward_reference(gates, m, w_h), iters=1, reps=3)
        p6 = time_ms(lambda: lk.bilstm_bptt_reference(*bwd_args), iters=1, reps=3)
        with cudnn_rnn_full_f32():
            lib_fwd = lstm_library_call(rows, steps, width, hid, m, dev, backward=False)
            lib_bwd = lstm_library_call(rows, steps, width, hid, m, dev, backward=True)
            l5, l6 = time_ms(lib_fwd, iters=5), time_ms(lib_bwd, iters=5)
            ld5, ld6 = device_ms(lib_fwd), device_ms(lib_bwd)
        grads = lstm_input_grads_call(rows, steps, width, hid, dev)
        gm, gd = time_ms(grads, iters=10), device_ms(grads)
        n, rec = rows * steps, 2 * 2 * rows * steps * hid * G  # the recurrent product, both directions
        rec5["parts"].append(bound(rec, 4 * (n * (2 * G + 1 + 2 * hid + 4 * hid) + 2 * hid * G + 4 * rows * hid)))
        rec6["parts"].append(bound(3 * rec, 4 * (n * (2 * G + 1 + 4 * hid + 2 * hid + 2 * G)
                                                 + 2 * 2 * hid * G + 4 * rows * hid)))
        for r, k, kd, pl, lb, lbd in ((rec5, k5, d5, p5, l5, ld5), (rec6, k6, d6, p6, l6, ld6)):
            r["ms"], r["dev"], r["plain"] = r["ms"] + k, r["dev"] + kd, r["plain"] + pl
            r["lib"], r["lib_dev"] = r["lib"] + lb, r["lib_dev"] + lbd
        gemm["ms"], gemm["dev"] = gemm["ms"] + gm, gemm["dev"] + gd
        print(f"  K5/K6 {tag:9s} rows={rows:5d} T={steps:4d}: {plan_s}; max_abs_err K5={e5:.3e} "
              f"K6={e6:.3e}; K5 {k5:.4f} ms (device {d5:.4f}; plain {p5:.2f}; cudnn fwd {l5:.4f}, "
              f"device {ld5:.4f}); K6 {k6:.4f} ms (device {d6:.4f}; plain {p6:.2f}; cudnn bwd "
              f"{l6:.4f}, device {ld6:.4f}); dx/dW_x/db GEMMs {gm:.4f} ms (device {gd:.4f}); "
              f"K6 + GEMMs on the device {d6 + gd:.4f} vs cudnn bwd {ld6:.4f}; "
              f"K5 and K6 deterministic", flush=True)
    print(f"  K5/K6 five towers: K5 {rec5['ms']:.4f} ms (device {rec5['dev']:.4f}) vs cudnn fwd "
          f"{rec5['lib']:.4f} (device {rec5['lib_dev']:.4f}); K6 {rec6['ms']:.4f} ms (device "
          f"{rec6['dev']:.4f}) vs cudnn bwd {rec6['lib']:.4f} (device {rec6['lib_dev']:.4f}); the "
          f"dx/dW_x/db GEMMs {gemm['ms']:.4f} ms (device {gemm['dev']:.4f}): K6 + GEMMs on the "
          f"device {rec6['dev'] + gemm['dev']:.4f} vs cudnn bwd {rec6['lib_dev']:.4f}", flush=True)
    print_lstm_resources(plans, "K5/K6")

    # K7 / K8 with dropped operands (drop 0.2, as in training).
    rec7 = {"err": 0.0, "ms": 0.0, "plain": 0.0, "dev": 0.0, "parts": []}
    rec8 = {"err": 0.0, "ms": 0.0, "plain": 0.0, "dev": 0.0, "parts": []}
    D = 2 * h
    drop_plans = {}
    for tag, bb, tc, tq, dd in [("image", B_TRAIN, d.max_sentences, d.max_keyframes, D),
                                ("audio", B_TRAIN, d.max_sentences, d.max_audio_frames, D),
                                ("small-ragged", 3, 7, 45, 20)]:
        c, q = normal(bb, tc, dd), normal(bb, tq, dd)
        cd = c * dropout_mask(c.shape, 0.2, gen, dev)
        qd = q * dropout_mask(q.shape, 0.2, gen, dev)
        cm = t(ragged_mask(rng, bb, tc, lo=0, empty_row=1))
        qm = t(ragged_mask(rng, bb, tq, lo=0, empty_row=2))
        w = [normal(dd) * 0.1 for _ in range(3)]
        ops = (c, q, cd, qd, cm, qm, *w, torch.tensor(0.25, device=dev))
        fwd = bk.bidaf_dropout_forward(*ops)
        e7 = compare(f"bidaf_dropout[{tag}]", fwd, bk.bidaf_dropout_reference(*ops), bk.TOLERANCE)
        check(torch.equal(fwd, bk.bidaf_dropout_forward(*ops)), f"K7[{tag}]: two runs differ")
        g = normal(bb, tc, 4 * dd)
        bwd = bk.bidaf_dropout_backward(*ops, g)
        e8 = compare(f"bidaf_dropout_backward[{tag}]", bwd,
                     bk.bidaf_dropout_backward_reference(*ops, g), bk.BACKWARD_TOLERANCE,
                     normwise=True)
        again = bk.bidaf_dropout_backward(*ops, g)
        check(all(torch.equal(a, b) for a, b in zip(bwd, again)), f"K8[{tag}]: two runs differ")
        rec7["err"], rec8["err"] = max(rec7["err"], e7), max(rec8["err"], e8)
        plan = bk.drop_plan(tc, tq, dd)
        drop_plans[tag] = plan
        plan_s = f"cluster plan C={plan.C} tile={plan.tq} blocks={bb * plan.C}"
        if tag == "small-ragged":
            print(f"  K7/K8 {tag}: {plan_s}; max_abs_err K7={e7:.3e} K8={e8:.3e}; "
                  f"K7 and K8 deterministic", flush=True)
            continue
        k7 = time_ms(lambda: bk.bidaf_dropout_forward(*ops), iters=20)
        k8 = time_ms(lambda: bk.bidaf_dropout_backward(*ops, g), iters=20)
        d7 = device_ms(lambda: bk.bidaf_dropout_forward(*ops))
        d8 = device_ms(lambda: bk.bidaf_dropout_backward(*ops, g))
        p7 = time_ms(lambda: bk.bidaf_dropout_reference(*ops), iters=20)
        p8 = time_ms(lambda: bk.bidaf_dropout_backward_reference(*ops, g), iters=20)
        seq = bb * (2 * tc * dd + 2 * tq * dd + tc + tq) + 3 * dd + 1  # c, q, cd, qd, masks, params
        rec7["parts"].append(bound(bb * (4 * tc * tq * dd + 2 * tc * tc * (tq + dd)),
                                   4 * (seq + bb * tc * 4 * dd)))
        rec8["parts"].append(bound(bb * (12 * tc * tq * dd + 6 * tc * tc * tq + 6 * tc * tc * dd),
                                   4 * (seq + bb * tc * 4 * dd + bb * (2 * tc * dd + 2 * tq * dd)
                                        + 3 * dd + 1)))
        for r, k, kd, pl in ((rec7, k7, d7, p7), (rec8, k8, d8, p8)):
            r["ms"], r["dev"], r["plain"] = r["ms"] + k, r["dev"] + kd, r["plain"] + pl
        print(f"  K7/K8 {tag:5s} B={bb} T_c={tc} T_q={tq} D={dd}: {plan_s}; max_abs_err K7={e7:.3e} "
              f"K8={e8:.3e}; K7 {k7:.4f} ms (device {d7:.4f}; plain {p7:.4f}); K8 {k8:.4f} ms "
              f"(device {d8:.4f}; plain {p8:.4f}); K7 and K8 deterministic", flush=True)
    print_bidaf_drop_resources(drop_plans)

    def record(name, src, replaces, r, lib):
        out = {"name": name, "route": "cuda", "source": f"mmbidaf_tpu_torch/csrc/{src}",
               "replaces": f"mmbidaf_tpu/ops/pallas/{replaces}", "max_abs_err": r["err"],
               "ms": r["ms"], "plain_ms": r["plain"], **bound_fields(r["parts"]),
               "library_ms": lib, "device_ms": r["dev"]}  # device time beside the events'
        if "lib_dev" in r:  # K5 / K6: cuDNN's device time
            out["library_device_ms"] = r["lib_dev"]
        print(f"{name}: max_abs_err={r['err']:.3e} kernel={r['ms']:.4f} ms (device "
              f"{r['dev']:.4f}) plain={r['plain']:.4f} ms library={lib} "
              f"roofline={out['bound_ms']:.4f} ms ({out['bound_by']})", flush=True)
        return out

    return [record("bilstm_train_forward", "lstm.cu", "lstm_kernel.py:228", rec5, rec5["lib"]),
            record("bilstm_bptt", "lstm_bwd.cu", "lstm_kernel.py:256", rec6, rec6["lib"]),
            record("bidaf_dropout_forward", "bidaf.cu", "bidaf_kernel.py:154", rec7, None),
            record("bidaf_dropout_backward", "bidaf_bwd.cu", "bidaf_kernel.py:189", rec8, None)]


def check_decode(lp, picks, raw, cfg, tag: str) -> None:
    K, T_s = cfg.model.max_decode_steps, cfg.data.max_sentences
    sm = raw["sent_mask"]
    n = sm.shape[0]
    check(tuple(lp.shape) == (n, K, T_s) and tuple(picks.shape) == (n, K),
          f"{tag}: shapes {lp.shape} {picks.shape}")
    check(bool(np.isfinite(lp).all()), f"{tag}: non-finite log-probs")
    check(bool(((picks >= 0) & (picks < T_s)).all()), f"{tag}: picks out of range")
    for b in range(n):
        check(all(sm[b, p] == 1 for p in picks[b]), f"{tag}: row {b} picked a padded sentence")
        check(len(set(picks[b].tolist())) == K, f"{tag}: row {b} repeated a pick")


def f32_kernels_vs_plain(cfg, s, raw, raw_np, tag: str) -> None:
    """An f32 copy of ``cfg`` through the kernels and through the plain
    versions (full f32 convs for both) on the served weights and the same batch:
    valid and equal picks, log-probs within 1e-3; the conv epilogue launched
    on the kernel side and not on the plain one."""
    from mmbidaf_tpu_torch.data.frontend import make_end_to_end_decode
    from mmbidaf_tpu_torch.ops.cuda.conv_epilogue_kernel import conv_epilogue

    cfg_k = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32"))
    cfg_p = dataclasses.replace(cfg_k, model=dataclasses.replace(
        cfg_k.model, use_pallas_lstm=False, use_pallas_attention=False, use_pallas_melspec=False))
    fe32 = s.frontend
    fe32.vgg.float()  # in place: the served bf16 VGG weights, exactly, in f32
    before = conv_epilogue.launches
    lp_k, picks_k = make_end_to_end_decode(cfg_k)(s.model, fe32, raw)
    mid = conv_epilogue.launches
    with plain_vgg_kernels():
        lp_p, picks_p = make_end_to_end_decode(cfg_p)(s.model, fe32, raw)
    check(mid > before and conv_epilogue.launches == mid,
          f"{tag} f32: conv epilogue launches {mid - before} (kernels), "
          f"{conv_epilogue.launches - mid} (plain)")
    lp_k, lp_p = lp_k.cpu().numpy(), lp_p.cpu().numpy()
    check_decode(lp_k, picks_k.cpu().numpy(), raw_np, cfg, f"{tag} f32 kernels")
    check(bool((picks_k == picks_p).all()), f"{tag} f32: kernel and plain picks differ")
    valid = lp_p > -1e29
    dmax = float(np.abs(lp_k - lp_p)[valid].max())
    check(dmax <= 1e-3, f"{tag} f32: kernel vs plain log-probs differ by {dmax:.3e} > 1e-3")
    print(f"{tag} f32 B={len(picks_k)}: picks equal; log-prob max abs diff {dmax:.3e} (bound 1e-3)",
          flush=True)


@contextlib.contextmanager
def plain_vgg_kernels():
    """K14's and the conv epilogue's plain versions in place of their
    wrappers while the block runs (the VGG's kernels have no flag to turn
    off)."""
    from mmbidaf_tpu_torch.ops.cuda import conv_epilogue_kernel, winograd_kernel

    fused = winograd_kernel.winograd_conv3x3_fused
    epilogue = conv_epilogue_kernel.conv_epilogue
    winograd_kernel.winograd_conv3x3_fused = winograd_kernel.winograd_reference
    conv_epilogue_kernel.conv_epilogue = conv_epilogue_kernel.conv_epilogue_reference
    try:
        yield
    finally:
        winograd_kernel.winograd_conv3x3_fused = fused
        conv_epilogue_kernel.conv_epilogue = epilogue


@contextlib.contextmanager
def count_direct_convs(counts: list):
    """Append the C_in of every ``F.conv2d`` call while the block runs."""
    import torch.nn.functional as F

    conv2d = F.conv2d

    def counted(x, w, *args, **kwargs):
        counts.append(w.shape[1])
        return conv2d(x, w, *args, **kwargs)

    F.conv2d = counted
    try:
        yield
    finally:
        F.conv2d = conv2d


def load_corpus_module():
    from mmbidaf_tpu_torch.examples import make_synthetic_corpus

    return make_synthetic_corpus


def timed_batches(fn, n: int = 5) -> float:
    """Median wall time of ``n`` calls, each ending in a synchronize."""
    import torch

    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def profile_kernels(fn, arg, t_ref: float, tag: str, unit: str, groups: dict | None = None):
    """``tools/device_profile.py``'s device-op table over 3 calls ``arg =
    fn(arg)`` after its warm-up calls (one pays CUPTI's start-up): device
    kernel time per call beside ``t_ref`` (the unprofiled median, seconds),
    the device's idle share of the profiled calls, the top kernels by device
    time, and the device time of the kernels whose names contain each of
    ``groups``' substrings. Returns the last ``arg``."""
    from mmbidaf_tpu_torch.tools.device_profile import group_ms, profile_ops

    for _ in range(3):  # a window that recorded no kernel (it happens now and then) is taken again
        prof = profile_ops(fn, arg, 3, on_card=True)
        rows, dev_ms, arg = prof.rows, prof.total_ms, prof.carry
        if dev_ms > 0:
            break
    if dev_ms <= 0:
        print(f"{tag} torch.profiler recorded no device kernel in 3 windows: no profile", flush=True)
        return arg
    print(f"{tag} torch.profiler over 3 calls: device kernel time {dev_ms:.2f} ms a {unit} "
          f"(median {unit} {t_ref * 1e3:.2f} ms unprofiled), device idle {prof.idle:.1%} of "
          f"the profiled calls; kernels by device time:", flush=True)
    for r in rows[:15]:
        print(f"    {r['ms']:9.3f} ms/{unit}  x{int(r['calls']):<5d} {r['name'][:90]}", flush=True)
    for name, ms in group_ms(rows, {k: (sub,) for k, sub in (groups or {}).items()}).items():
        print(f"{tag} {name} (kernels named *{groups[name]}*): {ms:.3f} ms a {unit}, "
              f"{ms / dev_ms:.1%} of the device time", flush=True)
    return arg


def vgg_passes(cfg, n_frames: int, dev) -> tuple[int, int]:
    """(frames a VGG pass takes, passes) for ``n_frames`` frames at ``cfg``."""
    from mmbidaf_tpu_torch.data.frontend import vgg_frame_chunk
    from mmbidaf_tpu_torch.ops.vgg import VGG16_SPEC

    chunk = vgg_frame_chunk(cfg, n_frames, VGG16_SPEC, dev) or n_frames
    return chunk, -(-n_frames // chunk)


def phase_epilogue(dev, cfg) -> dict:
    """Phase 3: the VGG's conv epilogue on the card at each VGG-16 block
    shape of a B=64 batch's frame chunk, bf16 and channels-last: in place
    and pooled, each equal (``torch.equal``) to its plain version, in place
    the output ``y`` itself, pooled ``y`` untouched. Its time over the 13
    convs of a pass (8 in place, 5 pooled; CUDA events) beside the separate
    bias add, ReLU and pool on the same tensors (the passes the stack ran
    before), and its bound from the bytes it must move. Returns its record
    (launches filled in by phase 4)."""
    import torch
    import torch.nn.functional as F

    from mmbidaf_tpu_torch.ops.cuda import conv_epilogue_kernel as ek
    from mmbidaf_tpu_torch.ops.vgg import VGG16_SPEC

    n, _ = vgg_passes(cfg, B * cfg.data.max_keyframes, dev)
    gen = torch.Generator(device=dev).manual_seed(24)
    layers = vgg_conv_layers(VGG16_SPEC, cfg.data.image_size)
    spec = list(VGG16_SPEC)
    pooled = [nxt == "M" for item, nxt in zip(spec, spec[1:] + [None]) if item != "M"]
    check(sum(pooled) == 5 and len(layers) == 13, f"(3) VGG-16 pools {sum(pooled)} of {len(layers)}")
    times = {}
    for size, c in sorted({(size, c_out) for size, _, c_out in layers}, reverse=True):
        y = torch.empty(n, c, size, size, device=dev, dtype=torch.bfloat16,
                        memory_format=torch.channels_last).normal_(generator=gen)
        b = (torch.randn(c, device=dev, generator=gen) * 0.5).bfloat16()
        for pool in (True, False):  # the pooled call leaves y as it was
            want = ek.conv_epilogue_reference(y, b, pool)
            y0 = y.clone() if pool else None
            before = ek.conv_epilogue.launches
            got = ek.conv_epilogue(y, b, pool)
            check(ek.conv_epilogue.launches == before + 1, "(3) conv_epilogue did not launch once")
            check(got.is_contiguous(memory_format=torch.channels_last) and torch.equal(got, want),
                  f"(3) conv_epilogue [{n}, {c}, {size}, {size}] pool={pool} differs from its plain version")
            check(torch.equal(y, y0) if pool else got.data_ptr() == y.data_ptr(),
                  f"(3) conv_epilogue pool={pool} at {size}² {c} wrote where it should not")
            del want, got, y0
        for pool in (True, False):  # timed after the checks: the passes rewrite y
            k = time_ms(lambda: ek.conv_epilogue(y, b, pool), iters=3, reps=3)
            p = time_ms(lambda: (F.max_pool2d(ek.bias_relu_(y, b), 2, 2) if pool
                                 else ek.bias_relu_(y, b)), iters=3, reps=3)
            times[size, c, pool] = (k, p)
        del y
        torch.cuda.empty_cache()
    ms = plain = 0.0
    parts = []
    for (size, _, c), pool in zip(layers, pooled):
        k, p = times[size, c, pool]
        ms, plain = ms + k, plain + p
        elems = n * size * size * c
        out = elems // 4 if pool else elems
        parts.append(bound(2 * elems + (3 * out if pool else 0), 2 * (elems + out + c)))
    rec = {"name": "conv_epilogue", "route": "cuda", "source": "mmbidaf_tpu_torch/csrc/conv_epilogue.cu",
           "replaces": None, "launches": 0, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
           **bound_fields(parts), "library_ms": None}
    print(f"conv_epilogue: a VGG-16 pass of {n} frames (bf16, 8 in place + 5 pooled): equal to "
          f"its plain version at every shape; kernel={ms:.4f} ms plain={plain:.4f} ms "
          f"bound={rec['bound_ms']:.4f} ms ({rec['bound_by']}; {rec['bound_ms'] / ms:.1%} of the bound); "
          + "; ".join(f"{s}² x{c} {'pool' if pl else 'in place'} {k:.3f}/{p:.3f} ms"
                      for (s, c, pl), (k, p) in sorted(times.items(), reverse=True)), flush=True)
    return rec


def phase_slice(dev, card: str, cfg, records: list[dict]) -> float:
    """Phase 4: the serving slice at the bench configuration. ``records`` are
    K1's, K2's, K3's and the conv epilogue's, whose launches it fills in.
    Returns the median time of a B=64 batch (seconds)."""
    import torch

    from mmbidaf_tpu_torch.data.frontend import make_end_to_end_decode
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel, lstm_kernel, melspec_kernel
    from mmbidaf_tpu_torch.ops.cuda.conv_epilogue_kernel import conv_epilogue
    from mmbidaf_tpu_torch.serving import Summarizer

    t0 = time.perf_counter()
    s = Summarizer.init_random(cfg, seed=0, device=dev, serve_batch_size=4)
    torch.cuda.synchronize()
    print(f"slice: bench config, random weights from seed 0, init "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(0)
    raw_np = raw_batch(cfg, rng)
    raw = {k: torch.from_numpy(v).to(dev) for k, v in raw_np.items()}
    end_to_end = make_end_to_end_decode(cfg)

    counters = (lstm_kernel.bilstm_cuda, bidaf_kernel.bidaf_attention_fused, melspec_kernel.mfcc_fused,
                conv_epilogue)
    for fn in counters:
        fn.launches = 0
    lstm_kernel.bilstm_cuda.routes = {"cluster": 0, "l2": 0}
    bidaf_kernel.bidaf_attention_fused.routes = {"cluster": 0, "K9": 0}
    melspec_kernel.mfcc_fused.routes = {"fft": 0, "dense": 0}
    torch.cuda.reset_peak_memory_stats(dev)
    # (a) the end-to-end program at B=64
    lp, picks = end_to_end(s.model, s.frontend, raw)
    torch.cuda.synchronize()
    chunk, passes = vgg_passes(cfg, B * cfg.data.max_keyframes, dev)
    check(conv_epilogue.launches == 13 * passes,
          f"(a) conv_epilogue launched {conv_epilogue.launches} times in one batch of {passes} "
          f"VGG passes of {chunk} frames, not 13 a pass")
    check_decode(lp.cpu().numpy(), picks.cpu().numpy(), raw_np, cfg, "end-to-end bf16")
    t_batch = timed_batches(lambda: end_to_end(s.model, s.frontend, raw))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"(a) end-to-end B={B}: median batch {t_batch * 1e3:.2f} ms over 5 -> "
          f"{B / t_batch:.2f} videos/s on {card}; peak memory {peak_gb:.2f} GB", flush=True)
    profile_kernels(lambda _: end_to_end(s.model, s.frontend, raw), None, t_batch, "(a)", "batch",
                    {"K1 bilstm": "bilstm_cluster_kernel", "K2 bidaf": "bidaf_fwd_cluster_kernel",
                     "K3 mfcc (FFT pass)": "logmel_fft_kernel", "K3 mfcc (DCT pass)": "mfcc_dct_kernel",
                     "conv epilogue": "conv_epilogue_vec_kernel"})
    # (b) 8 requests through the serving API
    with tempfile.TemporaryDirectory() as tmp:
        load_corpus_module().make_corpus(tmp, videos=8, sentences=12, frames=10, seconds=4.0, seed=0)
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
    k1_routes = lstm_kernel.bilstm_cuda.routes
    k2_routes = bidaf_kernel.bidaf_attention_fused.routes
    k3_routes = melspec_kernel.mfcc_fused.routes
    check(conv_epilogue.launches % 13 == 0,
          f"(c) conv_epilogue launched {conv_epilogue.launches} times, not 13 a VGG pass")
    print(f"(c) routes during (a)+(b): K1 {k1_routes}, K2 {k2_routes}, K3 {k3_routes}", flush=True)
    check(k1_routes["cluster"] == lstm_kernel.bilstm_cuda.launches and k1_routes["l2"] == 0,
          f"(c) K1 left its cluster route at the bench widths: {k1_routes}")
    check(k2_routes == {"cluster": bidaf_kernel.bidaf_attention_fused.launches, "K9": 0},
          f"(c) K2 left its cluster route at the bench widths: {k2_routes}")
    check(k3_routes == {"fft": melspec_kernel.mfcc_fused.launches, "dense": 0},
          f"(c) K3 left its FFT route at the bench widths: {k3_routes}")

    # (d) f32: kernels vs plain versions, same weights, same batch
    f32_kernels_vs_plain(cfg, s, raw, raw_np, "(d) bench")
    del s
    return t_batch


def phase_long(dev, card: str, long_records: list[dict]) -> float:
    """Phase 6: long-video serving at the long-audio configuration, then the
    log-mel configuration. K4's and K9's launches are counted over (a), (b)
    and the B=64 batch of (d). Returns (a)'s median batch, s."""
    import torch

    from mmbidaf_tpu_torch.data.frontend import apply_frontend, make_end_to_end_decode
    from mmbidaf_tpu_torch.data.text import sent_tokenize
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel, lstm_kernel, melspec_kernel
    from mmbidaf_tpu_torch.ops.lstm import stacked_bilstm_apply
    from mmbidaf_tpu_torch.serving import Summarizer

    cfg = long_config()
    d = cfg.data
    t0 = time.perf_counter()
    s = Summarizer.init_random(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"long: config6 on one device ({d.max_audio_frames} audio frames, vocab {d.vocab_size}, "
          f"{cfg.model.compute_dtype}), random weights from seed 0, init "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    raw_np = raw_batch(cfg, np.random.default_rng(1), B_LONG)
    raw = {k: torch.from_numpy(v).to(dev) for k, v in raw_np.items()}
    end_to_end = make_end_to_end_decode(cfg)
    counters = {"K1": lstm_kernel.bilstm_cuda, "K2": bidaf_kernel.bidaf_attention_fused,
                "K3": melspec_kernel.mfcc_fused, "K4": melspec_kernel.log_mel_fused,
                "K9": bidaf_kernel.bidaf_attention_tiled}
    for fn in counters.values():
        fn.launches = 0
    lstm_kernel.bilstm_cuda.routes = {"cluster": 0, "l2": 0}
    bidaf_kernel.bidaf_attention_fused.routes = {"cluster": 0, "K9": 0}
    melspec_kernel.log_mel_fused.routes = {"fft": 0, "dense": 0}
    torch.cuda.reset_peak_memory_stats(dev)
    # (a) the end-to-end program at B=16, 4096 audio frames
    lp, picks = end_to_end(s.model, s.frontend, raw)
    torch.cuda.synchronize()
    check_decode(lp.cpu().numpy(), picks.cpu().numpy(), raw_np, cfg, "long-audio bf16")
    t_batch = timed_batches(lambda: end_to_end(s.model, s.frontend, raw))
    t_6a = t_batch
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"(6a) end-to-end B={B_LONG}, {d.max_audio_frames} audio frames: median batch "
          f"{t_batch * 1e3:.2f} ms over 5 -> {B_LONG / t_batch:.3f} videos/s on {card}; "
          f"peak memory {peak_gb:.2f} GB", flush=True)
    # (b) windowed long transcripts through the serving API, then one plain request
    with tempfile.TemporaryDirectory() as tmp:
        load_corpus_module().make_corpus(tmp, videos=2, sentences=80, frames=16, seconds=41.0,
                                         seed=1)
        dirs = sorted(os.path.join(tmp, v) for v in os.listdir(tmp))
        with open(os.path.join(dirs[0], "transcript.txt")) as f:
            n_sents = len(sent_tokenize(f.read()))
        check(n_sents > d.max_sentences, f"the long transcript has only {n_sents} sentences")
        t0 = time.perf_counter()
        longs = [s.summarize_long(v) for v in dirs]
        dt_long = time.perf_counter() - t0
        t0 = time.perf_counter()
        short = s.summarize(dirs[0])
        dt_short = time.perf_counter() - t0
    check(all(isinstance(x, str) and x for x in longs + [short]), "long-video summaries: empty")
    print(f"(6b) summarize_long: 2 requests of {n_sents} sentences (windows of {d.max_sentences}, "
          f"stride {d.max_sentences // 2}) answered in {dt_long:.2f} s; summarize: 1 request in "
          f"{dt_short:.2f} s; first: {longs[0][:80]!r}", flush=True)
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"(6a-b) launches: {launches}", flush=True)
    for k in ("K1", "K2", "K4", "K9"):
        check(launches[k] > 0, f"{k} was never launched on the long-audio path")
    check(launches["K3"] == 0, "K3 ran on the long-audio path (4096 frames exceed its bound)")
    routes = {"K1": lstm_kernel.bilstm_cuda.routes, "K2": bidaf_kernel.bidaf_attention_fused.routes,
              "K4": melspec_kernel.log_mel_fused.routes}
    print(f"(6a-b) routes: {routes}", flush=True)
    check(routes["K1"] == {"cluster": launches["K1"], "l2": 0}, "(6a-b) K1 left its cluster route")
    check(routes["K2"] == {"cluster": launches["K2"], "K9": launches["K9"]},
          "(6a-b) K2's wrapper took other routes than the image tower's cluster and the audio's K9")
    check(routes["K4"] == {"fft": launches["K4"], "dense": 0}, "(6a-b) K4 left its FFT route")
    rec4, rec9 = long_records
    rec4["launches"], rec9["launches"] = launches["K4"], launches["K9"]
    # where the time of (a) goes: the frontend alone, the audio tower's
    # BiLSTM alone (4096 steps, bf16 as in the model), and a profile
    with torch.inference_mode():
        t_front = timed_batches(lambda: apply_frontend(s.frontend, raw, cfg))
        feats = apply_frontend(s.frontend, raw, cfg)
        aud = copy.deepcopy(s.model.aud_lstm).to(torch.bfloat16)
        x, m = feats["audio"].bfloat16(), feats["aud_mask"].bfloat16()
        t_aud = time_ms(lambda: stacked_bilstm_apply(aud, x, m, bilstm_fn=lstm_kernel.bilstm_cuda),
                        iters=2, reps=3)
    print(f"(6a) frontend alone (VGG-16 on {B_LONG * d.max_keyframes} keyframes, K4 and dB/DCT on "
          f"{B_LONG}x{d.max_audio_frames} frames): median {t_front * 1e3:.2f} ms; model + decode "
          f"{(t_batch - t_front) * 1e3:.2f} ms; the audio BiLSTM alone (K1, {d.max_audio_frames} "
          f"steps): {t_aud:.2f} ms", flush=True)
    profile_kernels(lambda _: end_to_end(s.model, s.frontend, raw), None, t_batch, "(6a)", "batch",
                    {"K1 bilstm": "bilstm_cluster_kernel", "K2 bidaf": "bidaf_fwd_cluster_kernel",
                     "K4 log_mel": "logmel_fft_kernel", "K9 bidaf_tiled": "tiled_"})
    # (c) f32 at B=2: kernels vs plain versions
    f32_kernels_vs_plain(cfg, s, {k: v[:2] for k, v in raw.items()},
                         {k: v[:2] for k, v in raw_np.items()}, "(6c) long-audio")
    del s

    # (d) the log-mel configuration: one B=64 batch through K4's log mode
    lm = logmel_config()
    s = Summarizer.init_random(lm, seed=0, device=dev)
    raw_np = raw_batch(lm, np.random.default_rng(2))
    raw = {k: torch.from_numpy(v).to(dev) for k, v in raw_np.items()}
    k4 = melspec_kernel.log_mel_fused
    k4.launches = 0
    k4.routes = {"fft": 0, "dense": 0}
    end_to_end = make_end_to_end_decode(lm)
    lp, picks = end_to_end(s.model, s.frontend, raw)
    torch.cuda.synchronize()
    check_decode(lp.cpu().numpy(), picks.cpu().numpy(), raw_np, lm, "logmel bf16")
    # only the log mode runs on this configuration (logmel, not MFCC)
    check(k4.launches > 0, "K4's log mode was never launched on the log-mel path")
    check(k4.routes == {"fft": k4.launches, "dense": 0}, f"(6d) K4 left its FFT route: {k4.routes}")
    launched = k4.launches
    rec4["launches"] += launched
    t_batch = timed_batches(lambda: end_to_end(s.model, s.frontend, raw), n=3)
    print(f"(6d) logmel B={B}: K4 log launches {launched} (routes {k4.routes}); median batch "
          f"{t_batch * 1e3:.2f} ms over 3 -> {B / t_batch:.2f} videos/s on {card}", flush=True)
    f32_kernels_vs_plain(lm, s, {k: v[:2] for k, v in raw.items()},
                         {k: v[:2] for k, v in raw_np.items()}, "(6d) logmel")
    return t_6a


def winograd_config():
    """The bench configuration with the Winograd VGG frontend
    (``use_winograd_conv=True``)."""
    cfg = bench_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, use_winograd_conv=True))


def vgg_conv_layers(spec, size: int) -> list[tuple[int, int, int]]:
    """(spatial size, C_in, C_out) of each 3x3 conv of ``spec`` on ``size``² frames."""
    layers, c_in = [], 3
    for item in spec:
        if item == "M":
            size //= 2
        else:
            layers.append((size, c_in, item))
            c_in = item
    return layers


def conv_library_call(x, w, b):
    """A callable: one cuDNN conv with bias, then ReLU, on the channels-last
    view of the NHWC ``x`` (HWIO ``w``), in its dtype."""
    import torch
    import torch.nn.functional as F

    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return lambda: F.relu(F.conv2d(xc, wc, b, padding=1), inplace=True)


def conv_library_ms(x, w, b) -> float:
    return time_ms(conv_library_call(x, w, b), iters=3)


def device_ms(fn, calls: int = 10) -> float:
    """Device time of one call of ``fn``: the time of all its CUDA kernels
    under ``torch.profiler`` over ``calls`` back-to-back calls, per call. It
    leaves out the host's launch overhead, which the CUDA-event time of a
    call of tens of microseconds can be made of."""
    return sum(device_ms_by_kernel(fn, ("",), calls).values())


def device_ms_by_kernel(fn, subs, calls: int = 10, windows: int = 3) -> dict:
    """As ``device_ms``, split by kernel: the device time per call of the
    kernels whose names contain each of ``subs``. A profiler window that
    recorded no kernel at all (it happens now and then) is taken again, up
    to ``windows`` times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if kernels:
            break
    check(bool(kernels), f"torch.profiler recorded no kernel in {windows} windows")
    return {sub: sum(e.self_device_time_total for e in kernels if sub in e.key) / calls / 1e3
            for sub in subs}


def achieved(flops: float, ms: float, part: tuple[float, float]) -> str:
    """The achieved rate of ``flops`` in ``ms`` and the share of the bound
    ``part`` (its larger time over ``ms``)."""
    return f"({flops / ms / 1e9:.1f} TFLOP/s, {max(part) / ms:.1%} of the bound)"


def print_tensor_core_resources() -> None:
    """ptxas's registers, spills and static shared memory for the tensor-core
    bodies of K14 and K11-K13 (from the build log), and the dynamic shared
    memory a block of each asks for."""
    from mmbidaf_tpu_torch.ops.cuda import build

    log = build.library_path().with_suffix(".log")
    check(log.exists(), f"(7b) no build log at {log}")
    res = build.ptxas_resources(log.read_text())
    lib = build.library()
    for label, key, smem in (("K14 bf16", "winograd_mma_kernel", lib.mmb_winograd_mma_smem_bytes()),
                             ("K11 bf16", "conv3x3_im2col_mma_kernel", lib.mmb_conv3x3_mma_smem_bytes()),
                             ("K12 bf16", "conv3x3_taps_mma_kernel", lib.mmb_conv3x3_taps_smem_bytes()),
                             ("K13 bf16", "conv3x3_ring_mma_kernel", lib.mmb_conv3x3_ring_smem_bytes())):
        found = [r for name, r in res.items() if key in name]
        check(len(found) == 1, f"(7b) ptxas reported {len(found)} kernels named {key}")
        r = found[0]
        print(f"  {label} ({key}): {r['registers']} registers, spill stores {r['spill_stores']} B, "
              f"spill loads {r['spill_loads']} B, static smem {r['smem']} B, dynamic smem {smem} B",
              flush=True)


def template_args(mangled: str, key: str) -> str:
    """The template arguments of kernel ``key`` in its mangled name, as
    ``<4, false>`` (integers and booleans only), or ``-`` if it has none."""
    rest = mangled[mangled.index(key) + len(key):]
    if not rest.startswith("I"):
        return "-"
    args = re.findall(r"L([ib])(\d+)", rest.split("EE", 1)[0])
    return "<" + ", ".join(v if k == "i" else ("true" if v == "1" else "false") for k, v in args) + ">"


def print_resources(label: str, keys, keep=lambda inst: True) -> None:
    """ptxas's registers, spills and static shared memory (from the build
    log) of every instance of each kernel in ``keys``."""
    from mmbidaf_tpu_torch.ops.cuda import build

    log = build.library_path().with_suffix(".log")
    check(log.exists(), f"({label}) no build log at {log}")
    res = build.ptxas_resources(log.read_text())
    for tag, key in keys:
        found = sorted((template_args(name, key), r) for name, r in res.items()
                       if f"{len(key)}{key}" in name)
        found = [(inst, r) for inst, r in found if keep(inst)]
        check(len(found) > 0, f"({label}) ptxas reported no kernel named {key}")
        for inst, r in found:
            print(f"  {tag} {key}{inst}: {r['registers']} registers, spill stores "
                  f"{r['spill_stores']} B, spill loads {r['spill_loads']} B, static smem {r['smem']} B",
                  flush=True)


def print_lstm_resources(plans: dict, which: str) -> None:
    """ptxas's registers, spills and static shared memory of K1's kernels
    (``which="K1"``: the cluster body without residuals, and the L2 route)
    or of K5's and K6's, and each tower's dynamic shared memory a block
    under its cluster plan."""
    if which == "K1":
        print_resources("3", (("K1", "bilstm_cluster_kernel"), ("K1 l2", "bilstm_kernel")),
                        keep=lambda inst: not inst.endswith("true>"))
    else:
        print_resources("3", (("K5", "bilstm_cluster_kernel"), ("K6 (a)", "lstm_z_kernel"),
                              ("K6 (b)", "bilstm_bptt_cluster_kernel"),
                              ("K6 (c)", "lstm_dwh_partial_kernel"), ("K6 (c)", "sum_partials_kernel")),
                        keep=lambda inst: not inst.endswith("false>"))
    for tag, plan in plans.items():
        smem = (f"K1 {plan.smem_fwd} B" if which == "K1"
                else f"K5 {plan.smem_fwd} B, K6 walk {plan.smem_bwd} B")
        print(f"  {which} {tag}: dynamic smem a block {smem} (C={plan.C}, R={plan.R})", flush=True)


def phase_parity_tool(dev) -> dict:
    """Phase 7a: the kernel-parity tool at batch 32; K10-K13's launches over it."""
    from mmbidaf_tpu_torch.ops.cuda import conv_kernel, preprocess_kernel
    from mmbidaf_tpu_torch.tools import kernel_parity

    counters = {"K10": preprocess_kernel.preprocess_frames_fused, "K11": conv_kernel.conv3x3_same,
                "K12": conv_kernel.conv3x3_same_acc, "K13": conv_kernel.conv3x3_same_db}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    report = kernel_parity.run(dev, 32)
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"(7a) kernel_parity batch 32: {report['n_rows'] - report['n_fail']}/{report['n_rows']} rows "
          f"pass in {time.perf_counter() - t0:.1f} s; launches over it: {launches}", flush=True)
    check(report["n_fail"] == 0, "(7a) a kernel-parity row failed")
    covered = {k for r in report["results"] for k in r["kernels"]}
    check(covered == set(kernel_parity.KERNELS), f"(7a) the tool covers {sorted(covered)}")
    for k, n in launches.items():
        check(n > 0, f"(7a) {k} was never launched by the kernel-parity tool")
    return launches


def phase_vgg_kernels(dev, tool_launches: dict) -> list[dict]:
    """Phase 7b: K10-K14 against their plain versions, timed, at the shapes
    their paths use. Returns their records (K14's launches filled in by 7c-d)."""
    import torch

    from mmbidaf_tpu_torch.ops.cuda import conv_kernel as ck
    from mmbidaf_tpu_torch.ops.cuda import preprocess_kernel as pk
    from mmbidaf_tpu_torch.ops.cuda import winograd_kernel as wk
    from mmbidaf_tpu_torch.ops.vgg import IMAGENET_MEAN, IMAGENET_STD, VGG16_SPEC
    from mmbidaf_tpu_torch.tools import kernel_parity

    gen = torch.Generator(device=dev).manual_seed(17)
    records = []
    print_tensor_core_resources()

    def record(name, src, replaces, err, ms, plain, lib, parts, launches):
        rec = {"name": name, "route": "cuda", "source": f"mmbidaf_tpu_torch/csrc/{src}",
               "replaces": f"mmbidaf_tpu/ops/pallas/{replaces}", "launches": launches,
               "max_abs_err": err, "ms": ms, "plain_ms": plain, **bound_fields(parts),
               "library_ms": lib}
        print(f"{name}: max_abs_err={err:.3e} kernel={ms:.4f} ms plain={plain:.4f} ms "
              f"library={lib if lib is None else round(lib, 4)} ms bound={rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}); launches {launches}", flush=True)
        records.append(rec)

    # K10 at the tool's shape: 64 frames of 240x320 -> 224, f32 out (and bf16),
    # beside one resize call of the library plus one elementwise pass.
    n, h, w, s = 64, *FRAME_HW, 224
    fr = torch.randint(0, 256, (n, h, w, 3), device=dev, generator=gen, dtype=torch.uint8)
    err = compare("preprocess[64x240x320->224]", pk.preprocess_frames_fused(fr, s),
                  pk.preprocess_reference(fr, s), pk.TOLERANCE[torch.float32])
    e16 = compare("preprocess[64x240x320->224, bf16]", pk.preprocess_frames_fused(fr, s, torch.bfloat16),
                  pk.preprocess_reference(fr, s, torch.bfloat16), pk.TOLERANCE[torch.bfloat16])
    check(torch.equal(pk.preprocess_frames_fused(fr, s), pk.preprocess_frames_fused(fr, s)),
          "K10: two runs differ")
    ms = time_ms(lambda: pk.preprocess_frames_fused(fr, s), iters=10)
    kd = device_ms(lambda: pk.preprocess_frames_fused(fr, s))
    plain = time_ms(lambda: pk.preprocess_reference(fr, s), iters=10)
    # the library: F.interpolate on the widened frames, channels-last, then
    # (y/255 - mean)/std as one addcmul (never used by the port)
    xf = fr.permute(0, 3, 1, 2).float().contiguous(memory_format=torch.channels_last)
    std = torch.from_numpy(IMAGENET_STD).to(dev).view(1, 3, 1, 1)
    mean = torch.from_numpy(IMAGENET_MEAN).to(dev).view(1, 3, 1, 1)
    scale, shift = 1.0 / (255.0 * std), -(mean / std)

    def library():
        y = torch.nn.functional.interpolate(xf, size=(s, s), mode="bilinear", antialias=True,
                                            align_corners=False)
        return torch.addcmul(shift, y, scale)

    e_lib = (library().permute(0, 2, 3, 1) - pk.preprocess_reference(fr, s)).abs().max().item()
    check(e_lib <= pk.TOLERANCE[torch.float32]["atol"], f"K10's library call is {e_lib:.3e} off")
    lib = time_ms(library, iters=10)
    lib_d = device_ms(library)
    plan = pk.preprocess_plan(s, h, w)
    part = bound(resize_flops(n, h, w, s), n * (h * w * 3 + s * s * 3 * 4))
    print(f"  K10 preprocess 64x{h}x{w}->{s}: {plan.rows} output rows a block, input band "
          f"{plan.band_rows} rows, smem {plan.smem} B, {-(-s // plan.rows) * n} blocks; "
          f"max_abs_err f32 {err:.3e} bf16 {e16:.3e}; deterministic; kernel {ms:.4f} ms (device "
          f"{kd:.4f}, {max(part) / kd:.1%} of the bound); library (F.interpolate antialias + one "
          f"addcmul, f32 frames) {lib:.4f} ms (device {lib_d:.4f}, {e_lib:.2e} from plain)", flush=True)
    print_resources("7b", (("K10", "preprocess_band_kernel"),))
    record("preprocess_frames_fused", "preprocess.cu", "preprocess_kernel.py:39", err, ms, plain, lib,
           [part], tool_launches["K10"])
    del fr, xf

    # K11-K13 at the tool's VGG-16 layers (N=8, bf16), beside cuDNN.
    rec = {k: {"err": 0.0, "ms": 0.0} for k in ("K11", "K12", "K13")}
    device = dict.fromkeys(("K11", "K12", "K13", "cuDNN"), 0.0)
    plain = lib = 0.0
    parts = []
    nb = 32 // 4
    for layer, size, c_in, c_out in kernel_parity.CONV_LAYERS:
        x, wt, b = (t.to(dev) for t in kernel_parity.conv_operands(
            np.random.default_rng(size), "cpu", nb, size, c_in, c_out))
        ref = ck.conv3x3_reference(x, wt, b)
        flops = 2 * nb * size * size * 9 * c_in * c_out
        parts.append(bound(flops, 2 * (nb * size * size * (c_in + c_out) + 9 * c_in * c_out + c_out),
                           PEAK_BF16_FLOPS))
        line = []
        for k, fn in (("K11", ck.conv3x3_same), ("K12", ck.conv3x3_same_acc),
                      ("K13", ck.conv3x3_same_db)):
            e = compare(f"{fn.__name__}[{layer}]", fn(x, wt, b), ref, ck.TOLERANCE[x.dtype])
            t = time_ms(lambda: fn(x, wt, b), iters=3)
            rec[k]["err"], rec[k]["ms"] = max(rec[k]["err"], e), rec[k]["ms"] + t
            line.append(f"{k} {t:.4f} ms (err {e:.2e}) {achieved(flops, t, parts[-1])}")
        route = ck.conv3x3_same_db.route
        check(route == "tma", f"(7b) K13 took the {route} route at {layer}, not TMA")
        p = time_ms(lambda: ck.conv3x3_reference(x, wt, b), iters=3)
        lb = conv_library_ms(x, wt, b)
        plain, lib = plain + p, lib + lb
        print(f"  K11-K13 {layer} N={nb} {size}² {c_in}->{c_out} bf16: {'; '.join(line)}; K13 route {route}; "
              f"plain {p:.4f} ms; cuDNN {lb:.4f} ms; bound {max(parts[-1]):.4f} ms", flush=True)
        line = []
        for k, fn in (("K11", ck.conv3x3_same), ("K12", ck.conv3x3_same_acc),
                      ("K13", ck.conv3x3_same_db), ("cuDNN", conv_library_call(x, wt, b))):
            d = device_ms(fn if k == "cuDNN" else lambda: fn(x, wt, b))
            device[k] += d
            line.append(f"{k} {d:.4f} ms {achieved(flops, d, parts[-1])}")
        print(f"  K11-K13 {layer} device time (torch.profiler, 10 calls): {'; '.join(line)}", flush=True)
    print(f"  K11-K13 device time over the three layers: "
          f"{'; '.join(f'{k} {d:.4f} ms' for k, d in device.items())}", flush=True)
    for k, name, body in (("K11", "conv3x3_same", 32), ("K12", "conv3x3_same_acc", 124),
                          ("K13", "conv3x3_same_db", 208)):
        record(name, "conv3x3.cu", f"conv_kernel.py:{body}", rec[k]["err"], rec[k]["ms"], plain, lib,
               parts, tool_launches[k])

    # K14 at the Winograd serving path's twelve convs: B_WINO videos x 16 keyframes.
    nf = B_WINO * bench_config().data.max_keyframes
    err = ms = plain = lib = 0.0
    parts = []
    for size, c_in, c_out in vgg_conv_layers(VGG16_SPEC, 224):
        if c_in < 32:
            continue
        x = torch.randn(nf, size, size, c_in, device=dev, generator=gen).bfloat16()
        wt = (torch.randn(3, 3, c_in, c_out, device=dev, generator=gen)
              * math.sqrt(2.0 / (9 * c_in))).bfloat16()
        b = (torch.randn(c_out, device=dev, generator=gen) * 0.1).bfloat16()
        e = compare(f"winograd[{size}² {c_in}->{c_out}]", wk.winograd_conv3x3_fused(x, wt, b, relu=True),
                    wk.winograd_reference(x, wt, b, relu=True), wk.TOLERANCE[x.dtype])
        k = time_ms(lambda: wk.winograd_conv3x3_fused(x, wt, b, relu=True), iters=2, reps=3)
        p = time_ms(lambda: wk.winograd_reference(x, wt, b, relu=True), iters=1, reps=3)
        lb = conv_library_ms(x, wt, b)
        err, ms, plain, lib = max(err, e), ms + k, plain + p, lib + lb
        flops = 2 * nf * size * size * 9 * c_in * c_out * 16 / 36
        parts.append(bound(flops, 2 * (nf * size * size * (c_in + c_out) + 16 * c_in * c_out + c_out),
                           PEAK_BF16_FLOPS))
        print(f"  K14 N={nf} {size}² {c_in}->{c_out} bf16: max_abs_err={e:.3e} kernel={k:.3f} ms "
              f"{achieved(flops, k, parts[-1])} plain={p:.3f} ms cuDNN={lb:.3f} ms "
              f"bound={max(parts[-1]):.4f} ms", flush=True)
        del x
    record("winograd_conv3x3_fused", "winograd.cu", "winograd_kernel.py:46", err, ms, plain, lib, parts, 0)
    return records


def phase_winograd(dev, card: str, rec14: dict) -> None:
    """Phase 7c-e: serving at the bench config with the Winograd frontend."""
    import torch

    from mmbidaf_tpu_torch.data.frontend import apply_frontend, make_end_to_end_decode
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel, lstm_kernel, melspec_kernel, winograd_kernel
    from mmbidaf_tpu_torch.serving import Summarizer

    cfg = winograd_config()
    d = cfg.data
    t0 = time.perf_counter()
    s = Summarizer.init_random(cfg, seed=0, device=dev, serve_batch_size=4)
    torch.cuda.synchronize()
    print(f"winograd: bench config with use_winograd_conv=True, random weights from seed 0, init "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    raw_np = raw_batch(cfg, np.random.default_rng(4), B_WINO)
    raw = {k: torch.from_numpy(v).to(dev) for k, v in raw_np.items()}
    end_to_end = make_end_to_end_decode(cfg)
    counters = {"K1": lstm_kernel.bilstm_cuda, "K2": bidaf_kernel.bidaf_attention_fused,
                "K3": melspec_kernel.mfcc_fused, "K14": winograd_kernel.winograd_conv3x3_fused}
    for fn in counters.values():
        fn.launches = 0
    lstm_kernel.bilstm_cuda.routes = {"cluster": 0, "l2": 0}
    bidaf_kernel.bidaf_attention_fused.routes = {"cluster": 0, "K9": 0}
    melspec_kernel.mfcc_fused.routes = {"fft": 0, "dense": 0}
    direct = []
    # (c) one batch: K14 for the twelve C_in >= 32 convs, the direct conv for the stem
    with count_direct_convs(direct):
        lp, picks = end_to_end(s.model, s.frontend, raw)
        torch.cuda.synchronize()
    check_decode(lp.cpu().numpy(), picks.cpu().numpy(), raw_np, cfg, "winograd bf16")
    first = {k: fn.launches for k, fn in counters.items()}
    print(f"(7c) one B={B_WINO} batch: launches {first}; direct convs by C_in {direct}", flush=True)
    check(first["K14"] == 12, f"(7c) K14 ran {first['K14']} times in one VGG-16 pass, not 12")
    check(direct == [3], f"(7c) the direct conv ran for C_in {direct}, not only the stem")
    for k in ("K1", "K2", "K3"):
        check(first[k] > 0, f"(7c) {k} was never launched on the Winograd serving path")
    torch.cuda.reset_peak_memory_stats(dev)
    t_batch = timed_batches(lambda: end_to_end(s.model, s.frontend, raw))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"(7c) end-to-end B={B_WINO} (256 keyframes), Winograd VGG: median batch "
          f"{t_batch * 1e3:.2f} ms over 5 -> {B_WINO / t_batch:.3f} videos/s on {card}; "
          f"peak memory {peak_gb:.2f} GB", flush=True)
    with torch.inference_mode():
        t_front = timed_batches(lambda: apply_frontend(s.frontend, raw, cfg))
        direct_cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, use_winograd_conv=False))
        t_direct = timed_batches(lambda: apply_frontend(s.frontend, raw, direct_cfg))
    print(f"(7c) frontend alone (VGG-16 on {B_WINO * d.max_keyframes} keyframes + MFCC): Winograd "
          f"{t_front * 1e3:.2f} ms, direct cuDNN {t_direct * 1e3:.2f} ms; model + decode "
          f"{(t_batch - t_front) * 1e3:.2f} ms", flush=True)
    profile_kernels(lambda _: end_to_end(s.model, s.frontend, raw), None, t_batch, "(7c)", "batch",
                    {"K14 winograd": "winograd_mma_kernel", "K1 bilstm": "bilstm_cluster_kernel",
                     "max-pool": "max_pool"})
    # (d) 4 requests through the serving API
    with tempfile.TemporaryDirectory() as tmp:
        load_corpus_module().make_corpus(tmp, videos=4, sentences=12, frames=10, seconds=4.0, seed=3)
        dirs = sorted(os.path.join(tmp, v) for v in os.listdir(tmp))
        t0 = time.perf_counter()
        summaries = s.summarize_batch(dirs)
        dt = time.perf_counter() - t0
    check(len(summaries) == 4 and all(isinstance(x, str) and x for x in summaries),
          "(7d) summarize_batch: empty or missing summaries")
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"(7d) summarize_batch: 4 requests answered in {dt:.2f} s; first: {summaries[0][:80]!r}; "
          f"launches over (7c)-(7d): {launches}", flush=True)
    check(launches["K14"] > first["K14"], "(7d) K14 was not launched by summarize_batch")
    k1_routes = lstm_kernel.bilstm_cuda.routes
    k2_routes = bidaf_kernel.bidaf_attention_fused.routes
    k3_routes = melspec_kernel.mfcc_fused.routes
    print(f"(7c-d) routes: K1 {k1_routes}, K2 {k2_routes}, K3 {k3_routes}", flush=True)
    check(k1_routes == {"cluster": launches["K1"], "l2": 0}, "(7c-d) K1 left its cluster route")
    check(k2_routes == {"cluster": launches["K2"], "K9": 0}, "(7c-d) K2 left its cluster route")
    check(k3_routes == {"fft": launches["K3"], "dense": 0}, "(7c-d) K3 left its FFT route")
    rec14["launches"] = launches["K14"]
    # (e) for information: bf16 Winograd vs direct features; then f32 kernels vs plain at B=2
    two = {k: v[:2] for k, v in raw.items()}
    with torch.inference_mode():
        fw = apply_frontend(s.frontend, two, cfg)["images"]
        fd = apply_frontend(s.frontend, two, direct_cfg)["images"]
    dist = (fw - fd).abs().max().item()
    print(f"(7e) bf16 VGG features, Winograd vs direct, B=2: max abs diff {dist:.3e}, "
          f"{dist / fd.abs().max().item():.3e} of max |direct|", flush=True)
    k14 = winograd_kernel.winograd_conv3x3_fused.launches
    f32_kernels_vs_plain(cfg, s, two, {k: v[:2] for k, v in raw_np.items()}, "(7e) winograd")
    check(winograd_kernel.winograd_conv3x3_fused.launches == k14 + 12,
          "(7e) the f32 kernel path did not run K14 twelve times")


def print_bidaf_drop_resources(plans: dict) -> None:
    """ptxas's registers, spills and static shared memory for K7's and K8's
    cluster kernels (from the build log), and each shape's plan and dynamic
    shared memory a block."""
    from mmbidaf_tpu_torch.ops.cuda import build

    log = build.library_path().with_suffix(".log")
    check(log.exists(), f"(3) no build log at {log}")
    res = build.ptxas_resources(log.read_text())
    for label, key in (("K7", "bidaf_drop_fwd_cluster_kernel"), ("K8", "bidaf_drop_bwd_cluster_kernel"),
                       ("K8", "sum_over_batch_kernel")):
        found = [r for name, r in res.items() if key in name]
        check(len(found) == 1, f"(3) ptxas reported {len(found)} kernels named {key}")
        r = found[0]
        print(f"  {label} {key}: {r['registers']} registers, spill stores {r['spill_stores']} B, "
              f"spill loads {r['spill_loads']} B, static smem {r['smem']} B", flush=True)
    for tag, plan in plans.items():
        print(f"  K7/K8 {tag}: C={plan.C} tile={plan.tq}; dynamic smem a block K7 {plan.smem_fwd} B, "
              f"K8 {plan.smem_bwd} B", flush=True)


def train_state(cfg, dev, seed: int, batch_size: int = B_TRAIN):
    """A ``TrainState`` at ``cfg`` from ``seed`` and one fixed synthetic batch
    of ``batch_size``."""
    import torch

    from mmbidaf_tpu_torch.data.synthetic import random_word_vectors, synthetic_batch
    from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_init
    from mmbidaf_tpu_torch.train.loop import init_train_state

    rng = np.random.default_rng(seed)
    wv = random_word_vectors(rng, cfg.data.vocab_size, cfg.model.emb_dim)
    state = init_train_state(mmbidaf_init(cfg, wv, dev, seed=seed), cfg, seed=seed + 1)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in synthetic_batch(rng, cfg, batch_size=batch_size).items()}
    return state, batch


def phase_train(dev, card: str, records: list[dict]) -> float:
    """Phase 5: the training step at the bench_train configuration; returns
    its median step, s."""
    import torch

    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel, lstm_kernel
    from mmbidaf_tpu_torch.train.loop import make_train_step

    cfg = train_config()
    t0 = time.perf_counter()
    state, batch = train_state(cfg, dev, seed=0)
    train_step = make_train_step(cfg)
    torch.cuda.synchronize()
    print(f"train: bench_train config (f32, drop 0.2, adadelta, B={B_TRAIN}), random weights "
          f"from seed 0, init {time.perf_counter() - t0:.2f} s", flush=True)
    counters = (lstm_kernel.bilstm_train_forward, lstm_kernel.bilstm_bptt,
                bidaf_kernel.bidaf_dropout_forward, bidaf_kernel.bidaf_dropout_backward)
    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_s = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        check(math.isfinite(loss) and math.isfinite(gnorm), f"train step {i}: loss {loss}, grad norm {gnorm}")
        losses.append(loss)
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"(5a) launches during {TRAIN_STEPS} steps: {launches}", flush=True)
    for rec, fn in zip(records, counters):
        check(fn.launches > 0, f"{fn.__name__} was never launched on the training path")
        rec["launches"] = fn.launches
    first, last = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    print(f"(5a) loss: first {losses[0]:.6f}, mean of steps 1-10 {first:.6f}, "
          f"mean of the last 10 {last:.6f}; last grad norm {gnorm:.6f}", flush=True)
    check(last < first, f"training: the loss did not fall ({first:.6f} -> {last:.6f})")
    t_step = statistics.median(step_s[1:])
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"(5a) median step {t_step * 1e3:.2f} ms over {TRAIN_STEPS - 1} -> {1.0 / t_step:.3f} steps/s, "
          f"{B_TRAIN / t_step:.2f} videos/s on {card}; peak memory {peak_gb:.2f} GB", flush=True)
    profile_kernels(lambda st: train_step(st, batch)[0], state, t_step, "(5a)", "step",
                    groups={"K5": "bilstm_cluster_kernel", "K6 (a) z": "lstm_z_kernel",
                            "K6 (b) walk": "bilstm_bptt_cluster_kernel",
                            "K6 (c) dW_h": "lstm_dwh_partial_kernel",
                            "K8": "bidaf_drop_bwd_cluster_kernel",
                            "K7": "bidaf_drop_fwd_cluster_kernel"})

    # (b) drop_prob 0, f32: one step through the kernels and through the plain versions.
    results = []
    for kernels in (True, False):
        cfg0 = train_config(drop_prob=0.0, kernels=kernels)
        st, b0 = train_state(cfg0, dev, seed=3)
        st, m = make_train_step(cfg0)(st, b0)
        results.append((float(m["loss"]), float(m["grad_norm"]),
                        dict(st.params.named_parameters()), dict(st.ema_params.named_parameters())))
    (lk, gk, pk, ek), (lp, gp, pp, ep) = results
    dp = max((pk[n] - pp[n]).abs().max().item() for n in pk)
    de = max((ek[n] - ep[n]).abs().max().item() for n in ek)
    print(f"(5b) f32 drop 0, one step: loss kernels {lk:.7f} plain {lp:.7f}; grad norm {gk:.7f} vs {gp:.7f}; "
          f"max param diff {dp:.3e}, max EMA diff {de:.3e} (bound {TRAIN_PARITY_ATOL})", flush=True)
    check(abs(lk - lp) <= TRAIN_PARITY_ATOL and abs(gk - gp) <= TRAIN_PARITY_ATOL * max(1.0, gp),
          "(5b) kernel and plain loss / grad norm differ")
    check(dp <= TRAIN_PARITY_ATOL and de <= TRAIN_PARITY_ATOL, "(5b) kernel and plain parameters differ")
    return t_step


def corpus_cli_args(tmp: str, cfg_path: str, name: str, *extra: str) -> list[str]:
    return ["--data_dir", os.path.join(tmp, "corpus"), "--vgg", "vgg16", "--config_json", cfg_path,
            "--device", "cuda", "--save_dir", tmp, "--name", name, *extra]


def final_checkpoint(run_dir: str) -> dict:
    import torch

    with open(os.path.join(run_dir, "ckpts", "index.json")) as f:
        step = max(int(k) for k in json.load(f))
    return torch.load(os.path.join(run_dir, "ckpts", f"step_{step}.pt"), weights_only=True)


def run_log(run_dir: str) -> list[dict]:
    with open(os.path.join(run_dir, "log.jsonl")) as f:
        return [json.loads(line) for line in f]


@contextlib.contextmanager
def timed_train_steps(counters):
    """``loop.make_train_step`` patched while the block runs: each step it
    builds is timed up to a synchronise (``seconds``, with each step's start
    in ``starts``) and counts the launches of ``counters`` and K3's routes
    inside it."""
    import types

    import torch

    from mmbidaf_tpu_torch.ops.cuda import melspec_kernel
    from mmbidaf_tpu_torch.train import loop

    rec = types.SimpleNamespace(starts=[], seconds=[], launches={fn.__name__: 0 for fn in counters},
                                k3_routes={"fft": 0, "dense": 0})
    make_train_step = loop.make_train_step

    def timed_make(*args, **kw):
        step = make_train_step(*args, **kw)

        def timed(state, batch):
            before = [fn.launches for fn in counters]
            routes = dict(melspec_kernel.mfcc_fused.routes)
            rec.starts.append(time.perf_counter())
            out = step(state, batch)
            torch.cuda.synchronize()
            rec.seconds.append(time.perf_counter() - rec.starts[-1])
            for fn, n in zip(counters, before):
                rec.launches[fn.__name__] += fn.launches - n
            for k in rec.k3_routes:
                rec.k3_routes[k] += melspec_kernel.mfcc_fused.routes[k] - routes[k]
            return out

        return timed

    loop.make_train_step = timed_make
    try:
        yield rec
    finally:
        loop.make_train_step = make_train_step


def loop_step_s(rec) -> float:
    """The loop's median step, start to start (host decode and upload
    included), the first step's interval left out."""
    return statistics.median(b - a for a, b in zip(rec.starts[1:], rec.starts[2:]))


def phase_corpus(dev, card: str, tmp: str) -> float:
    """Phase 8: ``train.cli --data_dir`` on a corpus at the bench_train widths,
    raw frames through the frozen frontend inside the step, then the run
    served by ``Summarizer.from_run``. The corpus and runs go under ``tmp``
    (phase 10 reuses the corpus); returns the median raw-corpus step, s."""
    import torch

    from mmbidaf_tpu_torch.data.frontend import frontend_init
    from mmbidaf_tpu_torch.data.pipeline import VideoCorpus, batched_iterator
    from mmbidaf_tpu_torch.data.synthetic import random_word_vectors
    from mmbidaf_tpu_torch.data.vocab import vocab_from_corpus_dir
    from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_init
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel, lstm_kernel, melspec_kernel
    from mmbidaf_tpu_torch.ops.vgg import VGG16_SPEC
    from mmbidaf_tpu_torch.serving import Summarizer
    from mmbidaf_tpu_torch.train import cli, loop
    from mmbidaf_tpu_torch.train.checkpoint import load_config

    cfg = train_config()
    d = cfg.data
    seconds = (d.max_audio_frames * d.hop_length + d.win_length) / d.sample_rate + 0.05
    t0 = time.perf_counter()
    load_corpus_module().make_corpus(
        os.path.join(tmp, "corpus"), videos=CORPUS_TRAIN + CORPUS_DEV, sentences=d.max_sentences,
        frames=d.max_keyframes, seconds=seconds, seed=0, split=CORPUS_DEV)
    cfg_path = os.path.join(tmp, "train.json")
    with open(cfg_path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    print(f"corpus: {CORPUS_TRAIN} training and {CORPUS_DEV} dev videos, {d.max_sentences} "
          f"sentences, {d.max_keyframes} frames of 48x64, {seconds:.3f} s of audio each, "
          f"written in {time.perf_counter() - t0:.2f} s", flush=True)

    # (a) the trainer, its steps timed and their launches counted
    counters = (melspec_kernel.mfcc_fused, lstm_kernel.bilstm_train_forward,
                lstm_kernel.bilstm_bptt, bidaf_kernel.bidaf_dropout_forward,
                bidaf_kernel.bidaf_dropout_backward)
    for fn in counters:
        fn.launches = 0
    melspec_kernel.mfcc_fused.routes = {"fft": 0, "dense": 0}
    torch.cuda.reset_peak_memory_stats(dev)
    run_dir = os.path.join(tmp, "run")
    t0 = time.perf_counter()
    with timed_train_steps(counters) as rec:
        cli.main(corpus_cli_args(tmp, cfg_path, "run", "--num_steps", str(CORPUS_STEPS),
                                 "--eval_steps", str(CORPUS_STEPS)))
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    launches = {fn.__name__: fn.launches for fn in counters}
    step_s = rec.seconds
    print(f"(8a) launches during the run: {launches}; inside the {len(step_s)} steps: "
          f"{rec.launches}; K3 routes inside the steps: {rec.k3_routes}", flush=True)
    check(len(step_s) == CORPUS_STEPS, f"(8a) {len(step_s)} train steps ran")
    for name, n in rec.launches.items():
        check(n > 0, f"(8a) {name} was never launched inside the real-corpus train step")
    check(rec.k3_routes["fft"] > 0 and rec.k3_routes["dense"] == 0,
          f"(8a) K3 left its FFT route inside the train step: {rec.k3_routes}")
    logs = run_log(run_dir)
    losses = [r["loss"] for r in logs if "loss" in r]
    evals = [r for r in logs if "eval_loss" in r]
    check(bool(losses) and all(math.isfinite(x) for x in losses), f"(8a) train losses {losses}")
    check(len(evals) == 1 and math.isfinite(evals[0]["eval_loss"]), f"(8a) eval {evals}")
    t_step = statistics.median(step_s[1:])
    t_loop = loop_step_s(rec)
    print(f"(8a) real-corpus train step (B={B_TRAIN}, raw frames, VGG-16 f32 + K3 in the step): "
          f"median {t_step * 1e3:.2f} ms over {len(step_s) - 1} (first {step_s[0] * 1e3:.2f} ms) "
          f"-> {B_TRAIN / t_step:.2f} videos/s on {card}; the loop's median step, host decode "
          f"of the batch included, {t_loop * 1e3:.2f} ms ({B_TRAIN / t_loop:.2f} videos/s); "
          f"the run {wall:.2f} s for "
          f"{CORPUS_STEPS} steps, an eval of {CORPUS_DEV} dev videos and a save "
          f"({CORPUS_STEPS * B_TRAIN / wall:.2f} videos/s end to end); peak memory {peak_gb:.2f} GB "
          f"of {torch.cuda.get_device_properties(dev).total_memory / 1e9:.1f}; "
          f"mean loss {losses[-1]:.6f}, eval loss {evals[0]['eval_loss']:.6f}, "
          f"ROUGE-L {evals[0]['ROUGE-L']:.4f}", flush=True)

    # the host's share: decode of B_TRAIN examples, the first epoch's
    # (gold labels computed) and later ones' (labels kept by the corpus)
    train_dir = os.path.join(tmp, "corpus", "train")
    w2i = vocab_from_corpus_dir(train_dir, max_size=d.vocab_size)
    stream = batched_iterator(VideoCorpus(train_dir, cfg, w2i, require_summary=True), B_TRAIN,
                              seed=cfg.train.seed)
    decode_s = []
    for _ in range(2 * CORPUS_TRAIN // B_TRAIN + 3):
        t0 = time.perf_counter()
        nb = next(stream)
        decode_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in nb.items()}
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) * 1e3
    first = decode_s[:CORPUS_TRAIN // B_TRAIN]
    print(f"(8a) host decode of a B={B_TRAIN} batch: first epoch (labels computed) "
          f"{statistics.median(first) * 1e3:.2f} ms, later epochs (labels kept) median "
          f"{statistics.median(decode_s[CORPUS_TRAIN // B_TRAIN:]) * 1e3:.2f} ms over "
          f"{len(decode_s) - len(first)}; its upload (pageable) {upload_ms:.2f} ms", flush=True)

    # where a step's device time goes, on one raw corpus batch
    wv = random_word_vectors(np.random.default_rng(3), len(w2i), cfg.model.emb_dim)
    st = loop.init_train_state(mmbidaf_init(cfg, wv, dev, seed=3), cfg, seed=4)
    step = loop.make_train_step(cfg, frontend_init(cfg, VGG16_SPEC, dev, seed=5), VGG16_SPEC)
    profile_kernels(lambda x: step(x, batch)[0], st, t_step, "(8a)", "step",
                    groups={"K3 (FFT pass)": "logmel_fft_kernel", "K3 (DCT pass)": "mfcc_dct_kernel",
                            "K5": "bilstm_cluster_kernel", "K6 (b) walk": "bilstm_bptt_cluster_kernel",
                            "K7": "bidaf_drop_fwd_cluster_kernel", "K8": "bidaf_drop_bwd_cluster_kernel",
                            "cuDNN implicit-GEMM convs": "xmma_fprop",
                            "cuDNN FFT convs": "DSE::", "cuDNN FFT products": "complex",
                            "max-pool": "max_pool"})
    del st, step

    # (b) drop_prob 0, f32: one raw-batch step through the kernels and the plain versions
    results = []
    for kernels in (True, False):
        cfg0 = train_config(drop_prob=0.0, kernels=kernels)
        cfg0 = dataclasses.replace(cfg0, model=dataclasses.replace(cfg0.model,
                                                                   use_pallas_melspec=kernels))
        st = loop.init_train_state(mmbidaf_init(cfg0, wv, dev, seed=3), cfg0, seed=4)
        fe = frontend_init(cfg0, VGG16_SPEC, dev, seed=5)
        st, m = loop.make_train_step(cfg0, fe, VGG16_SPEC)(st, batch)
        results.append((float(m["loss"]), float(m["grad_norm"]),
                        dict(st.params.named_parameters()), dict(st.ema_params.named_parameters())))
        del fe
    (lk, gk, pk, ek), (lp, gp, pp, ep) = results
    dp = max((pk[n] - pp[n]).abs().max().item() for n in pk)
    de = max((ek[n] - ep[n]).abs().max().item() for n in ek)
    print(f"(8b) f32 drop 0, one raw-batch step: loss kernels {lk:.7f} plain {lp:.7f}; grad norm "
          f"{gk:.7f} vs {gp:.7f}; max param diff {dp:.3e}, max EMA diff {de:.3e} "
          f"(bound {TRAIN_PARITY_ATOL})", flush=True)
    check(abs(lk - lp) <= TRAIN_PARITY_ATOL and abs(gk - gp) <= TRAIN_PARITY_ATOL * max(1.0, gp),
          "(8b) kernel and plain loss / grad norm differ")
    check(dp <= TRAIN_PARITY_ATOL and de <= TRAIN_PARITY_ATOL, "(8b) kernel and plain parameters differ")
    del results, pk, pp, ek, ep

    # (c) the same steps with and without the prefetch thread
    loop_ms = {}
    for name, depth in (("pf0", "0"), ("pf2", "2")):
        with timed_train_steps(()) as rec:
            cli.main(corpus_cli_args(tmp, cfg_path, name, "--num_steps", str(PREFETCH_STEPS),
                                     "--eval_steps", "1000", "--prefetch", depth))
        loop_ms[depth] = loop_step_s(rec) * 1e3
    l0, l2 = run_log(os.path.join(tmp, "pf0")), run_log(os.path.join(tmp, "pf2"))
    c0, c2 = final_checkpoint(os.path.join(tmp, "pf0")), final_checkpoint(os.path.join(tmp, "pf2"))
    same = all(torch.equal(c0["params"][k], c2["params"][k]) for k in c0["params"])
    print(f"(8c) {PREFETCH_STEPS} steps, prefetch 2 vs 0: logged losses "
          f"{[r['loss'] for r in l2]} vs {[r['loss'] for r in l0]}; final params bit for bit "
          f"equal: {same}; the loop's median step {loop_ms['2']:.2f} vs {loop_ms['0']:.2f} ms "
          f"(host decode included; the second epoch on, labels kept) on {card}", flush=True)
    check([r["loss"] for r in l0] == [r["loss"] for r in l2] and same,
          "(8c) prefetch changed the losses or the parameters")

    # (d) serve the run
    dev_dirs = sorted(os.path.join(tmp, "corpus", "dev", v)
                      for v in os.listdir(os.path.join(tmp, "corpus", "dev")))
    served = (lstm_kernel.bilstm_cuda, bidaf_kernel.bidaf_attention_fused, melspec_kernel.mfcc_fused)
    for fn in served:
        fn.launches = 0
    run_cfg = load_config(run_dir)
    t0 = time.perf_counter()
    s = Summarizer.from_run(run_dir, seed=run_cfg.train.seed)
    summaries = s.summarize_batch(dev_dirs)
    dt = time.perf_counter() - t0
    raw, _ = s._raw_batch(dev_dirs)
    picks_k = s._decode_batch(raw)
    launches = {fn.__name__: fn.launches for fn in served}
    check(len(summaries) == CORPUS_DEV and all(isinstance(x, str) and x for x in summaries),
          "(8d) from_run: empty or missing summaries")
    for name, n in launches.items():
        check(n > 0, f"(8d) {name} was never launched serving the trained run")
    plain_cfg = dataclasses.replace(run_cfg, model=dataclasses.replace(
        run_cfg.model, use_pallas_lstm=False, use_pallas_attention=False, use_pallas_melspec=False))
    sp = Summarizer.from_checkpoint(os.path.join(run_dir, "ckpts"), os.path.join(run_dir, "vocab.json"),
                                    os.path.join(run_dir, "emb.npz"), plain_cfg, VGG16_SPEC,
                                    seed=run_cfg.train.seed, device=dev)
    picks_p = sp._decode_batch(raw)
    print(f"(8d) Summarizer.from_run answered {CORPUS_DEV} dev videos in {dt:.2f} s (load included); "
          f"launches {launches}; f32 picks through the kernels equal the plain versions': "
          f"{bool((picks_k == picks_p).all())}; first: {summaries[0][:80]!r}", flush=True)
    check(bool((picks_k == picks_p).all()), "(8d) kernel and plain picks of the trained run differ")
    return t_step


def f32_configs(cfg):
    """An f32 copy of ``cfg`` through the kernels and one through the plain versions."""
    k = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32"))
    p = dataclasses.replace(k, model=dataclasses.replace(
        k.model, use_pallas_lstm=False, use_pallas_attention=False, use_pallas_melspec=False))
    return k, p


def write_serving_corpus(root: str, cfg) -> tuple[dict, list[list[str]], list[str]]:
    """Phase 9's videos at 240x320: ``load_test.make_mixed_corpus``'s tiers
    (a quarter, a half and all of the caps, PER_TIER each, with gold
    summaries for ``infer``); LEVEL_VIDEOS for each diagonal rung level of
    the default ladders, whose true lengths are that level's rungs; and two
    videos of LONG_SENTENCES sentences."""
    from mmbidaf_tpu_torch.data.text import sent_tokenize
    from mmbidaf_tpu_torch.serving import bucket_ladder_levels, serving_bucket_ladders
    from mmbidaf_tpu_torch.tools import load_test

    d = cfg.data
    cap_samples = d.max_audio_frames * d.hop_length + d.win_length
    tiers = load_test.make_mixed_corpus(os.path.join(root, "mixed"), cfg, per_tier=PER_TIER,
                                        res=FRAME_HW, seed=0)
    for vd in (v for vds in tiers.values() for v in vds):
        with open(os.path.join(vd, "transcript.txt")) as f:
            sents = sent_tokenize(f.read())
        with open(os.path.join(vd, "summary.txt"), "w") as f:
            f.write(" ".join(sents[::3]))
    rng = np.random.default_rng(1)
    filler = "alpha beta gamma delta epsilon zeta eta theta iota kappa lambda mu".split()
    levels = []
    for i, lv in enumerate(bucket_ladder_levels(serving_bucket_ladders(cfg, True))):
        levels.append([])
        for v in range(LEVEL_VIDEOS):
            vd = os.path.join(root, f"level{i}", f"video_{v}")
            load_test.write_video_dir(vd, rng, n_frames=lv["keyframes"],
                                      n_samples=lv["audio_frames"] * d.hop_length,
                                      n_sents=lv["sentences"], res=FRAME_HW, sample_rate=d.sample_rate)
            # lv["words"] tokens a sentence: "Clip", its number, filler, "ends", "."
            words = " ".join(filler[:lv["words"] - 4])
            with open(os.path.join(vd, "transcript.txt"), "w") as f:
                f.write(" ".join(f"Clip {v * 100 + j} {words} ends.".replace("  ", " ")
                                 for j in range(lv["sentences"])))
            levels[-1].append(vd)
    long_dirs = []
    for v in range(2):
        vd = os.path.join(root, "long", f"long_{v}")
        load_test.write_video_dir(vd, rng, n_frames=d.max_keyframes, n_samples=cap_samples,
                                  n_sents=LONG_SENTENCES, res=FRAME_HW, sample_rate=d.sample_rate)
        long_dirs.append(vd)
    return tiers, levels, long_dirs


def first_request_main(mode: str, video_dir: str) -> None:
    """In a fresh process (``chip_smoke.py --first-request cold|warm DIR``):
    a bucketed bench-config Summarizer at batch 8 decodes ``video_dir`` once
    on the host (the decoder's first call), then answers two requests for
    it, after ``warmup((240, 320), batch_size=8)`` with ``warm``; prints the
    seconds of each step as JSON."""
    import torch

    sys.path.insert(0, ROOT)
    from mmbidaf_tpu_torch.serving import Summarizer

    rec = {}
    t0 = time.perf_counter()
    s = Summarizer.init_random(bench_config(), seed=0, device=torch.device("cuda", 0),
                               serve_batch_size=8, serve_buckets=True)
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    s._raw_row(video_dir)  # the host's first decode (its imports), apart from the requests
    rec["host_first_s"] = time.perf_counter() - t0
    if mode == "warm":
        t0 = time.perf_counter()
        s.warmup(FRAME_HW, batch_size=8)
        torch.cuda.synchronize()
        rec["warmup_s"] = time.perf_counter() - t0
    for key in ("first_s", "second_s"):
        t0 = time.perf_counter()
        s.summarize(video_dir)
        rec[key] = time.perf_counter() - t0
    print(json.dumps(rec), flush=True)


def first_request(video_dir: str, warm: bool) -> dict:
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--first-request",
                        "warm" if warm else "cold", video_dir],
                       capture_output=True, text=True, cwd=ROOT, timeout=600)
    check(r.returncode == 0, f"(9a) the first-request process failed: {r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def batcher_videos_per_s(summarizer, rows: list, depth: int) -> float:
    """Videos/s of a ``DynamicBatcher`` (batches of 8) whose queue already
    holds BATCHER_BATCHES batches of decoded rows: its collate, upload,
    dispatch and fetch, without the requests' host decode."""
    from concurrent.futures import Future

    from mmbidaf_tpu_torch.serving import DynamicBatcher

    b = DynamicBatcher(summarizer, max_batch_size=8, max_wait_ms=1000.0, pipeline_depth=depth)
    try:
        items = [(*rows[i % len(rows)], Future()) for i in range(8 * BATCHER_BATCHES)]
        t0 = time.perf_counter()
        for it in items:
            b._queue.put(it)
        for it in items:
            it[2].result(timeout=300)
        dt = time.perf_counter() - t0
    finally:
        b.close()
    check(b.stats["batches"] == BATCHER_BATCHES, f"(9c) the batcher ran {b.stats['batches']} batches")
    return len(items) / dt


def phase_serving(dev, card: str, records: list[dict], tmp: str) -> dict:
    """Phase 9: the serving stack at the bench configuration: bucket ladders
    and warmup, the decode modes, the daemon under load, and ``infer``. The
    corpus goes under ``tmp``; returns its load-test tiers (phase 10 reuses
    their PNG frames) and its rung-level videos (phase 11 reuses both)."""
    import io

    import torch

    from mmbidaf_tpu_torch import infer
    from mmbidaf_tpu_torch.data.frontend import frontend_init
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel, lstm_kernel, melspec_kernel
    from mmbidaf_tpu_torch.ops.vgg import VGG16_SPEC
    from mmbidaf_tpu_torch.serving import AXES, Summarizer
    from mmbidaf_tpu_torch.tools import load_test

    cfg = bench_config()
    d = cfg.data
    caps = (d.max_sentences, d.max_words, d.max_keyframes, d.max_audio_frames)
    t0 = time.perf_counter()
    tiers, level_dirs, long_dirs = write_serving_corpus(tmp, cfg)
    print(f"(9) corpus: {PER_TIER} videos a tier (quarter, half, full), {LEVEL_VIDEOS} at each of "
          f"{len(level_dirs)} rung levels, 2 of "
          f"{LONG_SENTENCES} sentences, frames {FRAME_HW[0]}x{FRAME_HW[1]}, written in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # (9a) a first request, cold and after warmup, each in a fresh process
    # (a video on the top diagonal level, a shape warmup runs)
    cold = first_request(level_dirs[-1][0], warm=False)
    warm = first_request(level_dirs[-1][0], warm=True)
    print(f"(9a) fresh process, bucketed Summarizer at batch 8 on {card}: cold: init "
          f"{cold['init_s']:.3f} s, the host's first decode of the video {cold['host_first_s']:.3f} s, "
          f"first request {cold['first_s']:.3f} s, second "
          f"{cold['second_s']:.3f} s; warmed: init {warm['init_s']:.3f} s, warmup((240, 320), "
          f"batch_size=8) {warm['warmup_s']:.3f} s, first request {warm['first_s']:.3f} s, second "
          f"{warm['second_s']:.3f} s", flush=True)
    check(warm["first_s"] < cold["first_s"], "(9a) warmup did not shorten the first request")

    counters = (lstm_kernel.bilstm_cuda, bidaf_kernel.bidaf_attention_fused, melspec_kernel.mfcc_fused)
    for fn in counters:
        fn.launches = 0
    lstm_kernel.bilstm_cuda.routes = {"cluster": 0, "l2": 0}
    bidaf_kernel.bidaf_attention_fused.routes = {"cluster": 0, "K9": 0}
    melspec_kernel.mfcc_fused.routes = {"fft": 0, "dense": 0}

    s = Summarizer.init_random(cfg, seed=0, device=dev, serve_buckets=True)
    plain_s = Summarizer(s.model, s.frontend, s.word2idx, cfg, s.vgg_spec)  # the caps
    t0 = time.perf_counter()
    s.warmup(FRAME_HW, batch_size=8)
    torch.cuda.synchronize()
    plans = (len(lstm_kernel._occupancy_checked), len(bidaf_kernel._occupancy_checked))
    levels = [tuple(lv[k] for k in AXES) for lv in s.bucket_levels]
    print(f"(9a) in-process warmup at batch 8, the caps and diagonal levels {levels}: "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    groups = [(f"level {i}", s, vids) for i, vids in enumerate(level_dirs)]
    groups.append(("caps", plain_s, tiers["full"]))
    level_raw = {}
    for name, summ, vids in groups:
        rows = [summ._raw_row(v)[0] for v in vids]
        raw = summ._stack_rows((rows * 8)[:8])
        level_raw[name] = (summ, raw, vids)
        shape = tuple(raw[k].shape[-1] for k in ("sent_mask", "word_mask", "img_mask", "aud_mask"))
        want = levels[int(name[-1])] if name.startswith("level") else caps
        check(shape == want, f"(9a) {name}: the batch took {shape}, not {want}")
        before = [fn.launches for fn in counters]
        t = timed_batches(lambda: summ._decode_batch(raw))
        grew = [fn.launches - n for fn, n in zip(counters, before)]
        print(f"(9a) {name} {shape}, B=8: median batch {t * 1e3:.2f} ms ({8 / t:.2f} videos/s); "
              f"K1/K2/K3 launches {grew}", flush=True)
        check(all(g > 0 for g in grew), f"(9a) {name}: K1-K3 did not all launch: {grew}")
    check((len(lstm_kernel._occupancy_checked), len(bidaf_kernel._occupancy_checked)) == plans,
          "(9a) a level's decode checked a plan that warmup had not")
    print(f"(9a) bucket_stats {s.bucket_stats}; plan checks after warmup {plans}, unchanged by "
          f"the level decodes", flush=True)

    # f32 at every level: kernels vs plain, bucketed vs the same videos at the caps
    cfg_k, cfg_p = f32_configs(cfg)
    fe32 = frontend_init(cfg_k, VGG16_SPEC, dev, seed=1)  # init_random's weights, in f32
    f32 = {(kern, b): Summarizer(s.model, fe32, s.word2idx, c, VGG16_SPEC, serve_buckets=b)
           for kern, c in ((True, cfg_k), (False, cfg_p)) for b in (True, None)}
    for name, _, vids in groups:
        rows = [s._raw_row(v)[0] for v in vids]
        rows = (rows * 8)[:8]
        picks = {key: summ._decode_batch(summ._stack_rows(rows)) for key, summ in f32.items()}
        same = {f"{'kernels' if k else 'plain'}{' bucketed' if b else ' caps'}":
                bool((p == picks[(True, True)]).all()) for (k, b), p in picks.items()}
        print(f"(9a) f32 {name}: picks equal to the bucketed kernel path's: {same}", flush=True)
        check(all(same.values()), f"(9a) f32 {name}: picks differ: {same}")
    del f32, fe32

    # (9b) the decode modes at B=8, the caps batch
    raw8 = level_raw["caps"][1]
    beam = Summarizer(s.model, s.frontend, s.word2idx, cfg, s.vgg_spec, mode="beam", topk=4)
    topk = Summarizer(s.model, s.frontend, s.word2idx, cfg, s.vgg_spec, mode="topk", topk=4, seed=0)
    times = {}
    for name, summ in (("greedy", plain_s), ("beam", beam), ("topk", topk)):
        times[name] = timed_batches(lambda: summ._decode_batch(raw8))
    t0 = time.perf_counter()
    out = plain_s._decode_batch_device(raw8)
    t_dispatch = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    del out
    print(f"(9b) B=8 at the caps (bf16) on {card}: median batch greedy {times['greedy'] * 1e3:.2f} ms, "
          f"beam (width 4) {times['beam'] * 1e3:.2f} ms, top-k (k=4) {times['topk'] * 1e3:.2f} ms; "
          f"a greedy batch's dispatch returns after {t_dispatch * 1e3:.2f} of its {t_total * 1e3:.2f} ms",
          flush=True)
    p1 = Summarizer(s.model, s.frontend, s.word2idx, cfg, s.vgg_spec, mode="topk", topk=4,
                    seed=0)._decode_batch(raw8)
    p2 = Summarizer(s.model, s.frontend, s.word2idx, cfg, s.vgg_spec, mode="topk", topk=4,
                    seed=0)._decode_batch(raw8)
    check(bool((p1 == p2).all()), "(9b) top-k picks differ under one seed")
    sm = raw8["sent_mask"].cpu().numpy()
    for b in range(8):
        check(all(sm[b, p] == 1 for p in p1[b]) and len(set(p1[b].tolist())) == len(p1[b]),
              f"(9b) top-k row {b}: invalid picks {p1[b]}")
    fe32 = frontend_init(cfg_k, VGG16_SPEC, dev, seed=1)
    beam_k = Summarizer(s.model, fe32, s.word2idx, cfg_k, VGG16_SPEC, mode="beam", topk=4)
    beam_p = Summarizer(s.model, fe32, s.word2idx, cfg_p, VGG16_SPEC, mode="beam", topk=4)
    rows = [s._raw_row(v)[0] for v in (tiers["full"] * 8)[:8]]
    raw32 = beam_k._stack_rows(rows)
    (lp_k, pk), (lp_p, pp) = beam_k._decode_batch(raw32, with_scores=True), beam_p._decode_batch(
        raw32, with_scores=True)
    one = Summarizer(s.model, fe32, s.word2idx, cfg_k, VGG16_SPEC, mode="beam", topk=1)._decode_batch(raw32)
    greedy = Summarizer(s.model, fe32, s.word2idx, cfg_k, VGG16_SPEC)._decode_batch(raw32)
    print(f"(9b) f32 beam width 4: kernel picks equal plain: {bool((pk == pp).all())} (score "
          f"max diff {float(np.abs(lp_k - lp_p).max()):.3e}); width 1 equals greedy: "
          f"{bool((one == greedy).all())}; top-k reproducible under one seed and valid", flush=True)
    check(bool((pk == pp).all()), "(9b) f32 beam: kernel and plain picks differ")
    check(bool((one == greedy).all()), "(9b) f32 beam of width 1 differs from greedy")
    del beam_k, beam_p, fe32
    t0 = time.perf_counter()
    long_out = [s.summarize_long(v) for v in long_dirs]
    dt = time.perf_counter() - t0
    check(all(isinstance(x, str) and x for x in long_out), "(9b) summarize_long: empty summary")
    print(f"(9b) summarize_long with ladders: 2 videos of {LONG_SENTENCES} sentences in {dt:.2f} s; "
          f"first: {long_out[0][:80]!r}", flush=True)

    # (9c) the daemon under load
    expected = {vd: plain_s.summarize(vd) for vds in tiers.values() for vd in vds}
    rows = load_test.run_sweep(lambda buckets: s if buckets else plain_s, tiers, clients=8,
                               requests=LOAD_REQUESTS, dynamic_batch=8, batch_wait_ms=5.0)
    for r in rows:
        lm = r["latency_ms"]
        print(f"(9c) {r['config']}: {r['ok']}/{r['requests']} answered, p50 {lm['p50']:.2f} ms, "
              f"p95 {lm['p95']:.2f} ms, p99 {lm['p99']:.2f} ms, sustained {r['sustained_vps']:.2f} "
              f"videos/s; batcher {r.get('batcher')} on {card}", flush=True)
        check(r["ok"] == LOAD_REQUESTS and r["errors"] == 0, f"(9c) {r['config']}: failed requests")
        wrong = [vd for vd, a in r["answers"].items() if a != [expected[vd]]]
        check(not wrong, f"(9c) {r['config']}: answers differ from Summarizer.summarize: {wrong}")
    by = {r["config"]: r for r in rows}
    print(f"(9c) the pipelined fetch (batch) against the synchronous one (batch_sync): "
          f"{by['batch']['sustained_vps']:.2f} against {by['batch_sync']['sustained_vps']:.2f} "
          f"videos/s, p50 {by['batch']['latency_ms']['p50']:.2f} against "
          f"{by['batch_sync']['latency_ms']['p50']:.2f} ms: batch "
          f"{'beat' if by['batch']['sustained_vps'] > by['batch_sync']['sustained_vps'] else 'did not beat'}"
          f" batch_sync", flush=True)

    # the batcher alone, its queue filled with decoded rows: does the
    # pipelined fetch overlap the next batch's collate, upload and dispatch?
    rows = [plain_s._raw_row(v) for v in tiers["full"]]
    vps = {}
    for depth in (1, 0, 0, 1):
        vps.setdefault(depth, []).append(batcher_videos_per_s(plain_s, rows, depth))
    print(f"(9c) the batcher alone on decoded rows at the caps, {BATCHER_BATCHES} batches of 8: "
          f"pipeline_depth 1 {vps[1][0]:.2f}, {vps[1][1]:.2f} videos/s; depth 0 {vps[0][0]:.2f}, "
          f"{vps[0][1]:.2f} videos/s on {card}", flush=True)

    # (9d) infer on the mixed corpus
    cfg_path = os.path.join(tmp, "bench.json")
    with open(cfg_path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    for extra in ((), ("--mode", "beam")):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            infer.main(["--device", str(dev), "--config_json", cfg_path, "--data_dir", os.path.join(tmp, "mixed"),
                        "--batch_size", "8", "--bucket_eval", "--prefetch", "2", *extra])
        line = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{'ROUGE-1'")][-1]
        scores = ast.literal_eval(line.partition(" (")[0])
        print(f"(9d) infer --bucket_eval --prefetch 2 {' '.join(extra)}: {line} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        check(all(math.isfinite(v) for v in scores.values()) and f"({3 * PER_TIER} videos scored)" in line,
              f"(9d) infer printed {line}")

    launches = {fn.__name__: fn.launches for fn in counters}
    routes = {fn.__name__: dict(fn.routes) for fn in counters}
    print(f"(9) launches over phase 9: {launches}; routes {routes}", flush=True)
    check(routes["bilstm_cuda"] == {"cluster": launches["bilstm_cuda"], "l2": 0}, "(9) K1 left its cluster route")
    check(routes["bidaf_attention_fused"] == {"cluster": launches["bidaf_attention_fused"], "K9": 0},
          "(9) K2 left its cluster route")
    check(routes["mfcc_fused"] == {"fft": launches["mfcc_fused"], "dense": 0}, "(9) K3 left its FFT route")
    for rec, fn in zip(records, counters):
        check(fn.launches > 0, f"(9) {fn.__name__} was never launched on the serving stack")
        rec["launches"] += fn.launches
    return tiers, level_dirs


def decode_rates(blobs: list[bytes]) -> dict:
    """Frames/s decoding ``blobs`` through PIL one by one, through the
    native pool at 1 and 4 threads (PIL's per image where the build lacks
    the codec), and, for the record, PIL in 4 Python threads (Pillow's
    decoders release the GIL; the port does not decode so): the median of
    DECODE_REPS runs each."""
    import io
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from mmbidaf_tpu_torch import native

    def pil(b):
        return np.asarray(Image.open(io.BytesIO(b)).convert("RGB"))

    pool = ThreadPoolExecutor(4)
    paths = {"PIL": lambda: [pil(b) for b in blobs],
             "native x1": lambda: native.image_decode_batch(blobs, num_threads=1),
             "native x4": lambda: native.image_decode_batch(blobs, num_threads=4),
             "PIL in 4 threads (record only)": lambda: list(pool.map(pil, blobs))}
    rates = {}
    for name, fn in paths.items():
        times = []
        for _ in range(DECODE_REPS):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        rates[name] = len(blobs) / statistics.median(times)
    pool.shutdown()
    return rates


def host_batch_load(corpus, tag: str, reps: int = 3) -> float:
    """The host's load of one B_TRAIN-example batch of ``corpus`` (collate
    included) once its gold labels are kept: the median seconds over
    ``reps`` loads, then cProfile's functions by own time over one more."""
    import cProfile
    import pstats

    from mmbidaf_tpu_torch.data.pipeline import collate

    def load():
        return collate([corpus[i] for i in range(B_TRAIN)])

    load()  # the gold labels computed and kept
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        load()
        times.append(time.perf_counter() - t0)
    prof = cProfile.Profile()
    prof.runcall(load)
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:6]
    print(f"{tag} host load of a B={B_TRAIN} batch (labels kept): median "
          f"{statistics.median(times) * 1e3:.2f} ms over {reps}; by own time under cProfile: " +
          "; ".join(f"{os.path.basename(f)}:{ln}({fn}) {tt * 1e3:.1f} ms x{nc}"
                    for (f, ln, fn), (_, nc, tt, _, _) in top), flush=True)
    return statistics.median(times)


def oracle_inputs(batch: dict) -> dict:
    """A feature batch as the torch oracle's forward takes it (on the CPU)."""
    import torch

    kw = {k: torch.from_numpy(batch[k]) for k in ("word_mask", "sent_mask", "images", "img_mask",
                                                  "audio", "aud_mask")}
    kw["text_ids"] = torch.from_numpy(batch["text_ids"]).long()
    return kw


def phase_host(dev, card: str, records: list[dict], train_records: list[dict], corpus_tmp: str,
               raw_step_s: float, tiers: dict, decoded: dict) -> None:
    """Phase 10: the host side users bring data and weights through: the
    native decode runtime, a reference checkpoint converted and served,
    features precomputed over phase 8's corpus and trained on, the Stockham
    FFT, and the trainer's tensorboard file."""
    import glob
    import io
    import shutil

    import torch
    from PIL import Image

    from mmbidaf_tpu_torch import native
    from mmbidaf_tpu_torch.data.frontend import frontend_init
    from mmbidaf_tpu_torch.data.pipeline import VideoCorpus
    from mmbidaf_tpu_torch.data.synthetic import random_word_vectors, synthetic_batch
    from mmbidaf_tpu_torch.data.vocab import save_vocab, vocab_from_corpus_dir
    from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_decode
    from mmbidaf_tpu_torch.ops import audio as audio_ops
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel, lstm_kernel, melspec_kernel
    from mmbidaf_tpu_torch.ops.vgg import VGG16_SPEC
    from mmbidaf_tpu_torch.serving import Summarizer
    from mmbidaf_tpu_torch.tools import convert_torch_checkpoint
    from mmbidaf_tpu_torch.tools.mfcc_variants import f64_mfcc
    from mmbidaf_tpu_torch.tools.precompute_features import precompute
    from mmbidaf_tpu_torch.train import cli
    from mmbidaf_tpu_torch.train.metrics import read_tensorboard_scalars

    # (10a) native decode: the build, phase 9's decodes, pixels and rates
    codecs = native.native_codecs()
    gxx = shutil.which("g++")
    print(f"(10a) native decode runtime: codecs {codecs}; g++ {gxx}; {os.cpu_count()} host CPUs",
          flush=True)
    check(gxx is None or native.native_available(), "(10a) the native library did not build, "
          "though g++ is present")
    print(f"(10a) phase 9's host decodes: {decoded['native']} images natively, {decoded['pil']} "
          f"through PIL", flush=True)
    if "png" in codecs:
        check(decoded["native"] > 0 and decoded["pil"] == 0,
              f"(10a) phase 9's PNG frames did not all decode natively: {decoded}")
    else:
        print("(10a) this host's build lacks the PNG codec: phase 9 decoded its PNGs through PIL",
              flush=True)
    pngs = sorted(p for vd in tiers["full"] for p in glob.glob(os.path.join(vd, "frames", "*.png")))
    blobs = []
    for p in pngs:
        with open(p, "rb") as f:
            blobs.append(f.read())
    ours = native.image_decode_batch(blobs, num_threads=4)
    same = all(np.array_equal(a, np.asarray(Image.open(io.BytesIO(b)).convert("RGB")))
               for a, b in zip(ours, blobs))
    check(same, "(10a) native and PIL pixels differ on phase 9's PNG frames")
    rates = decode_rates(blobs)
    print(f"(10a) {len(blobs)} PNG frames of {FRAME_HW[0]}x{FRAME_HW[1]} (phase 9's full tier), "
          f"pixels equal to PIL's: {same}; frames/s " +
          ", ".join(f"{k} {v:.1f}" for k, v in rates.items()) + f" on {card}'s host", flush=True)

    # (10b) the reference's own checkpoint: the oracle at the bench widths,
    # saved as the starter saves it, converted, served by from_run in f32
    spec = importlib.util.spec_from_file_location(
        "torch_model", os.path.join(ROOT, "tests", "oracles", "torch_model.py"))
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
    cfg_k, _ = f32_configs(bench_config())
    d, m = cfg_k.data, cfg_k.model
    wv = random_word_vectors(np.random.default_rng(10), d.vocab_size, m.emb_dim)
    torch.manual_seed(10)
    tm = oracle.MMBiDAF(torch.from_numpy(wv), m.hidden_size, img_feat_dim=m.img_feat_dim,
                        audio_feat_dim=m.audio_feat_dim, num_decode_steps=m.max_decode_steps,
                        mask_selected=m.mask_selected, num_rnn_layers=m.num_rnn_layers).eval()
    served = (lstm_kernel.bilstm_cuda, bidaf_kernel.bidaf_attention_fused, melspec_kernel.mfcc_fused)
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"model_state": tm.state_dict(), "step": 0}, os.path.join(tmp, "best.pth.tar"))
        with open(os.path.join(tmp, "cfg.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg_k), f)
        save_vocab({f"w{i}": i for i in range(d.vocab_size)}, wv, os.path.join(tmp, "vocab.json"),
                   os.path.join(tmp, "emb.npz"))
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            convert_torch_checkpoint.main(["--torch_ckpt", os.path.join(tmp, "best.pth.tar"),
                                           "--config_json", os.path.join(tmp, "cfg.json"),
                                           "--out", os.path.join(tmp, "run"),
                                           "--vocab", os.path.join(tmp, "vocab.json")])
        t_convert = time.perf_counter() - t0
        for fn in served:
            fn.launches = 0
        t0 = time.perf_counter()
        s = Summarizer.from_run(os.path.join(tmp, "run"), seed=0)
        t_load = time.perf_counter() - t0
    batch = synthetic_batch(np.random.default_rng(11), cfg_k, batch_size=8)
    with torch.inference_mode():
        lp, picks = mmbidaf_decode(s.model, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
                                   cfg_k)
    with torch.no_grad():
        t_lp, t_picks = tm(**oracle_inputs(batch))
    valid = np.broadcast_to(batch["sent_mask"][:, None, :] > 0, t_lp.shape)
    dist = float(np.abs(lp.cpu().numpy()[valid] - t_lp.numpy()[valid]).max())
    equal = bool((picks.cpu() == t_picks).all())
    summaries = s.summarize_batch(tiers["full"])
    launches = [fn.launches for fn in served]
    print(f"(10b) the oracle at the bench widths ({sum(p.numel() for p in tm.parameters()) / 1e6:.2f}M "
          f"parameters) as {{'model_state': ...}}: converted in {t_convert:.2f} s, from_run on the card "
          f"in {t_load:.2f} s; f32, kernels on, B=8 feature batch: greedy picks equal to the oracle's "
          f"forward: {equal}, max log-prob distance {dist:.3e}; {len(summaries)} raw videos summarized; "
          f"K1/K2/K3 launches {launches} on {card}", flush=True)
    check(equal, "(10b) the converted checkpoint's picks differ from the oracle's")
    check(all(isinstance(x, str) and x for x in summaries), "(10b) empty summaries")
    for rec, n in zip(records, launches):
        check(n > 0, f"(10b) {rec['name']} was never launched serving the converted checkpoint")
        rec["launches"] += n
    del s, tm

    # (10c) features precomputed over phase 8's corpus, then the trainer on them
    cfg = train_config()
    k3 = melspec_kernel.mfcc_fused
    k3.launches = 0
    fe = frontend_init(cfg, VGG16_SPEC, dev, seed=cfg.train.seed + 2)
    t0 = time.perf_counter()
    n = precompute(os.path.join(corpus_tmp, "corpus"), cfg, fe, VGG16_SPEC, batch=16,
                   log=lambda _: None)
    dt = time.perf_counter() - t0
    del fe
    print(f"(10c) precompute_features over phase 8's corpus (VGG-16 f32 at 224^2 + K3, batches of "
          f"16): {n} videos in {dt:.2f} s ({n / dt:.2f} videos/s), K3 launches {k3.launches} on "
          f"{card}", flush=True)
    check(n == CORPUS_TRAIN + CORPUS_DEV and k3.launches > 0, f"(10c) {n} videos, K3 {k3.launches}")
    records[2]["launches"] += k3.launches
    counters = (lstm_kernel.bilstm_train_forward, lstm_kernel.bilstm_bptt,
                bidaf_kernel.bidaf_dropout_forward, bidaf_kernel.bidaf_dropout_backward)
    k3.launches = 0
    with timed_train_steps(counters) as rec:
        cli.main(corpus_cli_args(corpus_tmp, os.path.join(corpus_tmp, "train.json"), "features",
                 "--num_steps", str(FEATURE_STEPS), "--eval_steps", str(FEATURE_STEPS)))
    step_s = rec.seconds
    check(len(step_s) == FEATURE_STEPS, f"(10c) {len(step_s)} train steps ran")
    check(k3.launches == 0, "(10c) the frontend ran on the feature batches")
    for name, c in rec.launches.items():
        check(c > 0, f"(10c) {name} was never launched inside the feature-batch train step")
    for r in train_records:
        r["launches"] += rec.launches[r["name"]]
    t_step, t_loop = statistics.median(step_s[1:]), loop_step_s(rec)
    logs = run_log(os.path.join(corpus_tmp, "features"))
    check(all(math.isfinite(r.get("loss", 0.0)) for r in logs), f"(10c) losses {logs}")
    print(f"(10c) train.cli --data_dir on features.npz, B={B_TRAIN} f32 drop 0.2: median step "
          f"{t_step * 1e3:.2f} ms over {len(step_s) - 1} ({B_TRAIN / t_step:.2f} videos/s), the loop's "
          f"{t_loop * 1e3:.2f} ms (host load of the batch included), against phase 8's raw-corpus "
          f"step {raw_step_s * 1e3:.2f} ms; launches inside the steps {rec.launches} on {card}",
          flush=True)

    # where the loop's host time goes: a raw batch and a feature batch
    train_dir = os.path.join(corpus_tmp, "corpus", "train")
    w2i = vocab_from_corpus_dir(train_dir, max_size=cfg.data.vocab_size)
    for tag, precomputed in (("(10c) raw corpus:", False), ("(10c) features.npz:", True)):
        host_batch_load(VideoCorpus(train_dir, cfg, w2i, use_precomputed=precomputed,
                                    require_summary=True), tag)

    # (10e) the trainer's tensorboard file holds log.jsonl's scalars, CRCs valid
    tb_dir = os.path.join(corpus_tmp, "features", "tb")
    (tb_file,) = os.listdir(tb_dir)
    version, triples = read_tensorboard_scalars(os.path.join(tb_dir, tb_file))
    want = [(k, r["step"], float(np.float32(v))) for r in logs for k, v in r.items()
            if k not in ("step", "time")]
    print(f"(10e) {tb_file}: {version}, {len(triples)} scalars over steps "
          f"{sorted({st for _, st, _ in triples})}, CRCs valid, equal to log.jsonl's: "
          f"{triples == want}", flush=True)
    check(triples == want and version == "brain.Event:2", "(10e) the tensorboard file differs")

    # (10d) the Stockham FFT at the bench audio config, against an f64 MFCC
    d = bench_config().data
    cfg_s = dataclasses.replace(bench_config(), data=dataclasses.replace(d, audio_fft="stockham"))
    consts = audio_ops.make_audio_frontend_consts(d.sample_rate, d.n_fft, d.win_length, d.n_mels,
                                                  d.n_mfcc, d.fmin, d.fmax, device=dev)
    T = d.max_audio_frames
    sig = torch.from_numpy((np.random.default_rng(12).standard_normal(
        (B, (T - 1) * d.hop_length + d.win_length)) * 0.1).astype(np.float32)).to(dev)
    ref = f64_mfcc(audio_ops.frame_signal(sig, d.win_length, d.hop_length, T), consts)
    paths = {"stockham": dict(fused=cfg_s.model.use_pallas_melspec, fft=cfg_s.data.audio_fft),
             "matmul (plain)": dict(fused=False, fft="matmul"),
             "matmul (K3)": dict(fused=True, fft="matmul")}
    out = {}
    for name, kw in paths.items():
        fn = lambda: audio_ops.waveform_to_features(sig, consts, d.win_length, d.hop_length, T, **kw)  # noqa: E731
        k3.launches = 0
        x = fn()
        launched = k3.launches
        out[name] = (float(np.abs(x.double().cpu().numpy() - ref).max()), time_ms(fn, 10), launched)
    print(f"(10d) MFCC of B={B} x {T} frames (n_fft {d.n_fft}), max distance from an f64 MFCC and "
          f"time: " + "; ".join(f"{k} {v[0]:.3e}, {v[1]:.4f} ms" for k, v in out.items())
          + f" on {card}", flush=True)
    check(out["stockham"][2] == 0, "(10d) a kernel ran on the Stockham path")
    check(out["stockham"][0] <= melspec_kernel.TOLERANCE["atol"],
          f"(10d) Stockham MFCC {out['stockham'][0]:.3e} from the f64 MFCC")


# -- phase 11: frozen serving artifacts ------------------------------------------


ARTIFACT_CALLS = 6  # a fresh process's decodes of the bench artifact: one cold, then 5 timed


def artifact_decode_main(art: str, raw_path: str, out_path: str) -> None:
    """In a fresh process (``chip_smoke.py --artifact-decode ART RAW OUT``):
    ``ExportedDecoder`` loads the artifact, decodes the raw batch once cold
    and ARTIFACT_CALLS - 1 times more (median), and prints as JSON the
    times, K1-K3's launches and routes in this process, the MFCC kernel's
    cached FFT operands and any model-code module imported; the outputs go
    to ``out_path``."""
    import torch

    sys.path.insert(0, ROOT)
    from mmbidaf_tpu_torch.export import ExportedDecoder, _file_sha256
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel, lstm_kernel, melspec_kernel
    from mmbidaf_tpu_torch.parallel.mesh import initialize_distributed

    dev = torch.device("cuda", 0)
    # a mesh artifact (phase 13) loads under the process group its
    # COORDINATOR_ADDRESS names; without one, none is started
    rec = {"group": initialize_distributed("cuda")}
    # the load's parts, each once (their files read from disk the first
    # time), then the whole load as ExportedDecoder does it
    t0 = time.perf_counter()
    for f in sorted(os.listdir(art)):
        _file_sha256(os.path.join(art, f))
    t1 = time.perf_counter()
    torch.load(os.path.join(art, "weights.pt"), weights_only=True, map_location=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    torch.export.load(os.path.join(art, "decode.pt2")).module()
    t3 = time.perf_counter()
    rec["load_parts_s"] = {"sha256": t1 - t0, "weights": t2 - t1, "program": t3 - t2}
    t0 = time.perf_counter()
    dec = ExportedDecoder(art, device=dev)
    rec["load_s"] = time.perf_counter() - t0
    raw = {k: torch.from_numpy(v).to(dev) for k, v in np.load(raw_path).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    log_p, picks = dec.run(raw)
    torch.cuda.synchronize()
    rec["cold_s"] = time.perf_counter() - t0
    rec["batch_s"] = timed_batches(lambda: dec.run(raw), ARTIFACT_CALLS - 1)
    counters = {"K1": lstm_kernel.bilstm_cuda, "K2": bidaf_kernel.bidaf_attention_fused,
                "K3": melspec_kernel.mfcc_fused}
    rec["launches"] = {k: fn.launches for k, fn in counters.items()}
    rec["routes"] = {k: dict(fn.routes) for k, fn in counters.items()}
    rec["fft_operand_caches"] = len(melspec_kernel._WINDOWS)
    rec["layout"] = dec.layout
    rec["leaked"] = sorted(m for m in sys.modules if m in (
        "jax", "mmbidaf_tpu", "mmbidaf_tpu_torch.models", "mmbidaf_tpu_torch.serving",
        "mmbidaf_tpu_torch.data.frontend") or m.startswith(("jax.", "mmbidaf_tpu.",
                                                            "mmbidaf_tpu_torch.models.")))
    np.savez(out_path, log_p=log_p.float().cpu().numpy(), picks=picks.cpu().numpy())
    if rec["group"]:
        import torch.distributed as dist

        dist.destroy_process_group()
    print(json.dumps(rec), flush=True)


def artifact_first_request_main(mode: str, art: str, video_dir: str) -> None:
    """In a fresh process (``chip_smoke.py --artifact-first-request cold|warm
    ART DIR``): ``ExportedSummarizer`` loads the artifact, decodes the video
    once on the host, then answers two requests for it, after ``warmup()``
    with ``warm``; prints the seconds of each step as JSON."""
    import torch

    sys.path.insert(0, ROOT)
    from mmbidaf_tpu_torch.export import ExportedSummarizer

    rec = {}
    t0 = time.perf_counter()
    s = ExportedSummarizer(art, device=torch.device("cuda", 0))
    rec["load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    s._raw_row(video_dir)
    rec["host_first_s"] = time.perf_counter() - t0
    if mode == "warm":
        t0 = time.perf_counter()
        s.warmup()
        torch.cuda.synchronize()
        rec["warmup_s"] = time.perf_counter() - t0
    for key in ("first_s", "second_s"):
        t0 = time.perf_counter()
        s.summarize(video_dir)
        rec[key] = time.perf_counter() - t0
    print(json.dumps(rec), flush=True)


def release_cached_memory() -> None:
    """Hand the caching allocator's unused blocks back to the card, so a
    process started next (a fresh artifact process, the daemon) finds the
    memory that phases 1-10 left reserved in this one."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def artifact_child(*args: str, env: dict | None = None) -> dict:
    release_cached_memory()
    r = subprocess.run([sys.executable, os.path.abspath(__file__), *args], capture_output=True,
                       text=True, cwd=ROOT, timeout=600, env={**os.environ, **(env or {})})
    check(r.returncode == 0, f"(11) {args[0]} process failed: {r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def dir_sizes(path: str) -> dict:
    return {f: os.path.getsize(os.path.join(path, f)) for f in sorted(os.listdir(path))}


def dispatch_cost_us(dev) -> dict:
    """Host microseconds a call of K1 and K2 at small shapes, through the
    custom op (``torch.ops.mmbidaf.*``: the dispatcher, then the CUDA
    implementation) and through that implementation called directly, in
    turns (op, direct, direct, op), 400 calls a turn; the difference is
    the custom op's dispatch cost. Launches here time the dispatch, outside
    the main path."""
    import torch

    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel, lstm_kernel

    g = torch.Generator(device=dev).manual_seed(11)
    gates = torch.randn(4, 8, 8 * 128, device=dev, generator=g)
    mask = torch.ones(4, 8, device=dev)
    w_h = torch.randn(2, 128, 512, device=dev, generator=g) * 0.05
    c, q = torch.randn(2, 8, 256, device=dev, generator=g), torch.randn(2, 8, 256, device=dev, generator=g)
    cm, qm = torch.ones(2, 8, device=dev), torch.ones(2, 8, device=dev)
    w = [torch.randn(256, device=dev, generator=g) for _ in range(3)] + [torch.zeros((), device=dev)]
    pairs = {"K1": (lambda: torch.ops.mmbidaf.bilstm(gates, mask, w_h),
                    lambda: lstm_kernel._bilstm_launch(gates, mask, w_h)),
             "K2": (lambda: torch.ops.mmbidaf.bidaf(c, q, cm, qm, *w),
                    lambda: bidaf_kernel._bidaf_launch(c, q, cm, qm, *w))}
    out = {}
    for name, (op, direct) in pairs.items():
        times = {"op": [], "direct": []}
        for kind in ("op", "direct", "direct", "op"):
            fn = op if kind == "op" else direct
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(400):
                fn()
            times[kind].append((time.perf_counter() - t0) / 400 * 1e6)
            torch.cuda.synchronize()
        out[name] = {k: min(v) for k, v in times.items()}
    return out


def phase_export(dev, card: str, tmp: str, serving_root: str, tiers: dict, level_dirs: list,
                 t_batch_4a: float, all_records: list[dict]) -> None:
    """Phase 11: frozen serving artifacts (``export.py``) on the card: the
    bench configuration at B=64 in a fresh process, an f32 copy at B=2, beam
    and bucketed greedy artifacts at B=8 over phase 9's videos, the
    long-audio and Winograd configurations at B=2, and the CLIs and the
    daemon over an artifact, on phase 9's videos (``write_serving_corpus``
    under ``serving_root``: load-test tiers and rung-level videos).
    ``all_records`` gain the in-process launches."""
    import io

    import torch

    from mmbidaf_tpu_torch import infer
    from mmbidaf_tpu_torch.data.frontend import make_end_to_end_decode
    from mmbidaf_tpu_torch.export import ExportedDecoder, ExportedSummarizer, export_summarizer
    from mmbidaf_tpu_torch.ops.cuda import (bidaf_kernel, lstm_kernel, melspec_kernel,
                                            winograd_kernel)
    from mmbidaf_tpu_torch.serving import AXES, Summarizer
    from mmbidaf_tpu_torch.tools import export_artifact, load_test

    cfg = bench_config()
    cost = dispatch_cost_us(dev)
    print("(11) custom-op dispatch, host µs a call (op / direct): " + "; ".join(
        f"{k} {v['op']:.2f} / {v['direct']:.2f} (+{v['op'] - v['direct']:.2f})" for k, v in cost.items())
        + f" on {card}", flush=True)

    counters = {"bilstm": lstm_kernel.bilstm_cuda, "bidaf_attention": bidaf_kernel.bidaf_attention_fused,
                "mfcc": melspec_kernel.mfcc_fused, "log_mel": melspec_kernel.log_mel_fused,
                "bidaf_attention_tiled": bidaf_kernel.bidaf_attention_tiled,
                "winograd_conv3x3": winograd_kernel.winograd_conv3x3_fused}

    def zero():
        for fn in counters.values():
            fn.launches = 0
        lstm_kernel.bilstm_cuda.routes = {"cluster": 0, "l2": 0}
        bidaf_kernel.bidaf_attention_fused.routes = {"cluster": 0, "K9": 0}
        melspec_kernel.mfcc_fused.routes = {"fft": 0, "dense": 0}
        melspec_kernel.log_mel_fused.routes = {"fft": 0, "dense": 0}

    total = {k: 0 for k in counters}

    def collect() -> dict:
        got = {k: fn.launches for k, fn in counters.items()}
        for k, n in got.items():
            total[k] += n
        return got

    # (11a) the bench configuration at B=64, bf16, in a fresh process
    s = Summarizer.init_random(cfg, seed=0, device=dev)
    raw_np = raw_batch(cfg, np.random.default_rng(0), B)
    raw = {k: torch.from_numpy(v).to(dev) for k, v in raw_np.items()}
    live_lp, live_picks = make_end_to_end_decode(cfg)(s.model, s.frontend, raw)
    live_lp, live_picks = live_lp.float().cpu().numpy(), live_picks.cpu().numpy()
    art = os.path.join(tmp, "bench")
    zero()
    t0 = time.perf_counter()
    manifest = export_summarizer(s, art, batch_size=B, frame_hw=FRAME_HW)
    t_export = time.perf_counter() - t0
    check(all(fn.launches == 0 for fn in counters.values()), "(11a) the export launched a kernel")
    sizes = dir_sizes(art)
    print(f"(11a) bench config B={B} bf16: exported in {t_export:.2f} s (no kernel launched), "
          f"{sum(sizes.values()) / 1e6:.2f} MB: {sizes}; VGG frame chunk traced "
          f"{manifest['vgg_frame_chunk']}", flush=True)
    raw_path, out_path = os.path.join(tmp, "raw64.npz"), os.path.join(tmp, "out64.npz")
    np.savez(raw_path, **raw_np)
    rec = artifact_child("--artifact-decode", art, raw_path, out_path)
    got = np.load(out_path)
    dist = float(np.abs(got["log_p"] - live_lp).max())
    print(f"(11a) fresh process: load {rec['load_s']:.2f} s (its parts alone, files read cold: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in rec["load_parts_s"].items()) + f"), first call {rec['cold_s'] * 1e3:.2f} ms, "
          f"median batch {rec['batch_s'] * 1e3:.2f} ms over {ARTIFACT_CALLS - 1} "
          f"({B / rec['batch_s']:.2f} videos/s) against phase 4a's live {t_batch_4a * 1e3:.2f} ms on {card}; "
          f"launches {rec['launches']}, routes {rec['routes']}, cached FFT operands "
          f"{rec['fft_operand_caches']}; picks equal to make_end_to_end_decode's: "
          f"{bool((got['picks'] == live_picks).all())}, log-prob max abs diff {dist:.3e}", flush=True)
    check(not rec["leaked"], f"(11a) the artifact's process imported the model's code: {rec['leaked']}")
    n = ARTIFACT_CALLS
    check(rec["launches"] == {"K1": 5 * n, "K2": 2 * n, "K3": n},
          f"(11a) launches {rec['launches']} != 5 / 2 / 1 a batch over {n} batches")
    check(rec["routes"] == {"K1": {"cluster": 5 * n, "l2": 0}, "K2": {"cluster": 2 * n, "K9": 0},
                            "K3": {"fft": n, "dense": 0}}, f"(11a) routes {rec['routes']}")
    check(rec["fft_operand_caches"] == 1, "(11a) K3's FFT operands were not cached once")
    check(bool((got["picks"] == live_picks).all()), "(11a) the artifact's picks differ from the live program's")
    check_decode(got["log_p"], got["picks"], raw_np, cfg, "(11a) artifact")
    shutil.rmtree(art)

    # (11b) an f32 copy at B=2, cuDNN's TF32 flag at its default
    check(torch.backends.cudnn.allow_tf32, "(11b) cuDNN's TF32 flag is not its default (on)")
    cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32"))
    s32 = Summarizer.init_random(cfg32, seed=0, device=dev)
    raw2_np = {k: v[:2] for k, v in raw_np.items()}
    raw2 = {k: v[:2] for k, v in raw.items()}
    art32 = os.path.join(tmp, "f32")
    export_summarizer(s32, art32, batch_size=2, frame_hw=FRAME_HW)
    lp32, picks32 = ExportedDecoder(art32, device=dev).decode_raw(raw2_np)
    l_lp, l_picks = make_end_to_end_decode(cfg32)(s32.model, s32.frontend, raw2)
    d32 = float(np.abs(lp32 - l_lp.cpu().numpy()).max())
    print(f"(11b) f32 B=2, cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}: picks equal "
          f"{bool((picks32 == l_picks.cpu().numpy()).all())}, log-prob max abs diff {d32:.3e} "
          f"(bound 1e-5), {sum(dir_sizes(art32).values()) / 1e6:.2f} MB", flush=True)
    check(bool((picks32 == l_picks.cpu().numpy()).all()) and d32 <= 1e-5,
          "(11b) the f32 artifact differs from the live f32 path")
    del s32
    shutil.rmtree(art32)

    # (11c) beam (width 4) at B=8, and a bucketed greedy artifact at B=8
    zero()
    beam = Summarizer(s.model, s.frontend, s.word2idx, cfg, s.vgg_spec, mode="beam", topk=4)
    art_beam = os.path.join(tmp, "beam")
    export_summarizer(beam, art_beam, batch_size=8, frame_hw=FRAME_HW)
    dec_beam = ExportedDecoder(art_beam, device=dev)
    raw8_np = {k: v[:8] for k, v in raw_np.items()}
    raw8 = {k: v[:8] for k, v in raw.items()}
    b_lp, b_picks = dec_beam.decode_raw(raw8_np)
    lb_lp, lb_picks = beam._decode_batch_device(raw8)
    t_art = timed_batches(lambda: dec_beam.run(raw8))
    t_live = timed_batches(lambda: beam._decode_batch_device(raw8))
    print(f"(11c) beam width 4 B=8: picks equal {bool((b_picks == lb_picks.cpu().numpy()).all())}, "
          f"score max abs diff {float(np.abs(b_lp - lb_lp.float().cpu().numpy()).max()):.3e}; median "
          f"batch artifact {t_art * 1e3:.2f} ms, live {t_live * 1e3:.2f} ms on {card}", flush=True)
    check(bool((b_picks == lb_picks.cpu().numpy()).all()), "(11c) beam artifact picks differ")
    del dec_beam
    shutil.rmtree(art_beam)

    live_b = Summarizer(s.model, s.frontend, s.word2idx, cfg, s.vgg_spec, serve_buckets=True,
                        serve_batch_size=8)
    art_b = os.path.join(tmp, "bucketed")
    t0 = time.perf_counter()
    man_b = export_summarizer(live_b, art_b, batch_size=8, frame_hw=FRAME_HW, buckets=True)
    t_export_b = time.perf_counter() - t0
    art_s = ExportedSummarizer(art_b, device=dev)
    levels = [tuple(lv[k] for k in AXES) for lv in art_s.bucket_levels]
    check(len(levels) == len(level_dirs), f"(11c) {len(levels)} frozen levels, {len(level_dirs)} in phase 9")
    d = cfg.data
    caps = (d.max_sentences, d.max_words, d.max_keyframes, d.max_audio_frames)
    print(f"(11c) bucketed greedy B=8: {1 + len(man_b['bucket_programs'])} programs (levels {levels} "
          f"and the caps) exported in {t_export_b:.2f} s, {sum(dir_sizes(art_b).values()) / 1e6:.2f} MB",
          flush=True)
    for name, vids in [(f"level {i}", v) for i, v in enumerate(level_dirs)] + [("caps", tiers["full"])]:
        vids = (vids * 8)[:8]
        check(art_s.summarize_batch(vids) == live_b.summarize_batch(vids),
              f"(11c) {name}: the bucketed artifact's answers differ from the live Summarizer's")
        # one trimmed batch on the card, through both programs in turns
        raw_l = {k: torch.from_numpy(v).to(dev)
                 for k, v in art_s._stack_rows([art_s._raw_row(v)[0] for v in vids]).items()}
        t = {"artifact": [], "live": []}
        dispatch = {"artifact": [], "live": []}
        for kind in ("artifact", "live", "live", "artifact"):
            fn = art_s.decoder.run if kind == "artifact" else live_b._decode_batch_device
            t[kind].append(timed_batches(lambda: fn(raw_l)))
            for _ in range(5):  # the host's dispatch alone: until the call returns
                t0 = time.perf_counter()
                fn(raw_l)
                dispatch[kind].append(time.perf_counter() - t0)
                torch.cuda.synchronize()
        d_ms = {k: statistics.median(v) * 1e3 for k, v in dispatch.items()}
        print(f"(11c) {name}: answers equal the live bucketed Summarizer's; median batch (B=8, on "
              f"the card) artifact {t['artifact'][0] * 1e3:.2f}, {t['artifact'][1] * 1e3:.2f} ms, live "
              f"{t['live'][0] * 1e3:.2f}, {t['live'][1] * 1e3:.2f} ms; the host's dispatch of a batch "
              f"artifact {d_ms['artifact']:.2f} ms, live {d_ms['live']:.2f} ms", flush=True)
    print(f"(11c) bucket_stats {art_s.bucket_stats}", flush=True)
    check(set(art_s.bucket_stats) == set(levels) | {caps}, "(11c) a frozen level went unused")
    cold = artifact_child("--artifact-first-request", "cold", art_b, level_dirs[-1][0])
    warm = artifact_child("--artifact-first-request", "warm", art_b, level_dirs[-1][0])
    print(f"(11c) fresh process, bucketed artifact at batch 8: cold: load {cold['load_s']:.3f} s, first "
          f"request {cold['first_s']:.3f} s, second {cold['second_s']:.3f} s; warmed: load "
          f"{warm['load_s']:.3f} s, warmup() {warm['warmup_s']:.3f} s, first request "
          f"{warm['first_s']:.3f} s, second {warm['second_s']:.3f} s", flush=True)
    check(warm["first_s"] < cold["first_s"], "(11c) warmup did not shorten the first request")
    print(f"(11a-c) launches in this process over (b)-(c): {collect()}", flush=True)

    # (11d) long audio and the Winograd frontend, each at B=2
    zero()
    cfg_l = long_config()
    s_l = Summarizer.init_random(cfg_l, seed=0, device=dev)
    raw_l_np = raw_batch(cfg_l, np.random.default_rng(6), 2)
    raw_l = {k: torch.from_numpy(v).to(dev) for k, v in raw_l_np.items()}
    art_l = os.path.join(tmp, "long")
    export_summarizer(s_l, art_l, batch_size=2, frame_hw=FRAME_HW)
    zero()
    lp_a, picks_a = ExportedDecoder(art_l, device=dev).decode_raw(raw_l_np)
    got = collect()
    routes = {"K1": dict(lstm_kernel.bilstm_cuda.routes), "K2": dict(bidaf_kernel.bidaf_attention_fused.routes),
              "K4": dict(melspec_kernel.log_mel_fused.routes)}
    l_lp, l_picks = make_end_to_end_decode(cfg_l)(s_l.model, s_l.frontend, raw_l)
    print(f"(11d) long audio B=2: artifact launches {got}, routes {routes}; picks equal the live "
          f"program's {bool((picks_a == l_picks.cpu().numpy()).all())}, log-prob max abs diff "
          f"{float(np.abs(lp_a - l_lp.float().cpu().numpy()).max()):.3e}", flush=True)
    check(got["bilstm"] == 5 and got["bidaf_attention"] == 1 and got["bidaf_attention_tiled"] == 1
          and got["log_mel"] >= 1 and got["mfcc"] == 0,
          f"(11d) the long-audio artifact did not launch K1, K2, K9 and K4 (and not K3): {got}")
    check(routes["K2"] == {"cluster": 1, "K9": 1}, f"(11d) K2's routes {routes['K2']}")
    check(bool((picks_a == l_picks.cpu().numpy()).all()), "(11d) long-audio artifact picks differ")
    del s_l
    shutil.rmtree(art_l)
    cfg_w = winograd_config()
    s_w = Summarizer.init_random(cfg_w, seed=0, device=dev)
    raw_w_np = raw_batch(cfg_w, np.random.default_rng(7), 2)
    raw_w = {k: torch.from_numpy(v).to(dev) for k, v in raw_w_np.items()}
    art_w = os.path.join(tmp, "winograd")
    man_w = export_summarizer(s_w, art_w, batch_size=2, frame_hw=FRAME_HW)
    zero()
    lp_a, picks_a = ExportedDecoder(art_w, device=dev).decode_raw(raw_w_np)
    got = collect()
    frames = 2 * cfg_w.data.max_keyframes
    passes = -(-frames // man_w["vgg_frame_chunk"]) if man_w["vgg_frame_chunk"] else 1
    w_lp, w_picks = make_end_to_end_decode(cfg_w)(s_w.model, s_w.frontend, raw_w)
    print(f"(11d) Winograd B=2: artifact launches {got} ({passes} VGG pass(es)); picks equal the "
          f"live program's {bool((picks_a == w_picks.cpu().numpy()).all())}, log-prob max abs diff "
          f"{float(np.abs(lp_a - w_lp.float().cpu().numpy()).max()):.3e}", flush=True)
    check(got["winograd_conv3x3"] == 12 * passes, f"(11d) K14 launched {got['winograd_conv3x3']} times")
    check(bool((picks_a == w_picks.cpu().numpy()).all()), "(11d) Winograd artifact picks differ")
    del s_w
    shutil.rmtree(art_w)

    # (11e) the CLIs and the daemon over an artifact
    zero()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        export_artifact.main(["--random", "--vgg", "vgg16", "--verify", "--out", os.path.join(tmp, "cli")])
    print(f"(11e) export_artifact --random --vgg vgg16 --verify: "
          f"{' | '.join(buf.getvalue().strip().splitlines())} ({time.perf_counter() - t0:.2f} s)", flush=True)
    check("verify ok" in buf.getvalue(), "(11e) export_artifact --verify did not pass")
    shutil.rmtree(os.path.join(tmp, "cli"))
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        infer.main(["--artifact", art_b, "--data_dir", os.path.join(serving_root, "mixed")])
    line = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{'ROUGE-1'")][-1]
    scores = ast.literal_eval(line.partition(" (")[0])
    print(f"(11e) infer --artifact on phase 9's tiers: {line} in {time.perf_counter() - t0:.2f} s", flush=True)
    check(all(math.isfinite(v) for v in scores.values()) and f"({3 * PER_TIER} videos scored)" in line,
          f"(11e) infer --artifact printed {line}")
    expected = {vd: art_s.summarize(vd) for vds in tiers.values() for vd in vds}
    print(f"(11e) launches in this process over (d)-(e): {collect()}", flush=True)
    release_cached_memory()
    p = subprocess.Popen([sys.executable, "-u", "-m", "mmbidaf_tpu_torch.tools.serve", "--artifact", art_b,
                          "--dynamic_batch", "8", "--port", "0", "--warmup", "240x320"],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
    try:
        lines = []
        for ln in p.stdout:
            lines.append(ln)
            if ln.startswith("serving "):
                break
        if not (lines and lines[-1].startswith("serving ")):
            fail(f"(11e) the daemon did not start: {''.join(lines)} {p.stderr.read()[-3000:]}")
        port = int(lines[-1].split("http://127.0.0.1:")[1].split()[0])
        for vds in tiers.values():  # one request a tier outside the measured window
            load_test.post(port, vds[0], 600)
        r = load_test.drive(port, tiers, clients=8, requests=LOAD_REQUESTS, timeout=600)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
        p.send_signal(signal.SIGTERM)
        check(p.wait(timeout=120) == 0, "(11e) the daemon did not drain on SIGTERM")
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
        p.stdout.close()
        p.stderr.close()
    lm = r["latency_ms"]
    print(f"(11e) serve --artifact --dynamic_batch 8 ({''.join(lines[:-1]).strip()}): "
          f"{r['ok']}/{r['requests']} answered, p50 {lm['p50']:.2f} ms, p95 {lm['p95']:.2f} ms, p99 "
          f"{lm['p99']:.2f} ms, sustained {r['sustained_vps']:.2f} videos/s on {card}; /healthz artifact "
          f"{health.get('artifact')}, batcher {health.get('batcher')}", flush=True)
    check(r["ok"] == LOAD_REQUESTS and r["errors"] == 0, "(11e) the daemon failed requests")
    wrong = [vd for vd, a in r["answers"].items() if a != [expected[vd]]]
    check(not wrong, f"(11e) the daemon's answers differ from ExportedSummarizer.summarize's: {wrong}")
    check(health.get("artifact", {}).get("format_version") == 1, "(11e) /healthz shows no artifact format")
    shutil.rmtree(art_b)
    for rec_ in all_records:
        rec_["launches"] += total.get(rec_["name"], 0)
    print(f"(11) launches in this process over phase 11 (added to the records): {total}", flush=True)



# -- phase 12: the mesh layouts at world size 1 ----------------------------------


def serving_counters():
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel, lstm_kernel, melspec_kernel

    fns = {"K1": lstm_kernel.bilstm_cuda, "K2": bidaf_kernel.bidaf_attention_fused,
           "K3": melspec_kernel.mfcc_fused, "K4": melspec_kernel.log_mel_fused,
           "K9": bidaf_kernel.bidaf_attention_tiled}
    for fn in fns.values():
        fn.launches = 0
    lstm_kernel.bilstm_cuda.routes = {"cluster": 0, "l2": 0}
    bidaf_kernel.bidaf_attention_fused.routes = {"cluster": 0, "K9": 0}
    melspec_kernel.mfcc_fused.routes = {"fft": 0, "dense": 0}
    return fns


def read_counters(fns: dict) -> tuple[dict, dict]:
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel, lstm_kernel, melspec_kernel

    return ({k: fn.launches for k, fn in fns.items()},
            {"K1": dict(lstm_kernel.bilstm_cuda.routes),
             "K2": dict(bidaf_kernel.bidaf_attention_fused.routes),
             "K3": dict(melspec_kernel.mfcc_fused.routes)})


def mesh_cfg(cfg, **mesh):
    return dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh, **mesh))


def phase_mesh(dev, card: str, tmp: str, corpus_root: str, t_batch: float, t_step5: float,
               t_long: float, raw_step_s: float) -> float:
    """Phase 12: the mesh layouts at world size 1, each collective a
    one-rank NCCL call; every layout against the path without a mesh.
    Returns (a)'s median data-parallel batch, s."""
    import torch
    import torch.distributed as dist

    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel, lstm_kernel
    from mmbidaf_tpu_torch.parallel.mesh import initialize_distributed
    from mmbidaf_tpu_torch.serving import Summarizer
    from mmbidaf_tpu_torch.train import cli, loop

    env = {"COORDINATOR_ADDRESS": f"file://{os.path.join(tmp, 'store')}", "NUM_PROCESSES": "1",
           "PROCESS_ID": "0"}
    os.environ.update(env)
    try:
        check(initialize_distributed("cuda"), "(12) initialize_distributed started no group")
        print(f"(12) process group: backend {dist.get_backend()}, world size "
              f"{dist.get_world_size()}, rank {dist.get_rank()}", flush=True)
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1, "(12) not one NCCL rank")

        # (a) data-parallel serving at the bench configuration, B=64 bf16
        cfg = bench_config()
        raw_np = raw_batch(cfg, np.random.default_rng(0))
        raw = {k: torch.from_numpy(v).to(dev) for k, v in raw_np.items()}
        s = Summarizer.init_random(cfg, seed=0, device=dev, serve_batch_size=B, data_parallel=True)
        print(f"(12a) Summarizer(data_parallel=True): mesh {dict(s._mesh.shape)}", flush=True)
        fns = serving_counters()
        lp, picks = s._decode_batch_device(raw)
        torch.cuda.synchronize()
        check_decode(lp.cpu().numpy(), picks.cpu().numpy(), raw_np, cfg, "(12a) data-parallel bf16")
        t_dp = timed_batches(lambda: s._decode_batch_device(raw))
        launches, routes = read_counters(fns)
        print(f"(12a) data-parallel B={B} bf16: median batch {t_dp * 1e3:.2f} ms over 5 -> "
              f"{B / t_dp:.2f} videos/s, beside phase 4(a)'s {t_batch * 1e3:.2f} ms, on {card}; "
              f"launches {launches}, routes {routes}", flush=True)
        for k in ("K1", "K2", "K3"):
            check(launches[k] > 0, f"(12a) {k} was never launched under data_parallel")
        check(routes["K1"]["l2"] == 0 and routes["K2"]["K9"] == 0 and routes["K3"]["dense"] == 0,
              f"(12a) a kernel left its route: {routes}")
        del s

        # (b) f32, B=8: every serving layout bit for bit the path without a mesh
        k32, _ = f32_configs(cfg)
        raw8 = {k: v[:8] for k, v in raw.items()}
        ref = None
        for name, c, dp in (("none", k32, False), ("data_parallel", k32, True),
                            ("tp_vgg num_model=1", mesh_cfg(k32, tp_vgg=True, num_model=1), False),
                            ("data_parallel + tp_vgg", mesh_cfg(k32, tp_vgg=True, num_model=1),
                             True)):
            s = Summarizer.init_random(c, seed=0, device=dev, serve_batch_size=8,
                                       data_parallel=dp)
            fns = serving_counters()
            out = [t.cpu() for t in s._decode_batch_device(raw8)]
            launches, _ = read_counters(fns)
            if ref is None:
                ref = out
                continue
            same = all(torch.equal(a, b) for a, b in zip(out, ref))
            print(f"(12b) f32 B=8 {name}: log-probs and picks bit for bit the path without a "
                  f"mesh: {same}; launches {launches}", flush=True)
            check(same, f"(12b) {name} differs from the path without a mesh")
            check(all(launches[k] > 0 for k in ("K1", "K2", "K3")), f"(12b) {name}: {launches}")
            if "tp_vgg" in name:
                check(getattr(s.frontend.vgg, "tp", None) is not None,
                      f"(12b) {name}: the classifier was not split")
            del s

        # (c) sp_audio at num_seq=1, the long-audio configuration
        lcfg = long_config()
        lk32, lp32 = f32_configs(lcfg)
        raw2_np = raw_batch(lcfg, np.random.default_rng(1), 2)
        raw2 = {k: torch.from_numpy(v).to(dev) for k, v in raw2_np.items()}
        res = {}
        for name, c in (("plain", lp32), ("kernels", lk32),
                        ("sp", mesh_cfg(lp32, sp_audio=True, num_seq=1))):
            s = Summarizer.init_random(c, seed=0, device=dev)
            fns = serving_counters()
            res[name] = [t.cpu() for t in s._decode_batch_device(raw2)]
            res[name + ".launches"] = read_counters(fns)[0]
            del s
        for other in ("plain", "kernels"):
            same = torch.equal(res["sp"][1], res[other][1])
            diff = (res["sp"][0] - res[other][0]).abs().max().item()
            print(f"(12c) f32 B=2, {lcfg.data.max_audio_frames} audio frames, sp_audio at "
                  f"num_seq=1 against the path without a mesh ({other}): picks equal {same}, "
                  f"max log-prob diff {diff:.3e}", flush=True)
            check(same, f"(12c) sp_audio picks differ from the {other} path")
        sp_launches = res["sp.launches"]
        print(f"(12c) launches under sp_audio: {sp_launches} (the SP chain is plain: no K3, K4, K9)",
              flush=True)
        s = Summarizer.init_random(mesh_cfg(lcfg, sp_audio=True, num_seq=1), seed=0, device=dev)
        raw16 = {k: torch.from_numpy(v).to(dev)
                 for k, v in raw_batch(lcfg, np.random.default_rng(1), B_LONG).items()}
        fns = serving_counters()
        lp, picks = s._decode_batch_device(raw16)
        torch.cuda.synchronize()
        t_sp = timed_batches(lambda: s._decode_batch_device(raw16), n=3)
        launches, routes = read_counters(fns)
        print(f"(12c) sp_audio B={B_LONG} bf16, {lcfg.data.max_audio_frames} frames: median batch "
              f"{t_sp * 1e3:.2f} ms over 3, beside phase 6(a)'s {t_long * 1e3:.2f} ms on the "
              f"kernels, on {card}; launches {launches}", flush=True)
        check(launches["K1"] > 0 and launches["K2"] > 0, f"(12c) K1/K2 not launched: {launches}")
        check(launches["K4"] == 0 and launches["K9"] == 0 and launches["K3"] == 0,
              f"(12c) the SP tower reached an audio kernel: {launches}")
        del s

        # (d) training: the step with the mesh, then train.cli with the mesh flags
        from mmbidaf_tpu_torch.parallel.mesh import make_mesh

        tcfg = train_config()
        mesh = make_mesh(mesh_cfg(tcfg, num_data=1).mesh, dev)
        runs = {}
        for name, m in (("plain", None), ("mesh", mesh)):
            state, batch = train_state(tcfg, dev, seed=0)
            step = loop.make_train_step(tcfg, mesh=m)
            for _ in range(2):
                state, _ = step(state, batch)
            runs[name] = [state, batch, step, []]
        same = all(torch.equal(runs["plain"][0].params.state_dict()[k], v)
                   for k, v in runs["mesh"][0].params.state_dict().items())
        print(f"(12d) two steps at drop 0.2 with the mesh (flat-gradient all-reduce through NCCL) "
              f"bit for bit the steps without it: {same}", flush=True)
        check(same, "(12d) the data-parallel step differs from the step without a mesh")
        # in turns (plain, mesh, mesh, plain, twice), 15 steps each: the step
        # is held by the host, whose state drifts over a long process
        for name in ("plain", "mesh", "mesh", "plain") * 2:
            state, batch, step, times = runs[name]
            for _ in range(15):
                t0 = time.perf_counter()
                state, _ = step(state, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            runs[name][0] = state
        t_plain, t_mesh = (statistics.median(runs[k][3]) for k in ("plain", "mesh"))
        print(f"(12d) make_train_step in turns, 60 steps each: median {t_mesh * 1e3:.2f} ms with "
              f"the mesh, {t_plain * 1e3:.2f} ms without; phase 5's {t_step5 * 1e3:.2f} ms; on "
              f"{card}", flush=True)
        del runs, state, batch

        counters = (lstm_kernel.bilstm_train_forward, lstm_kernel.bilstm_bptt,
                    bidaf_kernel.bidaf_dropout_forward, bidaf_kernel.bidaf_dropout_backward)
        cfg_path = os.path.join(tmp, "train.json")
        with open(cfg_path, "w") as f:
            json.dump(dataclasses.asdict(tcfg), f)
        cli_s = {"plain": [], "mesh": []}
        for i, name in enumerate(("plain", "mesh", "mesh", "plain")):
            flags = ["--num_data", "1"] if name == "mesh" else []
            with timed_train_steps(counters) as rec:
                cli.main(["--config_json", cfg_path, "--device", "cuda", "--num_steps", "30",
                          "--eval_steps", "30", "--save_dir", tmp, "--name", f"{name}{i}",
                          *flags])
            cli_s[name] += rec.seconds[1:]
            check(len(rec.seconds) == 30 and all(n > 0 for n in rec.launches.values()),
                  f"(12d) train.cli {flags}: {len(rec.seconds)} steps, {rec.launches}")
            losses = [r["loss"] for r in run_log(os.path.join(tmp, f"{name}{i}")) if "loss" in r]
            check(bool(losses) and all(math.isfinite(x) for x in losses), f"(12d) losses {losses}")
        t_cli, t_cli0 = (statistics.median(cli_s[k]) for k in ("mesh", "plain"))
        print(f"(12d) train.cli on the synthetic stream (B={B_TRAIN}), in turns, 58 steps each: "
              f"median step {t_cli * 1e3:.2f} ms with --num_data 1, {t_cli0 * 1e3:.2f} ms without; "
              f"launches inside the last run's steps {rec.launches}", flush=True)
        with timed_train_steps(counters) as rec:
            cli.main(corpus_cli_args(corpus_root, os.path.join(corpus_root, "train.json"), "mesh",
                                     "--num_steps", "4", "--eval_steps", "4", "--num_data", "1",
                                     "--sp_audio", "--num_seq", "1", "--tp_vgg",
                                     "--num_model", "1"))
        t_raw = statistics.median(rec.seconds[1:])
        logs = run_log(os.path.join(corpus_root, "mesh"))
        evals = [r for r in logs if "eval_loss" in r]
        print(f"(12d) train.cli on phase 8's corpus with --sp_audio --num_seq 1 --tp_vgg "
              f"--num_model 1 --num_data 1: median step {t_raw * 1e3:.2f} ms over "
              f"{len(rec.seconds) - 1}, beside phase 8's {raw_step_s * 1e3:.2f} ms; launches "
              f"inside the steps {rec.launches}; eval {evals}", flush=True)
        check(len(rec.seconds) == 4 and all(n > 0 for n in rec.launches.values()),
              f"(12d) the corpus run: {len(rec.seconds)} steps, {rec.launches}")
        check(len(evals) == 1 and math.isfinite(evals[0]["eval_loss"]), f"(12d) eval {evals}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
    return t_dp


# -- phase 13: mesh artifacts, the daemon under a mesh, the device-op profiler ----


def group_env(tmp: str, name: str) -> dict:
    """A one-process group's variables on a fresh ``file://`` store."""
    return {"COORDINATOR_ADDRESS": f"file://{os.path.join(tmp, name)}", "NUM_PROCESSES": "1",
            "PROCESS_ID": "0"}


def write_run_dir(root: str, cfg) -> str:
    """A ``train.cli``-shaped run at ``cfg`` (config, vocabulary, one
    checkpoint of random weights from seed 0) for the daemon's live path."""
    from mmbidaf_tpu_torch.data.synthetic import random_word_vectors
    from mmbidaf_tpu_torch.data.vocab import save_vocab
    from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_init
    from mmbidaf_tpu_torch.train.checkpoint import CheckpointManager, save_config
    from mmbidaf_tpu_torch.train.loop import init_train_state

    os.makedirs(root)
    w2i = {f"w{i}": i for i in range(cfg.data.vocab_size)}
    wv = random_word_vectors(np.random.default_rng(0), cfg.data.vocab_size, cfg.model.emb_dim)
    save_vocab(w2i, wv, os.path.join(root, "vocab.json"), os.path.join(root, "emb.npz"))
    CheckpointManager(os.path.join(root, "ckpts")).save_unranked(
        init_train_state(mmbidaf_init(cfg, wv, "cpu", seed=0), cfg, seed=1))
    save_config(root, cfg)
    return root


def daemon_answers(args: list[str], env: dict, tiers: dict, expected: dict, tag: str) -> str:
    """``tools/serve.py`` with ``args`` in a process of its own under the
    group ``env`` names: MESH_REQUESTS requests over phase 9's tiers, each
    answer against ``expected``, then SIGTERM; returns the result line."""
    from mmbidaf_tpu_torch.tools import load_test

    release_cached_memory()
    p = subprocess.Popen([sys.executable, "-u", "-m", "mmbidaf_tpu_torch.tools.serve", *args,
                          "--port", "0", "--warmup", "240x320"], stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, cwd=ROOT, env={**os.environ, **env})
    try:
        lines = []
        for ln in p.stdout:
            lines.append(ln)
            if ln.startswith("serving "):
                break
        if not (lines and lines[-1].startswith("serving ")):
            fail(f"{tag} the daemon did not start: {''.join(lines)} {p.stderr.read()[-3000:]}")
        port = int(lines[-1].split("http://127.0.0.1:")[1].split()[0])
        r = load_test.drive(port, tiers, clients=4, requests=MESH_REQUESTS, timeout=600)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
        p.send_signal(signal.SIGTERM)
        check(p.wait(timeout=120) == 0, f"{tag} the daemon did not exit 0 on SIGTERM")
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
        p.stdout.close()
        p.stderr.close()
    check(r["ok"] == MESH_REQUESTS and r["errors"] == 0, f"{tag} the daemon failed requests: {r}")
    wrong = [vd for vd, a in r["answers"].items() if a != [expected[vd]]]
    check(not wrong, f"{tag} answers differ from summarize's: {wrong}")
    lm = r["latency_ms"]
    return (f"{r['ok']}/{r['requests']} answered, each equal to summarize's, p50 {lm['p50']:.2f} "
            f"ms, p95 {lm['p95']:.2f} ms, {r['sustained_vps']:.2f} videos/s; /healthz "
            f"parallelism {health.get('parallelism')}")


def phase_mesh_serving(dev, card: str, tmp: str, tiers: dict, t_batch: float, t_dp: float,
                       t_step5: float, all_records: list[dict]) -> None:
    """Phase 13 at world size 1 over NCCL: (a) the bench configuration
    exported as a data-parallel and a DP x TP artifact, each loaded and run
    in a fresh process against the live DP path; (b) the daemon with
    ``--data_parallel`` over the DP artifact and over a run, on phase 9's
    videos; (c) ``tools/device_profile.py`` at the bench shapes, serve and
    train. ``all_records`` gain this process's launches."""
    import torch
    import torch.distributed as dist

    from mmbidaf_tpu_torch.export import ExportedSummarizer, export_summarizer
    from mmbidaf_tpu_torch.parallel.mesh import initialize_distributed
    from mmbidaf_tpu_torch.serving import Summarizer
    from mmbidaf_tpu_torch.tools import device_profile

    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel, lstm_kernel

    fns = {**serving_counters(),
           "K5": lstm_kernel.bilstm_train_forward, "K6": lstm_kernel.bilstm_bptt,
           "K7": bidaf_kernel.bidaf_dropout_forward, "K8": bidaf_kernel.bidaf_dropout_backward}
    for fn in fns.values():
        fn.launches = 0
    env = group_env(tmp, "store")
    os.environ.update(env)
    try:
        check(initialize_distributed("cuda"), "(13) initialize_distributed started no group")
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1, "(13) not one NCCL rank")

        # (a) the bench configuration as DP and DP x TP artifacts, B=64 bf16
        cfg = bench_config()
        raw_np = raw_batch(cfg, np.random.default_rng(0))
        raw = {k: torch.from_numpy(v).to(dev) for k, v in raw_np.items()}
        raw_path = os.path.join(tmp, "raw64.npz")
        np.savez(raw_path, **raw_np)
        live = None
        for name, c in (("DP", cfg), ("DP x TP", mesh_cfg(cfg, tp_vgg=True, num_model=1))):
            s = Summarizer.init_random(c, seed=0, device=dev, serve_batch_size=B,
                                       data_parallel=True)
            lp, picks = s._decode_batch_device(raw)
            if live is None:  # the live DP path: phase 12a's program
                live = (lp.float().cpu().numpy(), picks.cpu().numpy())
            art = os.path.join(tmp, name.replace(" ", ""))
            t0 = time.perf_counter()
            manifest = export_summarizer(s, art, batch_size=B, frame_hw=FRAME_HW)
            t_export = time.perf_counter() - t0
            del s
            out_path = os.path.join(tmp, "out.npz")
            rec = artifact_child("--artifact-decode", art, raw_path, out_path,
                                 env=group_env(tmp, f"store_{name.replace(' ', '')}"))
            got = np.load(out_path)
            d_lp = float(np.abs(got["log_p"] - live[0]).max())
            same = bool((got["picks"] == live[1]).all())
            print(f"(13a) {name} artifact, bench config B={B} bf16: mesh {manifest['mesh']}, head "
                  f"program {manifest['head_file']}, exported in {t_export:.2f} s, "
                  f"{sum(dir_sizes(art).values()) / 1e6:.2f} MB; fresh process (NCCL world size "
                  f"1, layout {rec['layout']['axis_names']}): load {rec['load_s']:.2f} s, first "
                  f"call {rec['cold_s'] * 1e3:.2f} ms, median batch {rec['batch_s'] * 1e3:.2f} ms "
                  f"over {ARTIFACT_CALLS - 1} ({B / rec['batch_s']:.2f} videos/s) beside phase "
                  f"12a's live DP {t_dp * 1e3:.2f} ms and 4a's {t_batch * 1e3:.2f} ms on {card}; "
                  f"launches {rec['launches']}, routes {rec['routes']}; against the live DP path: "
                  f"picks equal {same}, log-prob distance {d_lp:.3e}", flush=True)
            n = ARTIFACT_CALLS
            check(rec["group"] and not rec["leaked"],
                  f"(13a) {name}: group {rec['group']}, model code imported {rec['leaked']}")
            check(rec["launches"] == {"K1": 5 * n, "K2": 2 * n, "K3": n},
                  f"(13a) {name}: launches {rec['launches']} != 5 / 2 / 1 a batch over {n}")
            check(rec["routes"] == {"K1": {"cluster": 5 * n, "l2": 0},
                                    "K2": {"cluster": 2 * n, "K9": 0},
                                    "K3": {"fft": n, "dense": 0}}, f"(13a) routes {rec['routes']}")
            check(same and d_lp == 0.0, f"(13a) the {name} artifact differs from the live DP path")
            if name == "DP":
                art_dp = art
            else:
                shutil.rmtree(art)

        # (b) the daemon under the mesh flags, over the DP artifact and over a run
        art_s = ExportedSummarizer(art_dp, device=dev)
        expected = {vd: art_s.summarize(vd) for vds in tiers.values() for vd in vds}
        del art_s
        line = daemon_answers(["--artifact", art_dp, "--data_parallel", "--dynamic_batch", str(B)],
                              group_env(tmp, "store_daemon_art"), tiers, expected, "(13b)")
        print(f"(13b) serve --artifact (DP, B={B}) --data_parallel --dynamic_batch {B}: {line} "
              f"on {card}", flush=True)
        shutil.rmtree(art_dp)
        run = write_run_dir(os.path.join(tmp, "run"), cfg)
        s = Summarizer.from_run(run, device=dev, serve_batch_size=8, data_parallel=True)
        expected = {vd: s.summarize(vd) for vds in tiers.values() for vd in vds}
        del s
        line = daemon_answers(["--run_dir", run, "--data_parallel", "--serve_batch_size", "8",
                               "--dynamic_batch", "8"], group_env(tmp, "store_daemon_live"), tiers,
                              expected, "(13b)")
        print(f"(13b) serve --run_dir (bench config) --data_parallel --serve_batch_size 8 "
              f"--dynamic_batch 8: {line} on {card}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)

    # (c) the device-op profiler at the bench shapes
    release_cached_memory()
    before = {k: fn.launches for k, fn in fns.items()}
    for mode, want in (("serve", ("K1 bilstm", "K2 bidaf", "K3 mfcc")),
                       ("train", ("K5 bilstm forward", "K6 bilstm backward", "K7 bidaf forward",
                                  "K8 bidaf backward"))):
        res = device_profile.run(mode, steps=3, kernels=True, device="cuda",
                                 trace_dir=os.path.join(tmp, f"trace_{mode}"))
        print("\n".join(f"(13c) {ln}" for ln in device_profile.format_table(res, top=12)),
              flush=True)
        mfu = ("none (an f32 program)" if res["mfu"] is None
               else f"{res['mfu']:.2%} of {res['peak_bf16_tflops']} bf16 TFLOP/s")
        ref = ("phase 4a", t_batch) if mode == "serve" else ("phase 5a", t_step5)
        print(f"(13c) {mode}: step {res['step_s'] * 1e3:.2f} ms beside {ref[0]}'s "
              f"{ref[1] * 1e3:.2f} ms; {res['tflops']:.2f} TFLOP/s of utils.flops' count, MFU "
              f"{mfu} on {card}", flush=True)
        missing = [k for k in want if not res["kernels"][k] > 0]
        check(not missing, f"(13c) {mode}: no device time under {missing}")
        if mode == "serve":
            check(res["mfu"] is not None, f"(13c) no bf16 peak for {res['device']}")
    profiled = {k: fn.launches - before[k] for k, fn in fns.items()}
    print(f"(13c) launches over the profiler's runs: {profiled}", flush=True)
    check(all(profiled[k] > 0 for k in ("K1", "K2", "K3", "K5", "K6", "K7", "K8")),
          f"(13c) a kernel of the profiled programs was never launched: {profiled}")
    names = {"K1": "bilstm", "K2": "bidaf_attention", "K3": "mfcc", "K4": "log_mel",
             "K9": "bidaf_attention_tiled", "K5": "bilstm_train_forward", "K6": "bilstm_bptt",
             "K7": "bidaf_dropout_forward", "K8": "bidaf_dropout_backward"}
    total = {k: fn.launches for k, fn in fns.items()}
    for rec in all_records:
        rec["launches"] += sum(n for k, n in total.items() if names[k] == rec["name"])
    print(f"(13) launches in this process over phase 13 (added to the records): {total}",
          flush=True)



# -- phase 14: the capability configs trained on the card, K7/K8's routes ----

# The published capability configs (SURVEY [B:6-10]) and long audio.
CAPABILITY_CONFIGS = ("config1_text_only.json", "config2_text_image.json",
                      "config3_text_audio.json", "config4_trimodal.json")
CAPABILITY_STEPS = 10
B_LONG_TRAIN = 16
# Phase 14b: every (T_c, T_q, D) of this grid (and two small shapes) must
# have a K7/K8 route the card holds; the listed shapes run at drop 0 and
# 0.2 against the plain versions (B=32; B=16 at T_q=4096).
DROP_GATE_TC = (1, 8, 32, 33, 40, 48, 64, 65, 128)
DROP_GATE_TQ = (1, 16, 32, 64, 512, 1088, 1089, 2048, 4096)
DROP_GATE_EXTRA = ((5, 33, 40), (7, 45, 20))
DROP_GATE_RUN = ((64, 64, 256), (64, 512, 256), (64, 64, 200), (32, 32, 256), (40, 16, 256),
                 (128, 512, 256), (32, 1089, 256), (32, 4096, 256))
# The capability configs' blocks (T_s=64, 64 keyframes, 512 frames, D=256):
# what the tiled route's records sum over.
DROP_MAIN_SHAPES = ((64, 64, 256), (64, 512, 256))
# A shape with neither route (K7's walk holds no block past T_c ~ 4,000).
NO_ROUTE = (5000, 64, 256)


def capability_config(name: str, kernels: bool = True, **model):
    """``examples/configs/<name>`` at its published widths, the three kernel
    flags on (or off), the sequence-parallel layout off (one card), and
    ``model`` overrides."""
    from mmbidaf_tpu_torch.config import config_from_json

    cfg = config_from_json(os.path.join(ROOT, "examples", "configs", name))
    flags = dict(use_pallas_attention=kernels, use_pallas_lstm=kernels, use_pallas_melspec=kernels)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **flags, **model),
                               mesh=dataclasses.replace(cfg.mesh, sp_audio=False, num_seq=1))


def tower_shapes(cfg) -> dict:
    """The BiDAF blocks of one training step: tower -> (T_c, T_q, D)."""
    d, m = cfg.data, cfg.model
    T_s, D = d.max_sentences, 2 * m.hidden_size
    shapes = {}
    if m.use_images:
        shapes["image"] = (T_s, d.max_keyframes, D)
    if m.use_audio:
        shapes["audio"] = (T_s, d.max_audio_frames, D)
    if not shapes:
        shapes["self"] = (T_s, T_s, D)
    return shapes


def phase_capability(dev, card: str) -> dict:
    """Phase 14a: configs 1-4 at B=32 and config6 (sp_audio off, T_q=4096)
    at B=16 through ``make_train_step`` with every kernel flag on; returns
    the launches of K7 and K8 on each route over the phase."""
    import torch

    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel as bk
    from mmbidaf_tpu_torch.ops.cuda import lstm_kernel as lk
    from mmbidaf_tpu_torch.train.loop import make_train_step

    runs = [(name, B_TRAIN) for name in CAPABILITY_CONFIGS]
    runs.append(("config6_sp_long_audio.json", B_LONG_TRAIN))
    counters = (lk.bilstm_train_forward, lk.bilstm_bptt, bk.bidaf_dropout_forward,
                bk.bidaf_dropout_backward)
    routes = {"forward": {"cluster": 0, "tiled": 0}, "backward": {"cluster": 0, "tiled": 0}}
    for name, bb in runs:
        cfg = capability_config(name)
        t0 = time.perf_counter()
        state, batch = train_state(cfg, dev, seed=0, batch_size=bb)
        train_step = make_train_step(cfg)
        torch.cuda.synchronize()
        expect = {tower: bk.drop_route(*shape) for tower, shape in tower_shapes(cfg).items()}
        print(f"(14a) {name}: hidden {cfg.model.hidden_size}, T_s={cfg.data.max_sentences}, "
              f"W={cfg.data.max_words}, {cfg.data.max_keyframes} keyframes, "
              f"{cfg.data.max_audio_frames} frames, vocab {cfg.data.vocab_size}, drop "
              f"{cfg.model.drop_prob}, {cfg.model.compute_dtype}, B={bb}; init "
              f"{time.perf_counter() - t0:.2f} s; K7/K8 routes by tower "
              f"{ {k: (tower_shapes(cfg)[k], v) for k, v in expect.items()} }", flush=True)
        for fn in counters:
            fn.launches = 0
        for fn in counters[2:]:
            fn.routes = {"cluster": 0, "tiled": 0}
        losses, step_s = [], []
        for i in range(CAPABILITY_STEPS):
            t0 = time.perf_counter()
            state, metrics = train_step(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            check(math.isfinite(loss) and math.isfinite(gnorm),
                  f"(14a) {name} step {i}: loss {loss}, grad norm {gnorm}")
            losses.append(loss)
        launches = {fn.__name__: fn.launches for fn in counters}
        want = {r: CAPABILITY_STEPS * sum(v == r for v in expect.values())
                for r in ("cluster", "tiled")}
        print(f"(14a) {name}: launches {launches}; K7 routes {bk.bidaf_dropout_forward.routes}, "
              f"K8 routes {bk.bidaf_dropout_backward.routes} (expected {want})", flush=True)
        check(all(v > 0 for v in launches.values()), f"(14a) {name}: a kernel never launched")
        check(bk.bidaf_dropout_forward.routes == want and bk.bidaf_dropout_backward.routes == want,
              f"(14a) {name}: K7/K8 left the routes drop_route names")
        for key, fn in (("forward", bk.bidaf_dropout_forward), ("backward", bk.bidaf_dropout_backward)):
            for r, n in fn.routes.items():
                routes[key][r] += n
        print(f"(14a) {name}: losses {' '.join(f'{x:.5f}' for x in losses)}", flush=True)
        check(losses[-1] < losses[0], f"(14a) {name}: the loss did not fall")
        t_step = statistics.median(step_s[1:])
        print(f"(14a) {name}: median step {t_step * 1e3:.2f} ms over {CAPABILITY_STEPS - 1} -> "
              f"{bb / t_step:.2f} videos/s on {card}", flush=True)
        del state, batch, train_step
        # drop 0, f32: one step through the kernels and one through the plain versions
        results = []
        for kernels in (True, False):
            cfg0 = capability_config(name, kernels=kernels, drop_prob=0.0, compute_dtype="float32")
            st, b0 = train_state(cfg0, dev, seed=3, batch_size=bb)
            st, m = make_train_step(cfg0)(st, b0)
            results.append((float(m["loss"]), float(m["grad_norm"]),
                            {n: p.detach() for n, p in st.params.named_parameters()}))
            del st, b0
        (lk_, gk, pk), (lp, gp, pp) = results
        dp = max((pk[n] - pp[n]).abs().max().item() for n in pk)
        print(f"(14a) {name}: f32 drop 0, one step: loss kernels {lk_:.7f} plain {lp:.7f}; grad "
              f"norm {gk:.7f} vs {gp:.7f}; max param diff {dp:.3e} (bound {TRAIN_PARITY_ATOL})",
              flush=True)
        check(abs(lk_ - lp) <= TRAIN_PARITY_ATOL and abs(gk - gp) <= TRAIN_PARITY_ATOL * max(1.0, gp),
              f"(14a) {name}: kernel and plain loss / grad norm differ")
        check(dp <= TRAIN_PARITY_ATOL, f"(14a) {name}: kernel and plain parameters differ")
        del results, pk, pp
        release_cached_memory()
    print(f"(14a) K7/K8 launches by route over phase 14a: {routes}", flush=True)
    return routes


def drop_operands(rng, gen, dev, bb: int, tc: int, tq: int, dd: int, drop: float):
    """K7/K8's operands: unit-normal c and q, their dropped copies at
    ``drop`` (the same tensors at 0), ragged masks with an empty c row (1)
    and an empty q row (2), weights of 0.1 scale and bias 0.25."""
    import torch

    from mmbidaf_tpu_torch.ops.common import dropout_mask

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    c, q = normal(bb, tc, dd), normal(bb, tq, dd)
    cd = c * dropout_mask(c.shape, drop, gen, dev) if drop else c
    qd = q * dropout_mask(q.shape, drop, gen, dev) if drop else q
    cm = torch.from_numpy(ragged_mask(rng, bb, tc, lo=0, empty_row=1 if bb > 1 else None)).to(dev)
    qm = torch.from_numpy(ragged_mask(rng, bb, tq, lo=0, empty_row=2 if bb > 2 else None)).to(dev)
    w = [normal(dd) * 0.1 for _ in range(3)]
    return (c, q, cd, qd, cm, qm, *w, torch.tensor(0.25, device=dev)), normal(bb, tc, 4 * dd)


def drop_bounds(bb: int, tc: int, tq: int, dd: int) -> tuple:
    """K7's and K8's (ops ms, bytes ms) at one shape (phase 3's counts)."""
    seq = bb * (2 * tc * dd + 2 * tq * dd + tc + tq) + 3 * dd + 1
    return (bound(bb * (4 * tc * tq * dd + 2 * tc * tc * (tq + dd)), 4 * (seq + bb * tc * 4 * dd)),
            bound(bb * (12 * tc * tq * dd + 6 * tc * tc * tq + 6 * tc * tc * dd),
                  4 * (seq + bb * tc * 4 * dd + bb * (2 * tc * dd + 2 * tq * dd) + 3 * dd + 1)))


def phase_drop_routes(dev, card: str) -> list[dict]:
    """Phase 14b: every gate shape's K7/K8 route, its plans equal to the C
    plans and clusters the card holds; the run shapes at drop 0 and 0.2
    against the plain versions (twice bit for bit), timed; a shape with
    neither route refused before any launch. Returns the tiled route's two
    records (summed over DROP_MAIN_SHAPES at drop 0.2)."""
    import ctypes

    import torch

    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel as bk
    from mmbidaf_tpu_torch.ops.cuda import build

    lib = build.library()
    shapes = [(tc, tq, dd) for dd in (200, 256) for tc in DROP_GATE_TC for tq in DROP_GATE_TQ]
    count = {"cluster": 0, "tiled": 0}
    for tc, tq, dd in shapes + list(DROP_GATE_EXTRA):
        route = bk.drop_route(tc, tq, dd)
        count[route] += 1
        if route == "cluster":
            plan, out = bk.drop_plan(tc, tq, dd), (ctypes.c_int * 4)()
            check(lib.mmb_bidaf_drop_plan(tc, tq, dd, out) == 0
                  and tuple(out) == (plan.C, plan.tq, plan.smem_fwd, plan.smem_bwd),
                  f"(14b) K7/K8 cluster plan at {(tc, tq, dd)}: C {tuple(out)} vs {plan}")
            occ = (lib.mmb_bidaf_forward_dropout_occupancy(tc, tq, dd),
                   lib.mmb_bidaf_backward_occupancy(tc, tq, dd))
        else:
            plan, out = bk.tiled_plan(tc, tq, dd, 128, drop=True), (ctypes.c_int * 6)()
            check(lib.mmb_bidaf_tiled_drop_plan(tc, tq, dd, out) == 0
                  and tuple(out) == (plan.C, plan.span, plan.tq, int(plan.resident), plan.smem,
                                     plan.work),
                  f"(14b) K7 tiled plan at {(tc, tq, dd)}: C {tuple(out)} vs {plan}")
            bk._tiled_bwd_work(tc, tq, dd)  # raises where K8's C plan differs from its mirror
            occ = (lib.mmb_bidaf_tiled_forward_dropout_occupancy(tc, tq, dd),)
        check(min(occ) > 0, f"(14b) {(tc, tq, dd)} on the {route} route: the card holds no "
                            f"cluster (occupancy {occ})")
    print(f"(14b) gate: {len(shapes) + len(DROP_GATE_EXTRA)} shapes, routes {count}; every plan "
          f"equal to the C plan, every cluster held by the card", flush=True)

    rng = np.random.default_rng(14)
    gen = torch.Generator(device=dev).manual_seed(14)
    recs = {k: {"err": 0.0, "ms": 0.0, "plain": 0.0, "dev": 0.0, "parts": []} for k in (7, 8)}
    for tc, tq, dd in DROP_GATE_RUN:
        bb = B_LONG_TRAIN if tq > 2048 else B_TRAIN
        route = bk.drop_route(tc, tq, dd)
        for drop in (0.0, 0.2):
            ops, g = drop_operands(rng, gen, dev, bb, tc, tq, dd, drop)
            before = (bk.bidaf_dropout_forward.routes[route], bk.bidaf_dropout_backward.routes[route])
            fwd, stats = bk.bidaf_dropout_forward(*ops, with_stats=True)
            tag = f"{(tc, tq, dd)} B={bb} drop {drop}"
            e7 = compare(f"(14b) K7 {tag}", fwd, bk.bidaf_dropout_reference(*ops), bk.TOLERANCE)
            again = bk.bidaf_dropout_forward(*ops, with_stats=True)
            check(torch.equal(fwd, again[0]) and (stats is None or torch.equal(stats, again[1])),
                  f"(14b) K7 {tag}: two runs differ")
            bwd = bk.bidaf_dropout_backward(*ops, g, stats=stats)
            # K8 is held to the plain version run in f64: dbias sums B·T_c·T_q
            # terms that cancel to ~0, and at long T_q the f32 plain version's
            # own sums over T_q are off by the size of the bound
            ref32 = bk.bidaf_dropout_backward_reference(*ops, g)
            ref = [r.float() for r in bk.bidaf_dropout_backward_reference(
                *(x.double() for x in ops), g.double())]
            print(f"    (14b) K8 {tag}: dbias kernel {bwd[7].item():.4e}, plain f32 "
                  f"{ref32[7].item():.4e}, plain f64 {ref[7].item():.4e}; plain f32 vs f64 "
                  f"max abs err per output "
                  f"{' '.join(f'{(a - b).abs().max().item():.2e}' for a, b in zip(ref32, ref))}",
                  flush=True)
            e8 = compare(f"(14b) K8 {tag}", bwd, ref, bk.BACKWARD_TOLERANCE, normwise=True)
            check(all(torch.equal(a, b) for a, b in
                      zip(bwd, bk.bidaf_dropout_backward(*ops, g, stats=stats))),
                  f"(14b) K8 {tag}: two runs differ")
            after = (bk.bidaf_dropout_forward.routes[route], bk.bidaf_dropout_backward.routes[route])
            check(after == (before[0] + 2, before[1] + 2), f"(14b) {tag}: not on the {route} route")
            if drop == 0.0:
                print(f"  K7/K8 {tag}: {route}; max_abs_err K7={e7:.3e} K8={e8:.3e}; deterministic",
                      flush=True)
                continue
            k7 = time_ms(lambda: bk.bidaf_dropout_forward(*ops, with_stats=True), iters=10)
            k8 = time_ms(lambda: bk.bidaf_dropout_backward(*ops, g, stats=stats), iters=10)
            p7 = time_ms(lambda: bk.bidaf_dropout_reference(*ops), iters=3, reps=3)
            p8 = time_ms(lambda: bk.bidaf_dropout_backward_reference(*ops, g), iters=3, reps=3)
            b7, b8 = drop_bounds(bb, tc, tq, dd)
            if route == "tiled":
                parts = device_ms_by_kernel(
                    lambda: bk.bidaf_dropout_backward(*ops, g, stats=stats),
                    ("bidaf_tiled_bwd_prep", "bidaf_tiled_bwd_pass_kernel<false>",
                     "bidaf_tiled_bwd_pass_kernel<true>", "bidaf_tiled_bwd_finish",
                     "sum_over_batch"))
                print(f"    (14b) K8 tiled {tag}: device ms by kernel "
                      f"{ {k.split('_')[-1]: round(v, 4) for k, v in parts.items()} }", flush=True)
            plan = (bk.drop_plan(tc, tq, dd) if route == "cluster" else
                    (bk.tiled_plan(tc, tq, dd, 128, drop=True), bk.tiled_bwd_plan(tc, tq, dd)))
            if route == "tiled":
                w, p = plan
                plan_s = (f"K7 walk C={w.C} span={w.span} tile={w.tq} resident={w.resident} "
                          f"spill={w.work > 0} smem {w.smem} B; K8 blocks={p.C}x{p.per} tiles of "
                          f"{p.tq}, smem {p.smem} B, workspace {4 * p.work * bb / 1e6:.1f} MB")
            else:
                plan_s = f"cluster C={plan.C} tile={plan.tq} smem K7 {plan.smem_fwd} K8 {plan.smem_bwd} B"
            print(f"  K7/K8 {tag}: {route} ({plan_s}); max_abs_err K7={e7:.3e} K8={e8:.3e}; "
                  f"K7 {k7:.4f} ms (plain {p7:.4f}, bound {max(b7):.4f} by "
                  f"{'operations' if b7[0] >= b7[1] else 'bytes'}); K8 {k8:.4f} ms (plain "
                  f"{p8:.4f}, bound {max(b8):.4f}); deterministic; on {card}", flush=True)
            if (tc, tq, dd) in DROP_MAIN_SHAPES:
                for k, e, ms, pl, b in ((7, e7, k7, p7, b7), (8, e8, k8, p8, b8)):
                    r = recs[k]
                    r["err"], r["ms"], r["plain"] = max(r["err"], e), r["ms"] + ms, r["plain"] + pl
                    r["parts"].append(b)
    # a shape with neither route: refused before any launch
    ops, g = drop_operands(rng, gen, dev, 2, NO_ROUTE[0], NO_ROUTE[1], NO_ROUTE[2], 0.2)
    n7, n8 = bk.bidaf_dropout_forward.launches, bk.bidaf_dropout_backward.launches
    for fn in (lambda: bk.bidaf_dropout_forward(*ops), lambda: bk.bidaf_dropout_backward(*ops, g)):
        try:
            fn()
            fail(f"(14b) {NO_ROUTE} has no K7/K8 route but was launched")
        except ValueError as e:
            check("no K7/K8 route" in str(e), f"(14b) unexpected refusal: {e}")
    check((bk.bidaf_dropout_forward.launches, bk.bidaf_dropout_backward.launches) == (n7, n8),
          "(14b) a refused shape moved a launch counter")
    print(f"(14b) {NO_ROUTE}: no route; refused before any launch", flush=True)
    print_resources("14b", (("K7 tiled", "bidaf_tiled_cluster_kernel"),
                            ("K8 tiled", "bidaf_tiled_bwd_prep_kernel"),
                            ("K8 tiled", "bidaf_tiled_bwd_pass_kernel"),
                            ("K8 tiled", "bidaf_tiled_bwd_finish_kernel")),
                    keep=lambda inst: inst.count(",") < 2 or inst.endswith("true>"))

    def record(name, src, replaces, r):
        out = {"name": name, "route": "cuda", "source": f"mmbidaf_tpu_torch/csrc/{src}",
               "replaces": f"mmbidaf_tpu/ops/pallas/{replaces}", "max_abs_err": r["err"],
               "ms": r["ms"], "plain_ms": r["plain"], **bound_fields(r["parts"]),
               "library_ms": None}
        print(f"{name}: max_abs_err={r['err']:.3e} kernel={r['ms']:.4f} ms plain={r['plain']:.4f} "
              f"ms roofline={out['bound_ms']:.4f} ms ({out['bound_by']}) at {DROP_MAIN_SHAPES} "
              f"B={B_TRAIN} on {card}", flush=True)
        return out

    return [record("bidaf_dropout_forward[tiled]", "bidaf_tiled.cu", "bidaf_kernel.py:154", recs[7]),
            record("bidaf_dropout_backward[tiled]", "bidaf_tiled_bwd.cu", "bidaf_kernel.py:189",
                   recs[8])]


# Phase 14c: docs/QUALITY.md's quality run at its full size (the JAX twin's
# thresholds on the held-out picks); 14d: the tower ablation, at 1000 steps
# a config, not the reference's 2000: phases 14a-14d took 296 s at 2000 on
# an H100 80GB HBM3 at 700 W, the ablation 191 s of it.
QUALITY_STEPS, QUALITY_EVAL = 500, 100
QUALITY_BAR = 0.75
ABLATION_STEPS, ABLATION_EVAL = 1000, 250


def phase_quality(dev, card: str, tmp: str) -> dict:
    """Phase 14c: ``experiments.quality_run`` at docs/QUALITY.md's size
    (hidden 128, VGG-16 at 224², 512 MFCC frames, bf16, the kernel flags on,
    adadelta lr 0.5, 208 train / 32 dev learnable videos, B=32): the curve,
    and the last held-out pick overlap and ROUGE-L at least QUALITY_BAR."""
    from mmbidaf_tpu_torch.experiments import quality_run
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel as bk

    t0 = time.perf_counter()
    routes = (dict(bk.bidaf_dropout_forward.routes), dict(bk.bidaf_dropout_backward.routes))
    final = quality_run.main(["--data_dir", os.path.join(tmp, "quality"), "--videos", "240",
                              "--dev", "32", "--steps", str(QUALITY_STEPS), "--eval_every",
                              str(QUALITY_EVAL), "--batch", str(B_TRAIN), "--out",
                              os.path.join(tmp, "quality.jsonl")])
    print(f"(14c) curve (step, train loss, held-out pick overlap, ROUGE-L): "
          f"{[(r['step'], r['train_loss'], r['pick_overlap'], r['ROUGE-L']) for r in final['curve']]}",
          flush=True)
    last = final["final"]
    print(f"(14c) {final['train_videos']} train / {final['dev_videos']} dev videos, B={final['batch']}: "
          f"floor pick overlap {final['floor']['pick_overlap']}, ROUGE-L {final['floor']['ROUGE-L']}; "
          f"step {last['step']} pick overlap {last['pick_overlap']}, ROUGE-L {last['ROUGE-L']} "
          f"(oracle {final['oracle_ceiling']['ROUGE-L']}); featurize {final['featurize_s']:.2f} s, "
          f"{final['steps_per_s']:.2f} steps/s on {card}; K7/K8 routes "
          f"{bk.bidaf_dropout_forward.routes} / {bk.bidaf_dropout_backward.routes} (before "
          f"{routes[0]} / {routes[1]}); phase {time.perf_counter() - t0:.1f} s", flush=True)
    check(last["pick_overlap"] >= QUALITY_BAR and last["ROUGE-L"] >= QUALITY_BAR,
          f"(14c) held-out pick overlap {last['pick_overlap']} / ROUGE-L {last['ROUGE-L']} "
          f"below {QUALITY_BAR}")
    return final


def phase_ablation(dev, card: str, tmp: str, steps: int) -> dict:
    """Phase 14d: ``experiments.ablation_sweep`` (four tower configs on one
    split-cue corpus of 240 videos) at ``steps`` steps each; its table
    beside the reference run's quality columns (docs/runs/ablation_r5.json,
    the JAX package's run at 2000 steps); gated only on finite losses."""
    from mmbidaf_tpu_torch.experiments import ablation_sweep

    t0 = time.perf_counter()
    summary = ablation_sweep.main(["--data_dir", os.path.join(tmp, "ablation"), "--steps",
                                   str(steps), "--eval_every", str(ABLATION_EVAL), "--batch",
                                   str(B_TRAIN), "--out", os.path.join(tmp, "ablation.json")])
    with open(os.path.join(ROOT, "docs", "runs", "ablation_r5.json")) as f:
        ref = json.load(f)["table"]
    print(f"(14d) tower ablation, {steps} steps, B={B_TRAIN}, on {card} | the reference's "
          f"quality columns (docs/runs/ablation_r5.json, 2000 steps):", flush=True)
    for name, row in summary["table"].items():
        print(f"  {name:10s} " + " ".join(f"{k} {row[k]} (ref {ref[name][k]})"
                                           for k in ablation_sweep.TABLE_KEYS), flush=True)
    for name, run in summary["runs"].items():
        losses = [r["train_loss"] for r in run["curve"][1:]]
        check(all(math.isfinite(x) for x in losses), f"(14d) {name}: a non-finite loss {losses}")
    print(f"(14d) phase {time.perf_counter() - t0:.1f} s", flush=True)
    return summary


def phase_14(dev, card: str, tmp: str) -> list[dict]:
    """Phase 14: (a) the capability configs, (b) K7/K8's routes at the gate's
    shapes; returns the tiled route's records, launches from (a)."""
    t0 = time.perf_counter()
    routes = phase_capability(dev, card)
    records = phase_drop_routes(dev, card)
    for rec, key in zip(records, ("forward", "backward")):
        rec["launches"] = routes[key]["tiled"]
        check(rec["launches"] > 0, f"(14a) {rec['name']} was never launched on the main path")
    phase_quality(dev, card, tmp)
    release_cached_memory()
    phase_ablation(dev, card, tmp, ABLATION_STEPS)
    print(f"(14) phases 14a-14d took {time.perf_counter() - t0:.1f} s", flush=True)
    return records


# -- phase 15: the drivers and demos --------------------------------------------

# Phase 15's drivers (``mmbidaf_tpu_torch/experiments``) with their flags: the
# bench shapes, each driver's own count of timed calls (5-10), 20 steps an
# arm of the prefetch A/B. Phase 15 took 28 s with 3 timed calls a driver
# (H100 80GB HBM3 at 700 W).
DRIVER_RUNS = (
    ("conv_profile", []),
    ("winograd_profile", []),
    ("winograd_pallas_profile", []),
    ("preprocess_profile", []),
    ("fft_ab", []),
    ("e2e_breakdown", ["--batch", str(B_TRAIN)]),
    ("train_breakdown", ["--pallas"]),
    ("beam_ab", []),
    ("bucket_ab", []),
    ("prefetch_ab", ["--pallas", "--steps", "20"]),
)


def phase_counters() -> dict:
    """Every hand kernel phase 15 launches, its counter set to 0."""
    from mmbidaf_tpu_torch.ops.cuda import (bidaf_kernel, lstm_kernel, melspec_kernel,
                                            preprocess_kernel, winograd_kernel)

    fns = {"K1": lstm_kernel.bilstm_cuda, "K2": bidaf_kernel.bidaf_attention_fused,
           "K3": melspec_kernel.mfcc_fused, "K4": melspec_kernel.log_mel_fused,
           "K5": lstm_kernel.bilstm_train_forward, "K6": lstm_kernel.bilstm_bptt,
           "K7": bidaf_kernel.bidaf_dropout_forward, "K8": bidaf_kernel.bidaf_dropout_backward,
           "K10": preprocess_kernel.preprocess_frames_fused,
           "K14": winograd_kernel.winograd_conv3x3_fused}
    for fn in fns.values():
        fn.launches = 0
    return fns


def check_driver(name: str, res) -> None:
    """Each driver's own result holds what it promises."""
    import torch

    from mmbidaf_tpu_torch.experiments.conv_profile import VGG_LAYERS
    from mmbidaf_tpu_torch.ops.cuda import preprocess_kernel

    ops = {r.get("op") for r in res} if isinstance(res, list) else set()
    if name == "conv_profile":
        want = ({f"{x}_{t}" for x, *_ in VGG_LAYERS for t in ("bf16", "int8")}
                | {"gemm_bf16", "gemm_int8", "gemm_int8_row_major_b", "vgg_full_bf16"})
        check(want <= ops, f"(15) conv_profile: missing {sorted(want - ops)}")
    elif name in ("winograd_profile", "winograd_pallas_profile"):
        check(len(ops - {None}) == 10, f"(15) {name}: {sorted(ops - {None})}")
        errs = [r["max_abs_vs_cudnn"] for r in res if "max_abs_vs_cudnn" in r]
        check(all(math.isfinite(e) for e in errs), f"(15) {name}: K14 against cuDNN {errs}")
    elif name == "preprocess_profile":
        # f32: K10 against its plain version; the bf16 plain path rounds
        # inside its products, so its distance is reported, not gated
        err = res[-1]["max_abs_diff_f32"]
        check(err <= preprocess_kernel.TOLERANCE[torch.float32]["atol"],
              f"(15) K10 against the plain resize in f32: {err}")
    elif name == "fft_ab":
        routes = [(r["n_fft"], r["k4_route"]) for r in res[1:]]
        check(routes == [(512, "fft"), (2048, "fft"), (4096, "fft")], f"(15) fft_ab routes {routes}")
    elif name == "e2e_breakdown":
        check(len(res) == 8, f"(15) e2e_breakdown: {len(res) - 1} stages")
    elif name == "train_breakdown":
        check(all(math.isfinite(r["loss"]) for r in res[1:]), "(15) train_breakdown: a loss")
    else:  # the A/B drivers
        ratio = {"beam_ab": "beam_over_greedy", "bucket_ab": "bucketed_speedup",
                 "prefetch_ab": "value"}[name]
        check(res[ratio] > 0, f"(15) {name}: {res}")


def phase_drivers(dev, card: str, tmp: str) -> dict:
    """Phase 15: every driver of ``experiments/`` at the bench shapes with
    few timed calls, the parity demo with the kernels on, and the parallel
    demo at world size 1 through NCCL; one JSON line a driver (its result),
    and every kernel of the list launched in the phase."""
    import importlib
    import io

    from mmbidaf_tpu_torch.examples import parallel_demo, parity_demo

    t_phase = time.perf_counter()
    fns = phase_counters()
    results = {}
    for name, argv in DRIVER_RUNS:
        mod = importlib.import_module(f"mmbidaf_tpu_torch.experiments.{name}")
        before = {k: fn.launches for k, fn in fns.items()}
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            res = mod.main(argv)
        dt = time.perf_counter() - t0
        launched = {k: fn.launches - before[k] for k, fn in fns.items() if fn.launches > before[k]}
        print(json.dumps({"driver": name, "argv": argv, "seconds": dt, "launches": launched,
                          "card": card, "result": res}), flush=True)
        check_driver(name, res)
        results[name] = res
        release_cached_memory()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        par = parity_demo.main(["--device", "cuda"])
    print(json.dumps({"driver": "parity_demo", "seconds": time.perf_counter() - t0,
                      "card": card, "result": par}), flush=True)
    check(par["picks_equal"], "(15) parity_demo: the picks differ from the oracle's")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        demo = parallel_demo.main(["--device", "cuda", "--workdir",
                                   os.path.join(tmp, "parallel_demo")])
    print(json.dumps({"driver": "parallel_demo", "seconds": time.perf_counter() - t0,
                      "card": card, "result": {k: v for k, v in demo.items() if k != "summaries"}}),
          flush=True)
    check(demo["world"] == 1 and demo["artifact_equal"], f"(15) parallel_demo: {demo}")
    launches = {k: fn.launches for k, fn in fns.items()}
    print(f"(15) launches over phase 15: {launches}; phase {time.perf_counter() - t_phase:.1f} s "
          f"on {card}", flush=True)
    for k, n in launches.items():
        check(n > 0, f"(15) {k} was never launched in phase 15")
    return results


# -- phase 16: every shape the JAX kernels take; hidden 512, a 4096-point window --

# 16a: K5/K6 at widths on both sides of the cluster plan's edge (448, 432 and
# 384 units at 4, 8 and 16 rows a cluster) and rows that pick each R of
# either route; T=512 at 32 rows (the audio tower's steps); 128: the bench
# width, where K1 and K5 must still give the same bits.
LSTM_GATE_H = (128, 384, 400, 448, 449, 512, 640, 1024)  # 449: rows of odd width
LSTM_GATE_SHAPES = ((32, 16), (32, 512), (512, 16), (2048, 16))
# The Python mirrors of the L2 plan against the C plan over this grid.
LSTM_PLAN_H = (8, 100, 128, 384, 400, 448, 512, 699, 700, 1024, 4096, 9685, 9686)
LSTM_PLAN_ROWS = (1, 32, 128, 512, 1024, 2048)
# 16b: K4 / K3 at n_fft past 2048 (win = n_fft) and at windows that are no
# power of two (n_fft = win), 64 mels, hop 160. K4 on 512 frames, K3 on 128
# (where mfcc_fused_fits holds at n_fft 4096); at n_fft 16384 the dense
# route reads its two 537 MB bases once a block of 2 frames, so 16 frames.
MEL_GATE_NFFT = (4096, 8192, 16384)
MEL_GATE_WIN = (1000, 1500, 3000, 6000)
MEL_GATE_FRAMES, MFCC_GATE_FRAMES, MEL_GATE_FRAMES_16K = 512, 128, 16
# 16c / 16d: the hidden-512 model and the 4096-point-window model.
H512, N_FFT_4096 = 512, 4096
TRAIN512_STEPS = 10
B_PARITY = 8  # the f32 kernels-vs-plain batch of 16c's serving


def lstm_gate_operands(gen, rng, dev, rows: int, steps: int, hid: int):
    """K5/K6's operands at ``rows x steps x hid``: the projection of
    unit-normal inputs of width 64 through a seeded BiLSTM layer (gates as
    training hands them over), a ragged mask with an empty row, and
    unit-normal cotangents."""
    import torch

    from mmbidaf_tpu_torch.ops.cuda import lstm_kernel as lk
    from mmbidaf_tpu_torch.ops.lstm import BiLSTMParams

    p = BiLSTMParams(64, hid, gen, dev)
    x = torch.randn(rows, steps, 64, device=dev, generator=gen)
    m = torch.from_numpy(ragged_mask(rng, rows, steps, lo=0, empty_row=1)).to(dev)
    with torch.no_grad():
        gates = lk._projection(p, x).contiguous()
    w_h = torch.stack([p.fwd.w_h, p.bwd.w_h]).detach().contiguous()
    cot = [torch.randn(*shape, device=dev, generator=gen)
           for shape in ((rows, steps, 2 * hid), (rows, 2 * hid), (rows, 2 * hid))]
    return gates, m, w_h, cot


def lstm_route_plan(rows: int, hid: int) -> str:
    from mmbidaf_tpu_torch.ops.cuda import lstm_kernel as lk

    if lk.train_route(rows, hid) == "cluster":
        plan = lk.cluster_plan(rows, hid)
        return f"cluster C={plan.C} R={plan.R}"
    R = lk.l2_rows(rows, hid)
    return f"l2 R={R} blocks={2 * -(-rows // R)} smem {lk.l2_smem(hid, R)} B"


def phase_lstm_gate(dev, card: str) -> list[dict]:
    """Phase 16a: the L2 plan's mirror equals the C plan; K5 and K6 at every
    shape of the gate against their plain versions, K1 and K5 bit for bit
    equal, each launch on the route ``train_route`` names; then K5/K6 on
    their L2 route at the hidden-512 model's training towers, timed beside
    the plain versions and cuDNN. Returns the L2 route's two records
    (launches filled in by 16c)."""
    import torch

    from mmbidaf_tpu_torch.ops.cuda import build
    from mmbidaf_tpu_torch.ops.cuda import lstm_kernel as lk

    import ctypes

    t_phase = time.perf_counter()
    lib = build.library()
    for hid in LSTM_PLAN_H:
        for rows in LSTM_PLAN_ROWS:
            check(lib.mmb_lstm_l2_rows(rows, hid) == lk.l2_rows(rows, hid),
                  f"(16a) l2_rows({rows}, {hid}): C {lib.mmb_lstm_l2_rows(rows, hid)} vs "
                  f"{lk.l2_rows(rows, hid)}")
            try:
                k6 = lk.bptt_route(rows, hid)
            except ValueError:
                k6 = "none"
            check(lk._BPTT_ROUTES[lib.mmb_lstm_bptt_route(rows, hid, 0)] == k6,
                  f"(16a) bptt_route({rows}, {hid}): C {lib.mmb_lstm_bptt_route(rows, hid, 0)} vs {k6}")
    print(f"(16a) the L2 plan's and K6's route rule's mirrors equal the C ones over H {LSTM_PLAN_H} "
          f"x rows {LSTM_PLAN_ROWS}; no route past H="
          f"{max(h for h in range(9600, 9700) if lk.l2_rows(1, h))}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(16)
    rng = np.random.default_rng(16)
    k5, k6 = lk.bilstm_train_forward, lk.bilstm_bptt
    count = {"cluster": 0, "grid": 0, "l2": 0}
    err5 = err6 = 0.0
    for hid in LSTM_GATE_H:
        for rows, steps in LSTM_GATE_SHAPES:
            route, route6 = lk.train_route(rows, hid), lk.bptt_route(rows, hid)
            gates, m, w_h, (dout, dh, dc) = lstm_gate_operands(gen, rng, dev, rows, steps, hid)
            before = (k5.routes[route], k6.routes[route6])
            tag = f"H={hid} rows={rows} T={steps}"
            fwd = k5(gates, m, w_h)
            e5 = compare(f"(16a) K5 {tag}", fwd, lk.bilstm_train_forward_reference(gates, m, w_h),
                         lk.TOLERANCE)
            k1 = torch.ops.mmbidaf.bilstm(gates, m, w_h)
            check(all(torch.equal(a, b) for a, b in zip(k1, fwd[:3])),
                  f"(16a) K1 and K5 differ at {tag} on the {route} route")
            args = (gates, m, w_h, fwd[3], fwd[4], dout, dh, dc)
            bwd = k6(*args)
            e6 = compare(f"(16a) K6 {tag}", bwd, lk.bilstm_bptt_reference(*args), lk.BPTT_TOLERANCE,
                         normwise=True)
            check(not bwd[0][1].any(), f"(16a) K6 {tag}: dgates of the empty row not zero")
            check((k5.routes[route], k6.routes[route6]) == (before[0] + 1, before[1] + 1),
                  f"(16a) {tag}: K5/K6 not on the {route} / {route6} route")
            count[route6] += 1
            err5, err6 = max(err5, e5), max(err6, e6)
            print(f"  K5/K6 {tag}: {lstm_route_plan(rows, hid)}; K6 {route6}; max_abs_err K5={e5:.3e} "
                  f"K6={e6:.3e}; K1 = K5 bit for bit", flush=True)
            del gates, m, w_h, dout, dh, dc, fwd, bwd, k1, args
    print(f"(16a) gate: {sum(count.values())} shapes, routes {count}; K5 routes {k5.routes}, K6 "
          f"routes {k6.routes}; max_abs_err K5={err5:.3e} (bound {lk.TOLERANCE}) K6={err6:.3e} "
          f"(normwise {lk.BPTT_TOLERANCE})", flush=True)
    check(all(n > 0 for n in count.values()), f"(16a) the gate missed a route: {count}")
    print_resources("16a", (("K1/K5 l2", "bilstm_kernel"), ("K6 l2", "bilstm_bptt_l2_kernel"),
                            ("K6 grid", "bilstm_bptt_cluster_kernel_grid")))
    out = (ctypes.c_int * 10)()
    check(lib.mmb_lstm_grid_plan(B_TRAIN, H512, 1, out) == 0, "(16a) the card runs no grid walk plan "
          f"at rows={B_TRAIN}, H={H512}")
    print(f"(16a) K6's grid walk at rows={B_TRAIN}, H={H512} on this card: P={out[0]} blocks a "
          f"direction in {out[2]} clusters of {out[1]}, {out[4]} units a block, {out[7]} threads, "
          f"{out[8]} B of shared memory (the shape rule's P=64 needs 16 clusters; the card holds "
          f"{lib.mmb_bilstm_backward_grid_occupancy(B_TRAIN, H512, 64)})", flush=True)

    # the hidden-512 model's training towers (B=32), timed: the JSON records
    # (K6 on the routes bptt_route names, and on the L2 walk at every tower)
    recs = {k: {"err": 0.0, "ms": 0.0, "plain": 0.0, "lib": 0.0, "parts": []} for k in (5, 6, "6l2")}
    walks = ("bilstm_bptt_cluster_kernel_grid", "bilstm_bptt_l2_kernel")
    for tag, rows, steps, _ in lstm_shapes(hidden512_config(), B_TRAIN)[:5]:
        check(lk.train_route(rows, H512) == "l2", f"(16a) {tag} tower at H=512 is not on the L2 route")
        gates, m, w_h, (dout, dh, dc) = lstm_gate_operands(gen, rng, dev, rows, steps, H512)
        fwd = k5(gates, m, w_h)
        e5 = compare(f"(16a) K5 {tag}", fwd, lk.bilstm_train_forward_reference(gates, m, w_h),
                     lk.TOLERANCE)
        args = (gates, m, w_h, fwd[3], fwd[4], dout, dh, dc)
        route6, n6 = lk.bptt_route(rows, H512), dict(k6.routes)
        ref6 = lk.bilstm_bptt_reference(*args)
        e6 = compare(f"(16a) K6 {tag}", k6(*args), ref6, lk.BPTT_TOLERANCE, normwise=True)
        check(k6.routes[route6] == n6[route6] + 1, f"(16a) K6 {tag} not on the {route6} walk")
        e6l2 = compare(f"(16a) K6 {tag} l2", k6(*args, route="l2"), ref6, lk.BPTT_TOLERANCE,
                       normwise=True)
        iters = 2 if steps >= 512 else 5
        t5 = time_ms(lambda: k5(gates, m, w_h), iters=iters, reps=3)
        t6 = time_ms(lambda: k6(*args), iters=iters, reps=3)
        t6l2 = time_ms(lambda: k6(*args, route="l2"), iters=iters, reps=3)
        w6 = sum(device_ms_by_kernel(lambda: k6(*args), walks, calls=3).values())
        w6l2 = device_ms_by_kernel(lambda: k6(*args, route="l2"), walks, calls=3)[walks[1]]
        p5 = time_ms(lambda: lk.bilstm_train_forward_reference(gates, m, w_h), iters=1, reps=3)
        p6 = time_ms(lambda: lk.bilstm_bptt_reference(*args), iters=1, reps=3)
        with cudnn_rnn_full_f32():
            l5 = time_ms(lstm_library_call(rows, steps, H512, H512, m, dev, backward=False), iters=3)
            l6 = time_ms(lstm_library_call(rows, steps, H512, H512, m, dev, backward=True), iters=3)
        G, n = 4 * H512, rows * steps
        rec = 2 * 2 * n * H512 * G  # the recurrent product, both directions
        # bytes: the residual reads and writes as phase 3 counts them, and W_h
        # (4 MB a direction) read from L2 every step: its device-memory share is once
        b5 = bound(rec, 4 * (n * (2 * G + 1 + 2 * H512 + 4 * H512) + 2 * H512 * G + 4 * rows * H512))
        b6 = bound(3 * rec, 4 * (n * (2 * G + 1 + 4 * H512 + 2 * H512 + 2 * G) + 2 * 2 * H512 * G
                                 + 4 * rows * H512))
        for r, e, k, pl, lb, b in ((recs[5], e5, t5, p5, l5, b5), (recs[6], e6, t6, p6, l6, b6),
                                   (recs["6l2"], e6l2, t6l2, p6, l6, b6)):
            r["err"], r["ms"], r["plain"], r["lib"] = (max(r["err"], e), r["ms"] + k,
                                                       r["plain"] + pl, r["lib"] + lb)
            r["parts"].append(b)
        l2_reads = 2 * steps * -(-rows // lk.l2_rows(rows, H512)) * H512 * G * 4 / 1e9
        print(f"  K5/K6 {tag:8s} rows={rows:4d} T={steps:3d} H={H512}: {lstm_route_plan(rows, H512)}; "
              f"max_abs_err K5={e5:.3e} K6={e6:.3e}; K5 {t5:.3f} ms ({t5 * 1e3 / steps:.1f} us a "
              f"step; plain {p5:.2f}; cudnn fwd {l5:.3f}; bound {max(b5):.4f}); K6 {t6:.3f} ms on "
              f"the {route6} walk (the walk {w6:.3f} ms, {w6 * 1e3 / steps:.2f} us a step), "
              f"{t6l2:.3f} ms on the L2 walk (the walk {w6l2:.3f} ms, {w6l2 * 1e3 / steps:.2f} us a "
              f"step; max_abs_err {e6l2:.3e}) (plain {p6:.2f}; cudnn bwd {l6:.3f}; bound "
              f"{max(b6):.4f}); W_h read from L2 {l2_reads:.2f} GB a K5 call, on {card}", flush=True)
        del gates, m, w_h, dout, dh, dc, fwd, args

    def record(name, src, replaces, r):
        out = {"name": name, "route": "cuda", "source": f"mmbidaf_tpu_torch/csrc/{src}",
               "replaces": f"mmbidaf_tpu/ops/pallas/{replaces}", "max_abs_err": r["err"],
               "ms": r["ms"], "plain_ms": r["plain"], **bound_fields(r["parts"]),
               "library_ms": r["lib"]}
        print(f"{name}: max_abs_err={r['err']:.3e} kernel={r['ms']:.4f} ms plain={r['plain']:.4f} "
              f"ms cudnn={r['lib']:.4f} ms roofline={out['bound_ms']:.4f} ms ({out['bound_by']}) at "
              f"the hidden-512 towers, B={B_TRAIN}, on {card}", flush=True)
        return out

    print(f"(16a) phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return [record("bilstm_train_forward[l2]", "lstm.cu", "lstm_kernel.py:228", recs[5]),
            record("bilstm_bptt[l2]", "lstm_bwd.cu", "lstm_kernel.py:256", recs["6l2"]),
            record("bilstm_bptt[grid]", "lstm_bwd.cu", "lstm_kernel.py:256", recs[6])]


def mel_gate_frames(rng, dev, n: int, steps: int, win: int, silent: int | None = None,
                    hop: int = 160):
    """``n`` seeded noise waveforms (example ``silent`` all zeros) framed as
    ``steps`` frames of ``win``."""
    import torch

    from mmbidaf_tpu_torch.ops import audio

    sig = (rng.standard_normal((n, (steps - 1) * hop + win)) * 0.1).astype(np.float32)
    if silent is not None:
        sig[silent] = 0.0
    return audio.frame_signal(torch.from_numpy(sig).to(dev), win, hop, steps)


def phase_mel_gate(dev, card: str) -> dict:
    """Phase 16b: the route plans' mirrors equal the C plans; K4 (both modes)
    and K3 at every shape of the gate against their plain versions, each
    launch on the route named; K3's DCT pass at 512 mels; K4 at n_fft 4096
    on 512 frames timed (the JSON record; launches filled in by 16d)."""
    import ctypes

    import torch

    from mmbidaf_tpu_torch.ops import audio
    from mmbidaf_tpu_torch.ops.cuda import build
    from mmbidaf_tpu_torch.ops.cuda import melspec_kernel as mk

    t_phase = time.perf_counter()
    lib = build.library()
    out3 = (ctypes.c_int * 3)()
    n_plans = 0
    for n_fft in (16, 64, 256, 512, 1024, 2048, 4096, 8192, 16384):
        for win in sorted({min(n_fft, 400), n_fft}):
            check(lib.mmb_mel_dense_frames(win, n_fft // 2 + 1) == mk.dense_frames(win, n_fft // 2 + 1),
                  f"(16b) dense frames at [{win}, {n_fft // 2 + 1}]")
            for n_mels in (12, 64, 512):
                for ld in (160, win):
                    for f64 in (False, True):
                        nnz = 2 * (n_fft // 2 + 1)
                        plan = mk.fft_plan(n_fft, win, ld, n_mels, nnz, f64)
                        rc = lib.mmb_log_mel_fft_plan(n_fft, win, ld, n_mels, nnz, int(f64), out3)
                        check((rc == 0) == (plan is not None)
                              and (plan is None or tuple(out3) == tuple(plan)),
                              f"(16b) FFT plan at n_fft={n_fft} win={win} ld={ld} {n_mels} mels "
                              f"f64={f64}: C {rc} {tuple(out3)} vs {plan}")
                        n_plans += 1
    for win in MEL_GATE_WIN:
        check(lib.mmb_mel_dense_frames(win, win // 2 + 1) == mk.dense_frames(win, win // 2 + 1),
              f"(16b) dense frames at win {win}")
    print(f"(16b) {n_plans} FFT plans and the dense route's frames equal the C plans", flush=True)

    k3, k4 = mk.mfcc_fused, mk.log_mel_fused
    rng = np.random.default_rng(161)
    err4 = {True: 0.0, False: 0.0}
    err3, rec = 0.0, None
    for n_fft, win in [(n, n) for n in MEL_GATE_NFFT] + [(w, w) for w in MEL_GATE_WIN]:
        t0 = time.perf_counter()
        consts = audio.make_audio_frontend_consts(16000, n_fft, win, 64, 40, device=dev)
        bins = n_fft // 2 + 1
        steps = MEL_GATE_FRAMES_16K if n_fft >= 16384 else MEL_GATE_FRAMES
        frames = mel_gate_frames(rng, dev, 1, steps, win)
        r4, r3 = mk.log_mel_route(win, bins), mk.mfcc_route(win, bins)
        nnz = mk.mel_nonzeros(consts["mel_fb"])[1].numel()

        def blocks(route, f64):  # frames a block of the first pass
            return (mk.fft_plan(n_fft, win, 160, 64, nnz, f64).frames if route == "fft"
                    else mk.dense_frames(win, bins))

        line = []
        for log in (True, False):
            before = k4.routes[r4]
            out = k4(frames, consts, log=log)
            e = compare(f"(16b) K4 n_fft={n_fft} win={win} log={log}", out,
                        mk.log_mel_reference(frames, consts, log=log), mk.LOG_MEL_TOLERANCE[log],
                        normwise=not log)
            check(k4.routes[r4] == before + 1, f"(16b) K4 at n_fft={n_fft}: not on the {r4} route")
            err4[log] = max(err4[log], e)
            line.append(f"K4 log={log} {e:.3e}")
        f3 = mel_gate_frames(rng, dev, 2, min(steps, MFCC_GATE_FRAMES), win, silent=1)
        before = k3.routes[r3]
        out = k3(f3, consts)
        e3 = compare(f"(16b) K3 n_fft={n_fft} win={win}", out, mk.mfcc_reference(f3, consts),
                     mk.TOLERANCE)
        check(not out[1].any(), f"(16b) K3 n_fft={n_fft}: the silent example is not exactly 0")
        check(k3.routes[r3] == before + 1, f"(16b) K3 at n_fft={n_fft}: not on the {r3} route")
        err3 = max(err3, e3)
        print(f"  K4/K3 n_fft={n_fft} win={win}: K4 {r4} route ({blocks(r4, False)} frames a block), "
              f"K3 {r3} route ({blocks(r3, True)} frames a block); {steps} / {f3.shape[1]} frames; "
              f"max_abs_err {', '.join(line)}, K3 {e3:.3e}; {time.perf_counter() - t0:.1f} s",
              flush=True)
        if n_fft == N_FFT_4096:
            n = frames.shape[0] * frames.shape[1]
            sig_bytes = 4 * ((steps - 1) * 160 + win)
            k = time_ms(lambda: k4(frames, consts, log=False), iters=10)
            kl = time_ms(lambda: k4(frames, consts, log=True), iters=10)
            pl = time_ms(lambda: mk.log_mel_reference(frames, consts, log=False), iters=5)
            # the dense route at the same shape, for the record (its launch
            # outside the counters): O(win·bins) a frame against the FFT's
            dense_out = torch.empty(1, steps, 64, device=dev)

            def dense():
                rc = lib.mmb_log_mel_forward(
                    frames.data_ptr(), frames.stride(0), frames.stride(1), consts["cos"].data_ptr(),
                    consts["sin"].data_ptr(), consts["mel_fb"].data_ptr(), dense_out.data_ptr(), 1,
                    steps, win, bins, 64, 0, torch.cuda.current_stream(dev).cuda_stream)
                build.check_launch(lib, rc, "mmb_log_mel_forward")

            dense()
            e_dense = compare("(16b) K4 dense route at n_fft 4096", dense_out,
                              mk.log_mel_reference(frames, consts, log=False),
                              mk.LOG_MEL_TOLERANCE[False], normwise=True)
            dense_ms = time_ms(dense, iters=1, reps=3)
            ops = spectrum_flops(n, n_fft, win, consts["mel_fb"])
            dense_ops = n * (4 * win * bins + 3 * bins + 2 * int((consts["mel_fb"] != 0).sum()))
            part = bound(ops, sig_bytes + 4 * (win + 64 * bins + n * 64))
            dense_part = bound(dense_ops, sig_bytes + 4 * (2 * win * bins + bins * 64 + n * 64))
            rec = {"name": "log_mel[n_fft 4096]", "route": "cuda",
                   "source": "mmbidaf_tpu_torch/csrc/mfcc.cu",
                   "kernel": "logmel_fft_kernel<kMelPower> at 4 frames a block",
                   "replaces": "mmbidaf_tpu/ops/pallas/melspec_kernel.py:24", "max_abs_err": e,
                   "ms": k, "plain_ms": pl, **bound_fields([part]), "library_ms": None}
            print(f"  K4 n_fft={n_fft} raw mel on {steps} frames: {k:.4f} ms (log mode {kl:.4f}); "
                  f"plain {pl:.4f} ms; bound {max(part):.4f} ms by "
                  f"{rec['bound_by']} ({ops / 1e9:.3f} GFLOP as an FFT); the dense route at this "
                  f"shape ({mk.dense_frames(win, bins)} frames a block) {dense_ms:.2f} ms, max_abs_err "
                  f"{e_dense:.3e}, against its bound {max(dense_part):.4f} ms ({dense_ops / 1e9:.1f} "
                  f"GFLOP); on {card}", flush=True)
        del consts, frames, f3, out
        release_cached_memory()
    # K3's DCT pass past 384 mels (its block opts in to more shared memory)
    consts = audio.make_audio_frontend_consts(16000, 512, 400, 512, 40, device=dev)
    f3 = mel_gate_frames(rng, dev, 2, 64, 400)
    out = k3(f3, consts)
    e = compare("(16b) K3 512 mels", out, mk.mfcc_reference(f3, consts), mk.TOLERANCE)
    print(f"  K3 at 512 mels (DCT pass {mk.dct_smem_bytes(512)} B of shared memory): max_abs_err "
          f"{e:.3e}", flush=True)
    print(f"(16b) K4 routes {k4.routes}, K3 routes {k3.routes}; max_abs_err K4 log {err4[True]:.3e}, "
          f"raw {err4[False]:.3e}, K3 {max(err3, e):.3e}; phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    print_resources("16b", (("K3/K4 fft", "logmel_fft_kernel"), ("K3/K4 dense", "logmel_tile_kernel")))
    return rec


def hidden512_config():
    """The bench configuration with ``hidden_size=512`` (BiDAF width 1024)."""
    cfg = bench_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, hidden_size=H512))


def train512_config(drop_prob: float = 0.2, kernels: bool = True):
    """``bench_train.py --pallas`` at ``hidden_size=512``."""
    cfg = train_config(drop_prob, kernels)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, hidden_size=H512))


def window4096_config(features: str = "mfcc"):
    """The long-audio configuration (config6, ``sp_audio`` off) with
    ``n_fft = win_length = 4096``; MFCC, or ``logmel`` features."""
    cfg = long_config()
    data = dataclasses.replace(cfg.data, n_fft=N_FFT_4096, win_length=N_FFT_4096,
                               audio_features=features)
    model = cfg.model if features == "mfcc" else dataclasses.replace(
        cfg.model, audio_feat_dim=cfg.data.n_mels)
    return dataclasses.replace(cfg, data=data, model=model)


def phase_hidden512(dev, card: str) -> dict:
    """Phase 16c: the hidden-512 model served (B=64, bf16: K1 on its L2
    route, K2 / K9 at D=1024, K3) and trained (B=32, f32, drop 0.2:
    K5/K6 on their L2 routes, K7/K8 at D=1024); f32 picks and one drop-0
    step equal between the kernels and the plain versions. Returns K5's and
    K6's launches on the L2 route and K6's on the grid walk."""
    import torch

    from mmbidaf_tpu_torch.data.frontend import make_end_to_end_decode
    from mmbidaf_tpu_torch.ops.cuda import bidaf_kernel as bk
    from mmbidaf_tpu_torch.ops.cuda import lstm_kernel as lk
    from mmbidaf_tpu_torch.ops.cuda import melspec_kernel as mk
    from mmbidaf_tpu_torch.serving import Summarizer
    from mmbidaf_tpu_torch.train.loop import make_train_step

    t_phase = time.perf_counter()
    cfg = hidden512_config()
    s = Summarizer.init_random(cfg, seed=0, device=dev)
    raw_np = raw_batch(cfg, np.random.default_rng(16))
    raw = {k: torch.from_numpy(v).to(dev) for k, v in raw_np.items()}
    end_to_end = make_end_to_end_decode(cfg)
    counters = {"K1": lk.bilstm_cuda, "K2": bk.bidaf_attention_fused, "K3": mk.mfcc_fused,
                "K9": bk.bidaf_attention_tiled}
    for fn in counters.values():
        fn.launches = 0
    lk.bilstm_cuda.routes = {"cluster": 0, "l2": 0}
    bk.bidaf_attention_fused.routes = {"cluster": 0, "K9": 0}
    lp, picks = end_to_end(s.model, s.frontend, raw)
    torch.cuda.synchronize()
    check_decode(lp.cpu().numpy(), picks.cpu().numpy(), raw_np, cfg, "(16c) hidden-512 bf16")
    t_batch = timed_batches(lambda: end_to_end(s.model, s.frontend, raw), n=3)
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"(16c) hidden-512 serving B={B} bf16 (D={2 * H512}): median batch {t_batch * 1e3:.2f} ms "
          f"over 3 -> {B / t_batch:.2f} videos/s on {card}; launches {launches}; K1 routes "
          f"{lk.bilstm_cuda.routes}, K2 routes {bk.bidaf_attention_fused.routes}", flush=True)
    # K2's wrapper hands both blocks at D=1024 to K9 (bidaf_route)
    check(launches["K1"] > 0 and launches["K3"] > 0 and launches["K2"] + launches["K9"] > 0,
          f"(16c) a serving kernel never launched: {launches}")
    check(lk.bilstm_cuda.routes == {"cluster": 0, "l2": launches["K1"]},
          f"(16c) K1 left its L2 route at H=512: {lk.bilstm_cuda.routes}")
    profile_kernels(lambda _: end_to_end(s.model, s.frontend, raw), None, t_batch, "(16c serve)",
                    "batch", {"K1 l2": "bilstm_kernel", "K2 bidaf": "bidaf_fwd_cluster_kernel",
                              "K3 mfcc": "logmel_fft_kernel"})
    f32_kernels_vs_plain(cfg, s, {k: v[:B_PARITY] for k, v in raw.items()},
                         {k: v[:B_PARITY] for k, v in raw_np.items()}, "(16c) hidden-512")
    del s, raw, lp, picks
    release_cached_memory()

    cfg = train512_config()
    state, batch = train_state(cfg, dev, seed=0)
    train_step = make_train_step(cfg)
    fns = {"K5": lk.bilstm_train_forward, "K6": lk.bilstm_bptt, "K7": bk.bidaf_dropout_forward,
           "K8": bk.bidaf_dropout_backward}
    for fn in fns.values():
        fn.launches = 0
        fn.routes = {r: 0 for r in fn.routes}
    losses, step_s = [], []
    for i in range(TRAIN512_STEPS):
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        check(math.isfinite(loss) and math.isfinite(gnorm), f"(16c) step {i}: loss {loss}, grad norm {gnorm}")
        losses.append(loss)
    launches = {k: fn.launches for k, fn in fns.items()}
    routes = {k: dict(fn.routes) for k, fn in fns.items()}
    t_step = statistics.median(step_s[1:])
    print(f"(16c) hidden-512 training B={B_TRAIN} f32 drop 0.2: launches {launches}, routes {routes}; "
          f"losses {' '.join(f'{x:.5f}' for x in losses)}; median step {t_step * 1e3:.2f} ms over "
          f"{TRAIN512_STEPS - 1} -> {B_TRAIN / t_step:.2f} videos/s on {card}", flush=True)
    check(all(n > 0 for n in launches.values()), f"(16c) a training kernel never launched: {launches}")
    check(routes["K5"] == {"cluster": 0, "l2": launches["K5"]}
          and routes["K6"] == {"cluster": 0, "grid": 4 * TRAIN512_STEPS, "l2": TRAIN512_STEPS},
          f"(16c) K5 left its L2 route, or K6 the grid walk at the four 32-row towers and the L2 "
          f"walk at the word tower, at H=512: {routes}")
    check(losses[-1] < losses[0], f"(16c) the loss did not fall ({losses[0]} -> {losses[-1]})")
    profile_kernels(lambda st: train_step(st, batch)[0], state, t_step, "(16c train)", "step",
                    groups={"K5 l2": "bilstm_kernel", "K6 (a) z": "lstm_z_kernel",
                            "K6 (b) walk l2": "bilstm_bptt_l2_kernel",
                            "K6 (b) walk grid": "bilstm_bptt_cluster_kernel_grid",
                            "K6 (c) dW_h": "lstm_dwh_partial_kernel", "K7/K8": "bidaf_"})
    del state, batch, train_step
    release_cached_memory()
    results = []
    for kernels in (True, False):
        cfg0 = train512_config(drop_prob=0.0, kernels=kernels)
        st, b0 = train_state(cfg0, dev, seed=3)
        st, m = make_train_step(cfg0)(st, b0)
        results.append((float(m["loss"]), float(m["grad_norm"]),
                        {n: p.detach() for n, p in st.params.named_parameters()}))
        del st, b0
    (lk_, gk, pk), (lp_, gp, pp) = results
    dp = max((pk[n] - pp[n]).abs().max().item() for n in pk)
    print(f"(16c) f32 drop 0, one step: loss kernels {lk_:.7f} plain {lp_:.7f}; grad norm {gk:.7f} "
          f"vs {gp:.7f}; max param diff {dp:.3e} (bound {TRAIN_PARITY_ATOL}); phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    check(abs(lk_ - lp_) <= TRAIN_PARITY_ATOL and abs(gk - gp) <= TRAIN_PARITY_ATOL * max(1.0, gp),
          "(16c) kernel and plain loss / grad norm differ")
    check(dp <= TRAIN_PARITY_ATOL, "(16c) kernel and plain parameters differ")
    release_cached_memory()
    return {"K5": routes["K5"]["l2"], "K6": routes["K6"]["l2"], "K6 grid": routes["K6"]["grid"]}


def phase_window4096(dev, card: str) -> int:
    """Phase 16d: the long-audio model with a 4096-point window served at
    B=16 with MFCC (K4 raw + the dB/DCT tail: 4096 frames are past K3's
    whole-example bound) and with log-mel features (K4 log), K4 on its FFT
    route; f32 picks at B=2 equal between the kernels and the plain
    versions. Returns K4's launches."""
    import torch

    from mmbidaf_tpu_torch.data.frontend import make_end_to_end_decode
    from mmbidaf_tpu_torch.ops.cuda import melspec_kernel as mk
    from mmbidaf_tpu_torch.serving import Summarizer

    t_phase = time.perf_counter()
    k3, k4 = mk.mfcc_fused, mk.log_mel_fused
    k3.launches = k4.launches = 0
    k4.routes = {"fft": 0, "dense": 0}
    for features in ("mfcc", "logmel"):
        cfg = window4096_config(features)
        d = cfg.data
        s = Summarizer.init_random(cfg, seed=0, device=dev)
        raw_np = raw_batch(cfg, np.random.default_rng(164), B_LONG)
        raw = {k: torch.from_numpy(v).to(dev) for k, v in raw_np.items()}
        end_to_end = make_end_to_end_decode(cfg)
        n4 = k4.launches
        lp, picks = end_to_end(s.model, s.frontend, raw)
        torch.cuda.synchronize()
        check_decode(lp.cpu().numpy(), picks.cpu().numpy(), raw_np, cfg, f"(16d) {features} bf16")
        t_batch = timed_batches(lambda: end_to_end(s.model, s.frontend, raw), n=3)
        print(f"(16d) {features}, n_fft = win = {d.n_fft}, {d.max_audio_frames} frames, B={B_LONG} "
              f"bf16: median batch {t_batch * 1e3:.2f} ms over 3 -> {B_LONG / t_batch:.3f} videos/s "
              f"on {card}; K4 launches {k4.launches - n4} (routes {k4.routes}), K3 {k3.launches}",
              flush=True)
        check(k4.launches > n4, f"(16d) {features}: K4 never launched")
        f32_kernels_vs_plain(cfg, s, {k: v[:2] for k, v in raw.items()},
                             {k: v[:2] for k, v in raw_np.items()}, f"(16d) {features}")
        del s, raw, lp, picks
        release_cached_memory()
    check(k3.launches == 0, "(16d) K3 ran on 4096 frames (past its whole-example bound)")
    check(k4.routes == {"fft": k4.launches, "dense": 0}, f"(16d) K4 left its FFT route: {k4.routes}")
    print(f"(16d) phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return k4.launches


def phase_16(dev, card: str) -> list[dict]:
    """Phase 16: 16a and 16b, the shape gates of K5/K6 and K4/K3; 16c the
    hidden-512 model; 16d the 4096-point-window model. Returns the new
    routes' records, launches from 16c and 16d."""
    t0 = time.perf_counter()
    rec5, rec6, rec6g = phase_lstm_gate(dev, card)
    rec4 = phase_mel_gate(dev, card)
    release_cached_memory()
    l2 = phase_hidden512(dev, card)
    rec5["launches"], rec6["launches"], rec6g["launches"] = l2["K5"], l2["K6"], l2["K6 grid"]
    rec4["launches"] = phase_window4096(dev, card)
    print(f"(16) phases 16a-16d took {time.perf_counter() - t0:.1f} s on {card}", flush=True)
    return [rec5, rec6, rec6g, rec4]


def build_and_phase_16() -> list[dict]:
    """Phase 16 alone on the card, after the build: ``python -c "import
    chip_smoke; chip_smoke.build_and_phase_16()"`` from the repository root."""
    import torch

    from mmbidaf_tpu_torch.ops.cuda import build

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    build.library()
    return phase_16(torch.device("cuda", 0), card)

def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs the card")
    if sys.argv[1:2] == ["--first-request"]:
        first_request_main(*sys.argv[2:4])
        return
    if sys.argv[1:2] == ["--artifact-decode"]:
        artifact_decode_main(*sys.argv[2:5])
        return
    if sys.argv[1:2] == ["--artifact-first-request"]:
        artifact_first_request_main(*sys.argv[2:5])
        return
    sys.path.insert(0, ROOT)
    from mmbidaf_tpu_torch.ops.cuda import build

    # 1. device. TF32 is off for products (its default) and left at its
    # default, on, for cuDNN: the f32 convs pin full f32 themselves, so every
    # f32 comparison below is held at f32 as a user's process would run it.
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    name = torch.cuda.get_device_name(0)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    print(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}); "
          f"matmul.allow_tf32=False cudnn.allow_tf32={cudnn_tf32} "
          f"(cudnn.conv.fp32_precision={torch.backends.cudnn.conv.fp32_precision})", flush=True)
    check(cudnn_tf32, "cuDNN's TF32 flag is not its default (on)")

    # 2. build
    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s (nvcc, sm_90a)", flush=True)

    # 3. kernels against their plain versions
    cfg = bench_config()
    records = phase_kernels(dev, cfg)
    train_records = phase_train_kernels(dev, cfg)
    long_records = phase_long_kernels(dev)
    epilogue_record = phase_epilogue(dev, cfg)

    # 4. the slice at the bench config
    t_batch = phase_slice(dev, card, cfg, records + [epilogue_record])

    # 5. the training step
    t_step5 = phase_train(dev, card, train_records)

    # 6. long-video serving
    t_long = phase_long(dev, card, long_records)

    # 7. the kernel-parity tool, K10-K14 alone, and Winograd serving
    tool_launches = phase_parity_tool(dev)
    vgg_records = phase_vgg_kernels(dev, tool_launches)
    phase_winograd(dev, card, vgg_records[-1])

    with tempfile.TemporaryDirectory() as corpus_root, tempfile.TemporaryDirectory() as serving_root:
        # 8. the trainer on a real corpus, then the trained run served
        raw_step_s = phase_corpus(dev, card, corpus_root)

        # 9. the serving stack: bucket ladders, warmup, decode modes, the
        # daemon, infer; the host's image decodes counted over it
        from mmbidaf_tpu_torch import native

        native.decode_counts.update(native=0, pil=0)
        tiers, level_dirs = phase_serving(dev, card, records, serving_root)
        decoded = dict(native.decode_counts)

        # 10. the host side: native decode, a reference checkpoint, precomputed
        # features, the Stockham FFT, the tensorboard file
        phase_host(dev, card, records, train_records, corpus_root, raw_step_s, tiers, decoded)

        # 11. frozen serving artifacts: export, a fresh process, the CLIs and the daemon
        with tempfile.TemporaryDirectory() as export_root:
            phase_export(dev, card, export_root, serving_root, tiers, level_dirs, t_batch,
                         records + long_records + vgg_records)

        # 12. the mesh layouts at world size 1 through NCCL
        with tempfile.TemporaryDirectory() as mesh_root:
            t_dp = phase_mesh(dev, card, mesh_root, corpus_root, t_batch, t_step5, t_long,
                              raw_step_s)

        # 13. mesh artifacts, the daemon under a mesh, the device-op profiler
        with tempfile.TemporaryDirectory() as mesh_root:
            phase_mesh_serving(dev, card, mesh_root, tiers, t_batch, t_dp, t_step5,
                               records + train_records + long_records + vgg_records)

    # 14. the capability configs trained on the card, K7/K8's routes, the
    # held-out quality run and the tower ablation
    with tempfile.TemporaryDirectory() as tmp:
        drop_records = phase_14(dev, card, tmp)

    # 15. the drivers of experiments/, the parity demo and the parallel demo
    with tempfile.TemporaryDirectory() as tmp:
        phase_drivers(dev, card, tmp)

    # 16. every shape the JAX kernels take: K5/K6 past the cluster plan, K4/K3
    # past win + bins = 1,815; the hidden-512 and 4096-point-window models
    wide_records = phase_16(dev, card)

    leaked = sorted(m for m in sys.modules if m in ("jax", "mmbidaf_tpu")
                    or m.startswith(("jax.", "jaxlib", "mmbidaf_tpu.")))
    check(not leaked, f"jax or the JAX package was imported: {leaked[:5]}")

    print(card, flush=True)
    print(json.dumps({"kernels": records + [epilogue_record] + train_records + drop_records
                      + long_records + vgg_records + wide_records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
