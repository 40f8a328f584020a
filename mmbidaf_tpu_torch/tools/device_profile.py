"""Profiling CLI: trace serving batches or train steps, print the device-op
table — the port's counterpart of the repository's ``tools/profile.py``.

    # the serving program at the bench shapes (B=64, bf16, kernels on):
    python -m mmbidaf_tpu_torch.tools.device_profile --mode serve --steps 5
    # the training step with the hand kernels (K5-K8):
    python -m mmbidaf_tpu_torch.tools.device_profile --mode train --kernels
    # small shapes on the CPU:
    python -m mmbidaf_tpu_torch.tools.device_profile --quick --device cpu

Serve mode runs ``build_bench_config``'s program (``make_end_to_end_decode``
on a raw batch made on the device); train mode the train step on one
synthetic feature batch, in f32 (``--kernels``: through K5-K8). The kernel
build, cuDNN's choices and the profiler's own start-up happen on warm-up
calls BEFORE the trace, so the table holds steady-state ops only. On the
card the table is the device's kernels by device time; on the CPU, the aten
operations by self CPU time. Rows that are one of the port's hand kernels
carry its number (K1-K3 serve, K5-K8 train). The step is timed unprofiled
(``utils.profiling.timeit``); the summary gives the device's idle share of
it and the achieved rate of ``utils.flops``' count, with the MFU against
``peak_bf16_tflops`` for a bf16 program on a card it knows. ``--trace_dir`` keeps the
Chrome trace (``trace.json``). The module is not named ``profile``: that
name would shadow the standard library's, which ``torch._dynamo`` imports.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile

import numpy as np
import torch

# Device kernels of the port's hand kernels, by the substrings of their CUDA
# symbols (``csrc/*.cu``), for each mode's program.
KERNEL_GROUPS = {
    "serve": {
        "K1 bilstm": ("bilstm_cluster_kernel", "bilstm_kernel<"),
        "K2 bidaf": ("bidaf_fwd_cluster_kernel", "bidaf_tiled_cluster_kernel"),
        "K3 mfcc": ("logmel_fft_kernel", "logmel_tile_kernel", "mfcc_dct_kernel"),
    },
    "train": {
        "K5 bilstm forward": ("bilstm_cluster_kernel",),
        "K6 bilstm backward": ("lstm_z_kernel", "bilstm_bptt_cluster_kernel",
                               "lstm_dwh_partial_kernel", "sum_partials_kernel"),
        "K7 bidaf forward": ("bidaf_drop_fwd_cluster_kernel",),
        "K8 bidaf backward": ("bidaf_drop_bwd_cluster_kernel", "sum_over_batch_kernel"),
    },
}


def kernel_of(name: str, groups: dict) -> str | None:
    """The group ``name`` belongs to (the first whose substrings it holds)."""
    for label, subs in groups.items():
        if any(s in name for s in subs):
            return label
    return None


def profile_ops(fn, carry, steps: int, trace_dir: str | None = None, on_card: bool | None = None):
    """``carry = fn(carry)`` ``steps`` times under ``torch.profiler``, after
    one unprofiled call and, on the card, one profiled call that pays the
    profiler's start-up. Returns ``(rows, total_ms, carry)``: one row a
    device kernel (on the CPU: a CPU operation), ``ms`` its time a step,
    ``calls`` its launches a step, ``pct`` its share of ``total_ms``, the
    time of all of them a step; busiest first. ``on_card`` defaults to
    whether a card is there."""
    from torch.autograd import DeviceType
    from torch.profiler import profile

    from mmbidaf_tpu_torch.utils.profiling import profiler_activities, trace

    if on_card is None:
        on_card = torch.cuda.is_available()
    carry = fn(carry)
    _sync()
    if on_card:
        with profile(activities=profiler_activities()):
            carry = fn(carry)
            _sync()
    with trace(trace_dir or tempfile.mkdtemp(prefix="mmb_profile_")) as prof:
        for _ in range(steps):
            carry = fn(carry)
        _sync()
    events = prof.key_averages()
    if on_card:
        picked = [(e.key, e.self_device_time_total, e.count) for e in events
                  if e.device_type == DeviceType.CUDA]
    else:
        picked = [(e.key, e.self_cpu_time_total, e.count) for e in events
                  if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0]
    total = sum(t for _, t, _ in picked) / steps / 1e3
    rows = [{"name": k, "ms": t / steps / 1e3, "calls": c / steps,
             "pct": 100.0 * t / steps / 1e3 / total if total else 0.0} for k, t, c in picked]
    rows.sort(key=lambda r: -r["ms"])
    return rows, total, carry


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def group_ms(rows: list[dict], groups: dict) -> dict:
    """Time a step of the rows whose names hold any of each group's
    substrings (each group on its own)."""
    return {label: sum(r["ms"] for r in rows if any(s in r["name"] for s in subs))
            for label, subs in groups.items()}


def serve_step(cfg, batch: int, vgg_spec, device):
    """The serving program at ``cfg`` on a raw batch made on the device,
    random weights from seed 0: ``step(carry) -> (log_p, picks)``."""
    from mmbidaf_tpu_torch.data.frontend import (cast_vgg_weights, frontend_init,
                                                 make_end_to_end_decode)
    from mmbidaf_tpu_torch.data.synthetic import random_word_vectors
    from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_init
    from mmbidaf_tpu_torch.utils.bench_config import make_raw_batch_on_device

    wv = random_word_vectors(np.random.default_rng(0), cfg.data.vocab_size, cfg.model.emb_dim)
    model = mmbidaf_init(cfg, wv, device, seed=0)
    fe = cast_vgg_weights(frontend_init(cfg, vgg_spec, device, seed=1), cfg.model.compute_dtype)
    raw = make_raw_batch_on_device(cfg, batch, device)
    end_to_end = make_end_to_end_decode(cfg, vgg_spec)

    def step(carry):
        return end_to_end(model, fe, raw)

    return step, None


def train_step(cfg, batch: int, device):
    """The train step at ``cfg`` on one synthetic feature batch, random
    weights from seed 0: ``step(state) -> state``; also the parameter count."""
    from mmbidaf_tpu_torch.data.synthetic import random_word_vectors, synthetic_batch
    from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_init
    from mmbidaf_tpu_torch.train.loop import init_train_state, make_train_step

    rng = np.random.default_rng(0)
    wv = random_word_vectors(rng, cfg.data.vocab_size, cfg.model.emb_dim)
    model = mmbidaf_init(cfg, wv, device, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    state = init_train_state(model, cfg, seed=1)
    data = {k: torch.from_numpy(v).to(device)
            for k, v in synthetic_batch(rng, cfg, batch_size=batch).items()}
    inner = make_train_step(cfg)

    def step(st):
        return inner(st, data)[0]

    return step, state, n_params


def run(mode: str = "serve", quick: bool = False, batch: int | None = None, steps: int = 5,
        kernels: bool = False, trace_dir: str | None = None, device="cuda") -> dict:
    """Build the mode's program, time it, trace it; returns the summary with
    every row (``rows``) and each hand kernel's time a step (``kernels``)."""
    from mmbidaf_tpu_torch import resolve_device
    from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC, VGG16_SPEC
    from mmbidaf_tpu_torch.utils.bench_config import build_bench_config
    from mmbidaf_tpu_torch.utils.flops import (e2e_decode_flops_per_video, peak_bf16_tflops,
                                               train_step_flops)
    from mmbidaf_tpu_torch.utils.profiling import timeit

    dev = resolve_device(device)
    cfg = build_bench_config(quick)
    vgg_spec = TINY_SPEC if quick else VGG16_SPEC
    if mode == "train":
        # bench_train.py's program: f32, the kernels through --kernels
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype="float32", use_pallas_attention=kernels,
            use_pallas_lstm=kernels))
        batch = batch or (8 if quick else 32)
        step, carry, n_params = train_step(cfg, batch, dev)
        flops = train_step_flops(cfg, batch, n_params)
    elif mode == "serve":
        if kernels:
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, use_pallas_attention=True, use_pallas_lstm=True,
                use_pallas_melspec=True))
        batch = batch or (8 if quick else 64)
        step, carry = serve_step(cfg, batch, vgg_spec, dev)
        flops = e2e_decode_flops_per_video(cfg, vgg_spec) * batch
    else:
        raise ValueError(f"unknown mode {mode!r}: expected 'serve' or 'train'")
    state = {"carry": carry}

    def once():
        state["carry"] = step(state["carry"])
        return state["carry"]

    timed = timeit(once, iters=steps, warmup=1)
    rows, total_ms, state["carry"] = profile_ops(step, state["carry"], steps, trace_dir,
                                                 on_card=dev.type == "cuda")
    groups = KERNEL_GROUPS[mode]
    for r in rows:
        r["kernel"] = kernel_of(r["name"], groups)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    # the bf16 peak is the denominator of a bf16 program only
    peak = peak_bf16_tflops(name) if cfg.model.compute_dtype == "bfloat16" else None
    rate = flops / timed["p50_s"] / 1e12
    return {
        "mode": mode, "batch": batch, "steps": steps, "device": name,
        "compute_dtype": cfg.model.compute_dtype, "step_s": timed["p50_s"],
        "op_ms": total_ms, "idle": max(0.0, 1.0 - total_ms / (timed["p50_s"] * 1e3))
        if dev.type == "cuda" else None,
        "flops": flops, "tflops": rate, "peak_bf16_tflops": peak,
        "mfu": rate / peak if peak else None,
        "kernels": group_ms(rows, groups), "rows": rows,
    }


def format_table(res: dict, top: int = 20) -> list[str]:
    """The summary line, the top ``top`` rows, and each hand kernel's time."""
    unit = "device kernels" if res["idle"] is not None else "CPU operations"
    lines = [f"# {res['mode']} x{res['steps']} steps, batch {res['batch']}, "
             f"{res['compute_dtype']}, {res['device']}: step {res['step_s'] * 1e3:.2f} ms, "
             f"{unit} {res['op_ms']:.2f} ms a step"
             + (f", device idle {res['idle']:.1%}" if res["idle"] is not None else "")
             + f"; {res['tflops']:.2f} TFLOP/s of {res['flops'] / 1e9:.1f} GFLOP a step"
             + (f", MFU {res['mfu']:.2%} of {res['peak_bf16_tflops']} bf16 TFLOP/s"
                if res["mfu"] is not None else "")]
    lines.append(f"{'op':<64} {'ms/step':>10} {'calls':>7} {'pct':>6}  kernel")
    for r in res["rows"][:top]:
        lines.append(f"{r['name'][:64]:<64} {r['ms']:>10.3f} {r['calls']:>7.1f} "
                     f"{r['pct']:>5.1f}%  {r['kernel'] or ''}")
    for label, ms in res["kernels"].items():
        lines.append(f"{label}: {ms:.3f} ms a step")
    return lines


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="serve", choices=["serve", "train"])
    ap.add_argument("--quick", action="store_true", help="small shapes (CPU-friendly)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--steps", type=int, default=5,
                    help="traced steady-state steps (warm-up calls stay outside)")
    ap.add_argument("--top", type=int, default=20, help="table rows")
    ap.add_argument("--json", action="store_true",
                    help="one JSON line per op, then the summary, instead of the table")
    ap.add_argument("--trace_dir", default=None,
                    help="keep the Chrome trace here (default: a fresh temp dir)")
    ap.add_argument("--kernels", action="store_true",
                    help="run the hand kernels (the serving config has them on; train mode "
                         "and --quick run the plain paths without this flag)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    res = run(a.mode, a.quick, a.batch, a.steps, a.kernels, a.trace_dir, a.device)
    if a.json:
        for r in res["rows"][:a.top]:
            print(json.dumps(r))
        print(json.dumps({"summary": {k: v for k, v in res.items() if k != "rows"}}))
    else:
        print("\n".join(format_table(res, a.top)), flush=True)
    return res


if __name__ == "__main__":
    main()
