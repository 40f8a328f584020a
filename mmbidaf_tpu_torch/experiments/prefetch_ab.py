"""A/B: the serial training loop against the loop fed by
``data/prefetch.py::DevicePrefetcher`` — the port of
``experiments/prefetch_ab.py``, both arms in one process.

  arm A (serial):   next(stream) -> upload -> train_step
  arm B (prefetch): DevicePrefetcher(depth) collates and uploads in a thread
                    (pinned memory, a side stream) under the current step,
                    as ``train.cli --prefetch N`` does

Both arms run ``--steps`` steps of ``train/loop.py::make_train_step`` on
the same synthetic feature stream (``data/synthetic.py::batch_stream``) at
the bench widths in f32 with adadelta (``--pallas``: through K5-K8), after
two warm-up steps, and wait for the card once, at the end of the window, so
the difference is what the thread hides: the host's batch generation and
its upload. The serial arm runs twice, before and after the prefetch arm,
and the better of its two windows counts.

    python -m mmbidaf_tpu_torch.experiments.prefetch_ab [--steps 40] [--depth 2] [--pallas]
    python -m mmbidaf_tpu_torch.experiments.prefetch_ab --quick --device cpu --steps 3 --batch 4

Prints one JSON line and returns it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from mmbidaf_tpu_torch import resolve_device


def main(argv=None) -> dict:
    from mmbidaf_tpu_torch.data.prefetch import DevicePrefetcher, InFlight, batch_uploader
    from mmbidaf_tpu_torch.data.synthetic import batch_stream, random_word_vectors
    from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_init
    from mmbidaf_tpu_torch.train.loop import init_train_state, make_train_step
    from mmbidaf_tpu_torch.utils.bench_config import build_bench_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=40, help="measured steps per arm")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--depth", type=int, default=2, help="prefetch depth (arm B)")
    ap.add_argument("--quick", action="store_true", help="small shapes (the CPU)")
    ap.add_argument("--pallas", action="store_true", help="the hand kernels K5-K8")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    cfg = build_bench_config(a.quick)
    cfg = dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, compute_dtype="float32",
                                  use_pallas_attention=a.pallas, use_pallas_lstm=a.pallas),
        train=dataclasses.replace(cfg.train, batch_size=a.batch, optimizer="adadelta"))
    rng = np.random.default_rng(0)
    wv = random_word_vectors(rng, cfg.data.vocab_size, cfg.model.emb_dim)
    state = init_train_state(mmbidaf_init(cfg, wv, dev, seed=0), cfg, seed=1)
    train_step = make_train_step(cfg)
    upload = batch_uploader(dev)

    def to_device(nb):
        out = upload(nb)
        return out.claim() if isinstance(out, InFlight) else out

    nbytes = sum(v.nbytes for v in next(batch_stream(0, cfg, a.batch)).values())
    t0 = time.perf_counter()
    state, metrics = train_step(state, to_device(next(batch_stream(99, cfg, a.batch))))
    float(metrics["loss"])
    compile_s = time.perf_counter() - t0

    def run_arm(depth: int) -> float:
        """Wall seconds of ``a.steps`` steps, one wait for the card at the end."""
        nonlocal state
        stream = batch_stream(7, cfg, a.batch)  # the same data both arms
        pf = DevicePrefetcher(stream, upload, depth=depth) if depth > 0 else None
        try:
            def step():
                nonlocal state
                batch = next(pf)[1] if pf else to_device(next(stream))
                state, m = train_step(state, batch)
                return m

            for _ in range(2):  # the prefetch queue fills; first-call jitter
                m = step()
            float(m["loss"])
            t0 = time.perf_counter()
            for _ in range(a.steps):
                m = step()
            float(m["loss"])  # the window's one wait for the card
            return time.perf_counter() - t0
        finally:
            if pf is not None:
                pf.close()

    serial_s = run_arm(0)
    pipelined_s = run_arm(a.depth)
    serial2_s = run_arm(0)  # a second serial window guards against drift
    serial_best = min(serial_s, serial2_s)
    out = {
        "metric": "prefetch_speedup",
        "value": serial_best / pipelined_s,
        "unit": "x (serial/pipelined wall time)",
        "steps": a.steps,
        "batch_size": a.batch,
        "depth": a.depth,
        "pallas": a.pallas,
        "host_mb_per_batch": nbytes / 1e6,
        "serial_steps_per_s": a.steps / serial_best,
        "pipelined_steps_per_s": a.steps / pipelined_s,
        "serial_s": [serial_s, serial2_s],
        "pipelined_s": pipelined_s,
        "compile_s": compile_s,
        "backend": dev.type,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
