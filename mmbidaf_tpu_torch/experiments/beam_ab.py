"""A/B: greedy against beam-search serving of whole raw batches at the bench
configuration — the port of ``experiments/beam_ab.py``.

Both arms are ``make_end_to_end_decode`` (frontend, model, decode; K1-K3)
on the same raw batch of ``--batch`` (64) made on the card, greedy and
``mode="beam"`` of width ``--width`` (4). Both run the same kernels; the
first call of each arm (kernel library, plans, cuDNN's choices) is timed
apart as ``compile_s`` and kept out of the median of ``--iters``
synchronised calls.

    python -m mmbidaf_tpu_torch.experiments.beam_ab [--batch 64] [--width 4]
    python -m mmbidaf_tpu_torch.experiments.beam_ab --quick --device cpu --batch 2

Prints one JSON line (videos/s per arm and the beam/greedy ratio) and
returns it.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mmbidaf_tpu_torch import resolve_device


def serving_setup(quick: bool, device):
    """The bench config (``quick``: small shapes, tiny VGG), its VGG spec,
    random weights from seeds 0 (model) and 1 (frontend, cast to the
    compute dtype once)."""
    from mmbidaf_tpu_torch.data.frontend import cast_vgg_weights, frontend_init
    from mmbidaf_tpu_torch.data.synthetic import random_word_vectors
    from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_init
    from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC, VGG16_SPEC
    from mmbidaf_tpu_torch.utils.bench_config import build_bench_config

    cfg = build_bench_config(quick)
    spec = TINY_SPEC if quick else VGG16_SPEC
    wv = random_word_vectors(np.random.default_rng(0), cfg.data.vocab_size, cfg.model.emb_dim)
    model = mmbidaf_init(cfg, wv, device, seed=0)
    fe = cast_vgg_weights(frontend_init(cfg, spec, device, seed=1), cfg.model.compute_dtype)
    return cfg, spec, model, fe


def time_arm(fn, batch: int, iters: int) -> tuple[dict, float]:
    """The first call's seconds, then the median of ``iters`` synchronised
    calls → the arm's JSON fields and its unrounded batch seconds."""
    from mmbidaf_tpu_torch.utils.profiling import timeit

    first = timeit(fn, iters=1, warmup=0)["p50_s"]
    per_batch = timeit(fn, iters=iters, warmup=1)["p50_s"]
    return {"videos_per_sec_per_chip": batch / per_batch, "p50_batch_latency_s": per_batch,
            "compile_s": first}, per_batch


def main(argv=None) -> dict:
    from mmbidaf_tpu_torch.data.frontend import make_end_to_end_decode
    from mmbidaf_tpu_torch.utils.bench_config import make_raw_batch_on_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--width", type=int, default=4, help="beam width")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--quick", action="store_true", help="small shapes (the CPU)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg, spec, model, fe = serving_setup(args.quick, dev)
    raw = make_raw_batch_on_device(cfg, args.batch, dev)
    arms, secs = {}, {}
    for mode in ("greedy", "beam"):
        prog = make_end_to_end_decode(cfg, spec, mode=mode, topk=args.width)
        arms[mode], secs[mode] = time_arm(lambda: prog(model, fe, raw), args.batch, args.iters)
    out = {
        "experiment": "beam_ab",
        "batch_size": args.batch,
        "beam_width": args.width,
        "backend": dev.type,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        **{f"{k}_{m}": v for m, a in arms.items() for k, v in a.items()},
        "beam_over_greedy": secs["beam"] / secs["greedy"],
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
