"""A/B: serving a batch of short videos at the config's caps against the
same batch trimmed to its bucket rung — the port of
``experiments/bucket_ab.py``.

Every video of a raw batch of ``--batch`` (64) made on the card uses only
``--frac`` (0.25) of each ragged axis (prefix masks at the true lengths).
The full arm runs the batch at the caps; the bucketed arm first takes the
trim ``Summarizer(serve_buckets=True)`` applies to each batch
(``serving.trim_raw_to_rungs`` at the ``covering_rungs`` of
``serving_bucket_ladders``: each axis cut to the smallest rung covering its
true length). Both arms run
``make_end_to_end_decode`` (K1-K3); the first call of each (a new shape's
kernel plans, cuDNN's choices) is timed apart as ``compile_s`` and kept out
of the median of ``--iters`` synchronised calls. The greedy picks of the
two arms are compared and their mismatches counted (bf16 near-ties on
random weights may flip a pick; the CPU parity tests own correctness).

    python -m mmbidaf_tpu_torch.experiments.bucket_ab [--batch 64] [--frac 0.25]
    python -m mmbidaf_tpu_torch.experiments.bucket_ab --quick --device cpu --batch 2

Prints one JSON line (videos/s per arm and the speedup) and returns it.
"""

from __future__ import annotations

import argparse
import json

import torch

from mmbidaf_tpu_torch import resolve_device
from mmbidaf_tpu_torch.experiments.beam_ab import serving_setup, time_arm


def ragged_raw(raw: dict, cfg, frac: float) -> dict:
    """``raw`` with prefix masks at ``frac`` of each axis (at least 1)."""
    d = cfg.data
    dev = raw["sent_mask"].device
    true = {"sentences": max(int(d.max_sentences * frac), 1),
            "words": max(int(d.max_words * frac), 1),
            "keyframes": max(int(d.max_keyframes * frac), 1),
            "audio_frames": max(int(d.max_audio_frames * frac), 1)}

    def prefix(n, cap):
        return (torch.arange(cap, device=dev) < n).float()

    out = dict(raw)
    out["sent_mask"] = prefix(true["sentences"], d.max_sentences)[None, :] * raw["sent_mask"]
    out["word_mask"] = (prefix(true["words"], d.max_words)[None, None, :]
                        * out["sent_mask"][:, :, None])
    out["img_mask"] = prefix(true["keyframes"], d.max_keyframes)[None, :] * raw["img_mask"]
    out["aud_mask"] = prefix(true["audio_frames"], d.max_audio_frames)[None, :] * raw["aud_mask"]
    return out


def main(argv=None) -> dict:
    from mmbidaf_tpu_torch.data.frontend import make_end_to_end_decode
    from mmbidaf_tpu_torch.serving import (batch_true_lengths, covering_rungs,
                                           serving_bucket_ladders, trim_raw_to_rungs)
    from mmbidaf_tpu_torch.utils.bench_config import make_raw_batch_on_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--frac", type=float, default=0.25,
                    help="true length per axis as a fraction of the cap")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--quick", action="store_true", help="small shapes (the CPU)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg, spec, model, fe = serving_setup(args.quick, dev)
    raw = ragged_raw(make_raw_batch_on_device(cfg, args.batch, dev), cfg, args.frac)
    ladders = serving_bucket_ladders(cfg, True)
    rungs = covering_rungs(batch_true_lengths(raw), ladders)
    trimmed = trim_raw_to_rungs(raw, cfg, rungs)
    prog = make_end_to_end_decode(cfg, spec)
    arms, secs, picks = {}, {}, {}
    for name, inputs in (("full", raw), ("bucketed", trimmed)):
        arms[name], secs[name] = time_arm(lambda: prog(model, fe, inputs), args.batch, args.iters)
        picks[name] = prog(model, fe, inputs)[1].cpu()
    out = {
        "experiment": "bucket_ab",
        "batch_size": args.batch,
        "true_frac": args.frac,
        "rungs": rungs,
        "backend": dev.type,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        **{f"{k}_{m}": v for m, a in arms.items() for k, v in a.items()},
        "bucketed_speedup": secs["full"] / secs["bucketed"],
        "picks_mismatched": int((picks["full"] != picks["bucketed"]).sum()),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
