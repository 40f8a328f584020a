"""Corpus-derived bucket ladders as JSON, the ``--bucket_ladders`` format of
``tools/serve.py`` and ``infer`` — the counterpart of the repository's
``tools/suggest_buckets.py``.

One rung per length quantile of the training corpus
(``data.pipeline.suggest_buckets``; audio rungs aligned to 8 frames and to
the config's sequence axis), so serving and its acceptance test use the
same rung set::

    python -m mmbidaf_tpu_torch.tools.suggest_buckets --data_dir corpus/ > ladders.json
    python -m mmbidaf_tpu_torch.tools.serve --run_dir runs/x --bucket_serving \\
        --bucket_ladders ladders.json
    python -m mmbidaf_tpu_torch.infer --data_dir corpus/ --bucket_eval \\
        --bucket_ladders ladders.json ...

A sweep of the assets' headers on the host (lengths cached per example); it
touches no device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Emit corpus-derived bucket ladders as JSON for serve/infer --bucket_ladders")
    ap.add_argument("--data_dir", required=True, help="corpus root (video dirs with transcripts/media)")
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--run_dir", help="a train.cli run dir: use its saved config's caps")
    src.add_argument("--config_json", help="full Config overlay (JSON)")
    ap.add_argument("--num_seq", type=int, default=None,
                    help="sequence-axis size to align audio rungs to (default: the config's)")
    ap.add_argument("--quantiles", default="0.5,0.8,1.0",
                    help="length quantiles, one rung each (default p50/p80/max)")
    ap.add_argument("--out", default=None, metavar="FILE.json", help="write here, not to stdout")
    a = ap.parse_args(argv)

    from mmbidaf_tpu_torch.config import Config, config_from_json
    from mmbidaf_tpu_torch.data.pipeline import VideoCorpus, suggest_buckets

    if a.run_dir:
        from mmbidaf_tpu_torch.train.checkpoint import load_config

        cfg = load_config(a.run_dir)
    elif a.config_json:
        cfg = config_from_json(a.config_json)
    else:
        cfg = Config()
    try:
        quantiles = tuple(float(q) for q in a.quantiles.split(","))
    except ValueError:
        ap.error(f"--quantiles wants comma-separated floats, got {a.quantiles!r}")
    if not all(0.0 < q <= 1.0 for q in quantiles):
        ap.error(f"--quantiles must lie in (0, 1], got {quantiles}")

    # a split corpus derives its ladders from the training split
    data_dir = a.data_dir
    if os.path.isdir(os.path.join(data_dir, "train")):
        data_dir = os.path.join(data_dir, "train")
    corpus = VideoCorpus(data_dir, cfg, {}, use_precomputed=True)  # lengths need no vocab
    sug = suggest_buckets(corpus, num_seq=a.num_seq if a.num_seq is not None else cfg.mesh.num_seq,
                          quantiles=quantiles)
    text = json.dumps({k: list(v) for k, v in sug.items()}, indent=1)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text + "\n")
        print(f"wrote {a.out} ({len(corpus)} videos swept)", file=sys.stderr)
    else:
        print(text)


if __name__ == "__main__":
    main()
