"""Quickstart of the port: the whole user journey in one script, the port of
``examples/quickstart.py``.

    python -m mmbidaf_tpu_torch.examples.quickstart               # the card
    python -m mmbidaf_tpu_torch.examples.quickstart --device cpu  # the CPU

1. writes a small synthetic video corpus (frames, audio, transcripts, gold
   summaries) with ``mmbidaf_tpu_torch.examples.make_synthetic_corpus``;
2. trains a tiny trimodal model on it (``mmbidaf_tpu_torch.train.cli``);
3. evaluates ROUGE against the gold summaries (``mmbidaf_tpu_torch.infer``);
4. loads the run into the serving API (``Summarizer.from_run``) and
   summarizes a video, once whole and once through the windowed decoder
   (``summarize_long``).

Each stage is the command a user would type; the script ends with
``quickstart OK``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(cmd: list[str]) -> str:
    """Run one stage from the repository root; its output, or exit with the
    end of its errors."""
    print("+", " ".join(cmd), flush=True)
    res = subprocess.run(cmd, cwd=REPO, text=True, capture_output=True)
    if res.returncode != 0:
        sys.stderr.write(res.stdout[-2000:] + res.stderr[-4000:])
        raise SystemExit(f"step failed: {' '.join(cmd)}")
    return res.stdout


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="corpus -> train -> eval -> serve, end to end")
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "mmbidaf_torch_quickstart"))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    corpus = os.path.join(a.workdir, "corpus")
    rundir = os.path.join(a.workdir, "runs")
    py = sys.executable

    # 1. synthetic corpus (8 videos, ragged lengths)
    run([py, "-m", "mmbidaf_tpu_torch.examples.make_synthetic_corpus", "--out", corpus,
         "--videos", "8", "--sentences", "12", "--frames", "6", "--seconds", "2", "--ragged"])

    # 2. train a tiny trimodal model on it
    out = run([py, "-m", "mmbidaf_tpu_torch.train.cli", "--data_dir", corpus, "--vgg", "tiny",
               "--config_json", "examples/tiny_config.json", "--num_steps", str(a.steps),
               "--save_dir", rundir, "--device", a.device])
    lines = out.splitlines()
    print(lines[-2] if len(lines) > 1 else out.strip())

    # 3. evaluate: decode every video, ROUGE against the gold summaries (the
    #    frontend's VGG variant comes from the run's saved config)
    out = run([py, "-m", "mmbidaf_tpu_torch.infer", "--data_dir", corpus,
               "--load_dir", os.path.join(rundir, "mmbidaf", "ckpts"), "--print_summaries",
               "--device", a.device])
    print(out.strip().splitlines()[-1])

    # 4. the serving API, from the run directory (config, vocabulary and
    #    checkpoint are all saved by the trainer; the seed makes the
    #    frontend the trainer's)
    from mmbidaf_tpu_torch.serving import Summarizer
    from mmbidaf_tpu_torch.train.checkpoint import load_config

    run_dir = os.path.join(rundir, "mmbidaf")
    s = Summarizer.from_run(run_dir, seed=load_config(run_dir).train.seed, device=a.device)
    video0 = os.path.join(corpus, sorted(os.listdir(corpus))[0])
    print("summarize:", s.summarize(video0))
    print("summarize_long:", s.summarize_long(video0))
    print("quickstart OK")


if __name__ == "__main__":
    main()
