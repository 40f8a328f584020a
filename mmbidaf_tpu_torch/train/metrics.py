"""Metrics utilities: running means, JSONL logging, ROUGE evaluation — the
port's copy of ``mmbidaf_tpu.train.metrics`` (without its TensorFlow writer).

Replaces the reference's ``AverageMeter`` + tensorboard scalars (SURVEY.md
§6) with the same scalar names, logged as JSONL (tensorboard optional).
ROUGE stays host-side, as in the reference eval path (SURVEY §4.3).
"""

from __future__ import annotations

import json
import time
from typing import IO, Mapping


class AverageMeter:
    """Running mean, same contract as the reference's util.AverageMeter."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, num_samples: int = 1):
        self.count += num_samples
        self.sum += val * num_samples
        self.avg = self.sum / self.count


class JsonlLogger:
    def __init__(self, path: str):
        self._f: IO = open(path, "a")

    def log(self, step: int, scalars: Mapping[str, float]) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


def rouge_scores(summary: str, reference: str) -> dict[str, float]:
    """ROUGE-1/2/L F-measure, host-side like the reference: the JAX
    package's ``rouge_score`` scorer (Porter-stemmed tokens), computed by the
    port's own ``train/rouge.py``."""
    from mmbidaf_tpu_torch.train.rouge import rouge_f

    return rouge_f(summary, reference)


def summary_from_picks(picks, sentences: list[str]) -> str:
    """Assemble the extractive summary: ordered selected-sentence subset."""
    seen = []
    for i in picks:
        i = int(i)
        if 0 <= i < len(sentences) and i not in seen:
            seen.append(i)
    return " ".join(sentences[i] for i in sorted(seen))


def batch_rouge(
    picks, sentences_list: list[list[str]], golds: list[str | None]
) -> tuple[dict[str, float], int]:
    """Average ROUGE over a batch of decoded sentence-index picks.

    ``picks[b]`` are the decode-step indices for example b,
    ``sentences_list[b]`` its REAL transcript sentences, ``golds[b]`` its
    gold summary text (examples with no gold are skipped). Returns
    (mean scores, number of scored examples). This is the reference's eval
    metric (SURVEY.md §4.3): the hypothesis is assembled from on-disk
    transcript text, not fabricated strings.
    """
    agg = {"ROUGE-1": 0.0, "ROUGE-2": 0.0, "ROUGE-L": 0.0}
    n = 0
    for b in range(min(len(sentences_list), len(golds))):
        if golds[b] is None or not sentences_list[b]:
            continue
        hyp = summary_from_picks(picks[b], sentences_list[b])
        for k, v in rouge_scores(hyp, golds[b]).items():
            agg[k] += v
        n += 1
    return {k: v / max(n, 1) for k, v in agg.items()}, n

