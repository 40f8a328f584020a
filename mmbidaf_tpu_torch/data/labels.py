"""Gold extractive-label derivation — the port's copy of
``mmbidaf_tpu.data.labels`` (SURVEY.md §1 "Training objective"): match the
dataset's abstractive summary to transcript sentences by ROUGE overlap,
greedily, producing the K gold sentence indices the NLL targets.
"""

from __future__ import annotations

import numpy as np


def _lcs_len(a: list[str], b: list[str]) -> int:
    """Longest-common-subsequence length (ROUGE-L core), O(len(a)*len(b))."""
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b):
            cur.append(prev[j] + 1 if x == y else max(prev[j + 1], cur[-1]))
        prev = cur
    return prev[-1]


def rouge_l_f(candidate: list[str], reference: list[str]) -> float:
    lcs = _lcs_len(candidate, reference)
    if lcs == 0:
        return 0.0
    p = lcs / len(candidate)
    r = lcs / len(reference)
    return 2 * p * r / (p + r)


def rouge_1_f(candidate: list[str], reference: list[str]) -> float:
    """Unigram-overlap F1 with clipped counts (ROUGE-1)."""
    if not candidate or not reference:
        return 0.0
    from collections import Counter

    cand, ref = Counter(candidate), Counter(reference)
    overlap = sum(min(c, ref[w]) for w, c in cand.items())
    if overlap == 0:
        return 0.0
    p = overlap / len(candidate)
    r = overlap / len(reference)
    return 2 * p * r / (p + r)


def _set_score(selected: list[int], sentences: list[list[str]], summary: list[str]) -> float:
    """Score a selected set: sentences concatenated in TRANSCRIPT order
    (extractive summaries preserve source order), mean of ROUGE-1 and
    ROUGE-L F — the standard greedy-oracle recipe for extractive labels."""
    cand: list[str] = []
    for i in sorted(selected):
        cand += sentences[i]
    return 0.5 * (rouge_1_f(cand, summary) + rouge_l_f(cand, summary))


def greedy_extractive_labels(
    sentences: list[list[str]],
    summary_tokens: list[str],
    k: int,
) -> list[int]:
    """Greedy selection: at each step add the sentence that most improves
    the ROUGE score of the selected set against the abstractive summary.

    Returns exactly ``k`` indices (padded by repeating the best index if the
    transcript has fewer useful sentences — callers mask those steps).
    """
    selected: list[int] = []
    for _ in range(min(k, len(sentences))):
        best_idx, best_score = -1, -1.0
        for i, sent in enumerate(sentences):
            if i in selected or not sent:
                continue
            score = _set_score(selected + [i], sentences, summary_tokens)
            if score > best_score:
                best_idx, best_score = i, score
        if best_idx < 0:
            break
        selected.append(best_idx)
    if not selected:
        selected = [0]
    while len(selected) < k:
        selected.append(selected[-1])
    return selected[:k]


def make_targets(
    sentences: list[list[str]],
    summary_tokens: list[str],
    k: int,
) -> tuple[np.ndarray, np.ndarray]:
    """→ (targets [k] int32, target_mask [k] f32)."""
    n_useful = sum(1 for s in sentences if s)
    idxs = greedy_extractive_labels(sentences, summary_tokens, k)
    mask = (np.arange(k) < max(min(n_useful, k), 1)).astype(np.float32)
    return np.asarray(idxs, np.int32), mask
