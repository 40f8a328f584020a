"""Benchmark-corpus adapters: TVSum / SumMe annotation formats → gold
summaries in the VideoCorpus layout (SURVEY.md §1 "do not hard-code a
dataset assumption; the rebuild's data layer must be corpus-agnostic" —
these are the concrete adapters for the two public video-summarization
benchmarks the reference's problem setting targets).

Both datasets annotate *per-frame importance*, not text summaries:

    TVSum  ``ydata-tvsum50-anno.tsv``   rows: video_id <TAB> category <TAB>
           comma-separated per-frame scores (1-5), one row per annotator
           (20 per video).  The MATLAB bundle ``ydata-tvsum50.mat`` is
           HDF5/v7.3 with a ``tvsum50`` struct (video, user_anno, gt_score).
    SumMe  ``GT/<VideoName>.mat``       MATLAB v5 per video: ``gt_score``
           [nframes] mean importance, ``user_score`` [nframes, n_users]
           binary selections, scalar ``FPS``.

MMBiDAF selects transcript *sentences*, so the adapter bridges frame
importance to text: given the video's subtitle cues (SRT/VTT sidecars —
e.g. YouTube auto-captions; the datasets themselves ship none), each cue
is scored by the mean importance of the frames inside its time span, and
the gold summary is the highest-scoring cues within a duration budget
(the benchmarks' standard 15% keyshot budget), emitted in transcript
order as ``summary.txt``.  Downstream, ``data/labels.py`` recovers the
gold sentence indices from that text exactly as for any other corpus.

The port's copy of ``mmbidaf_tpu.data.benchmarks``: numpy only, its lazy imports
as there.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "load_tvsum_anno_tsv",
    "load_tvsum_mat",
    "load_summe_gt",
    "cue_importance",
    "select_summary_cues",
    "summary_from_importance",
    "sentence_spans",
    "keyshot_f1",
    "keyshot_from_files",
]


def load_tvsum_anno_tsv(path: str) -> dict[str, np.ndarray]:
    """TVSum ``*-anno.tsv`` → ``{video_id: mean importance [nframes] f32}``.

    Rows for the same video (one per annotator) are averaged; annotators
    occasionally disagree on frame count by a few frames (a known artifact
    of the distribution), so rows are truncated to the shortest.
    """
    per_video: dict[str, list[np.ndarray]] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split("\t")
            if len(parts) < 3:
                raise ValueError(f"malformed TVSum anno row: {line[:80]!r}")
            vid, scores = parts[0], parts[-1]
            row = np.asarray(
                [float(x) for x in scores.split(",") if x.strip()], np.float32
            )
            if row.size == 0:
                raise ValueError(f"empty score row for video {vid!r}")
            per_video.setdefault(vid, []).append(row)
    out: dict[str, np.ndarray] = {}
    for vid, rows in per_video.items():
        n = min(r.size for r in rows)
        out[vid] = np.stack([r[:n] for r in rows]).mean(axis=0)
    return out


def _h5_str(ds) -> str:
    """Decode an HDF5 MATLAB char array (uint16 codepoints) to str."""
    arr = np.asarray(ds).ravel()
    return "".join(chr(int(c)) for c in arr)


def load_tvsum_mat(path: str) -> dict[str, np.ndarray]:
    """TVSum ``ydata-tvsum50.mat`` (MATLAB v7.3 = HDF5) →
    ``{video_id: mean user_anno importance [nframes] f32}``.

    Layout: ``/tvsum50/{video,user_anno,...}`` are [50,1] object-reference
    arrays; each ``user_anno`` reference resolves to an [n_users, nframes]
    (or transposed) float dataset, ``video`` to a char-array id.
    """
    import h5py

    out: dict[str, np.ndarray] = {}
    with h5py.File(path, "r") as f:
        g = f["tvsum50"]
        vids, annos = g["video"], g["user_anno"]
        n = int(np.prod(vids.shape))
        vrefs = np.asarray(vids).ravel()
        arefs = np.asarray(annos).ravel()
        for i in range(n):
            vid = _h5_str(f[vrefs[i]])
            anno = np.asarray(f[arefs[i]], np.float32)
            # stored [nframes, n_users] or transposed; frames axis is longer
            if anno.ndim == 2 and anno.shape[0] < anno.shape[1]:
                anno = anno.T
            out[vid] = anno.mean(axis=1) if anno.ndim == 2 else anno
    return out


def load_summe_gt(path: str) -> tuple[np.ndarray, float]:
    """SumMe ``GT/<VideoName>.mat`` (MATLAB v5) → ``(gt_score [nframes] f32,
    fps)``.  Falls back to the mean of binary ``user_score`` when
    ``gt_score`` is absent, and to fps=30 when ``FPS`` is absent."""
    from scipy.io import loadmat

    m = loadmat(path)
    if "gt_score" in m:
        scores = np.asarray(m["gt_score"], np.float32).ravel()
    elif "user_score" in m:
        us = np.asarray(m["user_score"], np.float32)
        if us.ndim == 2 and us.shape[0] < us.shape[1]:
            us = us.T
        scores = us.mean(axis=1)
    else:
        raise ValueError(f"{path}: no gt_score/user_score variable")
    fps = float(np.asarray(m.get("FPS", 30.0)).ravel()[0])
    return scores, fps


def cue_importance(
    cues: list[tuple[float, float, str]],
    frame_scores: np.ndarray,
    fps: float,
) -> np.ndarray:
    """Mean per-frame importance over each subtitle cue's time span.

    Cues past the end of the annotation (auto-captions can overrun the
    video) get the global mean so they neither win nor lose selection.
    """
    frame_scores = np.asarray(frame_scores, np.float32)
    n = frame_scores.size
    fill = float(frame_scores.mean()) if n else 0.0
    out = np.empty((len(cues),), np.float32)
    for i, (start, end, _) in enumerate(cues):
        lo = min(max(int(start * fps), 0), n)
        hi = min(max(int(np.ceil(end * fps)), lo + 1), n)
        out[i] = frame_scores[lo:hi].mean() if hi > lo else fill
    return out


def select_summary_cues(
    cues: list[tuple[float, float, str]],
    scores: np.ndarray,
    budget_frac: float = 0.15,
) -> list[int]:
    """Pick the highest-importance cues whose total duration fits the
    benchmarks' 15% budget; always at least one. Returns indices in
    transcript (time) order."""
    if not cues:
        return []
    total = max(sum(e - s for s, e, _ in cues), 1e-6)
    budget = budget_frac * total
    picked: list[int] = []
    spent = 0.0
    for i in sorted(range(len(cues)), key=lambda i: -float(scores[i])):
        dur = cues[i][1] - cues[i][0]
        if picked and spent + dur > budget:
            continue
        picked.append(i)
        spent += dur
        if spent >= budget:
            break
    return sorted(picked)


def summary_from_importance(
    cues: list[tuple[float, float, str]],
    frame_scores: np.ndarray,
    fps: float,
    budget_frac: float = 0.15,
) -> str:
    """Subtitle cues + per-frame importance → gold summary text (the
    top-importance cues, in transcript order, within the duration budget)."""
    scores = cue_importance(cues, frame_scores, fps)
    picked = select_summary_cues(cues, scores, budget_frac)
    return " ".join(cues[i][2] for i in picked)


# ------------------------------------------------------------------------
# Keyshot evaluation — the benchmarks' native metric: F1 between the
# frames covered by the predicted summary and the top-importance frames
# within the duration budget (TVSum/SumMe protocol, adapted to the
# sentence-extractive setting: selected SENTENCES map back to time spans
# through the subtitle cues they came from).
# ------------------------------------------------------------------------


def sentence_spans(
    sentences: list[str],
    cues: list[tuple[float, float, str]],
) -> list[tuple[float, float]]:
    """Time span of each sentence: the transcript is the cues' bodies
    joined in order, and sentence splitting re-segments that same string —
    so each sentence's character range maps onto the cue(s) it overlaps.

    Robust to whitespace-normalization differences (both sides are matched
    on their whitespace-stripped character streams). Sentences that cannot
    be located (e.g. truncated transcripts) get an EMPTY span (0, 0) so
    they neither help nor hurt a keyshot score — a whole-video span would
    cover every frame and pin the F1 near the budget's baseline.
    """
    def squash(s: str) -> str:
        return "".join(s.split())

    stream = ""
    cue_char_end: list[tuple[int, float, float]] = []  # (end_offset, start_s, end_s)
    for start, end, body in cues:
        stream += squash(body)
        cue_char_end.append((len(stream), start, end))
    empty_span = (0.0, 0.0)

    spans: list[tuple[float, float]] = []
    pos = 0
    for sent in sentences:
        key = squash(sent)
        idx = stream.find(key, pos)
        if idx < 0:
            idx = stream.find(key)  # out-of-order fallback
        if idx < 0 or not key:
            spans.append(empty_span)
            continue
        lo_char, hi_char = idx, idx + len(key)
        pos = hi_char
        s_time, e_time = None, None
        prev_end = 0
        for c_end, c_s, c_e in cue_char_end:
            if c_end > lo_char and prev_end < hi_char:  # cue overlaps sentence
                s_time = c_s if s_time is None else min(s_time, c_s)
                e_time = c_e if e_time is None else max(e_time, c_e)
            prev_end = c_end
            if prev_end >= hi_char:
                break
        spans.append((s_time, e_time) if s_time is not None else empty_span)
    return spans


def keyshot_f1(
    pred_spans: list[tuple[float, float]],
    frame_scores: np.ndarray,
    fps: float,
    budget_frac: float = 0.15,
) -> float:
    """F1 between the frames inside ``pred_spans`` and the ground-truth
    keyshot frames (the top-``budget_frac`` of frames by importance)."""
    frame_scores = np.asarray(frame_scores, np.float32)
    n = frame_scores.size
    if n == 0:
        return 0.0
    k = max(int(round(budget_frac * n)), 1)
    gt = np.zeros(n, bool)
    gt[np.argsort(-frame_scores, kind="stable")[:k]] = True

    pred = np.zeros(n, bool)
    for start, end in pred_spans:
        lo = min(max(int(start * fps), 0), n)
        hi = min(max(int(np.ceil(end * fps)), lo), n)
        pred[lo:hi] = True

    inter = float((pred & gt).sum())
    if inter == 0:
        return 0.0
    p = inter / pred.sum()
    r = inter / gt.sum()
    return float(2 * p * r / (p + r))


def keyshot_from_files(
    video_dir: str,
    picked_sentences: list[str],
    budget_frac: float | None = None,
) -> float | None:
    """Keyshot F1 for a decoded video, when the corpus dir carries the
    benchmark annotations ``importance.npy`` + ``cues.json`` (written by
    tools/import_benchmark.py); None otherwise. The ground-truth budget
    defaults to the one the corpus was imported with (stored in
    cues.json; 0.15 for corpora predating that field)."""
    import json
    import os

    imp_path = os.path.join(video_dir, "importance.npy")
    cue_path = os.path.join(video_dir, "cues.json")
    if not (os.path.isfile(imp_path) and os.path.isfile(cue_path)):
        return None
    with open(cue_path) as f:
        meta = json.load(f)
    if budget_frac is None:
        budget_frac = float(meta.get("budget", 0.15))
    cues = [(float(s), float(e), t) for s, e, t in meta["cues"]]
    spans = sentence_spans(picked_sentences, cues)
    return keyshot_f1(spans, np.load(imp_path), float(meta["fps"]), budget_frac)
