"""Import a TVSum- or SumMe-style benchmark into the VideoCorpus layout —
the port's counterpart of the repository's ``tools/import_benchmark.py``, on
the port's ``data/benchmarks.py`` and ``data/subtitles.py`` (host only, no
device).

The public video-summarization benchmarks annotate per-frame importance,
not text; MMBiDAF selects transcript sentences. This CLI bridges them
(alignment logic in ``mmbidaf_tpu_torch/data/benchmarks.py``): per video it
reads the importance annotation, the subtitle sidecar (SRT/VTT — e.g.
YouTube auto-captions; the datasets ship none themselves), and the video
container, and emits:

    <out>/<video_id>/transcript.txt    all subtitle cues, time order
    <out>/<video_id>/summary.txt       top-importance cues within the 15%
                                       duration budget (the gold summary)
    <out>/<video_id>/importance.npy    the raw per-frame scores (kept for
                                       keyshot-style evaluation)
    <out>/<video_id>/frames/ audio.wav when ffmpeg + --videos are available

Usage:
    # TVSum: tsv annotations (or --mat ydata-tvsum50.mat)
    python -m mmbidaf_tpu_torch.tools.import_benchmark --dataset tvsum \
        --anno ydata-tvsum50-anno.tsv --subs subs/ --videos video/ --out corpus/

    # SumMe: per-video GT .mat files
    python -m mmbidaf_tpu_torch.tools.import_benchmark --dataset summe \
        --gt_dir GT/ --subs subs/ --videos videos/ --out corpus/
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from mmbidaf_tpu_torch.data import benchmarks
from mmbidaf_tpu_torch.data.subtitles import parse_cues, subtitles_to_transcript

SUB_EXTS = (".srt", ".vtt")
VIDEO_EXTS = (".mp4", ".mkv", ".webm", ".avi", ".mov")


def _video_duration(path: str) -> float | None:
    """Container duration in seconds via ffprobe, or None."""
    import subprocess

    try:
        out = subprocess.run(
            ["ffprobe", "-v", "error", "-show_entries", "format=duration",
             "-of", "default=noprint_wrappers=1:nokey=1", path],
            capture_output=True, text=True, timeout=30,
        )
        return float(out.stdout.strip()) if out.returncode == 0 else None
    except (OSError, ValueError, subprocess.TimeoutExpired):
        return None


def _find(stem: str, root: str | None, exts: tuple[str, ...]) -> str | None:
    if not root or not os.path.isdir(root):
        return None
    for ext in exts:
        p = os.path.join(root, stem + ext)
        if os.path.isfile(p):
            return p
    return None


def _extract_media(video_path: str, vdir: str, args) -> None:
    from mmbidaf_tpu_torch.data.video import extract_media_to_dir

    if not extract_media_to_dir(
        video_path, vdir, every_n=args.every_n, max_frames=args.max_frames,
        sample_rate=args.sample_rate,
    ):
        print(f"  ffmpeg unavailable; skipping media for {vdir}", file=sys.stderr)


def import_video(
    vid: str,
    frame_scores: np.ndarray,
    fps: float | None,
    args,
) -> bool:
    sub_path = _find(vid, args.subs, SUB_EXTS)
    if sub_path is None:
        print(f"skip {vid}: no subtitle sidecar in {args.subs}", file=sys.stderr)
        return False
    with open(sub_path, encoding="utf-8", errors="replace") as f:
        raw = f.read()
    cues = parse_cues(raw)
    if not cues:
        print(f"skip {vid}: no cues parsed from {sub_path}", file=sys.stderr)
        return False
    video_path = _find(vid, args.videos, VIDEO_EXTS)
    if fps is None:
        # TVSum tsv rows carry no fps. Best source: the video container's
        # duration (captions often stop before the video ends — deriving
        # from the last cue would then skew every cue→frame alignment).
        fps = args.fps or None
        if fps is None and video_path is not None:
            dur = _video_duration(video_path)
            if dur and dur > 1.0:
                fps = frame_scores.size / dur
        if fps is None:
            fps = frame_scores.size / max(cues[-1][1], 1.0)
            print(f"{vid}: fps derived from the subtitle span "
                  f"({fps:.1f}); pass --fps or --videos for exact alignment",
                  file=sys.stderr)
    if not (1.0 <= fps <= 240.0):
        print(f"warning: {vid}: implausible fps {fps:.2f} — check the "
              f"annotation/video pairing", file=sys.stderr)

    vdir = os.path.join(args.out, vid)
    os.makedirs(vdir, exist_ok=True)
    with open(os.path.join(vdir, "transcript.txt"), "w") as f:
        f.write(subtitles_to_transcript(raw))
    summary = benchmarks.summary_from_importance(
        cues, frame_scores, fps, args.budget
    )
    with open(os.path.join(vdir, "summary.txt"), "w") as f:
        f.write(summary)
    np.save(os.path.join(vdir, "importance.npy"), frame_scores)
    # cue spans + fps + the gold budget let eval map selected sentences
    # back to time spans and score keyshot-F1 against the SAME keyshot set
    # the golds were built with (data/benchmarks.py)
    with open(os.path.join(vdir, "cues.json"), "w") as f:
        json.dump({"fps": fps, "budget": args.budget, "cues": cues}, f)

    if video_path is not None:
        _extract_media(video_path, vdir, args)
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(description="Import a TVSum / SumMe benchmark as a corpus")
    ap.add_argument("--dataset", choices=("tvsum", "summe"), required=True)
    ap.add_argument("--anno", help="TVSum *-anno.tsv")
    ap.add_argument("--mat", help="TVSum ydata-tvsum50.mat (HDF5)")
    ap.add_argument("--gt_dir", help="SumMe GT/ directory of per-video .mat")
    ap.add_argument("--subs", help="directory of <video_id>.srt/.vtt sidecars")
    ap.add_argument("--videos", help="directory of <video_id>.mp4 containers")
    ap.add_argument("--out", required=True)
    ap.add_argument("--budget", type=float, default=0.15,
                    help="summary duration budget fraction (benchmark standard)")
    ap.add_argument("--fps", type=float, default=0.0,
                    help="override fps for tsv annotations (0 = derive)")
    ap.add_argument("--every_n", type=int, default=30)
    ap.add_argument("--max_frames", type=int, default=64)
    ap.add_argument("--sample_rate", type=int, default=16000)
    args = ap.parse_args(argv)

    if args.dataset == "tvsum":
        if args.anno:
            scores = benchmarks.load_tvsum_anno_tsv(args.anno)
        elif args.mat:
            scores = benchmarks.load_tvsum_mat(args.mat)
        else:
            ap.error("tvsum needs --anno or --mat")
        items = [(vid, s, None) for vid, s in sorted(scores.items())]
    else:
        if not args.gt_dir:
            ap.error("summe needs --gt_dir")
        items = []
        for name in sorted(os.listdir(args.gt_dir)):
            if not name.endswith(".mat"):
                continue
            s, fps = benchmarks.load_summe_gt(os.path.join(args.gt_dir, name))
            items.append((name[:-4], s, fps))

    n = sum(import_video(vid, s, fps, args) for vid, s, fps in items)
    print(f"imported {n}/{len(items)} videos into {args.out}")


if __name__ == "__main__":
    main()
