"""Import real video data into the VideoCorpus on-disk layout — the port's
counterpart of the repository's ``tools/import_corpus.py``, on the port's
``data/subtitles.py`` and ``data/video.py`` (host only, no device).

The reference's preprocessing is ad-hoc per-video scripting (SURVEY §4.1);
this CLI is its reusable equivalent: point it at a directory of videos with
sidecar subtitle transcripts (and optional summaries) and it emits the
layout ``train.cli`` / ``infer`` consume:

    <out>/<video_id>/frames/fNNNN.png   (or video.mp4 if ffmpeg decode is deferred)
    <out>/<video_id>/audio.wav
    <out>/<video_id>/transcript.txt
    <out>/<video_id>/summary.txt        (when a sidecar summary exists)

Input conventions (per video stem X): ``X.mp4`` (or .mkv/.webm/.avi),
transcript from ``X.srt`` / ``X.vtt`` / ``X.txt``, summary from
``X.summary.txt``. Frame/audio extraction uses ffmpeg when available
(data/video.py helpers); with --no_media only transcripts/summaries are
imported (the loaders then fall back to zero frames/audio, still trainable
text-only).

    python -m mmbidaf_tpu_torch.tools.import_corpus --src /data/lectures --out /data/corpus
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

VIDEO_EXTS = (".mp4", ".mkv", ".webm", ".avi", ".mov")
SUB_EXTS = (".srt", ".vtt", ".txt")


def find_videos(src: str) -> dict[str, dict]:
    """Stem → {video, transcript, summary} paths found under ``src``."""
    entries: dict[str, dict] = {}
    for name in sorted(os.listdir(src)):
        path = os.path.join(src, name)
        if not os.path.isfile(path):
            continue
        stem, ext = os.path.splitext(name)
        ext = ext.lower()
        if stem.endswith(".summary") and ext == ".txt":
            entries.setdefault(stem[: -len(".summary")], {})["summary"] = path
        elif ext in VIDEO_EXTS:
            entries.setdefault(stem, {})["video"] = path
        elif ext in SUB_EXTS:
            e = entries.setdefault(stem, {})
            # prefer srt/vtt over bare txt if both exist
            if "transcript" not in e or ext != ".txt":
                e["transcript"] = path
    return entries


def import_one(stem: str, files: dict, out_dir: str, args) -> bool:
    from mmbidaf_tpu_torch.data.subtitles import subtitles_to_transcript

    tpath = files.get("transcript")
    if tpath is None:
        print(f"skip {stem}: no transcript sidecar", file=sys.stderr)
        return False
    with open(tpath, encoding="utf-8", errors="replace") as f:
        raw = f.read()
    if tpath.lower().endswith((".srt", ".vtt")):
        transcript = subtitles_to_transcript(raw)
    else:
        transcript = " ".join(raw.split())
    if not transcript:
        print(f"skip {stem}: empty transcript", file=sys.stderr)
        return False

    vdir = os.path.join(out_dir, stem)
    os.makedirs(vdir, exist_ok=True)
    with open(os.path.join(vdir, "transcript.txt"), "w") as f:
        f.write(transcript)
    if "summary" in files:
        shutil.copyfile(files["summary"], os.path.join(vdir, "summary.txt"))

    if not args.no_media and "video" in files:
        from mmbidaf_tpu_torch.data.video import extract_media_to_dir

        if not extract_media_to_dir(
            files["video"], vdir, every_n=args.every_n,
            max_frames=args.max_frames, sample_rate=args.sample_rate,
        ):
            # keep the container next to the transcript for later decode
            shutil.copyfile(
                files["video"],
                os.path.join(vdir, "video" + os.path.splitext(files["video"])[1]),
            )
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(description="Import videos with sidecar transcripts as a corpus")
    ap.add_argument("--src", required=True, help="directory of videos + sidecars")
    ap.add_argument("--out", required=True, help="VideoCorpus root to create")
    ap.add_argument("--every_n", type=int, default=30, help="keyframe sampling stride")
    ap.add_argument("--max_frames", type=int, default=64)
    ap.add_argument("--sample_rate", type=int, default=16000)
    ap.add_argument("--no_media", action="store_true",
                    help="import transcripts/summaries only")
    args = ap.parse_args(argv)

    entries = find_videos(args.src)
    n = sum(import_one(stem, files, args.out, args) for stem, files in entries.items())
    print(f"imported {n}/{len(entries)} videos into {args.out}")


if __name__ == "__main__":
    main()
