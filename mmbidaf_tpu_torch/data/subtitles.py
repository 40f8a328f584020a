"""Subtitle parsing: SRT / WebVTT → transcript text (SURVEY.md §3.1
"Transcript preprocessing" — the reference preprocesses lecture videos
whose transcripts typically arrive as subtitle files; this is the
self-contained parser the ad-hoc scripts would wrap).

Both formats are cue-based:

    SRT:   index line, "HH:MM:SS,mmm --> HH:MM:SS,mmm", text lines, blank
    VTT:   "WEBVTT" header, optional cue ids, "HH:MM:SS.mmm --> ..." cues

Cues are concatenated in time order into one transcript string (sentence
splitting happens downstream in data/text.py); simple HTML-ish tags and
speaker prefixes are stripped; consecutive duplicate lines (a common
auto-caption artifact) are collapsed.

The port's copy of ``mmbidaf_tpu.data.subtitles``: numpy only, its lazy imports
as there.
"""

from __future__ import annotations

import re

_TIME_RE = re.compile(
    r"(\d{1,2}):(\d{2}):(\d{2})[.,](\d{3})\s*-->\s*(\d{1,2}):(\d{2}):(\d{2})[.,](\d{3})"
)
_TAG_RE = re.compile(r"<[^>]+>")
_SPEAKER_RE = re.compile(r"^\s*[A-Z][A-Z0-9 _.'-]{0,30}:\s+")


def _clean_line(line: str) -> str:
    line = _TAG_RE.sub("", line)
    line = _SPEAKER_RE.sub("", line)
    return line.strip()


def parse_cues(text: str) -> list[tuple[float, float, str]]:
    """Subtitle file content → ``[(start_s, end_s, cue_text), ...]``.

    Format-agnostic: any block containing a timestamp line is a cue;
    everything else (indices, WEBVTT headers, NOTE blocks) is skipped.
    """
    cues: list[tuple[float, float, str]] = []
    cur: list[str] = []
    span: tuple[float, float] | None = None

    def flush():
        nonlocal cur, span
        if span is not None:
            body = " ".join(_clean_line(l) for l in cur if _clean_line(l))
            if body:
                cues.append((span[0], span[1], body))
        cur = []
        span = None

    for raw in text.splitlines():
        line = raw.strip("﻿").rstrip()
        m = _TIME_RE.search(line)
        if m:
            flush()
            h1, m1, s1, ms1, h2, m2, s2, ms2 = map(int, m.groups())
            span = (
                h1 * 3600 + m1 * 60 + s1 + ms1 / 1000.0,
                h2 * 3600 + m2 * 60 + s2 + ms2 / 1000.0,
            )
        elif not line:
            flush()
        elif span is not None and not line.startswith(("WEBVTT", "NOTE")):
            cur.append(line)
    flush()
    cues.sort(key=lambda c: c[0])
    return cues


def subtitles_to_transcript(text: str) -> str:
    """SRT/VTT content → one transcript string (duplicate-cue collapsed)."""
    out: list[str] = []
    for _, _, body in parse_cues(text):
        if out and (out[-1] == body or out[-1].endswith(body)):
            continue  # auto-caption rolling duplicates
        out.append(body)
    return " ".join(out)
