"""Create a small synthetic on-disk video corpus for demos and smoke runs —
the port's own copy of the repository's ``examples/make_synthetic_corpus.py``
(numpy, PIL and the standard library only), writing the same files byte for
byte for the same flags and seed.

Each "video" gets PNG keyframes, a WAV audio track (mixed sine tones),
a transcript, and a gold abstractive summary — the corpus layout
``data.pipeline.VideoCorpus`` consumes.

    python -m mmbidaf_tpu_torch.examples.make_synthetic_corpus --out /tmp/corpus --videos 8
    python -m mmbidaf_tpu_torch.train.cli --data_dir /tmp/corpus --num_steps 50

``--learnable`` makes the pick task learnable rather than arbitrary: key
sentences (the gold summary) carry marker phrasing, the keyframes aligned
with key-sentence positions get a bright saliency band, and the audio gets
a high tone burst over the same spans — so a trained model's held-out
pick accuracy measures generalization, not memorization
(``experiments/quality_run.py``, docs/QUALITY.md). ``--split N``
additionally writes ``train/`` / ``dev/`` subdirs (the layout ``train.cli``
and ``infer`` special-case) with N dev videos held out.

``--cue_mode split`` assigns each key sentence exactly one cue class —
text / image / audio, round-robin — instead of all three: an image-cued key
reads like a filler and is identifiable only by the saliency band on its
aligned keyframes; an audio-cued key only by its tone burst. A text-only
model therefore has a sub-1.0 achievable ceiling by construction, and
per-cue-class pick recovery measures whether each tower earns its place
(``experiments/ablation_sweep.py`` reads the per-video ``cues.json`` this
writes).

Split mode also grounds every sentence in a distinct topic whose aligned
keyframe shows a topic-colored patch and whose audio span plays a
topic-coded tone, so cue retrieval is content matching (topic word <->
topic color/tone), the mechanism BiDAF attention exists for — not pure
positional alignment. Audio spans must lie inside the featurized window —
pass ``--seconds`` == DataConfig's ``max_audio_frames * hop + win`` over the
sample rate, or the tail sentences' cues are silently cropped (the loader
truncates).
"""

from __future__ import annotations

import argparse
import os
import wave as wave_mod

import numpy as np

TOPICS = [
    "gradient descent", "attention mechanisms", "tensor processing units",
    "sequence models", "data pipelines", "mel spectrograms",
    "pointer networks", "highway networks",
    "beam search", "vector quantization", "layer normalization",
    "positional encodings", "mixture models", "graph partitions",
    "sparse retrieval", "contrastive objectives",
]


def _topic_color(t: int) -> tuple[float, float, float]:
    """Deterministic saturated RGB for topic index ``t`` (hue wheel)."""
    import colorsys

    return colorsys.hsv_to_rgb((t % len(TOPICS)) / len(TOPICS), 1.0, 1.0)


def _topic_freq(t: int) -> float:
    """Deterministic pure-tone frequency for topic index ``t`` — spaced
    ~2 mel-ish bins apart, well under Nyquist for 16 kHz audio."""
    return 400.0 + 130.0 * (t % len(TOPICS))

# --learnable templates: key sentences carry marker words ("crucially",
# "takeaway", "conclusion"); fillers share the topic vocabulary so ONLY the
# markers (and the aligned image/audio cues) separate the classes.
FILLER_TEMPLATES = [
    "Lecture segment {j} explains {topic} with a worked example.",
    "The speaker then reviews {topic} on the next slide.",
    "A short aside mentions {topic} in passing.",
    "Notation for {topic} appears on the board.",
]
KEY_TEMPLATES = [
    "Crucially the main takeaway is that {topic} drives the final result.",
    "Importantly the central conclusion is that {topic} matters most here.",
]


def write_video(
    vd: str,
    rng: np.random.Generator,
    v: int,
    n_sents: int,
    n_frames: int,
    seconds: float,
    sample_rate: int,
    n_key: int,
    learnable: bool,
    cue_mode: str = "all",
    cue_classes: tuple = ("text", "image", "audio"),
) -> None:
    import json

    from PIL import Image

    key = np.sort(rng.choice(n_sents, size=min(n_key, n_sents), replace=False))
    # cue class per key sentence: "all" = every key carries text marker +
    # image band + audio burst; "split" = exactly one
    # cue each, round-robin over cue_classes from a random offset so no
    # class correlates with transcript position across the corpus
    if cue_mode == "split":
        off = int(rng.integers(len(cue_classes)))
        cues = {int(k): cue_classes[(i + off) % len(cue_classes)]
                for i, k in enumerate(key)}
    elif cue_mode == "all":
        cues = {int(k): "all" for k in key}
    else:
        raise ValueError(f"cue_mode must be 'all' or 'split', got {cue_mode!r}")
    img_cued = {k for k, c in cues.items() if c in ("image", "all")}
    audio_cued = {k for k, c in cues.items() if c in ("audio", "all")}
    text_cued = {k for k, c in cues.items() if c in ("text", "all")}

    # Topic grounding (split mode): every sentence gets a DISTINCT topic;
    # its 1:1-aligned frame shows the topic's color patch and its audio
    # span plays the topic's tone. Cross-modal identification of a cued key
    # is then CONTENT matching (topic word <-> topic color/tone + band/
    # burst) — the mechanism BiDAF attention is built for — rather than
    # pure positional alignment, which the probe run showed is not
    # learnable at corpus scale.
    if cue_mode == "split" and n_sents <= len(TOPICS):
        topic_idx = [int(x) for x in rng.permutation(len(TOPICS))[:n_sents]]
    else:
        topic_idx = [int(x) for x in rng.integers(0, len(TOPICS), size=n_sents)]
    topics = [TOPICS[t] for t in topic_idx]

    os.makedirs(os.path.join(vd, "frames"), exist_ok=True)
    for i in range(n_frames):
        # colored gradient frames so VGG features vary per video
        x = np.broadcast_to(np.linspace(0, 1, 64)[None, :, None], (48, 64, 1))
        y = np.broadcast_to(np.linspace(0, 1, 48)[:, None, None], (48, 64, 1))
        base = np.concatenate(
            [x * ((v + 1) % 3 + 1) / 3, y * ((v + 2) % 3 + 1) / 3,
             np.full((48, 64, 1), (i + 1) / n_frames)], axis=2
        )
        noise = rng.random((48, 64, 3)) * 0.2
        arr = (base + noise).clip(0, 1)
        if learnable:
            sent_at_frame = int(i * n_sents / n_frames)
            if cue_mode == "split":
                # topic color patch: bottom third shows the aligned
                # sentence's topic color (the content key for attention)
                arr[32:, :, :] = _topic_color(topic_idx[sent_at_frame])
            # saliency cue: frames aligned with a key sentence's relative
            # position get a bright band (visible to any conv featurizer)
            if sent_at_frame in img_cued:
                arr[8:16, :, :] = 1.0
        Image.fromarray((arr * 255).astype(np.uint8)).save(
            os.path.join(vd, "frames", f"f{i:04d}.png")
        )

    n_samp = int(seconds * sample_rate)
    t = np.arange(n_samp) / sample_rate
    if learnable and cue_mode == "split":
        # per-span topic tone (content key) + 3 kHz burst on audio-cued keys
        sig = np.zeros(n_samp)
        for j in range(n_sents):
            a = int(j * n_samp / n_sents)
            b = int((j + 1) * n_samp / n_sents)
            sig[a:b] = np.sin(2 * np.pi * _topic_freq(topic_idx[j]) * t[a:b])
        burst = np.zeros(n_samp)
        for k in audio_cued:
            a = int(k * n_samp / n_sents)
            b = int((k + 1) * n_samp / n_sents)
            burst[a:b] = np.sin(2 * np.pi * 3000 * t[a:b])
        sig = 0.6 * sig + 0.4 * burst
    else:
        freqs = 200 + 60 * np.asarray(rng.integers(1, 8, size=3))
        sig = sum(np.sin(2 * np.pi * f * t) for f in freqs) / 3
        if learnable:
            # tone-burst cue over each key sentence's time span
            burst = np.zeros(n_samp)
            for k in audio_cued:
                a = int(k * n_samp / n_sents)
                b = int((k + 1) * n_samp / n_sents)
                burst[a:b] = np.sin(2 * np.pi * 3000 * t[a:b])
            sig = 0.6 * sig + 0.4 * burst
    pcm = (sig * 20000).astype(np.int16)
    with wave_mod.open(os.path.join(vd, "audio.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())

    sents = []
    for j in range(n_sents):
        if learnable:
            # image/audio-cued keys read like fillers ON PURPOSE: their
            # transcript text carries zero class signal, so only the
            # matching tower can identify them (cue_mode="split")
            tpl = (KEY_TEMPLATES[int(rng.integers(len(KEY_TEMPLATES)))]
                   if j in text_cued else
                   FILLER_TEMPLATES[int(rng.integers(len(FILLER_TEMPLATES)))])
            sents.append(tpl.format(j=j, topic=topics[j]))
        else:
            sents.append(
                f"Lecture segment {j} explains {topics[j]} with a worked example."
            )
    with open(os.path.join(vd, "transcript.txt"), "w") as f:
        f.write(" ".join(sents))
    with open(os.path.join(vd, "summary.txt"), "w") as f:
        f.write(" ".join(sents[int(k)] for k in key))
    with open(os.path.join(vd, "cues.json"), "w") as f:
        json.dump({"cue_mode": cue_mode,
                   "cues": {str(k): cues[k] for k in sorted(cues)}}, f)


def make_corpus(
    out: str,
    videos: int = 8,
    sentences: int = 12,
    ragged: bool = False,
    frames: int = 10,
    seconds: float = 4.0,
    sample_rate: int = 16000,
    seed: int = 0,
    n_key: int = 3,
    learnable: bool = False,
    split: int = 0,
    cue_mode: str = "all",
    cue_classes: tuple = ("text", "image", "audio"),
) -> None:
    rng = np.random.default_rng(seed)
    for v in range(videos):
        if split:
            sub = "dev" if v >= videos - split else "train"
            vd = os.path.join(out, sub, f"video{v:03d}")
        else:
            vd = os.path.join(out, f"video{v:03d}")
        n_sents = int(rng.integers(3, sentences + 1)) if ragged else sentences
        write_video(vd, rng, v, n_sents, frames, seconds, sample_rate,
                    n_key, learnable, cue_mode=cue_mode,
                    cue_classes=cue_classes)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--videos", type=int, default=8)
    ap.add_argument("--sentences", type=int, default=12)
    ap.add_argument("--ragged", action="store_true",
                    help="vary sentence count per video in [3, --sentences] "
                         "(for bucketed-shape runs)")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--sample_rate", type=int, default=16000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--keys", type=int, default=3,
                    help="gold summary sentences per video")
    ap.add_argument("--learnable", action="store_true",
                    help="key sentences carry marker text + aligned "
                         "image/audio cues (held-out generalization demos)")
    ap.add_argument("--split", type=int, default=0, metavar="N_DEV",
                    help="write train/ and dev/ subdirs, holding out N videos")
    ap.add_argument("--cue_mode", choices=("all", "split"), default="all",
                    help="with --learnable: 'split' gives each key sentence "
                         "exactly one cue (text|image|audio) for per-tower "
                         "ablations; 'all' stacks all three")
    a = ap.parse_args(argv)

    make_corpus(a.out, a.videos, a.sentences, a.ragged, a.frames, a.seconds,
                a.sample_rate, a.seed, a.keys, a.learnable, a.split,
                cue_mode=a.cue_mode)
    print(f"wrote {a.videos} videos under {a.out}"
          + (f" (train/dev split, {a.split} held out)" if a.split else ""))


if __name__ == "__main__":
    main()
