"""Corpus, batching, shape buckets and the grain loader — the port's copy of
``mmbidaf_tpu.data.pipeline`` (SURVEY.md §3.1 "Datasets + collate", §2 L2).

A ``VideoCorpus`` over per-video asset directories is an index-based
random-access source (the grain ``RandomAccessDataSource`` protocol); the
plain and bucketed iterators and ``make_grain_loader`` turn it into padded
numpy batches. Each example is the *raw* schema (frames / waveform / text
ids) that the frozen frontend turns into features inside the train step
(``train/loop.py``), or precomputed ``images`` / ``audio`` features from a
``features.npz``. Numpy only: batches reach the card in the training loop.
"""

from __future__ import annotations

import os
from typing import Iterator, Sequence

import numpy as np

from mmbidaf_tpu_torch.config import Config
from mmbidaf_tpu_torch.data.labels import make_targets
from mmbidaf_tpu_torch.data.text import encode_transcript, word_tokenize
from mmbidaf_tpu_torch.data.video import load_video_assets


class VideoCorpus:
    """Random-access corpus over ``root/<video_id>/`` asset directories.

    Implements ``__len__`` / ``__getitem__`` (the grain RandomAccessDataSource
    protocol), so it plugs into ``grain.MapDataset.source(...)`` directly.
    """

    def __init__(
        self,
        root: str,
        cfg: Config,
        word2idx: dict[str, int],
        require_summary: bool = False,
        use_precomputed: bool = True,
    ):
        self.root = root
        self.cfg = cfg
        self.word2idx = word2idx
        # Serve features.npz (precomputed image and audio features — the
        # reference's preprocessed-.npy flow) when present: the train step
        # then skips the VGG/MFCC frontend entirely (batch schema is keyed
        # on frames/waveform presence).
        self.use_precomputed = use_precomputed
        self.video_ids = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )
        if require_summary:
            # Training needs gold labels (targets derive from summary.txt);
            # unlabeled videos are skipped with a notice.
            labeled = [
                v for v in self.video_ids
                if os.path.isfile(os.path.join(root, v, "summary.txt"))
            ]
            if len(labeled) < len(self.video_ids):
                skipped = sorted(set(self.video_ids) - set(labeled))
                print(f"VideoCorpus: skipping {len(skipped)} unlabeled "
                      f"video(s) (no summary.txt): {skipped[:5]}...")
            self.video_ids = labeled
        if not self.video_ids:
            raise FileNotFoundError(f"no usable video dirs under {root}")
        d = cfg.data
        self.num_audio_samples = d.max_audio_frames * d.hop_length + d.win_length
        # per-example length metadata (bucketed_iterator), filled lazily and
        # cached so repeated iterator constructions (e.g. resume) do O(1)
        # host IO instead of re-reading the corpus
        self._lengths: dict[int, dict[str, int]] = {}
        # gold labels per example: the greedy ROUGE search is the costliest
        # host step of __getitem__ (~25 ms at 32 sentences) and a pure
        # function of the example's text files, so each epoch after the first
        # reuses it
        self._targets: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def __repr__(self) -> str:
        # Stable across processes: grain validates checkpointed loader
        # state by repr(data_source); the default object repr embeds the
        # memory address and never matches on resume.
        return (f"VideoCorpus(root={self.root!r}, n={len(self.video_ids)}, "
                f"precomputed={self.use_precomputed})")

    def __len__(self) -> int:
        return len(self.video_ids)

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        d, m = self.cfg.data, self.cfg.model
        vdir = os.path.join(self.root, self.video_ids[idx])
        fpath = os.path.join(vdir, "features.npz")
        precomputed = self.use_precomputed and os.path.exists(fpath)
        assets = load_video_assets(
            vdir,
            d.max_keyframes,
            self.num_audio_samples,
            media=not precomputed,
            keyframe_policy=d.keyframe_policy,
            sample_rate=d.sample_rate,
        )
        enc = encode_transcript(
            assets["transcript"], self.word2idx, d.max_sentences, d.max_words
        )
        ex = {
            "text_ids": enc["text_ids"],
            "word_mask": enc["word_mask"],
            "sent_mask": enc["sent_mask"],
        }
        if precomputed:
            with np.load(fpath) as z:
                ex["images"] = z["images"].astype(np.float32)
                ex["audio"] = z["audio"].astype(np.float32)
                ex["img_mask"] = z["img_mask"].astype(np.float32)
                ex["aud_mask"] = z["aud_mask"].astype(np.float32)
        else:
            from mmbidaf_tpu_torch.data.video import audio_frames_valid

            ex["frames"] = assets["frames"]
            ex["img_mask"] = assets["img_mask"]
            ex["waveform"] = assets["waveform"]
            # mask reflects the TRUE audio length (SURVEY §3.1 "pad variable
            # T_aud; build masks") — the audio tower never attends over
            # zero-padded silence, and T_aud bucketing (bucketed_iterator)
            # becomes semantics-preserving.
            n_aud = audio_frames_valid(
                assets["valid_samples"], d.hop_length, d.max_audio_frames
            )
            ex["aud_mask"] = (
                np.arange(d.max_audio_frames) < n_aud
            ).astype(np.float32)
        if assets["summary"] is not None:
            if idx not in self._targets:
                sent_tokens = [word_tokenize(s) for s in enc["sentences"]]
                # pad token lists to T_s so indices line up with sent_mask
                sent_tokens += [[]] * (d.max_sentences - len(sent_tokens))
                self._targets[idx] = make_targets(
                    sent_tokens, word_tokenize(assets["summary"]), m.max_decode_steps
                )
            targets, target_mask = self._targets[idx]
            ex["targets"] = targets.copy()
            ex["target_mask"] = target_mask.copy()
        return ex


    def example_lengths(self, idx: int) -> dict[str, int]:
        """Cheap per-example true lengths for shape bucketing (SURVEY §8
        ground rules: T_sent, W, T_img, T_aud buckets): sentence count, max
        words/sentence, keyframe count, valid MFCC frames. Reads only text
        sidecars + file headers (WAV nframes, frame-dir listing, npy/npz
        metadata) — never decodes media. Cached per corpus instance."""
        cached = self._lengths.get(idx)
        if cached is not None:
            return cached
        import wave as wave_mod

        from mmbidaf_tpu_torch.data.text import sent_tokenize
        from mmbidaf_tpu_torch.data.video import audio_frames_valid

        d = self.cfg.data
        vdir = os.path.join(self.root, self.video_ids[idx])
        with open(os.path.join(vdir, "transcript.txt")) as f:
            sents = sent_tokenize(f.read())[: d.max_sentences]
        n_sent = max(len(sents), 1)
        n_word = max((len(word_tokenize(s)) for s in sents), default=1)
        n_word = max(min(n_word, d.max_words), 1)

        fpath = os.path.join(vdir, "features.npz")
        if self.use_precomputed and os.path.exists(fpath):
            with np.load(fpath) as z:
                n_img = max(int(z["img_mask"].sum()), 1)
                n_aud = max(int(z["aud_mask"].sum()), 1)
        else:
            from mmbidaf_tpu_torch.data.video import IMAGE_EXTS

            fdir = os.path.join(vdir, "frames")
            container_samples = container_sr = 0
            if os.path.exists(os.path.join(vdir, "frames.npy")):
                n_raw = np.load(os.path.join(vdir, "frames.npy"), mmap_mode="r").shape[0]
            elif os.path.isdir(fdir):
                n_raw = sum(
                    1 for f in os.listdir(fdir) if f.lower().endswith(IMAGE_EXTS)
                )
            else:
                n_raw = 0
                from mmbidaf_tpu_torch.data import containers

                cpath = containers.find_container(vdir)
                if cpath is not None and cpath.lower().endswith((".y4m", ".avi")):
                    # header-only length read — never decodes pixels/PCM
                    n_raw, container_samples, container_sr = (
                        containers.container_lengths(cpath)
                    )
            n_img = max(min(n_raw, d.max_keyframes), 1)
            if os.path.exists(os.path.join(vdir, "audio.npy")):
                n_samples = np.load(
                    os.path.join(vdir, "audio.npy"), mmap_mode="r"
                ).shape[0]
            elif os.path.exists(os.path.join(vdir, "audio.wav")):
                with wave_mod.open(os.path.join(vdir, "audio.wav"), "rb") as w:
                    n_samples = w.getnframes()
            elif container_samples and container_sr:
                # container PCM resamples to d.sample_rate at load time
                n_samples = int(round(container_samples * d.sample_rate
                                      / container_sr))
            else:
                n_samples = self.num_audio_samples  # silent track, full bucket
            n_aud = audio_frames_valid(
                min(n_samples, self.num_audio_samples), d.hop_length,
                d.max_audio_frames,
            )
        out = {"sentences": n_sent, "words": n_word, "keyframes": n_img,
               "audio_frames": n_aud}
        self._lengths[idx] = out
        return out

    def example_text(self, idx: int) -> tuple[list[str], str | None]:
        """The idx-th video's real transcript sentences (truncated/ordered
        exactly like ``__getitem__``'s token ids) and its gold summary text,
        for host-side summary assembly + ROUGE (SURVEY.md §4.3: decode →
        indices → sentences → summary string → ROUGE vs gold).

        Reads only transcript.txt / summary.txt — no frame or audio decode.
        """
        from mmbidaf_tpu_torch.data.text import sent_tokenize

        vdir = os.path.join(self.root, self.video_ids[idx])
        with open(os.path.join(vdir, "transcript.txt")) as f:
            sentences = sent_tokenize(f.read())[: self.cfg.data.max_sentences]
        summary = None
        spath = os.path.join(vdir, "summary.txt")
        if os.path.isfile(spath):
            with open(spath) as f:
                summary = f.read().strip()
        return sentences, summary


def collate(examples: Sequence[dict]) -> dict[str, np.ndarray]:
    """Stack fixed-shape examples into one padded batch."""
    keys = examples[0].keys()
    return {k: np.stack([e[k] for e in examples]) for k in keys}


def decode_examples(fetch, idxs, decode_rows=None) -> list[dict]:
    """``[fetch(i) for i in idxs]``, decoding only the ``decode_rows``
    batch positions; other positions get a zero-filled placeholder of the
    same shapes (multi-host local decode, where each host decodes only the
    rows its devices own and never uploads the placeholders). ``fetch`` must
    return same-shape dicts for every index (static or per-batch-bucketed
    shapes)."""
    if decode_rows is None:
        return [fetch(i) for i in idxs]
    local = {int(r) for r in decode_rows}
    exs: list[dict | None] = []
    template = None
    for row, i in enumerate(idxs):
        if row in local:
            ex = fetch(i)
            if template is None:
                template = {k: np.zeros_like(v) for k, v in ex.items()}
            exs.append(ex)
        else:
            exs.append(None)
    if template is None:  # degenerate: no local rows — decode one for shape
        template = {k: np.zeros_like(v) for k, v in fetch(idxs[0]).items()}
    return [template if e is None else e for e in exs]


def batched_iterator(
    corpus: VideoCorpus,
    batch_size: int,
    seed: int = 0,
    shuffle: bool = True,
    drop_remainder: bool = True,
    skip: int = 0,
) -> Iterator[dict[str, np.ndarray]]:
    """Epoch-less batched stream (repeats forever, reshuffling per epoch).

    The last short batch is padded by wrapping (a static batch shape).
    ``skip`` fast-forwards that many batches WITHOUT touching the corpus
    (index arithmetic only) — deterministic data-order resume after
    preemption: ``skip=k`` yields exactly what batch k+1 onward would be.
    """
    rng = np.random.default_rng(seed)
    n = len(corpus)
    skipped = 0
    while True:
        order = rng.permutation(n) if shuffle else np.arange(n)
        for start in range(0, n, batch_size):
            idxs = order[start : start + batch_size]
            if len(idxs) < batch_size:
                if drop_remainder and n >= batch_size:
                    continue
                # Tile the whole epoch order as many times as needed: one
                # `order[:k]` slice under-fills when the corpus is smaller
                # than half the batch (n=3, batch 8 must yield 8, not 6 —
                # a short batch breaks grad_accum divisibility).
                reps = -(-(batch_size - len(idxs)) // n)
                idxs = np.concatenate([idxs] + [order] * reps)[:batch_size]
            if skipped < skip:
                skipped += 1
                continue
            yield collate([corpus[int(i)] for i in idxs])


def bucket_for(count: int, buckets: Sequence[int]) -> int:
    """Smallest bucket holding ``count`` sentences (largest bucket caps)."""
    for b in buckets:
        if count <= b:
            return b
    return buckets[-1]


def default_axis_buckets(max_size: int) -> tuple[int, ...]:
    """Quarter/half/full ladder for a secondary bucketed axis."""
    return tuple(sorted({max(1, max_size // 4), max(1, max_size // 2), max_size}))


def suggest_buckets(
    corpus: VideoCorpus,
    num_seq: int = 1,
    quantiles: Sequence[float] = (0.5, 0.8, 1.0),
    audio_align: int = 8,
) -> dict[str, tuple[int, ...]]:
    """Percentile-derived bucket ladders for all four ragged axes
    (``train/cli.py --buckets auto``).

    The quarter/half/full defaults assume lengths spread evenly up to the
    config cap; real corpora cluster, so data-derived ladders waste less
    padding: one bucket per length quantile (default p50/p80/max), rounded
    UP so every example still fits its bucket exactly. Audio buckets are
    aligned to ``lcm(audio_align, num_seq)``: a sequence-parallel audio
    tower shards the frame axis ``num_seq``-ways (bucketed_iterator
    docstring), and frame counts aligned to 8 keep the kernels' tiles
    whole. Uses
    ``VideoCorpus.example_lengths`` (header-only IO, cached), so cost is
    one metadata sweep — the same sweep ``bucketed_iterator`` pays anyway.
    """
    import math

    if not len(corpus):
        raise ValueError("cannot suggest buckets for an empty corpus")
    lens = [corpus.example_lengths(i) for i in range(len(corpus))]
    d = corpus.cfg.data
    caps = {
        "sentences": d.max_sentences,
        "words": d.max_words,
        "keyframes": d.max_keyframes,
        "audio_frames": d.max_audio_frames,
    }
    aligns = {k: 1 for k in caps}
    aligns["audio_frames"] = math.lcm(max(audio_align, 1), max(num_seq, 1))
    out = {}
    for key, cap in caps.items():
        vals = np.asarray([ln[key] for ln in lens])
        al = aligns[key]
        ladder = set()
        for q in quantiles:
            v = int(np.quantile(vals, q, method="higher"))
            ladder.add(min(-(-max(v, 1) // al) * al, cap))
        out[key] = tuple(sorted(ladder))
    return out


def bucketed_iterator(
    corpus: VideoCorpus,
    batch_size: int,
    buckets: Sequence[int],
    seed: int = 0,
    shuffle: bool = True,
    skip: int = 0,
    word_buckets: Sequence[int] | None = None,
    img_buckets: Sequence[int] | None = None,
    aud_buckets: Sequence[int] | None = None,
    decode_rows: Sequence[int] | None = None,
    seq_align: int = 1,
) -> Iterator[dict[str, np.ndarray]]:
    """Bucketed-shape batched stream (SURVEY.md §8 ground rules / risk R3).

    Examples are grouped by transcript sentence count into the smallest
    fitting T_sent bucket; each batch's text arrays are trimmed to that
    bucket. The OTHER ragged axes — W (words/sentence), T_img (keyframes),
    T_aud (MFCC frames, the costliest static bucket) — are trimmed
    per-batch to the smallest bucket covering the batch's true lengths
    (``VideoCorpus.example_lengths``, header-only IO, cached). Trimming is
    semantics-preserving: masks reflect true lengths, so the model never
    attends over what was cut. The kernels plan once per shape tuple and
    cache the plan; pass ``()`` for an axis to keep it static.

    Defaults: quarter/half/full ladders per axis. ``seq_align`` is for a
    sequence-parallel audio tower (``MeshConfig.sp_audio``, not ported
    yet): every audio bucket — default ladder or explicit — is rounded UP
    to a multiple, so a ``num_frames % num_seq`` check can never kill a run
    mid-epoch on an unaligned bucket; an unaligned ``max_audio_frames``
    cap fails here, at startup.

    ``decode_rows`` (multi-host) names the batch rows THIS host's devices
    own: only those are decoded from disk; the others are zero-filled shape
    placeholders (identical shapes — bucket selection uses the GLOBAL
    metadata sweep, so every host picks the same buckets) that are never
    uploaded. Host video decode then scales 1/H with the host count
    instead of every host decoding the full global batch.
    """
    d = corpus.cfg.data
    buckets = sorted({min(b, d.max_sentences) for b in buckets})
    if not buckets:
        raise ValueError("need at least one bucket")
    word_buckets = sorted(
        {min(b, d.max_words) for b in (
            default_axis_buckets(d.max_words) if word_buckets is None else word_buckets
        )}
    ) or [d.max_words]
    img_buckets = sorted(
        {min(b, d.max_keyframes) for b in (
            default_axis_buckets(d.max_keyframes) if img_buckets is None else img_buckets
        )}
    ) or [d.max_keyframes]
    aud_buckets = sorted(
        {min(b, d.max_audio_frames) for b in (
            default_axis_buckets(d.max_audio_frames) if aud_buckets is None else aud_buckets
        )}
    ) or [d.max_audio_frames]
    if seq_align > 1:
        if d.max_audio_frames % seq_align:
            raise ValueError(
                f"max_audio_frames {d.max_audio_frames} must be a multiple"
                f" of seq_align {seq_align} (MeshConfig.num_seq) to bucket"
                " the audio axis under sp_audio"
            )
        aud_buckets = sorted({
            min(-(-b // seq_align) * seq_align, d.max_audio_frames)
            for b in aud_buckets
        })

    lengths = [corpus.example_lengths(i) for i in range(len(corpus))]
    groups: dict[int, list[int]] = {}
    for i, ln in enumerate(lengths):
        groups.setdefault(bucket_for(ln["sentences"], buckets), []).append(i)

    def batch_axis_buckets(sel: np.ndarray) -> tuple[int, int, int]:
        """Smallest (W, T_img, T_aud) buckets covering the batch."""
        w = max(lengths[int(i)]["words"] for i in sel)
        ti = max(lengths[int(i)]["keyframes"] for i in sel)
        ta = max(lengths[int(i)]["audio_frames"] for i in sel)
        return (
            bucket_for(w, word_buckets),
            bucket_for(ti, img_buckets),
            bucket_for(ta, aud_buckets),
        )

    def trim(ex: dict, b: int, bw: int, bi: int, ba: int) -> dict:
        out = dict(ex)
        out["text_ids"] = ex["text_ids"][:b, :bw]
        out["word_mask"] = ex["word_mask"][:b, :bw]
        out["sent_mask"] = ex["sent_mask"][:b]
        if "frames" in ex:
            out["frames"] = ex["frames"][:bi]
        if "images" in ex:
            out["images"] = ex["images"][:bi]
        if "img_mask" in ex:
            out["img_mask"] = ex["img_mask"][:bi]
        if "waveform" in ex:
            # ba frames need (ba-1)*hop + win ≤ ba*hop + win samples; keep
            # the same static relation the frontend assumes
            out["waveform"] = ex["waveform"][: ba * d.hop_length + d.win_length]
        if "audio" in ex:
            out["audio"] = ex["audio"][:ba]
        if "aud_mask" in ex:
            out["aud_mask"] = ex["aud_mask"][:ba]
        return out

    local_rows = None if decode_rows is None else {int(r) for r in decode_rows}
    if local_rows is not None:
        bad = [r for r in local_rows if not 0 <= r < batch_size]
        if bad:
            raise ValueError(
                f"decode_rows {bad} outside the batch [0, {batch_size})"
            )

    def assemble(sel, b, bw, bi, ba):
        return decode_examples(
            lambda i: trim(corpus[int(i)], b, bw, bi, ba), sel, local_rows
        )

    rng = np.random.default_rng(seed)
    skipped = 0
    while True:
        # One epoch: per-bucket shuffled batches, bucket order interleaved.
        epoch: list[tuple[int, np.ndarray]] = []
        for b, idxs in groups.items():
            order = rng.permutation(idxs) if shuffle else np.asarray(idxs)
            for start in range(0, len(order), batch_size):
                sel = order[start : start + batch_size]
                if len(sel) < batch_size:
                    fill = rng.choice(idxs, size=batch_size - len(sel))
                    sel = np.concatenate([sel, fill])
                epoch.append((b, sel))
        if shuffle:
            rng.shuffle(epoch)
        for b, sel in epoch:
            # skip = deterministic resume fast-forward (index-only)
            if skipped < skip:
                skipped += 1
                continue
            bw, bi, ba = batch_axis_buckets(sel)
            yield collate(assemble(sel, b, bw, bi, ba))


def translate_grain_state(
    state: bytes, new_worker_count: int, batch_size: int
) -> tuple[bytes, int]:
    """Translate a grain DataLoader iterator snapshot to a different worker
    topology (round-3 review item: loader state was tied to worker_count).

    grain workers consume interleaved arithmetic progressions of sampler
    indices (worker w takes w, w+W, …), so a mid-epoch snapshot's consumed
    set is generally NOT expressible under a different W — exact-order
    translation is impossible by construction. This performs the no-loss
    translation instead: find the longest contiguous prefix of sampler
    indices all workers have consumed, round it DOWN to a whole round of
    the new topology (new_W × batch_size), and emit a clean end-of-round
    state there. Records consumed beyond that prefix are re-served —
    returns ``(new_state, n_repeated_records)``; nothing is ever skipped.

    Raises ``ValueError`` (with the remediation spelled out) for snapshot
    formats this translator doesn't understand.
    """
    import json

    try:
        st = json.loads(state)
    except Exception as e:
        raise ValueError(f"unreadable grain loader state: {e}") from e
    if st.get("version") != 2 or "last_seen_indices" not in st:
        raise ValueError(
            "grain loader state version "
            f"{st.get('version')!r} is not translatable — resume with the "
            "saved worker topology (--loader_workers "
            f"{st.get('worker_count', '?')}), or delete loader_state.bin to "
            "restart the data order"
        )
    w_old = max(int(st.get("worker_count", 0)), 1)
    last = {int(k): int(v) for k, v in st["last_seen_indices"].items()}
    # per-worker consumed counts; first-unconsumed index per progression
    counts = []
    first_unconsumed = []
    for w in range(w_old):
        ls = last.get(w, w - w_old)
        c = (ls - w) // w_old + 1 if ls >= w else 0
        counts.append(c)
        first_unconsumed.append(w + c * w_old)
    total = sum(counts)
    prefix = min(first_unconsumed)  # indices [0, prefix) are all consumed

    w_new = max(new_worker_count, 1)
    align = w_new * batch_size
    prefix = (prefix // align) * align
    repeats = total - prefix

    c_new = prefix // w_new
    new_last = {
        str(w): (w + (c_new - 1) * w_new if c_new > 0 else w - w_new)
        for w in range(w_new)
    }
    out = dict(
        st,
        worker_count=new_worker_count,
        last_seen_indices=new_last,
        last_worker_index=(-1 if prefix == 0 else w_new - 1),
    )
    return json.dumps(out).encode(), repeats


def make_grain_loader(
    corpus: VideoCorpus,
    batch_size: int,
    seed: int = 0,
    worker_count: int = 0,
    num_epochs: int | None = None,
):
    """grain-backed loader: the reference's DataLoader-worker parallelism.

    ``worker_count>0`` decodes examples (PNG frames, WAV) in that many
    subprocesses, overlapping host IO with device steps; ``num_epochs=None``
    repeats forever (epoch-based runs pass the real count and the loader
    stops when exhausted).
    """
    import grain.python as grain

    sampler = grain.IndexSampler(
        num_records=len(corpus),
        shuffle=True,
        seed=seed,
        shard_options=grain.NoSharding(),
        num_epochs=num_epochs,
    )
    return grain.DataLoader(
        data_source=corpus,
        sampler=sampler,
        operations=[grain.Batch(batch_size=batch_size, drop_remainder=True)],
        worker_count=worker_count,
    )
