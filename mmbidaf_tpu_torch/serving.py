"""Serving API of the port: video asset directories in, summary text out.

    s = Summarizer.init_random(cfg, seed=0, device="cuda")
    s = Summarizer.from_jax_params(params_np, fe_np, word2idx, cfg, device="cuda")
    s = Summarizer.from_run(run_dir, seed=cfg.train.seed)  # a train.cli run
    summaries = s.summarize_batch([video_dir1, video_dir2])
    summary = s.summarize(video_dir)
    summary = s.summarize_long(video_dir)   # transcripts past max_sentences

The device side is ``data.frontend.make_end_to_end_decode`` (frontend +
model + greedy decode); host work is asset decode and summary assembly,
through the port's own copies of the JAX package's host modules.
``summarize_long`` featurizes a video's media once and decodes overlapping
transcript windows against it. Greedy decoding on one device only: top-k,
beam, the dynamic batcher, bucket ladders and data parallelism are not
ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from mmbidaf_tpu_torch.config import Config
from mmbidaf_tpu_torch.data.frontend import (
    Frontend,
    apply_frontend,
    cast_vgg_weights,
    frontend_init,
    make_end_to_end_decode,
)
from mmbidaf_tpu_torch.data.synthetic import random_word_vectors
from mmbidaf_tpu_torch.data.text import encode_sentences, encode_transcript, sent_tokenize
from mmbidaf_tpu_torch.data.video import audio_frames_valid, load_video_assets
from mmbidaf_tpu_torch.models.mmbidaf import MMBiDAF, mmbidaf_init
from mmbidaf_tpu_torch.ops.vgg import VGG16_SPEC
from mmbidaf_tpu_torch.train.metrics import summary_from_picks


def transcript_windows(n_sents: int, window: int, stride: int) -> list[int]:
    """Window start indices covering ``n_sents`` sentences: strided starts
    plus a tail window so the last sentences are never dropped."""
    if n_sents <= window:
        return [0]
    starts = list(range(0, n_sents - window, stride))
    starts.append(n_sents - window)
    return starts


def merge_window_picks(picks: np.ndarray, scores: np.ndarray, starts: Sequence[int],
                       window_lens: Sequence[int], k: int) -> list[int]:
    """Merge per-window pointer picks ``[W, K]`` (window-local indices, with
    per-pick ``scores``) into one global selection: picks on padded slots
    are dropped, a sentence picked by overlapping windows keeps its best
    score, and the top ``k`` return in transcript order."""
    best: dict[int, float] = {}
    for w, start in enumerate(starts):
        for j in range(picks.shape[1]):
            local = int(picks[w, j])
            if local >= window_lens[w]:
                continue
            g = start + local
            s = float(scores[w, j])
            if g not in best or s > best[g]:
                best[g] = s
    top = sorted(best, key=lambda g: -best[g])[:k]
    return sorted(top)


def picks_scores(log_p: np.ndarray, picks: np.ndarray) -> np.ndarray:
    """Per-pick merge scores ``[B, K]``: each pick's own log-prob from the
    per-step ``log_p [B, K, T_s]`` (beam decoding, whose totals would be
    broadcast here, is not ported)."""
    return np.take_along_axis(log_p, picks[:, :, None], axis=2)[:, :, 0]


def num_audio_samples(cfg: Config) -> int:
    """Waveform samples needed to fill the ``max_audio_frames`` bucket."""
    d = cfg.data
    return d.max_audio_frames * d.hop_length + d.win_length


def host_raw_row(video_dir: str, word2idx: dict[str, int], cfg: Config) -> tuple[dict, list[str]]:
    """Host-decode ONE video's assets into an (unstacked) numpy raw row — the
    seven arrays ``make_end_to_end_decode`` consumes — plus the transcript
    sentences for assembling the summary."""
    d = cfg.data
    assets = load_video_assets(
        video_dir, d.max_keyframes, num_audio_samples(cfg),
        keyframe_policy=d.keyframe_policy, sample_rate=d.sample_rate,
    )
    enc = encode_transcript(assets["transcript"], word2idx, d.max_sentences, d.max_words)
    n_aud = audio_frames_valid(assets["valid_samples"], d.hop_length, d.max_audio_frames)
    row = {
        "text_ids": enc["text_ids"],
        "word_mask": enc["word_mask"],
        "sent_mask": enc["sent_mask"],
        "frames": assets["frames"],
        "img_mask": assets["img_mask"],
        "waveform": assets["waveform"],
        "aud_mask": (np.arange(d.max_audio_frames) < n_aud).astype(np.float32),
    }
    return row, enc["sentences"]


class Summarizer:
    def __init__(
        self,
        model: MMBiDAF,
        frontend: Frontend,
        word2idx: dict[str, int],
        cfg: Config,
        vgg_spec=VGG16_SPEC,
        mode: str = "greedy",
        serve_batch_size: int | None = None,
        data_parallel: bool = False,
        serve_buckets=None,
    ):
        if mode in ("topk", "beam"):
            raise NotImplementedError(f"{mode!r} serving is not ported yet")
        if mode != "greedy":
            raise ValueError(f"unknown decode mode {mode!r}: expected 'greedy', 'beam', or 'topk'")
        if data_parallel:
            raise NotImplementedError("data-parallel serving is not ported yet")
        if serve_buckets not in (None, False):
            raise NotImplementedError("bucket-ladder serving is not ported yet")
        if serve_batch_size is not None and serve_batch_size < 1:
            raise ValueError(f"serve_batch_size must be >= 1, got {serve_batch_size}")
        self.device = model.embedding.table.device  # raw batches go where the weights are
        self.model = model
        # frozen VGG weights held in the compute dtype
        self.frontend = cast_vgg_weights(frontend, cfg.model.compute_dtype)
        self.word2idx = word2idx
        self.cfg = cfg
        self.vgg_spec = vgg_spec
        # Static serving batch: requests are padded up (and chunked) to it.
        self.serve_batch_size = serve_batch_size
        self._decode = make_end_to_end_decode(cfg, vgg_spec)

    # -- constructors -------------------------------------------------------

    @classmethod
    def init_random(cls, cfg: Config, seed: int = 0, vgg_spec=VGG16_SPEC, device="cuda", **kw):
        """Untrained summarizer with seeded random weights (smoke tests)."""
        wv = random_word_vectors(np.random.default_rng(seed), cfg.data.vocab_size,
                                 cfg.model.emb_dim)
        word2idx = {f"w{i}": i for i in range(cfg.data.vocab_size)}
        model = mmbidaf_init(cfg, wv, device, seed=seed)
        fe = frontend_init(cfg, vgg_spec, device, seed=seed + 1)
        return cls(model, fe, word2idx, cfg, vgg_spec, **kw)

    @classmethod
    def from_jax_params(cls, params: dict, fe_params: dict, word2idx: dict[str, int],
                        cfg: Config, vgg_spec=VGG16_SPEC, device="cuda", **kw):
        """Serve the JAX package's weights, given as numpy pytrees."""
        from mmbidaf_tpu_torch.interop.from_jax import frontend_from_jax, model_from_jax

        model = model_from_jax(params, cfg, device)
        fe = frontend_from_jax(fe_params, cfg, vgg_spec, device)
        return cls(model, fe, word2idx, cfg, vgg_spec, **kw)

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, vocab_path: str, emb_path: str, cfg: Config,
                        vgg_spec=VGG16_SPEC, seed: int = 0, use_ema: bool = True,
                        device="cuda", **kw):
        """Serve the newest checkpoint of a port-trained run with the run's
        vocabulary (``vocab.json`` / ``emb.npz``). ``use_ema=True`` serves the
        EMA shadow, the reference's eval convention. The frozen frontend is
        seeded from ``seed + 2``: a run trained on random VGG weights seeded
        them from ``cfg.train.seed + 2``, so pass ``seed=cfg.train.seed`` to
        serve through the VGG the run trained with."""
        from mmbidaf_tpu_torch.data.vocab import load_vocab
        from mmbidaf_tpu_torch.train.checkpoint import CheckpointManager
        from mmbidaf_tpu_torch.train.loop import init_train_state

        word2idx, table = load_vocab(vocab_path, emb_path)
        model = mmbidaf_init(cfg, table, device, seed=seed)
        restored = CheckpointManager(ckpt_dir).restore_latest(
            init_train_state(model, cfg, seed=seed + 1))
        if restored is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
        fe = frontend_init(cfg, vgg_spec, device, seed=seed + 2)
        served = restored.ema_params if use_ema else restored.params
        return cls(served, fe, word2idx, cfg, vgg_spec, **kw)

    @classmethod
    def from_run(cls, run_dir: str, mesh_overrides: dict | None = None, **kw):
        """Serve a ``train.cli`` run directory: its saved config (with the
        frontend's VGG variant), vocabulary and newest checkpoint.
        ``from_checkpoint``'s keywords pass through (``seed``, ``device``,
        ``use_ema``, ``vgg_spec`` …)."""
        import os

        from mmbidaf_tpu_torch.ops.vgg import spec_for_variant
        from mmbidaf_tpu_torch.train.checkpoint import load_config

        if mesh_overrides:
            raise NotImplementedError("mesh layouts are not ported yet (ROADMAP Queue 1)")
        cfg = load_config(run_dir)
        vgg_spec = kw.pop("vgg_spec", None) or spec_for_variant(cfg.model.vgg_variant)
        return cls.from_checkpoint(os.path.join(run_dir, "ckpts"),
                                   os.path.join(run_dir, "vocab.json"),
                                   os.path.join(run_dir, "emb.npz"), cfg, vgg_spec=vgg_spec, **kw)

    # -- inference ----------------------------------------------------------

    def _stack_rows(self, rows: Sequence[dict]) -> dict:
        """Stack per-video rows (numpy arrays, or tensors already on the card)
        into one batch on the model's device."""
        return {k: torch.stack([torch.as_tensor(r[k]) for r in rows]).to(self.device)
                for k in rows[0]}

    def _raw_batch(self, video_dirs: Sequence[str]) -> tuple[dict, list[list[str]]]:
        rows, sentences = [], []
        for vd in video_dirs:
            row, sents = host_raw_row(vd, self.word2idx, self.cfg)
            rows.append(row)
            sentences.append(sents)
        return self._stack_rows(rows), sentences

    def _decode_batch(self, raw: dict, with_scores: bool = False):
        """Picks ``[B, K]``, and with ``with_scores`` each pick's log-prob."""
        log_p, picks = self._decode(self.model, self.frontend, raw)
        picks = picks.cpu().numpy()
        if not with_scores:
            return picks
        return picks, picks_scores(log_p.cpu().numpy(), picks)

    def summarize_batch(self, video_dirs: Sequence[str]) -> list[str]:
        if not video_dirs:
            return []
        sb = self.serve_batch_size
        if sb is None:
            raw, sentences = self._raw_batch(video_dirs)
            picks = self._decode_batch(raw)
            return [summary_from_picks(picks[i], sentences[i]) for i in range(len(video_dirs))]
        # Static-shape serving: chunks of sb (the tail padded by repeating the
        # last video, sliced off after). Host decode of chunk i+1 overlaps the
        # device work of chunk i.
        chunks = []
        for start in range(0, len(video_dirs), sb):
            chunk = list(video_dirs[start:start + sb])
            chunks.append((chunk + [chunk[-1]] * (sb - len(chunk)), len(chunk)))
        out: list[str] = []
        with ThreadPoolExecutor(max_workers=1) as ex:
            pending = ex.submit(self._raw_batch, chunks[0][0])
            for i, (_, n_real) in enumerate(chunks):
                raw, sentences = pending.result()
                if i + 1 < len(chunks):
                    pending = ex.submit(self._raw_batch, chunks[i + 1][0])
                picks = self._decode_batch(raw)
                out.extend(summary_from_picks(picks[j], sentences[j]) for j in range(n_real))
        return out

    def summarize(self, video_dir: str) -> str:
        return self.summarize_batch([video_dir])[0]

    def summarize_long(self, video_dir: str, stride: int | None = None) -> str:
        """Summarize a video whose transcript exceeds the ``max_sentences``
        bucket (``summarize`` would cut it): overlapping windows of
        ``max_sentences`` sentences (``stride`` defaults to half a window)
        are decoded against the video's whole keyframe and audio context,
        featurized once at B=1, and their picks merged by log-prob. Window
        batches are padded and chunked to ``serve_batch_size`` when set."""
        d, m = self.cfg.data, self.cfg.model
        assets = load_video_assets(
            video_dir, d.max_keyframes, num_audio_samples(self.cfg),
            keyframe_policy=d.keyframe_policy, sample_rate=d.sample_rate,
        )
        sentences = sent_tokenize(assets["transcript"])
        n_aud = audio_frames_valid(assets["valid_samples"], d.hop_length, d.max_audio_frames)
        media = {
            "frames": assets["frames"],
            "img_mask": assets["img_mask"],
            "waveform": assets["waveform"],
            "aud_mask": (np.arange(d.max_audio_frames) < n_aud).astype(np.float32),
        }

        def window_row(sents, media_row):
            enc = encode_sentences(sents, self.word2idx, d.max_sentences, d.max_words)
            return {"text_ids": enc["text_ids"], "word_mask": enc["word_mask"],
                    "sent_mask": enc["sent_mask"], **media_row}

        if len(sentences) <= d.max_sentences:
            # one window over the assets already loaded
            picks = self._decode_batch(self._stack_rows([window_row(sentences, media)]))
            return summary_from_picks(picks[0], sentences)

        # Featurize the media once: every window shares the video's context,
        # which stays on the card as features.
        with torch.inference_mode():
            feat = apply_frontend(self.frontend, self._stack_rows([media]), self.cfg,
                                  self.vgg_spec)
        media = {k: v[0] for k, v in feat.items()}
        stride = stride or max(d.max_sentences // 2, 1)
        starts = transcript_windows(len(sentences), d.max_sentences, stride)
        rows = [window_row(sentences[st:st + d.max_sentences], media) for st in starts]
        sb = self.serve_batch_size or len(rows)
        picks_l, scores_l = [], []
        for i in range(0, len(rows), sb):
            chunk = rows[i:i + sb]
            n_real = len(chunk)
            p, sc = self._decode_batch(self._stack_rows(chunk + [chunk[-1]] * (sb - n_real)),
                                       with_scores=True)
            picks_l.append(p[:n_real])
            scores_l.append(sc[:n_real])
        window_lens = [min(d.max_sentences, len(sentences) - st) for st in starts]
        chosen = merge_window_picks(np.concatenate(picks_l), np.concatenate(scores_l), starts,
                                    window_lens, m.max_decode_steps)
        return " ".join(sentences[g] for g in chosen)
