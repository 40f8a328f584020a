"""Synthetic corpus generator — the port's copy of ``mmbidaf_tpu.data.synthetic``
(SURVEY.md §5 item 4); the same seed gives the same batches in both packages.

Produces fake "videos" — random keyframe features, sine-wave audio, lorem
transcripts — as fixed-shape padded batches with masks, for tests, smoke
training, and benchmarks. No real dataset required.
"""

from __future__ import annotations

import numpy as np

from mmbidaf_tpu_torch.config import Config


def random_word_vectors(rng: np.random.Generator, vocab_size: int, emb_dim: int) -> np.ndarray:
    """Fake GloVe table; rows 0 (pad) and 1 (OOV) are zeros (SURVEY §9)."""
    table = rng.standard_normal((vocab_size, emb_dim)).astype(np.float32) * 0.4
    table[0] = 0.0
    table[1] = 0.0
    return table


def synthetic_batch(
    rng: np.random.Generator,
    cfg: Config,
    batch_size: int | None = None,
    ragged: bool = True,
) -> dict[str, np.ndarray]:
    """One padded batch with masks + gold targets.

    Shapes (d = cfg.data, m = cfg.model):
      text_ids  [B, T_s, W] int32      word_mask [B, T_s, W] f32
      sent_mask [B, T_s] f32           images    [B, T_i, D_v] f32
      img_mask  [B, T_i] f32           audio     [B, T_a, D_a] f32
      aud_mask  [B, T_a] f32           targets   [B, K] int32
      target_mask [B, K] f32
    """
    d, m = cfg.data, cfg.model
    B = batch_size or cfg.train.batch_size
    T_s, W = d.max_sentences, d.max_words
    T_i, T_a = d.max_keyframes, d.max_audio_frames
    K = m.max_decode_steps

    def lengths(n, hi, lo=1):
        if not ragged:
            return np.full(n, hi, np.int64)
        ls = rng.integers(lo, hi + 1, size=n)
        ls[0] = hi
        return ls

    n_sent = lengths(B, T_s, lo=max(K, 2))
    sent_mask = (np.arange(T_s)[None] < n_sent[:, None]).astype(np.float32)

    n_words = rng.integers(1, W + 1, size=(B, T_s)) if ragged else np.full((B, T_s), W)
    word_mask = (np.arange(W)[None, None] < n_words[:, :, None]).astype(np.float32)
    word_mask *= sent_mask[:, :, None]  # padded sentences have no words

    text_ids = rng.integers(2, d.vocab_size, size=(B, T_s, W)).astype(np.int32)
    text_ids = np.where(word_mask > 0, text_ids, 0)

    n_img = lengths(B, T_i)
    img_mask = (np.arange(T_i)[None] < n_img[:, None]).astype(np.float32)
    images = rng.standard_normal((B, T_i, m.img_feat_dim)).astype(np.float32)
    images *= img_mask[:, :, None]

    n_aud = lengths(B, T_a)
    aud_mask = (np.arange(T_a)[None] < n_aud[:, None]).astype(np.float32)
    audio = rng.standard_normal((B, T_a, m.audio_feat_dim)).astype(np.float32)
    audio *= aud_mask[:, :, None]

    # Gold: K distinct valid sentence indices per example.
    targets = np.stack([rng.permutation(n)[:K] for n in n_sent]).astype(np.int32)
    target_mask = np.ones((B, K), np.float32)

    return {
        "text_ids": text_ids,
        "word_mask": word_mask,
        "sent_mask": sent_mask,
        "images": images,
        "img_mask": img_mask,
        "audio": audio,
        "aud_mask": aud_mask,
        "targets": targets,
        "target_mask": target_mask,
    }


def batch_stream(seed: int, cfg: Config, batch_size: int | None = None):
    """Infinite deterministic stream of synthetic batches."""
    rng = np.random.default_rng(seed)
    while True:
        yield synthetic_batch(rng, cfg, batch_size)
