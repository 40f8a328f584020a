"""GloVe vocab + embedding-matrix prep — the port's copy of
``mmbidaf_tpu.data.vocab`` (SURVEY.md §3.1 row 1).

Builds word2idx + the ``[V, emb_dim]`` embedding table from a GloVe ``.txt``
(word followed by floats per line), serializes vocab json + embedding
``.npz``. Index 0 is PAD (zeros, never attended), index 1 is OOV (zeros —
SURVEY §9 "OOV→zeros at a reserved index").
"""

from __future__ import annotations

import json
from collections import Counter
from typing import Iterable

import numpy as np

PAD_TOKEN = "--PAD--"
OOV_TOKEN = "--OOV--"
PAD_ID = 0
OOV_ID = 1


def build_vocab(
    token_iter: Iterable[list[str]],
    max_size: int | None = None,
    min_count: int = 1,
) -> dict[str, int]:
    """Corpus tokens → word2idx (most-frequent-first, after PAD/OOV).

    ``max_size`` caps the TOTAL vocabulary including the PAD/OOV rows, so
    the resulting embedding table never exceeds the configured
    ``vocab_size`` (consumers size buffers from that number)."""
    counts = Counter()
    for tokens in token_iter:
        counts.update(tokens)
    word2idx = {PAD_TOKEN: PAD_ID, OOV_TOKEN: OOV_ID}
    n_words = None if max_size is None else max(max_size - len(word2idx), 0)
    for word, c in counts.most_common(n_words):
        if c < min_count:
            break
        word2idx[word] = len(word2idx)
    return word2idx


def vocab_from_corpus_dir(data_dir: str, max_size: int | None = None) -> dict[str, int]:
    """Deterministic word2idx over every transcript under ``data_dir`` (the
    VideoCorpus layout: ``<root>/<video_id>/transcript.txt``). train.py and
    infer.py both use this so an inference process reconstructs the exact
    vocabulary the checkpoint was trained with."""
    import os

    from mmbidaf_tpu_torch.data.text import sent_tokenize, word_tokenize

    corpus_tokens = []
    for vid in sorted(os.listdir(data_dir)):
        tpath = os.path.join(data_dir, vid, "transcript.txt")
        if os.path.isfile(tpath):
            with open(tpath) as f:
                for sline in sent_tokenize(f.read()):
                    corpus_tokens.append(word_tokenize(sline))
    return build_vocab(corpus_tokens, max_size=max_size)


def load_glove(
    glove_path: str,
    word2idx: dict[str, int],
    emb_dim: int = 300,
    scale_oov: float = 0.0,
) -> np.ndarray:
    """Parse a GloVe .txt into an embedding table aligned to ``word2idx``.

    Words absent from the GloVe file keep zero vectors (they behave as OOV,
    matching the reference's frozen-GloVe convention).
    """
    table = np.zeros((len(word2idx), emb_dim), dtype=np.float32)
    with open(glove_path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            word = parts[0]
            idx = word2idx.get(word)
            if idx is not None and idx > OOV_ID and len(parts) == emb_dim + 1:
                table[idx] = np.asarray(parts[1:], dtype=np.float32)
    return table


def save_vocab(word2idx: dict[str, int], table: np.ndarray, vocab_path: str, emb_path: str):
    with open(vocab_path, "w") as f:
        json.dump(word2idx, f)
    np.savez_compressed(emb_path, table=table)


def load_vocab(vocab_path: str, emb_path: str) -> tuple[dict[str, int], np.ndarray]:
    with open(vocab_path) as f:
        word2idx = json.load(f)
    table = np.load(emb_path)["table"]
    return word2idx, table


def encode_tokens(tokens: list[str], word2idx: dict[str, int]) -> list[int]:
    return [word2idx.get(t, OOV_ID) for t in tokens]
