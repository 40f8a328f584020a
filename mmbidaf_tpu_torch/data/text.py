"""Transcript preprocessing, the port's copy of ``mmbidaf_tpu.data.text``:
sentence split → word tokenize → id mapping → pad to ``(T_sent, W_max)``
with masks.

Sentence splitting prefers NLTK punkt when its model data is present and
falls back to a vendored regex splitter. One difference from the JAX
package: that module falls back only when nltk is installed without its
punkt data, and where nltk is not installed at all (as on a CUDA host
without it) its import error escapes. The port takes the same regex
fallback in both cases, so sentences split the same way on either host.
"""

from __future__ import annotations

import re

import numpy as np

from mmbidaf_tpu_torch.data.vocab import encode_tokens

_SENT_RE = re.compile(r"(?<=[.!?])[\")\]]?\s+(?=[A-Z0-9\"(\[])")
_WORD_RE = re.compile(r"[A-Za-z0-9']+|[^\sA-Za-z0-9]")


def sent_tokenize(text: str) -> list[str]:
    try:
        from nltk.tokenize import sent_tokenize as nltk_sent

        return nltk_sent(text)
    except (LookupError, ImportError):
        pass
    text = " ".join(text.split())
    if not text:
        return []
    return [s.strip() for s in _SENT_RE.split(text) if s.strip()]


def word_tokenize(sentence: str) -> list[str]:
    return _WORD_RE.findall(sentence.lower())


def encode_transcript(transcript: str, word2idx: dict[str, int], max_sentences: int,
                      max_words: int) -> dict[str, np.ndarray]:
    """Transcript → padded ``text_ids [T_s, W]``, ``word_mask``, ``sent_mask``
    and the sentence strings."""
    return encode_sentences(sent_tokenize(transcript), word2idx, max_sentences, max_words)


def encode_sentences(sentences: list[str], word2idx: dict[str, int], max_sentences: int,
                     max_words: int) -> dict[str, np.ndarray]:
    """Pre-split sentence list → the same padded id/mask schema."""
    sentences = sentences[:max_sentences]
    text_ids = np.zeros((max_sentences, max_words), np.int32)
    word_mask = np.zeros((max_sentences, max_words), np.float32)
    sent_mask = np.zeros((max_sentences,), np.float32)
    for i, sent in enumerate(sentences):
        ids = encode_tokens(word_tokenize(sent)[:max_words], word2idx)
        if not ids:
            continue
        text_ids[i, : len(ids)] = ids
        word_mask[i, : len(ids)] = 1.0
        sent_mask[i] = 1.0
    return {
        "text_ids": text_ids,
        "word_mask": word_mask,
        "sent_mask": sent_mask,
        "sentences": sentences,
    }
