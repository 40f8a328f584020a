"""Transcript encoding for the port: ``mmbidaf_tpu.data.text`` (JAX-free), with
one difference. That module's sentence splitter falls back to its vendored
regex only when nltk is installed without its punkt data; where nltk is not
installed at all (as on a CUDA host without it) the import error escapes.
The port takes the same regex fallback in both cases, so sentences split
the same way on either host."""

from __future__ import annotations

import numpy as np

from mmbidaf_tpu.data import text as _text


def sent_tokenize(text: str) -> list[str]:
    try:
        return _text.sent_tokenize(text)
    except ImportError:
        text = " ".join(text.split())
        return [s.strip() for s in _text._SENT_RE.split(text) if s.strip()] if text else []


def encode_transcript(transcript: str, word2idx: dict[str, int], max_sentences: int,
                      max_words: int) -> dict[str, np.ndarray]:
    """Transcript → padded ``text_ids [T_s, W]``, ``word_mask``, ``sent_mask``
    and the sentence strings."""
    return _text.encode_sentences(sent_tokenize(transcript), word2idx, max_sentences, max_words)
