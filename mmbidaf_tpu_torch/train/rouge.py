"""ROUGE-1/2/L F-measures computed as ``rouge_score.RougeScorer(["rouge1",
"rouge2", "rougeL"], use_stemmer=True)`` computes them, with no third-party
package: the port's own copy of its tokenizer, of NLTK's Porter stemmer
(``PorterStemmer()``'s default ``NLTK_EXTENSIONS`` mode, the one
``rouge_score`` uses) and of its n-gram and LCS scores.

The JAX package's metrics import ``rouge_score``, which imports NLTK; a CUDA
host may have neither, and the trainer's eval must score there all the same.
``tests/test_torch_train_corpus.py`` holds the stems and the scores here equal
to NLTK's and ``rouge_score``'s.

Tokens: lowercase, every run of characters outside ``[a-z0-9]`` a separator,
tokens longer than 3 characters stemmed.
"""

from __future__ import annotations

import re
from collections import Counter
from functools import lru_cache

_NON_ALNUM = re.compile(r"[^a-z0-9]+")
_VALID = re.compile(r"^[a-z0-9]+$")
_VOWELS = frozenset("aeiou")
# NLTK's irregular forms, stemmed by lookup
_POOL = {
    "sky": "sky", "skies": "sky", "dying": "die", "lying": "lie", "tying": "tie",
    "news": "news", "innings": "inning", "inning": "inning", "outings": "outing",
    "outing": "outing", "cannings": "canning", "canning": "canning", "howe": "howe",
    "proceed": "proceed", "exceed": "exceed", "succeed": "succeed",
}


def _cons(w: str, i: int) -> bool:
    """Is ``w[i]`` a consonant? A ``y`` is one after a vowel (or first)."""
    if w[i] in _VOWELS:
        return False
    if w[i] == "y":
        negate = False
        while i > 0 and w[i] == "y":
            negate = not negate
            i -= 1
        return (w[i] not in _VOWELS) != negate
    return True


def _measure(stem: str) -> int:
    """m in [C](VC)^m[V]."""
    cv = "".join("c" if _cons(stem, i) else "v" for i in range(len(stem)))
    return cv.count("vc")


def _has_vowel(stem: str) -> bool:
    return any(not _cons(stem, i) for i in range(len(stem)))


def _double_cons(w: str) -> bool:
    return len(w) >= 2 and w[-1] == w[-2] and _cons(w, len(w) - 1)


def _cvc(w: str) -> bool:
    """Ends consonant-vowel-consonant, the last not w, x or y (NLTK: or is a
    two-letter vowel-consonant word)."""
    if len(w) >= 3:
        return (_cons(w, len(w) - 3) and not _cons(w, len(w) - 2) and _cons(w, len(w) - 1)
                and w[-1] not in "wxy")
    return len(w) == 2 and not _cons(w, 0) and _cons(w, 1)


def _m_pos(stem: str) -> bool:
    return _measure(stem) > 0


def _m_gt1(stem: str) -> bool:
    return _measure(stem) > 1


def _rules(w: str, rules) -> str:
    """The first rule whose suffix ``w`` ends with decides: replaced when its
    condition holds of the stem, else ``w`` unchanged. Suffix ``*d`` is a
    double consonant."""
    for suffix, repl, cond in rules:
        if suffix == "*d":
            if _double_cons(w):
                stem = w[:-2]
                return stem + repl if cond is None or cond(stem) else w
            continue
        if w.endswith(suffix):
            stem = w[:len(w) - len(suffix)]
            return stem + repl if cond is None or cond(stem) else w
    return w


def _step1a(w: str) -> str:
    if w.endswith("ies") and len(w) == 4:
        return w[:-3] + "ie"
    return _rules(w, [("sses", "ss", None), ("ies", "i", None), ("ss", "ss", None),
                      ("s", "", None)])


def _step1b(w: str) -> str:
    if w.endswith("ied"):
        return w[:-3] + ("ie" if len(w) == 4 else "i")
    if w.endswith("eed"):
        stem = w[:-3]
        return stem + "ee" if _measure(stem) > 0 else w
    for suffix in ("ed", "ing"):
        if w.endswith(suffix) and _has_vowel(w[:-len(suffix)]):
            mid = w[:-len(suffix)]
            break
    else:
        return w
    return _rules(mid, [
        ("at", "ate", None), ("bl", "ble", None), ("iz", "ize", None),
        ("*d", mid[-1], lambda stem: mid[-1] not in "lsz"),
        ("", "e", lambda stem: _measure(stem) == 1 and _cvc(stem)),
    ])


def _step1c(w: str) -> str:
    return _rules(w, [("y", "i", lambda stem: len(stem) > 1 and _cons(stem, len(stem) - 1))])


_STEP2 = [("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
          ("izer", "ize"), ("bli", "ble"), ("alli", "al"), ("entli", "ent"), ("eli", "e"),
          ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"), ("ator", "ate"),
          ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"), ("ousness", "ous"),
          ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"), ("fulli", "ful")]


def _step2(w: str) -> str:
    if w.endswith("alli") and _m_pos(w[:-4]):
        return _step2(w[:-4] + "al")
    rules = [(s, r, _m_pos) for s, r in _STEP2]
    rules.append(("logi", "log", lambda stem: _m_pos(w[:-3])))
    return _rules(w, rules)


def _step3(w: str) -> str:
    return _rules(w, [(s, r, _m_pos) for s, r in (
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"), ("ical", "ic"),
        ("ful", ""), ("ness", ""))])


def _step4(w: str) -> str:
    rules = [(s, "", _m_gt1) for s in ("al", "ance", "ence", "er", "ic", "able", "ible", "ant",
                                        "ement", "ment", "ent")]
    rules.append(("ion", "", lambda stem: _measure(stem) > 1 and stem[-1] in "st"))
    rules += [(s, "", _m_gt1) for s in ("ou", "ism", "ate", "iti", "ous", "ive", "ize")]
    return _rules(w, rules)


def _step5(w: str) -> str:
    if w.endswith("e"):
        stem = w[:-1]
        if _measure(stem) > 1 or (_measure(stem) == 1 and not _cvc(stem)):
            w = stem
    return _rules(w, [("ll", "l", lambda stem: _measure(w[:-1]) > 1)])


@lru_cache(maxsize=65536)
def porter_stem(word: str) -> str:
    """NLTK's ``PorterStemmer().stem(word)``."""
    w = word.lower()
    if w in _POOL:
        return _POOL[w]
    if len(word) <= 2:
        return w
    for step in (_step1a, _step1b, _step1c, _step2, _step3, _step4, _step5):
        w = step(w)
    return w


def tokenize(text: str) -> list[str]:
    """``rouge_score``'s tokens with the stemmer on."""
    tokens = _NON_ALNUM.sub(" ", text.lower()).split()
    return [t for t in (porter_stem(t) if len(t) > 3 else t for t in tokens) if _VALID.match(t)]


def _fmeasure(precision: float, recall: float) -> float:
    return 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0


def _ngram_f(target: list[str], pred: list[str], n: int) -> float:
    t = Counter(tuple(target[i:i + n]) for i in range(len(target) - n + 1))
    p = Counter(tuple(pred[i:i + n]) for i in range(len(pred) - n + 1))
    overlap = sum(min(c, p[g]) for g, c in t.items())
    return _fmeasure(overlap / max(sum(p.values()), 1), overlap / max(sum(t.values()), 1))


def _lcs_f(target: list[str], pred: list[str]) -> float:
    if not target or not pred:
        return 0.0
    prev = [0] * (len(pred) + 1)
    for x in target:
        cur = [0]
        for j, y in enumerate(pred):
            cur.append(prev[j] + 1 if x == y else max(prev[j + 1], cur[-1]))
        prev = cur
    return _fmeasure(prev[-1] / len(pred), prev[-1] / len(target))


def rouge_f(summary: str, reference: str) -> dict[str, float]:
    """ROUGE-1, ROUGE-2 and ROUGE-L F-measures of ``summary`` against
    ``reference``."""
    target, pred = tokenize(reference), tokenize(summary)
    return {"ROUGE-1": _ngram_f(target, pred, 1), "ROUGE-2": _ngram_f(target, pred, 2),
            "ROUGE-L": _lcs_f(target, pred)}
