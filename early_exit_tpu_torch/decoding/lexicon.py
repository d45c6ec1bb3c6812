"""Lexicon loading and OOV word snapping (counterpart of
`early_exit_tpu/decoding/lexicon.py`).

`apply_lex` semantics of the reference (util/tokenizer.py:28-50): every
decoded word not in the lexicon becomes its nearest lexicon entry by
edit distance. In-vocabulary words are a set lookup; the search for an
OOV word runs in the C++ engine of `csrc/lexicon` (`decoding/native.py`),
and its answers are cached per word.
"""

from __future__ import annotations

import io
from typing import List, Sequence

from early_exit_tpu_torch.decoding.native import NativeLexicon


def load_dict(file_path: str) -> List[str]:
    """One lexicon entry per line."""
    with io.open(file_path, encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f]


def edit_distance(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance (two-row DP) between two strings, or two lists
    of words."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


class LexiconCorrector:
    """apply_lex with an O(1) member check and the native OOV search."""

    def __init__(self, entries: Sequence[str]):
        self.entries = list(entries)
        self.members = set(self.entries)
        self._native = NativeLexicon(self.entries)
        self._cache = {}

    def snap_word(self, w: str) -> str:
        if w in self.members:
            return w
        if w not in self._cache:
            self._cache[w] = self._native.closest(w)
        return self._cache[w]

    def apply(self, text: str) -> str:
        """Each space-separated word snapped (empty words too, as the
        reference's split(" ") yields them)."""
        return " ".join(self.snap_word(w) for w in text.split(" "))


def apply_lex(predicted: str, lexicon) -> str:
    """The reference's signature: a list of entries or a LexiconCorrector."""
    if isinstance(lexicon, LexiconCorrector):
        return lexicon.apply(predicted)
    return LexiconCorrector(lexicon).apply(predicted)
