"""ARPA n-gram LM over the C++ reader of `csrc/beam/arpa_lm.cc`
(counterpart of `early_exit_tpu/decoding/ngram_lm.py`), for shallow
fusion in the lexicon beam. Scores are natural logs."""

from __future__ import annotations

import ctypes
from typing import Sequence

from early_exit_tpu_torch import _native


class ArpaLM:
    def __init__(self, path: str):
        self._lib = _native.get_lib()
        self._h = self._lib.eet_lm_load(path.encode("utf-8"))
        if not self._h:
            raise ValueError(f"failed to parse ARPA LM: {path}")
        self.path = path

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.eet_lm_free(self._h)
        except Exception:
            pass

    @property
    def order(self) -> int:
        return self._lib.eet_lm_order(self._h)

    @property
    def vocab_size(self) -> int:
        return self._lib.eet_lm_vocab_size(self._h)

    def word_id(self, word: str) -> int:
        """LM word id, -1 when out of vocabulary."""
        return self._lib.eet_lm_word_id(self._h, word.encode("utf-8"))

    def score(self, words: Sequence[str], *, add_eos: bool = True) -> float:
        """Natural-log score of the word sequence from <s> (OOV words score
        as <unk>), optionally closed with </s>."""
        ids = [self.word_id(w) for w in words]
        arr = (ctypes.c_int * max(len(ids), 1))(*ids)
        return float(self._lib.eet_lm_score_sequence(self._h, arr, len(ids),
                                                      1 if add_eos else 0))
