"""Lexicon-constrained CTC beam search over the C++ decoder of
`csrc/beam/lexicon_beam.cc` (counterpart of
`early_exit_tpu/decoding/lexicon_beam.py`).

The reference's flashlight `ctc_decoder` bank (util/beam_infer.py:51-75):
hypotheses are lexicon word sequences through a token trie, and a decode
returns the best word string. An `ArpaLM` passed as `lm=` scores word
boundaries and the sentence end with weight `lm_weight` (shallow
fusion). The decoder takes host log-probs (numpy float32).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np

from early_exit_tpu_torch import _native
from early_exit_tpu_torch.decoding.ngram_lm import ArpaLM


class LexiconBeamDecoder:
    def __init__(self, entries: Sequence[Tuple[str, Sequence[int]]],
                 vocab_size: int, *, blank: int = 0, beam_size: int = 10,
                 word_score: float = 0.0, beam_threshold: float = 50.0,
                 lm: Optional[ArpaLM] = None, lm_weight: float = 1.0):
        """entries: (word, token ids) pairs."""
        self._lib = _native.get_lib()
        self._h = self._lib.eet_trie_create(vocab_size)
        self.words: List[str] = []
        for word, toks in entries:
            arr = (ctypes.c_int * len(toks))(*[int(t) for t in toks])
            self._lib.eet_trie_add_word(self._h, arr, len(toks), len(self.words))
            self.words.append(word)
        self.vocab_size = vocab_size
        self.blank = blank
        self.beam_size = beam_size
        self.word_score = word_score
        self.beam_threshold = beam_threshold
        self.lm = None
        self.lm_weight = 0.0
        if lm is not None:
            self.set_lm(lm, lm_weight)

    def set_lm(self, lm: ArpaLM, lm_weight: float = 1.0) -> None:
        """Attach (or retune) the shallow-fusion LM; lexicon words the LM
        lacks score as its <unk>."""
        lex2lm = (ctypes.c_int * len(self.words))(*[lm.word_id(w) for w in self.words])
        self._lib.eet_trie_set_lm(self._h, lm._h, ctypes.c_float(lm_weight), lex2lm,
                                  len(self.words))
        self.lm = lm          # the trie holds the LM's handle
        self.lm_weight = lm_weight

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.eet_trie_free(self._h)
        except Exception:
            pass

    @classmethod
    def from_files(cls, lexicon_path: str, tokens_path: str, *,
                   blank_token: str = "@", **kw) -> "LexiconBeamDecoder":
        """From a `.tok` file (one piece per line, line index = token id)
        and a `.lex` file (`word<TAB>piece piece ...`)."""
        with open(tokens_path, encoding="utf-8") as f:
            tokens = [line.rstrip("\n") for line in f]
        piece_to_id = {p: i for i, p in enumerate(tokens)}
        entries, dropped = [], 0
        with open(lexicon_path, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                word, _, pieces = line.partition("\t")
                ids = [piece_to_id[p] for p in pieces.split(" ") if p in piece_to_id]
                if ids:
                    entries.append((word, ids))
                else:
                    dropped += 1
        if dropped:
            print(f"warning: {dropped} lexicon entries dropped — their "
                  f"pieces are absent from {tokens_path} (mismatched "
                  f"lexicon/tokens pair?)")
        return cls(entries, len(tokens), blank=piece_to_id.get(blank_token, 0), **kw)

    def decode(self, log_probs: np.ndarray) -> Tuple[str, float]:
        """(T, V) log-probs -> (transcript, score)."""
        lp = np.ascontiguousarray(log_probs, np.float32)
        T, V = lp.shape
        if V != self.vocab_size:
            raise ValueError(f"vocabulary {V}, decoder built for {self.vocab_size}")
        out = (ctypes.c_int * 512)()
        score = ctypes.c_float()
        n = self._lib.eet_trie_decode(
            self._h, lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), T, V,
            self.blank, self.word_score, self.beam_size, self.beam_threshold,
            out, len(out), ctypes.byref(score))
        if n < 0:
            return "", float("-inf")
        return " ".join(self.words[out[i]] for i in range(n)), score.value

    def decode_nbest(self, log_probs: np.ndarray, nbest: int) -> List[Tuple[str, float]]:
        """Up to `nbest` complete hypotheses (transcript, score), best first."""
        lp = np.ascontiguousarray(log_probs, np.float32)
        T, V = lp.shape
        out = (ctypes.c_int * 4096)()
        counts = (ctypes.c_int * nbest)()
        scores = (ctypes.c_float * nbest)()
        n = self._lib.eet_trie_decode_nbest(
            self._h, lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), T, V,
            self.blank, self.word_score, self.beam_size, self.beam_threshold, nbest,
            out, len(out), counts, scores)
        results, pos = [], 0
        for i in range(max(n, 0)):
            results.append((" ".join(self.words[out[pos + j]] for j in range(counts[i])),
                            float(scores[i])))
            pos += counts[i]
        return results

    def decode_batch(self, log_probs: np.ndarray, lengths=None) -> List[str]:
        """(B, T, V) -> transcripts, each row cut to its length."""
        outs = []
        for b in range(log_probs.shape[0]):
            lp = log_probs[b]
            if lengths is not None:
                lp = lp[:int(lengths[b])]
            outs.append(self.decode(lp)[0])
        return outs
