"""SentencePiece BPE encoder (the encode side of `early_exit_tpu/tokenizer/bpe.py`).

Reads the `.model` protobuf (pieces with scores and types, TrainerSpec
ids, NormalizerSpec flags) and encodes as the JAX package's pure-Python
engine does:

- normalize: collapse whitespace runs (`remove_extra_whitespaces`),
  prepend one space (`add_dummy_prefix`), spaces -> "▁";
- USER_DEFINED pieces match atomically, longest first, before BPE;
- BPE: from single characters, merge the adjacent pair whose
  concatenation is a NORMAL or USER_DEFINED piece of the highest score,
  the leftmost on ties, until no pair merges;
- a piece that is not in the vocabulary maps to unk_id.

Only models of type BPE without a precompiled normalization charsmap are
read; others raise by name. Decoding is `SentencePieceDecoder`'s.
"""

from __future__ import annotations

from typing import List, Tuple

from early_exit_tpu_torch.tokenizer.spm import (
    CONTROL, NORMAL, UNKNOWN, USER_DEFINED, WS, SentencePieceDecoder,
    parse_model)

MODEL_TYPE_BPE = 2


class SentencePieceBPE(SentencePieceDecoder):
    def __init__(self, pieces: List[Tuple[str, float, int]], trainer: dict,
                 normalizer: dict):
        if int(trainer.get("model_type", 1)) != MODEL_TYPE_BPE:
            raise NotImplementedError(
                "the port encodes SentencePiece BPE models only (model_type "
                f"{trainer.get('model_type', 1)}); unigram, word and char "
                "models are not ported")
        if normalizer.get("precompiled_charsmap"):
            raise NotImplementedError(
                "this model normalizes with a precompiled charsmap; the "
                "port's tokenizer has no Charsmap yet")
        byte_fallback = bool(int(trainer.get("byte_fallback", 0)))
        if byte_fallback:
            raise NotImplementedError(
                "byte_fallback encoding is not ported (decoding is)")
        super().__init__([(p, t) for p, _, t in pieces], byte_fallback)
        self.piece_to_id = {p: i for i, (p, _, _) in enumerate(pieces)}
        self.vocab_score = {p: s for p, s, t in pieces
                            if t in (NORMAL, USER_DEFINED)}

        def first(ptype, default):
            return next((i for i, (_, _, t) in enumerate(pieces)
                         if t == ptype), default)

        self.unk_id_ = int(trainer.get("unk_id", first(UNKNOWN, 0)))
        self.bos_id_ = int(trainer.get("bos_id", first(CONTROL, -1)))
        self.eos_id_ = int(trainer.get("eos_id", -1))
        self.pad_id_ = int(trainer.get("pad_id", -1))
        self.add_dummy_prefix = bool(int(normalizer.get("add_dummy_prefix", 1)))
        self.remove_extra_ws = bool(int(normalizer.get(
            "remove_extra_whitespaces", 1)))
        # longest first; a stable sort keeps the model's order on ties
        self.user_defined = sorted((p for p, _, t in pieces if t == USER_DEFINED),
                                   key=len, reverse=True)

    def bos_id(self) -> int:
        return self.bos_id_

    def eos_id(self) -> int:
        return self.eos_id_

    def pad_id(self) -> int:
        return self.pad_id_

    def unk_id(self) -> int:
        return self.unk_id_

    def _normalize(self, text: str) -> str:
        if self.remove_extra_ws:
            text = " ".join(text.split())
        if self.add_dummy_prefix and text:
            text = " " + text
        return text.replace(" ", WS)

    def _split_user_defined(self, text: str) -> List[Tuple[str, bool]]:
        """(chunk, is_user_defined) runs."""
        if not self.user_defined:
            return [(text, False)]
        out: List[Tuple[str, bool]] = []
        buf: List[str] = []
        i = 0
        while i < len(text):
            hit = next((u for u in self.user_defined if text.startswith(u, i)),
                       None)
            if hit is None:
                buf.append(text[i])
                i += 1
                continue
            if buf:
                out.append(("".join(buf), False))
                buf = []
            out.append((hit, True))
            i += len(hit)
        if buf:
            out.append(("".join(buf), False))
        return out

    def _bpe_merge(self, symbols: List[str]) -> List[str]:
        """Merge the best-scoring adjacent pair (leftmost on ties) until
        none is in the vocabulary."""
        symbols = list(symbols)
        while len(symbols) > 1:
            best_i, best = -1, None
            for i in range(len(symbols) - 1):
                s = self.vocab_score.get(symbols[i] + symbols[i + 1])
                if s is not None and (best is None or s > best):
                    best_i, best = i, s
            if best_i < 0:
                break
            symbols[best_i:best_i + 2] = [symbols[best_i] + symbols[best_i + 1]]
        return symbols

    def encode_as_pieces(self, text: str) -> List[str]:
        pieces: List[str] = []
        for chunk, is_ud in self._split_user_defined(self._normalize(text)):
            pieces.extend([chunk] if is_ud else self._bpe_merge(list(chunk)))
        return pieces

    def encode_as_ids(self, text: str) -> List[int]:
        return [self.piece_to_id.get(p, self.unk_id_)
                for p in self.encode_as_pieces(text)]


def load_tokenizer(path: str) -> SentencePieceBPE:
    return SentencePieceBPE(*parse_model(path))
