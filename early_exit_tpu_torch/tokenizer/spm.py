"""The unigram, word and char SentencePiece engines in plain Python (the
port's copy of `early_exit_tpu/tokenizer/spm.py`), and `load_tokenizer`
for all four model types (TrainerSpec.model_type UNIGRAM=1, BPE=2,
WORD=3, CHAR=4). They share the BPE engine's normalization (charsmap,
whitespace, "▁"), byte fallback and decoding (`bpe.py`).

Unigram encoding is Viterbi segmentation: the token sequence maximizing
the sum of piece log-probabilities (the `score` field of each piece).
Characters not covered by any piece become `<unk>` with a score of
(min piece score - 10); adjacent unknowns merge into a single unk piece.
N-best segmentation is a top-k dynamic program over the lattice;
sampling draws from the lattice by forward-filtering backward-sampling
(or from the n best), with the `random.Random` it is given.
"""

from __future__ import annotations

import math
import random
from typing import List

from early_exit_tpu_torch.tokenizer import proto
from early_exit_tpu_torch.tokenizer.bpe import WS, SentencePieceBPE

_UNK_PENALTY = 10.0

UNIGRAM, BPE, WORD, CHAR = 1, 2, 3, 4


class SentencePieceUnigram(SentencePieceBPE):
    """Viterbi max-likelihood segmentation over the unigram vocabulary."""

    def __init__(self, model: proto.ModelData):
        super().__init__(model)
        scores = [p.score for p in model.pieces
                  if p.type == proto.NORMAL]
        min_score = min(scores) if scores else 0.0
        self.unk_score = min_score - _UNK_PENALTY
        self.max_piece_chars = max(
            (len(p) for p in self.vocab_score), default=1)

    def _segment(self, chars: List[str]) -> List[str]:
        n = len(chars)
        neg_inf = float("-inf")
        best = [neg_inf] * (n + 1)
        best[0] = 0.0
        # back[j] = (i, piece, is_unk) — best path arrives at j from i
        back: List[tuple] = [None] * (n + 1)
        for i in range(n):
            if best[i] == neg_inf:
                continue
            limit = min(n, i + self.max_piece_chars)
            for j in range(i + 1, limit + 1):
                piece = "".join(chars[i:j])
                s = self.vocab_score.get(piece)
                if s is not None and best[i] + s > best[j]:
                    best[j] = best[i] + s
                    back[j] = (i, piece, False)
            # single-character unk fallback keeps the lattice connected
            if best[i] + self.unk_score > best[i + 1]:
                best[i + 1] = best[i] + self.unk_score
                back[i + 1] = (i, chars[i], True)
        pieces: List[tuple] = []
        j = n
        while j > 0:
            i, piece, is_unk = back[j]
            pieces.append((piece, is_unk))
            j = i
        pieces.reverse()
        # merge adjacent unknowns into one unk piece (as SentencePiece does)
        out: List[str] = []
        prev_unk = False
        for piece, is_unk in pieces:
            if is_unk and prev_unk:
                out[-1] += piece
            else:
                out.append(piece)
            prev_unk = is_unk
        return out

    def encode_as_pieces(self, text: str) -> List[str]:
        norm = self._normalize(text)
        pieces: List[str] = []
        for chunk, is_ud in self._split_user_defined(norm):
            if is_ud:
                pieces.append(chunk)
            else:
                pieces.extend(self._segment(list(chunk)))
        return self._with_byte_fallback(pieces)

    # -- lattice machinery for nbest / sampled encoding -------------------
    # (SentencePiece's unigram NBestEncode / SampleEncode over the
    # per-character lattice: n-best hypothesis search and
    # forward-filtering backward-sampling)

    def _edges_by_end(self, chars: List[str]):
        """edges[j] = list of (i, piece, score, is_unk) spanning i..j."""
        n = len(chars)
        edges: List[List[tuple]] = [[] for _ in range(n + 1)]
        for i in range(n):
            limit = min(n, i + self.max_piece_chars)
            for j in range(i + 1, limit + 1):
                piece = "".join(chars[i:j])
                s = self.vocab_score.get(piece)
                if s is not None:
                    edges[j].append((i, piece, s, False))
            # unk edge only where no single-char piece covers the position
            # (SentencePiece PopulateNodes: unk iff no single-char node)
            if chars[i] not in self.vocab_score:
                edges[i + 1].append((i, chars[i], self.unk_score, True))
        return edges

    @staticmethod
    def _merge_unks(path: List[tuple]) -> List[str]:
        """[(piece, is_unk)] -> pieces, adjacent unknowns merged (the
        SentencePiece behavior, as in _segment)."""
        out: List[str] = []
        prev_unk = False
        for piece, is_unk in path:
            if is_unk and prev_unk:
                out[-1] += piece
            else:
                out.append(piece)
            prev_unk = is_unk
        return out

    def _nbest_segment(self, chars: List[str], nbest: int
                       ) -> List[tuple[List[tuple], float]]:
        """Exact n-best segmentations: top-k DP over the lattice.
        Returns [(path [(piece, is_unk), ...], score)], best first."""
        n = len(chars)
        edges = self._edges_by_end(chars)
        # hyps[j] = up to nbest (score, path) best-first
        hyps: List[List[tuple]] = [[] for _ in range(n + 1)]
        hyps[0] = [(0.0, ())]
        for j in range(1, n + 1):
            cand = []
            for (i, piece, s, is_unk) in edges[j]:
                for (ps, path) in hyps[i]:
                    cand.append((ps + s, path + ((piece, is_unk),)))
            cand.sort(key=lambda c: -c[0])
            hyps[j] = cand[:nbest]
        return [(list(path), score) for score, path in hyps[n]]

    def _sample_segment(self, chars: List[str], alpha: float, rng
                        ) -> List[str]:
        """Forward-filtering backward-sampling: draws a segmentation with
        P(seg) ∝ exp(alpha · score(seg)) over the full lattice."""
        n = len(chars)
        if n == 0:
            return []
        edges = self._edges_by_end(chars)
        fwd = [float("-inf")] * (n + 1)
        fwd[0] = 0.0
        for j in range(1, n + 1):
            terms = [fwd[i] + alpha * s for (i, _, s, _) in edges[j]]
            m = max(terms)
            fwd[j] = m + math.log(sum(math.exp(t - m) for t in terms))
        path: List[tuple] = []
        j = n
        while j > 0:
            weights = [math.exp(fwd[i] + alpha * s - fwd[j])
                       for (i, _, s, _) in edges[j]]
            total = sum(weights)
            r = rng.random() * total
            acc = 0.0
            pick = len(weights) - 1
            for k, w in enumerate(weights):
                acc += w
                if r <= acc:
                    pick = k
                    break
            i, piece, _, is_unk = edges[j][pick]
            path.append((piece, is_unk))
            j = i
        path.reverse()
        return self._merge_unks(path)

    def nbest_encode_as_pieces(self, text: str, nbest: int
                               ) -> List[tuple[List[str], float]]:
        """N-best segmentations of the whole text, best first, as
        (pieces, score). User-defined chunks are atomic (one shared
        hypothesis), so the n-best structure comes from the free text."""
        norm = self._normalize(text)
        per_chunk: List[List[tuple[List[str], float]]] = []
        for chunk, is_ud in self._split_user_defined(norm):
            if is_ud:
                per_chunk.append([([chunk], 0.0)])
            else:
                per_chunk.append(
                    [(self._merge_unks(path), s)
                     for path, s in self._nbest_segment(list(chunk),
                                                        nbest)])
        # combine chunk-wise n-bests (beam product, keep global top-n);
        # dedupe piece sequences that coincide after unk merging
        combined: List[tuple[List[str], float]] = [([], 0.0)]
        for options in per_chunk:
            combined = sorted(
                ((ps + op, sc + osc) for ps, sc in combined
                 for op, osc in options),
                key=lambda c: -c[1])[:nbest]
        seen = set()
        out = []
        for ps, sc in combined:
            key = tuple(ps)
            if key not in seen:
                seen.add(key)
                out.append((self._with_byte_fallback(ps), sc))
        return out

    def sample_encode_as_pieces(self, text: str, alpha: float = 0.1,
                                rng=None, *, nbest_size: int = -1
                                ) -> List[str]:
        """Subword regularization (Kudo 2018): nbest_size < 0 samples
        from the full lattice (FFBS); nbest_size > 1 samples one of the
        nbest_size best segmentations with P ∝ exp(alpha·score) —
        sentencepiece SampleEncode semantics."""
        rng = random if rng is None else rng
        if nbest_size is not None and nbest_size > 1:
            options = self.nbest_encode_as_pieces(text, nbest_size)
            m = max(s for _, s in options)
            w = [math.exp(alpha * (s - m)) for _, s in options]
            r = rng.random() * sum(w)
            acc = 0.0
            for k, wk in enumerate(w):
                acc += wk
                if r <= acc:
                    return options[k][0]
            return options[-1][0]
        norm = self._normalize(text)
        pieces: List[str] = []
        for chunk, is_ud in self._split_user_defined(norm):
            if is_ud:
                pieces.append(chunk)
            else:
                pieces.extend(self._sample_segment(list(chunk), alpha,
                                                   rng))
        return self._with_byte_fallback(pieces)

    def encode(self, text: str, *, nbest_size: int = 0,
               alpha: float = 0.1, rng=None) -> List[int]:
        if nbest_size in (0, 1):
            return self.encode_as_ids(text)
        return self._pieces_to_ids(
            self.sample_encode_as_pieces(text, alpha, rng,
                                         nbest_size=nbest_size))


class _NoSampling:
    """word/char models have exactly one segmentation — sentencepiece
    reports SampleEncode/NBestEncode unavailable for them."""

    def sample_encode_as_pieces(self, *a, **k):
        raise NotImplementedError(
            "SampleEncode is not available for this model type")

    def nbest_encode_as_pieces(self, *a, **k):
        raise NotImplementedError(
            "NBestEncode is not available for this model type")

    def encode(self, text: str, *, nbest_size: int = 0, alpha: float = 0.1,
               rng=None) -> List[int]:
        if nbest_size not in (0, 1):
            raise NotImplementedError(
                "SampleEncode is not available for this model type")
        return self.encode_as_ids(text)


class SentencePieceChar(_NoSampling, SentencePieceBPE):
    """One piece per normalized character (model_type=CHAR)."""

    def encode_as_pieces(self, text: str) -> List[str]:
        return self._with_byte_fallback(list(self._normalize(text)))


class SentencePieceWord(_NoSampling, SentencePieceBPE):
    """One piece per whitespace-delimited word (model_type=WORD); each
    word carries its leading ▁ marker, as the trainer emits them."""

    def encode_as_pieces(self, text: str) -> List[str]:
        norm = self._normalize(text)
        words = [w for w in norm.split(WS) if w]
        return self._with_byte_fallback([WS + w for w in words])


_ENGINES = {UNIGRAM: SentencePieceUnigram, BPE: SentencePieceBPE,
            WORD: SentencePieceWord, CHAR: SentencePieceChar}


def load_tokenizer(model_path: str, *, prefer_native: bool = True):
    """Any SentencePiece `.model` (unigram, bpe, word or char). With
    prefer_native, the C++ engine (`native.NativeBPE`), which reads all
    four types: a failed build of the native library, or a model the
    engine cannot read, raises. Otherwise the Python engine of the
    model's type."""
    data = proto.parse_model(model_path)
    model_type = int(data.trainer.get("model_type", UNIGRAM))
    if model_type not in _ENGINES:
        raise ValueError(
            f"{model_path}: unsupported model_type={model_type} "
            f"(unigram=1, bpe=2, word=3, char=4)")
    if prefer_native:
        from early_exit_tpu_torch.tokenizer.native import NativeBPE
        return NativeBPE(model_path)
    return _ENGINES[model_type](data)


def load_decoder(model_path: str):
    """The Python engine of any model type, for decoding (no native
    library to build)."""
    return load_tokenizer(model_path, prefer_native=False)
