"""SentencePiece BPE engine in plain Python (the port's copy of
`early_exit_tpu/tokenizer/bpe.py`), and the decoding and normalization
that every model type shares (`spm.py` derives the others from it).

Reads a `.model` file's `proto.ModelData` and encodes and decodes as the
JAX package's pure-Python engine does:

- normalize: the precompiled charsmap (`charsmap.Charsmap`, e.g. the
  `nmt_nfkc` rules), then collapse whitespace runs
  (`remove_extra_whitespaces`), prepend one space (`add_dummy_prefix`),
  spaces -> "▁";
- USER_DEFINED pieces match atomically, longest first, before BPE;
- BPE: from single characters, merge the adjacent pair whose
  concatenation is a NORMAL or USER_DEFINED piece of the highest score,
  the leftmost on ties, until no pair merges; BPE-dropout
  (`sample_encode_as_pieces`) skips each merge of an agenda with
  probability alpha, drawing from the `random.Random` it is given;
- a piece that is not in the vocabulary maps to unk_id, or with
  `byte_fallback` to its UTF-8 bytes' `<0xXX>` pieces;
- decode: consecutive byte pieces form one UTF-8 run (strict: each
  invalid byte becomes U+FFFD), control ids are skipped, unk renders as
  " ⁇ ", "▁" becomes a space and the leading space is stripped.
"""

from __future__ import annotations

import heapq
import random
import re
from typing import Dict, List

from early_exit_tpu_torch.tokenizer import proto
from early_exit_tpu_torch.tokenizer.charsmap import Charsmap

WS = "▁"   # ▁

_BYTE_PIECE_RE = re.compile(r"^<0x([0-9A-Fa-f]{2})>$")


def byte_piece(b: int) -> str:
    """`<0xXX>` byte-piece name (sentencepiece ByteToPiece,
    model_interface.cc:193)."""
    return f"<0x{b:02X}>"


def piece_to_byte(piece: str) -> int:
    """Inverse of byte_piece; -1 when `piece` is not a byte piece."""
    m = _BYTE_PIECE_RE.match(piece)
    return int(m.group(1), 16) if m else -1


def _is_trail(b: int) -> bool:
    return (b & 0xC0) == 0x80


def _valid_cp(cp: int) -> bool:
    return cp < 0xD800 or (0xE000 <= cp <= 0x10FFFF)


def utf8_decode_strict(bs: bytes) -> str:
    """Decodes UTF-8 the way sentencepiece's decoder does on byte-piece
    runs (string_util DecodeUTF8, util.cc:44): strict validity incl.
    overlong/surrogate rejection; every structurally invalid byte becomes
    one U+FFFD (sentencepiece_processor.cc:845-850)."""
    out: List[str] = []
    i, n = 0, len(bs)
    while i < n:
        b0 = bs[i]
        if b0 < 0x80:
            out.append(chr(b0))
            i += 1
            continue
        if (b0 & 0xE0) == 0xC0 and i + 1 < n:
            b1 = bs[i + 1]
            cp = ((b0 & 0x1F) << 6) | (b1 & 0x3F)
            if _is_trail(b1) and cp >= 0x80 and _valid_cp(cp):
                out.append(chr(cp))
                i += 2
                continue
        if (b0 & 0xF0) == 0xE0 and i + 2 < n:
            b1, b2 = bs[i + 1], bs[i + 2]
            cp = ((b0 & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F)
            if (_is_trail(b1) and _is_trail(b2) and cp >= 0x800
                    and _valid_cp(cp)):
                out.append(chr(cp))
                i += 3
                continue
        if (b0 & 0xF8) == 0xF0 and i + 3 < n:
            b1, b2, b3 = bs[i + 1], bs[i + 2], bs[i + 3]
            cp = (((b0 & 0x07) << 18) | ((b1 & 0x3F) << 12)
                  | ((b2 & 0x3F) << 6) | (b3 & 0x3F))
            if (_is_trail(b1) and _is_trail(b2) and _is_trail(b3)
                    and cp >= 0x10000 and _valid_cp(cp)):
                out.append(chr(cp))
                i += 4
                continue
        out.append("�")
        i += 1
    return "".join(out)


class SentencePieceBPE:
    def __init__(self, model: proto.ModelData):
        self.model = model
        self.pieces = [p.piece for p in model.pieces]
        self.scores = [p.score for p in model.pieces]
        self.types = [p.type for p in model.pieces]
        self.piece_to_id: Dict[str, int] = {
            p: i for i, p in enumerate(self.pieces)}
        # mergeable vocabulary: NORMAL + USER_DEFINED pieces
        self.vocab_score: Dict[str, float] = {}
        for i, p in enumerate(model.pieces):
            if p.type in (proto.NORMAL, proto.USER_DEFINED):
                self.vocab_score[p.piece] = p.score

        def _find(ptype, default):
            for i, t in enumerate(self.types):
                if t == ptype:
                    return i
            return default

        t = model.trainer
        self.unk_id_: int = int(t.get("unk_id", _find(proto.UNKNOWN, 0)))
        self.bos_id_: int = int(t.get("bos_id", _find(proto.CONTROL, -1)))
        self.eos_id_: int = int(t.get("eos_id", -1))
        self.pad_id_: int = int(t.get("pad_id", -1))
        n = model.normalizer
        self.add_dummy_prefix = bool(n.get("add_dummy_prefix", 1))
        self.remove_extra_ws = bool(n.get("remove_extra_whitespaces", 1))
        # precompiled charsmap rules (NormalizerSpec field 2, e.g. nmt_nfkc)
        blob = n.get("precompiled_charsmap")
        self.charsmap = Charsmap(blob) if blob else None
        self.user_defined = sorted(
            (p.piece for p in model.pieces if p.type == proto.USER_DEFINED),
            key=len, reverse=True)
        # byte fallback (TrainerSpec.byte_fallback, field 35): unknown
        # surfaces encode as their UTF-8 bytes through the 256 <0xXX>
        # pieces (sentencepiece_processor.cc:576-598)
        self.byte_fallback = bool(int(t.get("byte_fallback", 0)))
        self._id_to_byte: Dict[int, int] = {}
        for i, p in enumerate(model.pieces):
            if p.type == proto.BYTE:
                b = piece_to_byte(p.piece)
                if b < 0:
                    raise ValueError(f"invalid byte piece {p.piece!r}")
                if not self.byte_fallback:
                    raise ValueError(
                        f"byte piece {p.piece!r} found although "
                        "`byte_fallback` is false")
                self._id_to_byte[i] = b
        if self.byte_fallback and len(set(
                self._id_to_byte.values())) != 256:
            raise ValueError("there are not 256 byte pieces although "
                             "`byte_fallback` is true")

    # -- SentencePieceProcessor-compatible surface ------------------------
    def get_piece_size(self) -> int:
        return len(self.pieces)

    def piece_size(self) -> int:
        return len(self.pieces)

    def bos_id(self) -> int:
        return self.bos_id_

    def eos_id(self) -> int:
        return self.eos_id_

    def pad_id(self) -> int:
        return self.pad_id_

    def unk_id(self) -> int:
        return self.unk_id_

    def id_to_piece(self, i: int) -> str:
        return self.pieces[i]

    # -- normalization ----------------------------------------------------
    def _normalize(self, text: str) -> str:
        if self.charsmap is not None:
            text = self.charsmap.normalize(text)
        if self.remove_extra_ws:
            text = " ".join(text.split())
        if self.add_dummy_prefix and text:
            text = " " + text
        return text.replace(" ", WS)

    # -- encoding ---------------------------------------------------------
    def _split_user_defined(self, text: str) -> List[tuple[str, bool]]:
        """Split into (chunk, is_user_defined) runs."""
        if not self.user_defined:
            return [(text, False)]
        out: List[tuple[str, bool]] = []
        i, n = 0, len(text)
        buf = []
        while i < n:
            matched = None
            for ud in self.user_defined:
                if text.startswith(ud, i):
                    matched = ud
                    break
            if matched is not None:
                if buf:
                    out.append(("".join(buf), False))
                    buf = []
                out.append((matched, True))
                i += len(matched)
            else:
                buf.append(text[i])
                i += 1
        if buf:
            out.append(("".join(buf), False))
        return out

    def _bpe_merge(self, chars: List[str]) -> List[str]:
        """Greedy best-pair merging by vocab score (ties -> leftmost)."""
        symbols = list(chars)
        while len(symbols) > 1:
            best_score = None
            best_i = -1
            for i in range(len(symbols) - 1):
                cand = symbols[i] + symbols[i + 1]
                s = self.vocab_score.get(cand)
                if s is not None and (best_score is None or s > best_score):
                    best_score = s
                    best_i = i
            if best_i < 0:
                break
            symbols[best_i:best_i + 2] = [symbols[best_i]
                                          + symbols[best_i + 1]]
        return symbols

    def _bpe_merge_dropout(self, chars: List[str], alpha: float,
                           rng) -> List[str]:
        """BPE-dropout merge (sentencepiece SampleEncode for BPE,
        bpe_model.cc:38-118): agenda-ordered merging — (score desc,
        leftmost first) — where each popped merge candidate is skipped
        with probability `alpha`. A skipped occurrence is only retried
        if a neighboring merge re-forms the pair."""
        n = len(chars)
        if n <= 1:
            return list(chars)
        piece = list(chars)          # piece[i] == "" -> slot i merged away
        nxt = list(range(1, n)) + [-1]
        prv = [-1] + list(range(n - 1))
        heap: List[tuple] = []

        def maybe_push(l: int, r: int):
            fused = piece[l] + piece[r]
            s = self.vocab_score.get(fused)
            if s is not None:
                heapq.heappush(heap, (-s, l, r, fused))

        for i in range(n - 1):
            maybe_push(i, i + 1)
        while heap:
            negs, l, r, fused = heapq.heappop(heap)
            if (not piece[l] or not piece[r] or nxt[l] != r
                    or piece[l] + piece[r] != fused):
                continue             # stale agenda entry
            if alpha > 0 and rng.random() < alpha:
                continue             # dropout: skip this merge
            piece[l] = fused
            piece[r] = ""
            nxt[l] = nxt[r]
            if nxt[r] >= 0:
                prv[nxt[r]] = l
            if prv[l] >= 0:
                maybe_push(prv[l], l)
            if nxt[l] >= 0:
                maybe_push(l, nxt[l])
        return [p for p in piece if p]

    def _with_byte_fallback(self, pieces: List[str]) -> List[str]:
        """Replaces would-be-unk pieces by their UTF-8 byte pieces when
        the model enables byte_fallback (the shared post-segmentation
        step of every model type, sentencepiece_processor.cc:576)."""
        if not self.byte_fallback:
            return pieces
        out: List[str] = []
        for p in pieces:
            if self.piece_to_id.get(p, self.unk_id_) != self.unk_id_:
                out.append(p)
            else:
                out.extend(byte_piece(b) for b in p.encode("utf-8"))
        return out

    def encode_as_pieces(self, text: str) -> List[str]:
        norm = self._normalize(text)
        pieces: List[str] = []
        for chunk, is_ud in self._split_user_defined(norm):
            if is_ud:
                pieces.append(chunk)
            else:
                pieces.extend(self._bpe_merge(list(chunk)))
        return self._with_byte_fallback(pieces)

    def sample_encode_as_pieces(self, text: str, alpha: float = 0.1,
                                rng=None) -> List[str]:
        """Subword regularization for BPE = BPE-dropout: each merge is
        skipped with probability alpha (sentencepiece's
        SampleEncodeAsPieces(text, nbest_size, alpha) ignores nbest_size
        for BPE and uses alpha as the dropout rate)."""
        rng = random if rng is None else rng
        norm = self._normalize(text)
        pieces: List[str] = []
        for chunk, is_ud in self._split_user_defined(norm):
            if is_ud:
                pieces.append(chunk)
            else:
                pieces.extend(
                    self._bpe_merge_dropout(list(chunk), alpha, rng))
        return self._with_byte_fallback(pieces)

    def nbest_encode_as_pieces(self, text: str, nbest: int
                               ) -> List[tuple[List[str], float]]:
        raise NotImplementedError(
            "NBestEncode is not available for BPE models "
            "(sentencepiece parity: BPEModel has no NBestEncode)")

    def encode_as_ids(self, text: str) -> List[int]:
        out = []
        for p in self.encode_as_pieces(text):
            pid = self.piece_to_id.get(p)
            out.append(self.unk_id_ if pid is None else pid)
        return out

    def _pieces_to_ids(self, pieces: List[str]) -> List[int]:
        return [self.piece_to_id.get(p, self.unk_id_) for p in pieces]

    def encode(self, text: str, *, nbest_size: int = 0,
               alpha: float = 0.1, rng=None) -> List[int]:
        """`nbest_size`/`alpha` follow the sentencepiece python API:
        nbest_size 0/1 -> deterministic encode; otherwise a sampled
        segmentation (BPE: BPE-dropout with rate alpha; unigram:
        sampled from the nbest_size best segmentations, or the full
        lattice when nbest_size < 0 — see spm.py)."""
        if nbest_size in (0, 1):
            return self.encode_as_ids(text)
        return self._pieces_to_ids(
            self.sample_encode_as_pieces(text, alpha, rng))

    # -- decoding ---------------------------------------------------------
    @staticmethod
    def _render(segments: List[tuple[str, bool]]) -> str:
        """Joins (text, is_raw) segments: ▁→space on piece text, byte-run
        decodes appended verbatim; strips the dummy-prefix space."""
        text = "".join(s if raw else s.replace(WS, " ")
                       for s, raw in segments)
        return text[1:] if text.startswith(" ") else text

    def decode_pieces(self, pieces: List[str]) -> str:
        segments: List[tuple[str, bool]] = []
        run = bytearray()

        def flush():
            if run:
                segments.append((utf8_decode_strict(bytes(run)), True))
                run.clear()

        for p in pieces:
            b = piece_to_byte(p) if self.byte_fallback else -1
            if b >= 0:
                run.append(b)
            else:
                flush()
                segments.append((p, False))
        flush()
        return self._render(segments)

    def decode(self, ids) -> str:
        # consecutive byte pieces merge into one UTF-8 byte string
        # (sentencepiece ProcessBytePieces, processor.cc:819-869)
        segments: List[tuple[str, bool]] = []
        run = bytearray()

        def flush():
            if run:
                segments.append((utf8_decode_strict(bytes(run)), True))
                run.clear()

        for i in ids:
            i = int(i)
            if not 0 <= i < len(self.pieces):
                continue
            if i in self._id_to_byte:
                run.append(self._id_to_byte[i])
                continue
            flush()
            if self.types[i] == proto.CONTROL:
                continue
            if self.types[i] == proto.UNKNOWN:
                segments.append((" ⁇ ", False))  # spm renders unk as ' ⁇ '
            else:
                segments.append((self.pieces[i], False))
        flush()
        return self._render(segments)
