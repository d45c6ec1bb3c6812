"""Reader of SentencePiece `.model` files, and their decoder.

Parses the serialized ModelProto (protobuf wire format, no protobuf
runtime) for the pieces, their scores and types and the trainer and
normalizer settings (`parse_model`), and turns ids back into text
with the semantics of `early_exit_tpu/tokenizer/bpe.py::decode`:
consecutive byte pieces form one UTF-8 run, control ids are skipped,
unk renders as " ⁇ ", "▁" becomes a space and the leading space is
stripped.
"""

from __future__ import annotations

import re
import struct
from typing import Iterable, List, Tuple

# ModelProto.SentencePiece.Type
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6

WS = "▁"
_BYTE_PIECE_RE = re.compile(r"^<0x([0-9A-Fa-f]{2})>$")


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes):
    """Yields (field number, wire type, value) over one message."""
    pos, n = 0, len(buf)
    while pos < n:
        key, pos = _varint(buf, pos)
        field, wtype = key >> 3, key & 7
        if wtype == 0:
            val, pos = _varint(buf, pos)
        elif wtype == 2:
            ln, pos = _varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:
            val = struct.unpack("<f", buf[pos:pos + 4])[0]
            pos += 4
        elif wtype == 1:
            val = struct.unpack("<d", buf[pos:pos + 8])[0]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wtype} at {pos}")
        yield field, wtype, val


# TrainerSpec and NormalizerSpec field numbers (sentencepiece_model.proto)
_TRAINER = {3: "model_type", 35: "byte_fallback", 40: "unk_id", 41: "bos_id",
            42: "eos_id", 43: "pad_id"}
_NORMALIZER = {2: "precompiled_charsmap", 3: "add_dummy_prefix",
               4: "remove_extra_whitespaces"}


def parse_model(path: str):
    """(piece, score, type) for every entry of ModelProto.pieces (field 1),
    and the TrainerSpec (field 2) and NormalizerSpec (field 3) values the
    port reads, by name."""
    with open(path, "rb") as f:
        buf = f.read()
    pieces: List[Tuple[str, float, int]] = []
    trainer: dict = {}
    normalizer: dict = {}
    for field, wtype, val in _fields(buf):
        if field == 1 and wtype == 2:
            piece, score, ptype = "", 0.0, NORMAL
            for f2, _, v2 in _fields(val):
                if f2 == 1:
                    piece = v2.decode("utf-8")
                elif f2 == 2:
                    score = float(v2)
                elif f2 == 3:
                    ptype = int(v2)
            pieces.append((piece, score, ptype))
        elif field in (2, 3) and wtype == 2:
            names, out = ((_TRAINER, trainer) if field == 2
                          else (_NORMALIZER, normalizer))
            for f2, _, v2 in _fields(val):
                if f2 in names:
                    out[names[f2]] = v2
    return pieces, trainer, normalizer


def _is_trail(b: int) -> bool:
    return (b & 0xC0) == 0x80


def _valid_cp(cp: int) -> bool:
    return cp < 0xD800 or (0xE000 <= cp <= 0x10FFFF)


def utf8_decode_strict(bs: bytes) -> str:
    """UTF-8 as sentencepiece decodes byte-piece runs: strict validity,
    and every structurally invalid byte becomes one U+FFFD."""
    out: List[str] = []
    i, n = 0, len(bs)
    while i < n:
        b0 = bs[i]
        if b0 < 0x80:
            out.append(chr(b0))
            i += 1
            continue
        for lead_mask, lead, width, low in ((0xE0, 0xC0, 2, 0x80),
                                            (0xF0, 0xE0, 3, 0x800),
                                            (0xF8, 0xF0, 4, 0x10000)):
            if (b0 & lead_mask) == lead and i + width - 1 < n:
                trail = bs[i + 1:i + width]
                cp = b0 & (0x7F >> width)
                for t in trail:
                    cp = (cp << 6) | (t & 0x3F)
                if (all(_is_trail(t) for t in trail) and cp >= low
                        and _valid_cp(cp)):
                    out.append(chr(cp))
                    i += width
                    break
        else:
            out.append("�")
            i += 1
    return "".join(out)


class SentencePieceDecoder:
    def __init__(self, pieces: List[Tuple[str, int]], byte_fallback: bool):
        self.pieces = [p for p, _ in pieces]
        self.types = [t for _, t in pieces]
        self._id_to_byte = {}
        if byte_fallback:
            for i, (p, t) in enumerate(pieces):
                m = _BYTE_PIECE_RE.match(p)
                if t == BYTE and m:
                    self._id_to_byte[i] = int(m.group(1), 16)

    def get_piece_size(self) -> int:
        return len(self.pieces)

    def id_to_piece(self, i: int) -> str:
        return self.pieces[i]

    def decode(self, ids: Iterable[int]) -> str:
        segments: List[Tuple[str, bool]] = []
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
            if self.types[i] == CONTROL:
                continue
            if self.types[i] == UNKNOWN:
                segments.append((" ⁇ ", False))
            else:
                segments.append((self.pieces[i], False))
        flush()
        text = "".join(s if raw else s.replace(WS, " ")
                       for s, raw in segments)
        return text[1:] if text.startswith(" ") else text


def load_decoder(path: str) -> SentencePieceDecoder:
    pieces, trainer, _ = parse_model(path)
    return SentencePieceDecoder([(p, t) for p, _, t in pieces],
                                bool(int(trainer.get("byte_fallback", 0))))
