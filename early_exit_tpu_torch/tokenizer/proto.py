"""Reader and writer of SentencePiece `.model` files (the port's copy of
`early_exit_tpu/tokenizer/proto.py`).

Reads the serialized ModelProto in the protobuf wire format (no protobuf
runtime, no generated code): the pieces with their scores and types,
and the TrainerSpec and NormalizerSpec values the engines use, the
NormalizerSpec's `precompiled_charsmap` kept as raw bytes
(`parse_model` -> `ModelData`). `serialize_model` writes the same
fields back, so that `parse_model` of its output returns its input.

Wire format: each field is a varint key (field_number << 3 | wire_type);
wire types used by ModelProto: 0 = varint, 2 = length-delimited,
5 = 32-bit (float).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Tuple

# SentencePiece piece types (ModelProto.SentencePiece.Type)
NORMAL = 1
UNKNOWN = 2
CONTROL = 3
USER_DEFINED = 4
UNUSED = 5
BYTE = 6


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def iter_fields(buf: bytes):
    """Yields (field_number, wire_type, value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wtype = key >> 3, key & 7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 2:
            ln, pos = _read_varint(buf, pos)
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


@dataclasses.dataclass
class SentencePieceEntry:
    piece: str
    score: float
    type: int = NORMAL


@dataclasses.dataclass
class ModelData:
    pieces: List[SentencePieceEntry]
    trainer: Dict[str, object]
    normalizer: Dict[str, object]


def _parse_piece(buf: bytes) -> SentencePieceEntry:
    piece, score, ptype = "", 0.0, NORMAL
    for field, _, val in iter_fields(buf):
        if field == 1:
            piece = val.decode("utf-8")
        elif field == 2:
            score = float(val)
        elif field == 3:
            ptype = int(val)
    return SentencePieceEntry(piece, score, ptype)


# TrainerSpec field numbers we care about
_TRAINER_FIELDS = {3: "model_type", 4: "vocab_size", 35: "byte_fallback",
                   40: "unk_id", 41: "bos_id", 42: "eos_id", 43: "pad_id"}
# NormalizerSpec field numbers
_NORM_FIELDS = {1: "name", 2: "precompiled_charsmap", 3: "add_dummy_prefix",
                4: "remove_extra_whitespaces", 5: "escape_whitespaces"}
# length-delimited fields that must stay raw bytes (never utf-8 decoded)
_BYTES_FIELDS = {"precompiled_charsmap"}


def _parse_spec(buf: bytes, mapping) -> Dict[str, object]:
    out = {}
    for field, wtype, val in iter_fields(buf):
        if field in mapping:
            if isinstance(val, bytes) and mapping[field] not in _BYTES_FIELDS:
                try:
                    val = val.decode("utf-8")
                except UnicodeDecodeError:
                    pass
            out[mapping[field]] = val
    return out


def _write_varint(out: bytearray, v: int) -> None:
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _write_field(out: bytearray, field: int, wtype: int, val) -> None:
    _write_varint(out, field << 3 | wtype)
    if wtype == 0:
        _write_varint(out, int(val) & 0xFFFFFFFFFFFFFFFF)
    elif wtype == 2:
        data = val.encode("utf-8") if isinstance(val, str) else bytes(val)
        _write_varint(out, len(data))
        out += data
    elif wtype == 5:
        out += struct.pack("<f", float(val))
    else:
        raise ValueError(wtype)


_TRAINER_FIELDS_INV = {v: k for k, v in _TRAINER_FIELDS.items()}
_NORM_FIELDS_INV = {v: k for k, v in _NORM_FIELDS.items()}


def serialize_model(pieces: List[SentencePieceEntry],
                    trainer: Dict[str, object],
                    normalizer: Dict[str, object]) -> bytes:
    """Serializes a ModelProto our readers (and SentencePiece) can load.
    Inverse of parse_model for the fields the framework uses."""
    out = bytearray()
    for p in pieces:
        sub = bytearray()
        _write_field(sub, 1, 2, p.piece)
        _write_field(sub, 2, 5, p.score)
        if p.type != NORMAL:
            _write_field(sub, 3, 0, p.type)
        _write_field(out, 1, 2, bytes(sub))
    sub = bytearray()
    for name, val in trainer.items():
        _write_field(sub, _TRAINER_FIELDS_INV[name], 0, int(val))
    _write_field(out, 2, 2, bytes(sub))
    sub = bytearray()
    for name, val in normalizer.items():
        field = _NORM_FIELDS_INV[name]
        if isinstance(val, (str, bytes)):
            _write_field(sub, field, 2, val)
        else:
            _write_field(sub, field, 0, int(val))
    _write_field(out, 3, 2, bytes(sub))
    return bytes(out)


def parse_model(path: str) -> ModelData:
    with open(path, "rb") as f:
        buf = f.read()
    pieces: List[SentencePieceEntry] = []
    trainer: Dict[str, object] = {}
    normalizer: Dict[str, object] = {}
    for field, wtype, val in iter_fields(buf):
        if field == 1 and wtype == 2:           # repeated SentencePiece
            pieces.append(_parse_piece(val))
        elif field == 2 and wtype == 2:         # TrainerSpec
            trainer = _parse_spec(val, _TRAINER_FIELDS)
        elif field == 3 and wtype == 2:         # NormalizerSpec
            normalizer = _parse_spec(val, _NORM_FIELDS)
    return ModelData(pieces, trainer, normalizer)
