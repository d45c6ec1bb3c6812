"""Reader for the flax-msgpack checkpoints of the JAX package.

`early_exit_tpu/training/checkpoint.py` writes `{"params", "model_state"}`
with `flax.serialization.to_bytes`: a msgpack map whose array leaves are
msgpack ext type 1, each payload itself msgpack `(shape, dtype name, raw
C-order bytes)`; numpy scalars are ext type 3 with the same payload. Python lists were saved as maps keyed "0", "1", ...

The decoder is pure Python (no `msgpack` package): it reads only what
flax writes -- maps, arrays, strings, bytes, ints, floats, nil/bools and
ext -- and returns nested dicts of CPU tensors (bf16 leaves are read as
int16 and viewed as `torch.bfloat16`).
"""

from __future__ import annotations

import hashlib
import json
import os
import struct

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_CKPT = os.path.join(REPO, "assets", "flagship_ckpt")
FLAGSHIP_CALIB = os.path.join(REPO, "assets", "flagship_calib.json")

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        fixed = {
            0xC0: lambda: None, 0xC2: lambda: False, 0xC3: lambda: True,
            0xC4: lambda: bytes(self.take(self.unpack(">B"))),
            0xC5: lambda: bytes(self.take(self.unpack(">H"))),
            0xC6: lambda: bytes(self.take(self.unpack(">I"))),
            0xC7: lambda: self._ext(self.unpack(">B")),
            0xC8: lambda: self._ext(self.unpack(">H")),
            0xC9: lambda: self._ext(self.unpack(">I")),
            0xCA: lambda: self.unpack(">f"),
            0xCB: lambda: self.unpack(">d"),
            0xCC: lambda: self.unpack(">B"),
            0xCD: lambda: self.unpack(">H"),
            0xCE: lambda: self.unpack(">I"),
            0xCF: lambda: self.unpack(">Q"),
            0xD0: lambda: self.unpack(">b"),
            0xD1: lambda: self.unpack(">h"),
            0xD2: lambda: self.unpack(">i"),
            0xD3: lambda: self.unpack(">q"),
            0xD4: lambda: self._ext(1),
            0xD5: lambda: self._ext(2),
            0xD6: lambda: self._ext(4),
            0xD7: lambda: self._ext(8),
            0xD8: lambda: self._ext(16),
            0xD9: lambda: str(self.take(self.unpack(">B")), "utf-8"),
            0xDA: lambda: str(self.take(self.unpack(">H")), "utf-8"),
            0xDB: lambda: str(self.take(self.unpack(">I")), "utf-8"),
            0xDC: lambda: [self.obj() for _ in range(self.unpack(">H"))],
            0xDD: lambda: [self.obj() for _ in range(self.unpack(">I"))],
            0xDE: lambda: self._map(self.unpack(">H")),
            0xDF: lambda: self._map(self.unpack(">I")),
        }
        if b not in fixed:
            raise ValueError(f"unsupported msgpack byte 0x{b:02x}")
        return fixed[b]()

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def _ext(self, n: int):
        code = self.unpack(">b")
        payload = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, raw = _Reader(payload).obj()
        if dtype == "bfloat16":
            t = torch.frombuffer(bytearray(raw), dtype=torch.int16)
            return t.view(torch.bfloat16).reshape(shape)
        return torch.from_numpy(
            np.frombuffer(raw, np.dtype(dtype)).copy()).reshape(shape)


def unpackb(data: bytes):
    """msgpack bytes (as flax writes them) -> nested dicts of tensors."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def load_tree(path: str) -> dict:
    with open(path, "rb") as f:
        return unpackb(f.read())


def to_torch(a) -> torch.Tensor:
    """A tensor, or a numpy leaf (an ml_dtypes bfloat16 array or a plain
    numpy array) -> CPU tensor of the same dtype and bits."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        u = np.ascontiguousarray(a).view(np.uint16)
        return torch.from_numpy(u.astype(np.int16, copy=True)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def load_calib(path: str = FLAGSHIP_CALIB) -> dict:
    with open(path) as f:
        return json.load(f)


def bound_tokenizer(calib: dict, repo: str = REPO) -> str:
    """The tokenizer the flagship was trained with, as named in its calib
    file, after checking its sha256 against the recorded one."""
    rel = calib.get("tokenizer")
    if not rel:
        raise RuntimeError("flagship_calib.json names no tokenizer")
    path = rel if os.path.isabs(rel) else os.path.join(repo, rel)
    if not os.path.exists(path):
        raise FileNotFoundError(f"flagship tokenizer binding missing: {rel}")
    want = calib.get("tokenizer_sha256")
    if want:
        with open(path, "rb") as f:
            got = hashlib.sha256(f.read()).hexdigest()
        if got != want:
            raise RuntimeError(
                f"flagship tokenizer content mismatch: {path} sha256 "
                f"{got[:12]}... != the recorded {want[:12]}...")
    return path
