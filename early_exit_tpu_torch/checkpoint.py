"""Reader and writer of the flax-msgpack checkpoints of the JAX package.

`early_exit_tpu/training/checkpoint.py` writes `{"params", "model_state"}`
with `flax.serialization.to_bytes`: a msgpack map whose array leaves are
msgpack ext type 1, each payload itself msgpack `(shape, dtype name, raw
C-order bytes)`; numpy scalars are ext type 3 with the same payload. Python lists were saved as maps keyed "0", "1", ...

The decoder is pure Python (no `msgpack` package): it reads only what
flax writes -- maps, arrays, strings, bytes, ints, floats, nil/bools and
ext -- and returns nested dicts of CPU tensors (bf16 leaves are read as
int16 and viewed as `torch.bfloat16`). The encoder (`packb`,
`save_tree`) writes what `flax.serialization.to_bytes` writes for the
JAX package's host trees, byte for byte: maps with sorted string keys,
lists as maps keyed "0", "1", ..., every tensor or numpy array as ext
type 1, with msgpack's shortest encodings; `save_tree` writes atomically
(a temporary file, then a rename).
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import tempfile

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


def _pack_uint(out: bytearray, n: int, fix_max: int, fix_base: int, codes) -> None:
    """A length or count: the fixed form up to fix_max, else the shortest
    of the 8/16/32-bit forms whose codes are given (None: no 8-bit form)."""
    if n <= fix_max:
        out.append(fix_base | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} too large")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif v > 0:
        for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                 (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2 ** 64 - 1)):
            if v <= limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
    else:
        for code, fmt, limit in ((0xD0, ">b", 2 ** 7), (0xD1, ">h", 2 ** 15),
                                 (0xD2, ">i", 2 ** 31), (0xD3, ">q", 2 ** 63)):
            if v >= -limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return


def _pack_str(out: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    _pack_uint(out, len(b), 31, 0xA0, (0xD9, 0xDA, 0xDB))
    out += b


def _ndarray_payload(shape, dtype_name: str, raw: bytes) -> bytes:
    p = bytearray([0x93])                       # [shape, dtype name, bytes]
    _pack_uint(p, len(shape), 15, 0x90, (None, 0xDC, 0xDD))
    for n in shape:
        _pack_int(p, int(n))
    _pack_str(p, dtype_name)
    _pack_uint(p, len(raw), -1, 0, (0xC4, 0xC5, 0xC6))
    p += raw
    return bytes(p)


def _pack_array(out: bytearray, a) -> None:
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            raw, name = t.view(torch.int16).numpy().tobytes(), "bfloat16"
        else:
            n = t.numpy()
            raw, name = n.tobytes(), n.dtype.name
        shape = tuple(t.shape)
    else:
        n = np.asarray(a)
        raw, name, shape = n.tobytes(order="C"), n.dtype.name, n.shape
    payload = _ndarray_payload(shape, name, raw)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(payload) in fixext:
        out.append(fixext[len(payload)])
    else:
        _pack_uint(out, len(payload), -1, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", _EXT_NDARRAY)
    out += payload


def _pack(out: bytearray, obj) -> None:
    if isinstance(obj, (list, tuple)):
        obj = {str(i): v for i, v in enumerate(obj)}
    if isinstance(obj, dict):
        _pack_uint(out, len(obj), 15, 0x80, (None, 0xDE, 0xDF))
        for k in sorted(obj, key=str):
            _pack_str(out, str(k))
            _pack(out, obj[k])
    elif isinstance(obj, (torch.Tensor, np.ndarray, np.generic)):
        _pack_array(out, np.asarray(obj) if isinstance(obj, np.generic) else obj)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__} into a checkpoint")


def packb(tree) -> bytes:
    """Nested dicts/lists of tensors or numpy arrays -> flax-msgpack bytes."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


def save_tree(tree, path: str) -> None:
    """Atomic write: a temporary file in the same directory, then a rename."""
    data = packb(tree)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


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
