"""ctypes binding of the C++ SentencePiece engine (`csrc/tokenizer/
bpe_tokenizer.cc`; the port's copy of `early_exit_tpu/tokenizer/
native.py`), over the port's own native library (`_native.get_lib()`).

The engine reads all four model types with their charsmap and byte
fallback, and encodes and decodes as the Python engines do.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List

from early_exit_tpu_torch import _native


class NativeBPE:
    """The tokenizer surface of the Python engines (deterministic encode,
    decode, pieces and special ids) over the C++ engine.

    Thread-safe: the engine never mutates the model handle while it
    encodes or decodes, and the scratch buffers the C side writes into
    are per thread (the data pipeline encodes from several loader threads
    at once; one shared buffer would garble labels when two calls, which
    release the GIL, overlap).
    """

    def __init__(self, model_path: str):
        self._lib = _native.get_lib()
        self._h = self._lib.eet_bpe_load(model_path.encode())
        if not self._h:
            raise ValueError(f"the native tokenizer cannot read {model_path} (a missing "
                             f"file, or byte pieces that byte_fallback does not allow)")
        self._tls = threading.local()

    @property
    def _buf(self):
        buf = getattr(self._tls, "buf", None)
        if buf is None:
            buf = self._tls.buf = ctypes.create_string_buffer(1 << 16)
        return buf

    @property
    def _ids(self):
        ids = getattr(self._tls, "ids", None)
        if ids is None:
            ids = self._tls.ids = (ctypes.c_int * 4096)()
        return ids

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.eet_bpe_free(self._h)

    def get_piece_size(self) -> int:
        return self._lib.eet_bpe_piece_size(self._h)

    def piece_size(self) -> int:
        return self.get_piece_size()

    def unk_id(self) -> int:
        return self._lib.eet_bpe_special(self._h, 0)

    def bos_id(self) -> int:
        return self._lib.eet_bpe_special(self._h, 1)

    def eos_id(self) -> int:
        return self._lib.eet_bpe_special(self._h, 2)

    def pad_id(self) -> int:
        return self._lib.eet_bpe_special(self._h, 3)

    def id_to_piece(self, i: int) -> str:
        n = self._lib.eet_bpe_id_to_piece(self._h, i, self._buf, len(self._buf))
        if n < 0:
            raise IndexError(i)
        return self._buf.value.decode("utf-8")

    def piece_type(self, i: int) -> int:
        return self._lib.eet_bpe_piece_type(self._h, i)

    def encode_as_ids(self, text: str) -> List[int]:
        raw = text.encode("utf-8")
        # length-delimited: an embedded NUL is legal input (it encodes
        # through <0x00> under byte fallback)
        n = self._lib.eet_bpe_encode_n(self._h, raw, len(raw), self._ids, len(self._ids))
        if n < 0:
            raise ValueError("encode overflow")
        return list(self._ids[:n])

    def encode(self, text: str) -> List[int]:
        return self.encode_as_ids(text)

    def encode_as_pieces(self, text: str) -> List[str]:
        return [self.id_to_piece(i) for i in self.encode_as_ids(text)]

    def decode(self, ids) -> str:
        ids = [int(i) for i in ids]
        arr = (ctypes.c_int * len(ids))(*ids)
        n = self._lib.eet_bpe_decode(self._h, arr, len(arr), self._buf, len(self._buf))
        if n < 0:
            raise ValueError("decode overflow")
        # raw[:n], not .value: decoded byte pieces may hold a NUL
        return self._buf.raw[:n].decode("utf-8", errors="replace")
