"""ctypes binding of the C++ lexicon snapper (counterpart of
`early_exit_tpu/decoding/native.py`)."""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence

from early_exit_tpu_torch import _native


class NativeLexicon:
    def __init__(self, entries: Sequence[str]):
        self._lib = _native.get_lib()
        self._h = self._lib.eet_lex_create()
        for w in entries:
            self._lib.eet_lex_add(self._h, w.encode("utf-8"))
        # scratch per thread: `closest` may run from concurrent threads, and
        # the C call releases the GIL while it writes here
        self._tls = threading.local()

    @property
    def _buf(self):
        buf = getattr(self._tls, "buf", None)
        if buf is None:
            buf = self._tls.buf = ctypes.create_string_buffer(1 << 12)
        return buf

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.eet_lex_free(self._h)
        except Exception:
            pass

    def contains(self, word: str) -> bool:
        return bool(self._lib.eet_lex_contains(self._h, word.encode("utf-8")))

    def closest(self, word: str) -> str:
        d = self._lib.eet_lex_closest(self._h, word.encode("utf-8"),
                                      self._buf, len(self._buf))
        if d < 0:
            raise RuntimeError("empty lexicon")
        return self._buf.value.decode("utf-8")
