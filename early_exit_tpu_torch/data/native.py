"""ctypes binding of the C++ FLAC decoder (counterpart of
`early_exit_tpu/data/native.py`)."""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from early_exit_tpu_torch import _native


def decode_flac(path: str) -> Tuple[np.ndarray, int]:
    """(waveform float32 in [-1, 1], sample rate): the 16-bit samples over
    32768; several channels are averaged to mono."""
    lib = _native.get_lib()
    h = lib.eet_flac_decode(path.encode())
    if not h:
        raise ValueError(f"failed to decode FLAC: {path}")
    try:
        n = lib.eet_flac_num_samples(h)
        sr = lib.eet_flac_sample_rate(h)
        ch = lib.eet_flac_channels(h)
        buf = np.empty(n, np.int32)
        lib.eet_flac_copy(h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    finally:
        lib.eet_flac_free(h)
    x = buf.astype(np.float32) / 32768.0
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr
