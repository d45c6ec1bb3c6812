"""FLAC reading and a minimal FLAC writer (counterpart of
`early_exit_tpu/data/flac.py`).

LibriSpeech ships FLAC. Decoding goes through the C++ decoder of `csrc/`
(`data/native.py`); the writer lays out corpora in the LibriSpeech
format for tests and the chip smoke run.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from early_exit_tpu_torch.data.native import decode_flac


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    return decode_flac(path)


def _utf8_frame_number(idx: int) -> bytes:
    """FLAC frame numbers use UTF-8-style coding of the index."""
    if idx < 0x80:
        return bytes([idx])
    out = []
    n = 1
    while idx >= (1 << (6 - n + 5 * n)) and n < 6:
        n += 1
    lead_mask = (0xFF00 >> (n + 1)) & 0xFF
    shift = 6 * n
    out.append(lead_mask | (idx >> shift))
    for k in range(n - 1, -1, -1):
        out.append(0x80 | ((idx >> (6 * k)) & 0x3F))
    return bytes(out)


def write_flac_verbatim(path: str, samples: np.ndarray,
                        sample_rate: int = 16000,
                        block_size: int = 4096) -> None:
    """A minimal FLAC file: mono, 16-bit, VERBATIM subframes, zero CRCs.
    Takes a float waveform in [-1, 1] (scaled by 32767 and truncated to
    int16) or int16 samples."""
    if samples.dtype != np.int16:
        samples = np.clip(np.asarray(samples, np.float32), -1.0, 1.0)
        samples = (samples * 32767.0).astype(np.int16)
    total = len(samples)

    def bits(value: int, n: int, acc: list) -> None:
        for i in range(n - 1, -1, -1):
            acc.append((value >> i) & 1)

    # STREAMINFO
    acc: list = []
    bits(block_size, 16, acc)
    bits(block_size, 16, acc)
    bits(0, 24, acc)
    bits(0, 24, acc)
    bits(sample_rate, 20, acc)
    bits(0, 3, acc)            # channels - 1
    bits(15, 5, acc)           # bits per sample - 1
    bits(total, 36, acc)
    bits(0, 128, acc)          # md5 (unset)
    body = bytearray()
    for i in range(0, len(acc), 8):
        b = 0
        for bit in acc[i:i + 8]:
            b = (b << 1) | bit
        body.append(b)
    chunks = [b"fLaC", bytes([0x80, 0, 0, len(body)]), bytes(body)]

    for f, start in enumerate(range(0, total, block_size)):
        blk = samples[start:start + block_size]
        bs = len(blk)
        # frame header: sync + flags (2 B), block size code 7 / rate code 0
        # (1 B), mono / 16 bits (1 B), frame number, block size - 1 (2 B,
        # big-endian), crc8 (1 B): byte-aligned, so no bit writer is needed
        hdr = (b"\xff\xf8" + bytes([0x70, 0x08]) + _utf8_frame_number(f)
               + int(bs - 1).to_bytes(2, "big") + b"\x00")
        # subframe: VERBATIM (1 B) + 16-bit big-endian samples + crc16 (2 B)
        chunks.append(hdr + b"\x02" + blk.astype(">i2").tobytes() + b"\x00\x00")
    with open(path, "wb") as fh:
        fh.write(b"".join(chunks))
