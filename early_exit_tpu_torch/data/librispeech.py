"""LibriSpeech reader (counterpart of
`early_exit_tpu/data/librispeech.py`).

Reads the standard on-disk layout:

    <root>/LibriSpeech/<split>/<speaker>/<chapter>/
        <speaker>-<chapter>-<utt>.flac        (audio)
        <speaker>-<chapter>.trans.txt         (transcripts)

Audio is decoded lazily: WAV through the standard library, FLAC through
the C++ decoder of `csrc/` (`data/flac.py`). Utterances are listed split
by split, then by speaker, chapter and file name in sorted order, the
JAX package's order. The synthetic corpus is `data/synthetic.py`'s.
"""

from __future__ import annotations

import os
import wave
from typing import List, Tuple

import numpy as np

from early_exit_tpu_torch.data.synthetic import SyntheticDataset, Utterance

__all__ = ["LibriSpeechDataset", "SyntheticDataset", "Utterance", "read_audio"]


def _read_wav(path: str) -> Tuple[np.ndarray, int]:
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        channels = w.getnchannels()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported wav sample width {width}")
    if channels > 1:
        x = x.reshape(-1, 2).mean(axis=1)
    return x, sr


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    if path.endswith(".wav"):
        return _read_wav(path)
    if path.endswith(".flac"):
        from early_exit_tpu_torch.data.flac import read_flac
        return read_flac(path)
    raise ValueError(f"unsupported audio format: {path}")


def audio_samples(path: str) -> int:
    """The sample count `read_audio` returns, from the file's header
    (FLAC's STREAMINFO, WAV's frame count); a FLAC stream that leaves the
    count unset (0) is decoded."""
    if path.endswith(".wav"):
        with wave.open(path, "rb") as w:
            return w.getnframes()
    with open(path, "rb") as f:
        head = f.read(26)
    # "fLaC", a STREAMINFO block header, then rate 20 bits, channels 3,
    # bits per sample 5 and the total samples 36 in bytes 18..25
    if len(head) == 26 and head[:4] == b"fLaC" and head[4] & 0x7F == 0:
        total = int.from_bytes(head[18:26], "big") & ((1 << 36) - 1)
        if total:
            return total
    return len(read_audio(path)[0])


class LibriSpeechDataset:
    """Index of one or more LibriSpeech splits (`url` may list several,
    comma-separated, indexed in that order); audio is decoded lazily."""

    def __init__(self, root: str, url: str = "train-clean-100"):
        names = [u.strip() for u in url.split(",") if u.strip()]
        if not names:
            raise ValueError("empty LibriSpeech split list")
        self.items: List[Tuple[str, str, str, str, str]] = []
        self._bases: List[str] = []
        for name in names:
            self._index_split(root, name)
        self.base = self._bases[0]

    @property
    def bases(self) -> List[str]:
        """Base directory of every indexed split, in `url` order."""
        return list(self._bases)

    def _index_split(self, root: str, url: str) -> None:
        base = os.path.join(root, "LibriSpeech", url)
        if not os.path.isdir(base):
            base = os.path.join(root, url)
        if not os.path.isdir(base):
            raise FileNotFoundError(f"no LibriSpeech split at {base}")
        self._bases.append(base)
        for speaker in sorted(os.listdir(base)):
            sdir = os.path.join(base, speaker)
            if not os.path.isdir(sdir):
                continue
            for chapter in sorted(os.listdir(sdir)):
                cdir = os.path.join(sdir, chapter)
                if not os.path.isdir(cdir):
                    continue
                trans = os.path.join(cdir, f"{speaker}-{chapter}.trans.txt")
                texts = {}
                if os.path.exists(trans):
                    with open(trans, encoding="utf-8") as f:
                        for line in f:
                            utt_id, _, text = line.partition(" ")
                            texts[utt_id] = text.strip()
                for name in sorted(os.listdir(cdir)):
                    stem, ext = os.path.splitext(name)
                    if ext in (".flac", ".wav") and stem in texts:
                        self.items.append((os.path.join(cdir, name), texts[stem],
                                           speaker, chapter, stem))

    def __len__(self) -> int:
        return len(self.items)

    def meta(self, i: int) -> Tuple[int, str]:
        """(sample count, transcript) of item i from the audio's header."""
        return audio_samples(self.items[i][0]), self.items[i][1]

    def __getitem__(self, i: int) -> Utterance:
        path, text, speaker, chapter, utt = self.items[i]
        wav, sr = read_audio(path)
        return Utterance(wav, sr, text, speaker, chapter, utt)
