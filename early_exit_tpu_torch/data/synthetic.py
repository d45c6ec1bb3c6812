"""Deterministic synthetic corpus shaped like LibriSpeech.

A copy of `early_exit_tpu/data/librispeech.py::SyntheticDataset` with the
same seeds and the same numpy `RandomState` draws, so the port and the
JAX package see identical requests. Each character is an 80 ms tone at
a character-specific frequency plus noise; the knobs (speaker warp,
duration and amplitude jitter, per-utterance noise spread) are the
flagship's training distribution (`assets/flagship_calib.json`,
"bench_eval").
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

_WORDS = ("THE OF AND TO A IN THAT IS WAS HE FOR IT WITH AS HIS ON BE AT "
          "BY I THIS HAD NOT ARE BUT FROM OR HAVE AN THEY WHICH ONE YOU "
          "WERE HER ALL SHE THERE WOULD THEIR WE HIM BEEN HAS WHEN WHO "
          "WILL MORE NO IF OUT SO SAID WHAT UP ITS ABOUT INTO THAN THEM "
          "CAN ONLY OTHER NEW SOME COULD TIME THESE TWO MAY THEN DO FIRST "
          "ANY MY NOW SUCH LIKE OUR OVER MAN ME EVEN MOST MADE AFTER ALSO "
          "DID MANY BEFORE MUST THROUGH BACK YEARS WHERE MUCH YOUR WAY "
          "WELL DOWN SHOULD BECAUSE EACH JUST THOSE PEOPLE").split()


@dataclasses.dataclass
class Utterance:
    waveform: np.ndarray          # float32 (n_samples,), in [-1, 1]
    sample_rate: int
    transcript: str
    speaker_id: str = "0"
    chapter_id: str = "0"
    utterance_id: str = ""
    # the white-noise sigma a synthetic utterance was drawn with; 0.0 for
    # a disk corpus
    noise_sigma: float = 0.0


class SyntheticDataset:
    CHAR_MS = 80.0

    def __init__(self, n_items: int = 64, sample_rate: int = 16000,
                 seed: int = 0, min_words: int = 2, max_words: int = 12,
                 noise: float = 0.02, speaker_warp: float = 0.0,
                 dur_jitter: float = 0.0, amp_jitter: float = 0.0,
                 noise_hi: float | None = None):
        self.n_items = n_items
        self.sample_rate = sample_rate
        self.seed = seed
        self.min_words = min_words
        self.max_words = max_words
        self.noise = noise
        self.speaker_warp = speaker_warp
        self.dur_jitter = dur_jitter
        self.amp_jitter = amp_jitter
        self.noise_hi = noise_hi

    def __len__(self) -> int:
        return self.n_items

    @staticmethod
    def _char_freq(c: str) -> float:
        if c == " ":
            return 120.0
        if c == "'":
            return 150.0
        return 400.0 + 110.0 * (ord(c.lower()) - ord("a"))  # 400..3150 Hz

    def _plan(self, i: int):
        """(generator, text, warp, [(samples, amplitude)] a character): the
        draws before the waveform's, the generator left after them."""
        rng = np.random.RandomState(self.seed * 100003 + i)
        n_words = rng.randint(self.min_words, self.max_words + 1)
        words = [_WORDS[rng.randint(len(_WORDS))] for _ in range(n_words)]
        text = " ".join(words)
        base_seg = self.CHAR_MS / 1000.0 * self.sample_rate
        alpha = 1.0 + (rng.uniform(-self.speaker_warp, self.speaker_warp)
                       if self.speaker_warp else 0.0)
        segs = []
        for _ in text:
            dur = base_seg * (1.0 + (rng.uniform(-self.dur_jitter,
                                                 self.dur_jitter)
                                     if self.dur_jitter else 0.0))
            amp = 0.2 * (1.0 + (rng.uniform(-self.amp_jitter,
                                            self.amp_jitter)
                                if self.amp_jitter else 0.0))
            segs.append((max(int(dur), 1), amp))
        return rng, text, alpha, segs

    def meta(self, i: int) -> Tuple[int, str]:
        """(sample count, transcript) of item i, without its waveform."""
        _, text, _, segs = self._plan(i)
        return sum(n for n, _ in segs), text

    def __getitem__(self, i: int) -> Utterance:
        rng, text, alpha, plan = self._plan(i)
        segs = []
        for c, (seg, amp) in zip(text, plan):
            f = self._char_freq(c) * alpha
            t = np.arange(seg) / self.sample_rate
            segs.append(amp * np.sin(2 * np.pi * f * t))
        wav = np.concatenate(segs).astype(np.float32)
        sigma = (rng.uniform(self.noise, self.noise_hi)
                 if self.noise_hi and self.noise_hi > self.noise
                 else self.noise)
        wav += sigma * rng.randn(len(wav)).astype(np.float32)
        return Utterance(wav.astype(np.float32), self.sample_rate, text,
                         "0", "0", f"synth-{i}", noise_sigma=float(sigma))


def synth_batch(knobs: dict, n: int, seed: int):
    """n utterances drawn with the calib file's `bench_eval` knobs, padded
    into one (n, N) float32 array -> (wav, sample_counts, transcripts)."""
    ds = SyntheticDataset(n_items=n, seed=seed,
                          min_words=knobs.get("min_words", 18),
                          max_words=knobs.get("max_words", 22),
                          noise=knobs.get("noise", 0.02),
                          noise_hi=knobs.get("noise_hi"),
                          speaker_warp=knobs.get("speaker_warp", 0.0),
                          dur_jitter=knobs.get("dur_jitter", 0.0),
                          amp_jitter=knobs.get("amp_jitter", 0.0))
    utts = [ds[i] for i in range(n)]
    wav = np.zeros((n, max(len(u.waveform) for u in utts)), np.float32)
    counts = np.zeros((n,), np.int64)
    for i, u in enumerate(utts):
        wav[i, :len(u.waveform)] = u.waveform
        counts[i] = len(u.waveform)
    return wav, counts, [u.transcript for u in utts]
