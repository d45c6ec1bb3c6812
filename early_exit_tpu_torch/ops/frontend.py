"""Audio frontend: STFT power spectrogram -> mel filterbank.

Counterpart of `early_exit_tpu/ops/frontend.py`: centred reflect
padding, periodic Hann window of win_length centred in an n_fft of
2*cfg.n_fft (the reference quirk), power 2, HTK mel filterbank, no log.
`method="dft"` is the windowed real DFT cropped to the window's 320
samples, as two float32 matrix products; `method="fft"` is an rfft.
The products stay float32 (`runtime.exact_float32` keeps TF32 out on
the card): the features are raw power with a huge dynamic range.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from early_exit_tpu_torch.configs import AudioConfig


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int,
                   f_min: float = 0.0, f_max: Optional[float] = None
                   ) -> np.ndarray:
    """(n_freqs, n_mels) triangular HTK filterbank, no norm."""
    if f_max is None:
        f_max = sample_rate / 2.0
    freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    f_diff = np.diff(hz_pts)
    slopes = hz_pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def hann_window(win_length: int, n_fft: int) -> np.ndarray:
    """Periodic Hann of win_length, zero-padded centred to n_fft."""
    n = np.arange(win_length)
    w = 0.5 * (1.0 - np.cos(2.0 * math.pi * n / win_length))
    left = (n_fft - win_length) // 2
    out = np.zeros(n_fft, np.float64)
    out[left:left + win_length] = w
    return out.astype(np.float32)


def _windowed_dft(n_fft: int, win_length: int, device) -> tuple:
    """(win_length, n_fft//2+1) cosine and sine bases with the Hann window
    folded in, cropped to the window's support. The angle is reduced
    mod n_fft in exact integer arithmetic before the float conversion."""
    left = (n_fft - win_length) // 2
    j = torch.arange(win_length, dtype=torch.int64, device=device)[:, None]
    k = torch.arange(n_fft // 2 + 1, dtype=torch.int64, device=device)[None, :]
    phase = ((j + left) * k) % n_fft
    ang = (-2.0 * math.pi / n_fft) * phase.to(torch.float32)
    n = np.arange(win_length)
    w = 0.5 * (1.0 - np.cos(2.0 * math.pi * n / win_length))
    w = torch.as_tensor(w.astype(np.float32), device=device)[:, None]
    return torch.cos(ang) * w, torch.sin(ang) * w


def _frames(wav: torch.Tensor, n_fft: int, hop_length: int,
            width: Optional[int] = None) -> torch.Tensor:
    """Centred STFT frames (B, T, width); width (default n_fft) crops each
    frame to its centred width-wide span."""
    pad = n_fft // 2
    x = F.pad(wav[:, None, :], (pad, pad), mode="reflect")[:, 0]
    n_frames = 1 + wav.shape[1] // hop_length
    width = n_fft if width is None else width
    offset = (n_fft - width) // 2
    # the first n_frames as a gather, not a slice: a capture over a
    # symbolic length cannot always show that n_frames fits the unfolded
    # count, and some torch versions then give the slice a size of its own
    first = torch.arange(n_frames, device=wav.device)
    return x[:, offset:].unfold(1, width, hop_length).index_select(1, first)


def spectrogram(wav: torch.Tensor, *, n_fft: int, win_length: int,
                hop_length: int, method: str = "fft") -> torch.Tensor:
    """(B, N) waveform -> (B, T, n_fft//2+1) float32 power spectrogram."""
    wav = wav.float()
    if method == "fft":
        frames = _frames(wav, n_fft, hop_length)
        frames = frames * torch.as_tensor(hann_window(win_length, n_fft),
                                          device=wav.device)
        spec = torch.fft.rfft(frames, dim=-1)
        return spec.real ** 2 + spec.imag ** 2
    if method != "dft":
        raise ValueError(f"unknown mel method {method!r}")
    frames = _frames(wav, n_fft, hop_length, width=win_length)
    cos, sin = _windowed_dft(n_fft, win_length, wav.device)
    re = torch.matmul(frames, cos)
    im = torch.matmul(frames, sin)
    return re * re + im * im


def mel_spectrogram(wav: torch.Tensor, cfg: AudioConfig, *,
                    log_compress: bool = False,
                    method: str = "fft") -> torch.Tensor:
    """(B, N) waveform -> (B, T, n_mels) float32 features."""
    n_fft = cfg.n_fft * 2
    spec = spectrogram(wav, n_fft=n_fft, win_length=cfg.win_length,
                       hop_length=cfg.hop_length, method=method)
    fb = torch.as_tensor(mel_filterbank(n_fft // 2 + 1, cfg.n_mels,
                                        cfg.sample_rate), device=wav.device)
    mel = torch.matmul(spec, fb)
    if log_compress:
        mel = torch.log(mel + 1e-6)
    return mel


def mel_lengths(sample_counts: torch.Tensor, hop_length: int) -> torch.Tensor:
    """Valid mel-frame count per item (centred STFT)."""
    return 1 + sample_counts // hop_length
