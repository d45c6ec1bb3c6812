"""Time subsampling and resampling (counterpart of
`early_exit_tpu/models/subsampling.py`): the stride-2 VALID k=3
convolutions (two, x4, for the Conformer trunk; one, x2, for the
zipformer), and the U-Net's repeat-upsample and strided downsample."""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from early_exit_tpu_torch.nn import core


def conv_subsample_params(c_in: int, c_out: int, n_convs: int = 2
                          ) -> Tuple[nn.ParameterList, nn.ParameterList]:
    """The weights (3, c_in, c_out), (3, c_out, c_out), ... and biases of
    n_convs convolutions, zero (`conv_subsample_init_` draws them)."""
    ws = nn.ParameterList([nn.Parameter(torch.zeros(3, c_in if i == 0 else c_out, c_out))
                           for i in range(n_convs)])
    bs = nn.ParameterList([nn.Parameter(torch.zeros(c_out)) for _ in range(n_convs)])
    return ws, bs


def conv_subsample_init_(convs: List[Tuple[torch.Tensor, torch.Tensor]],
                         generator: torch.Generator) -> None:
    """Each (w (3, c_in, c_out), b) in place: Xavier uniform with fans
    c_in * 3 and c_out * 3, zero bias."""
    for w, b in convs:
        core.conv1d_init_(w, b, generator)


def conv_subsample_apply(convs: List[Tuple[torch.Tensor, torch.Tensor]],
                         x: torch.Tensor, *,
                         compute_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """(B, T, C) -> (B, T', d_model): stride-2 VALID k=3 convs, no
    activation. convs: [(w (3, c_in, c_out), b (c_out,)), ...]."""
    for w, b in convs:
        x = core.conv1d(x, w, b, stride=2, padding="VALID",
                        compute_dtype=compute_dtype)
    return x


def subsampled_length(lengths: torch.Tensor, n_convs: int = 2) -> torch.Tensor:
    """True frame count after VALID k=3 s=2 convs."""
    out = lengths
    for _ in range(n_convs):
        out = torch.div(out - 3, 2, rounding_mode="floor") + 1
    return out.clamp(min=0)


def reference_subsampled_length(lengths: torch.Tensor, factor: int,
                                max_t: int) -> torch.Tensor:
    """The reference's rule: float division, truncation, then at most T'."""
    return (lengths.float() / factor).to(torch.int32).clamp(max=max_t)


def up_index(length, factor: int, device=None) -> torch.Tensor:
    """The gather (length,) that repeats each frame `factor` times."""
    return torch.div(torch.arange(length, device=device), factor, rounding_mode="floor")


def down_index(length, factor: int, device=None) -> torch.Tensor:
    """The gather (ceil(length / factor),) of every `factor`-th frame."""
    return torch.arange(0, length, factor, device=device)


def upsample_to(x: torch.Tensor, factor: int, length) -> torch.Tensor:
    """Each frame of (B, T, D) repeated `factor` times over time, cut to
    `length` frames, as one gather: a capture over a symbolic length then
    needs no guard that the cut fits (length <= factor * T)."""
    return x.index_select(1, up_index(length, factor, x.device))


def downsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Every `factor`-th frame (B, T, D), from the first, as one gather: a
    strided view would make a capture over a symbolic T guard on the
    kept length being 1 where it copies the view, and a later matmul's
    view guard T's parity."""
    return x.index_select(1, down_index(x.shape[1], factor, x.device))


def pad_downsample(x: torch.Tensor, factor: int) -> Tuple[torch.Tensor, int]:
    """`downsample` of (B, T, D) zero-padded at the end to a multiple of
    `factor`, and the pad, (-T) % factor. The padding is never picked
    (every kept frame k * factor is < T), so it is not made: a capture
    over a symbolic T adds no branch or guard on T's residue."""
    return downsample(x, factor), (-x.shape[1]) % factor
