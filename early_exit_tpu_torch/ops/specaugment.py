"""SpecAugment masking of (B, T, F) features (counterpart of
`early_exit_tpu/ops/specaugment.py`).

Frequency masks of width U[0, W] and adaptive time masks of width
U[0, frac * valid_len], placed inside each item's valid frames; masked
cells are set to 0. `apply` draws the four uniform tensors from a
generator on the features' device; `apply_uniforms` is the deterministic
rest, which the tests feed with the uniforms the JAX package draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _keep(u_w: torch.Tensor, u_s: torch.Tensor, max_w: torch.Tensor,
          extent: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) bool: False inside any of the masks of widths floor(u_w *
    (max_w + 1)) starting at floor(u_s * max(extent - w, 1))."""
    w = torch.floor(u_w * (max_w + 1.0))
    s = torch.floor(u_s * torch.clamp(extent - w, min=1.0))
    pos = torch.arange(n, dtype=torch.float32, device=u_w.device)
    hit = (pos >= s[..., None]) & (pos < (s + w)[..., None])      # (B, K, n)
    return ~hit.any(dim=1)


def apply_uniforms(feats: torch.Tensor, feat_lengths: torch.Tensor,
                   u_fw: Optional[torch.Tensor], u_fs: Optional[torch.Tensor],
                   u_tw: Optional[torch.Tensor], u_ts: Optional[torch.Tensor], *,
                   freq_mask_width: int = 27,
                   time_mask_frac: float = 0.05) -> torch.Tensor:
    """The masking for given uniforms: u_fw, u_fs (B, n_freq_masks) and
    u_tw, u_ts (B, n_time_masks) in [0, 1), or None for no masks."""
    B, T, Fn = feats.shape
    out = feats
    if u_fw is not None:
        keep = _keep(u_fw, u_fs, torch.tensor(float(freq_mask_width), device=feats.device),
                     torch.tensor(float(Fn), device=feats.device), Fn)
        out = out * keep[:, None, :].to(out.dtype)
    if u_tw is not None:
        valid = feat_lengths.to(feats.device).float()[:, None]     # (B, 1)
        keep = _keep(u_tw, u_ts, time_mask_frac * valid, valid, T)
        out = out * keep[:, :, None].to(out.dtype)
    return out


def apply(generator: torch.Generator, feats: torch.Tensor,
          feat_lengths: torch.Tensor, *, n_freq_masks: int = 2,
          freq_mask_width: int = 27, n_time_masks: int = 2,
          time_mask_frac: float = 0.05,
          rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Masks (B, T, F) features; same shape and dtype. rows (offset,
    total): feats are rows offset.. of a global batch of `total` rows
    (a data-parallel shard); the uniforms are drawn for all of them and
    this shard keeps its own, so every shard masks as the whole batch
    would."""
    B = feats.shape[0]
    offset, total = (0, B) if rows is None else rows

    def uniform(k):
        u = torch.rand((total, k), generator=generator, device=feats.device)
        return u[offset:offset + B]

    freq = n_freq_masks > 0 and freq_mask_width > 0
    time = n_time_masks > 0 and time_mask_frac > 0.0
    u_fw, u_fs = (uniform(n_freq_masks), uniform(n_freq_masks)) if freq else (None, None)
    u_tw, u_ts = (uniform(n_time_masks), uniform(n_time_masks)) if time else (None, None)
    return apply_uniforms(feats, feat_lengths, u_fw, u_fs, u_tw, u_ts,
                          freq_mask_width=freq_mask_width,
                          time_mask_frac=time_mask_frac)
