"""CTC loss and greedy CTC decoding (counterpart of
`early_exit_tpu/ops/ctc.py`).

`ctc_loss` is `torch.nn.functional.ctc_loss` (one call; a Python loop
over ~250-400 frames would cost thousands of launches a step) with the
input lengths clamped to >= 1, which gives the JAX package's values: its
recursion always counts frame 0, so an input length of 0 scores as 1.
`zero_infinity` zeroes the infeasible rows and their gradients.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

def ctc_loss(log_probs: torch.Tensor, input_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor, *,
             blank: int = 0, reduction: str = "mean",
             zero_infinity: bool = True) -> torch.Tensor:
    """torch.nn.CTCLoss-compatible loss of (B, T, V) log-probs. reduction
    "none" gives (B,); "mean" divides each row by its label length and
    means over the batch; "sum"."""
    nll = F.ctc_loss(log_probs.float().transpose(0, 1), labels.long(),
                     input_lengths.long().clamp_min(1), label_lengths.long(),
                     blank=blank, reduction="none", zero_infinity=zero_infinity)
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    return (nll / label_lengths.clamp_min(1).float()).mean()


def greedy_decode(log_probs: torch.Tensor, lengths: torch.Tensor, *,
                  blank: int = 0):
    """Best path: argmax -> collapse repeats -> drop blanks.

    log_probs: (B, T, V) log-probs or raw logits (the argmax is
    softmax-invariant); lengths: (B,). Returns (tokens (B, T) padded
    with `blank`, n_tokens (B,))."""
    best = torch.argmax(log_probs, dim=-1)
    return greedy_decode_ids(best, lengths, blank=blank)


def greedy_decode_ids(best: torch.Tensor, lengths: torch.Tensor, *,
                      blank: int = 0):
    """greedy_decode from per-frame argmax ids (B, T); only frames
    t < lengths count. A stable compaction by scatter."""
    B, T = best.shape
    t_idx = torch.arange(T, device=best.device)[None, :]
    valid = t_idx < lengths.to(best.device)[:, None]
    prev = torch.cat([torch.full((B, 1), -1, dtype=best.dtype,
                                 device=best.device), best[:, :-1]], dim=1)
    keep = (best != blank) & (best != prev) & valid
    # the running count of kept frames as a product with the (T, T)
    # upper-triangular ones, exact (0/1 operands, float32 sums far below
    # 2^24, TF32 or not): AOTInductor (torch 2.11) cannot generate the
    # split scan it compiles a cumsum over a few rows into
    upto = (t_idx.T <= t_idx).to(torch.float32)                # (T, T)
    pos = torch.matmul(keep.to(torch.float32), upto).to(torch.int64) - 1
    n_tokens = keep.sum(dim=1)
    # discarded frames land in a spare column T, cut off below
    dest = torch.where(keep, pos, torch.full_like(pos, T))
    out = torch.full((B, T + 1), blank, dtype=best.dtype, device=best.device)
    out.scatter_(1, dest, torch.where(keep, best, torch.full_like(best, blank)))
    return out[:, :T], n_tokens
