"""CTC loss, the CTC log-likelihood recursion, the AED cross-entropy and
greedy CTC decoding (counterpart of `early_exit_tpu/ops/ctc.py`).

`ctc_loss` is `torch.nn.functional.ctc_loss` (one call; a Python loop
over ~250-400 frames would cost thousands of launches a step) with the
input lengths clamped to >= 1, which gives the JAX package's values: its
recursion always counts frame 0, so an input length of 0 scores as 1.
`zero_infinity` zeroes the infeasible rows and their gradients.

`ctc_neg_log_likelihood` is the JAX package's log-semiring recursion
itself, one vectorised step a frame, for the joint rescoring of AED
hypotheses: a hypothesis may hold the blank id (which `F.ctc_loss` leaves
undefined), and an infeasible alignment must score the JAX package's
finite ~1e30, not inf.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

# the recursion's log zero: finite, so that an infeasible row stays finite
NEG = -1e30


def ctc_neg_log_likelihood(log_probs: torch.Tensor, input_lengths: torch.Tensor,
                           labels: torch.Tensor, label_lengths: torch.Tensor,
                           blank: int = 0) -> torch.Tensor:
    """Per-row CTC negative log-likelihood by the forward recursion over the
    blank-interleaved label states, in float32.

    log_probs: (N, T, V) log-softmax outputs; input_lengths: (N,) valid
    frames (<= T; frame 0 always counts); labels: (N, L) padded ids (any
    id, blank included); label_lengths: (N,). Returns (N,): ~1e30 where
    the alignment is infeasible."""
    N, T, V = log_probs.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = log_probs.device
    z = torch.full((N, S), blank, dtype=torch.long, device=dev)
    z[:, 1::2] = labels.long()
    lp_z = log_probs.float().gather(2, z[:, None, :].expand(N, T, S))   # (N, T, S)
    z_prev2 = torch.cat([torch.full((N, 2), blank, dtype=torch.long, device=dev),
                         z[:, :-2]], dim=1)
    can_skip = (z != blank) & (z != z_prev2)
    can_skip[:, :2] = False
    neg = torch.full((N, S), NEG, device=dev)
    has_label = label_lengths.to(dev) > 0
    alpha = neg.clone()
    alpha[:, 0] = lp_z[:, 0, 0]
    alpha[:, 1] = torch.where(has_label, lp_z[:, 0, 1], neg[:, 1])
    active = torch.arange(T, device=dev)[:, None] < input_lengths.to(dev)[None, :]
    for t in range(1, T):
        move = torch.cat([neg[:, :1], alpha[:, :-1]], dim=1)
        skip = torch.where(can_skip, torch.cat([neg[:, :2], alpha[:, :-2]], dim=1), neg)
        new = torch.logaddexp(torch.logaddexp(alpha, move), skip) + lp_z[:, t]
        alpha = torch.where(active[t][:, None], new, alpha)
    ll = label_lengths.to(dev).long()
    a_last = alpha.gather(1, (2 * ll - 1).clamp(0, S - 1)[:, None])[:, 0]
    a_blank = alpha.gather(1, (2 * ll).clamp(0, S - 1)[:, None])[:, 0]
    return -torch.where(has_label, torch.logaddexp(a_last, a_blank), a_blank)

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


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, *,
                  ignore_index: Optional[int] = None) -> torch.Tensor:
    """torch.nn.CrossEntropyLoss's mean of (..., V) raw logits against
    (...) ids, in float32. ignore_index=None counts every position, pad
    included, as the reference's AED loss does."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    if ignore_index is None:
        return nll.mean()
    mask = (targets != ignore_index).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


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
    # the previous frame's id (-1 before the first) as a gather: a slice
    # of T - 1 frames would make a capture over a symbolic T guard on
    # T - 1 == 1
    prev = best.index_select(1, (t_idx[0] - 1).clamp(min=0))
    prev = torch.where(t_idx > 0, prev, torch.full_like(prev, -1))
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
    # contiguous: a later reshape of the strided cut would make a capture
    # over a symbolic batch guard on B == 1
    return out[:, :T].clone(memory_format=torch.contiguous_format), n_tokens
