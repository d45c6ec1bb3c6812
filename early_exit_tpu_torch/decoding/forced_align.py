"""CTC forced alignment: trellis DP and backtrack (counterpart of
`early_exit_tpu/decoding/forced_align.py`).

trellis[t+1, j] = max(trellis[t, j] + em[t, blank],
                      trellis[t, j-1] + em[t, tok[j-1]])
-- stay (emit blank) or advance (emit the next token), the reference's
`get_trellis` (util/beam_infer.py:129-149). The DP runs over frames on
the emission's device; the backtrack runs on the host.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

NEG = -1e30


@dataclasses.dataclass
class Point:
    token_index: int
    time_index: int
    score: float


def get_trellis(emission: torch.Tensor, tokens: torch.Tensor,
                blank: int = 0) -> torch.Tensor:
    """emission (T, V) log-probs, tokens (L,) -> trellis (T+1, L+1)."""
    em = torch.as_tensor(emission).float()
    tok = torch.as_tensor(tokens, device=em.device).long()
    L = tok.shape[0]
    row = torch.full((L + 1,), NEG, device=em.device)
    row[0] = 0.0
    tok_em = em[:, tok]                                # (T, L)
    rows = [row]
    head = torch.full((1,), NEG, device=em.device)
    for t in range(em.shape[0]):
        stay = row + em[t, blank]
        change = torch.cat([head, row[:-1] + tok_em[t]])
        row = torch.maximum(stay, change)
        rows.append(row)
    return torch.stack(rows)


def backtrack(trellis, emission, tokens, blank: int = 0) -> List[Point]:
    """The path from the trellis's last cell (the reference's backtrack,
    util/beam_infer.py:153-191: the cumulative score per step, and
    `changed > stayed` decides an advance), in forward time order."""
    tr = np.asarray(trellis)
    em = np.asarray(emission)
    tk = np.asarray(tokens)
    j = tr.shape[1] - 1
    path, prob = [], 0.0
    for t in range(tr.shape[0] - 1, 0, -1):
        stayed = tr[t - 1, j] + em[t - 1, blank]
        changed = tr[t - 1, j - 1] + em[t - 1, tk[j - 1]]
        prob = prob + float(em[t - 1, tk[j - 1] if changed > stayed else blank])
        path.append(Point(j - 1, t - 1, prob))
        if changed > stayed:
            j -= 1
            if j == 0:
                break
    return path[::-1]


def forced_align(emission, tokens, blank: int = 0):
    """Per-token frames: (starts (L,), ends (L,), the best path's score).
    starts[j] is the frame that emits token j; ends[j] the last frame
    before the path advances to token j+1 (blank frames belong to the
    token emitted last), so a held token gets its whole span."""
    em = torch.as_tensor(emission).float()
    tk = torch.as_tensor(tokens).long()
    L = int(tk.shape[0])
    tr = get_trellis(em, tk, blank).cpu().numpy()
    em_h, tk_h = em.cpu().numpy(), tk.cpu().numpy()
    starts = np.full((L,), -1, np.int64)
    ends = np.full((L,), -1, np.int64)
    for p in backtrack(tr, em_h, tk_h, blank):
        if starts[p.token_index] < 0:
            starts[p.token_index] = p.time_index
        ends[p.token_index] = p.time_index
    return starts, ends, float(tr[-1, -1])
