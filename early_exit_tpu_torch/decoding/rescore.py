"""Joint CTC + attention rescoring of the AED beam's n-best (counterpart
of `early_exit_tpu/decoding/rescore.py`).

The reference left this path commented out (util/beam_infer.py:309-383);
the JAX package completed it, and the port keeps its arithmetic:
- each hypothesis's CTC score is the exact log-marginal log p(y|x) of the
  exit's CTC emission (`ops/ctc.py::ctc_neg_log_likelihood`), divided by
  the hypothesis length; all B x K lanes of one exit go through one
  recursion of T' steps. An infeasible hypothesis scores about -1e30, a
  finite number, so a batch whose lanes are all infeasible still mixes
  to finite values;
- both score vectors go to probability space normalised by their max over
  the lanes, exp(s - max s), and mix as w * s_ctc + (1 - w) * s_attention;
  the best lane is the first of the highest mixes.
The hypotheses keep their leading BOS and trailing EOS: the CTC heads
are trained with them in the targets.
"""

from __future__ import annotations

import torch

from early_exit_tpu_torch.ops.ctc import ctc_neg_log_likelihood


def ctc_lane_scores(ctc_log_probs: torch.Tensor, n_frames, tokens: torch.Tensor,
                    lengths: torch.Tensor, *, blank: int = 0) -> torch.Tensor:
    """Length-normalised CTC log-likelihoods of B x K hypotheses.

    ctc_log_probs: (B, T, V) log-softmax emissions; n_frames: (B,) valid
    frames; tokens: (B, K, L) padded ids (BOS/EOS included); lengths:
    (B, K). Returns (B, K) log p(y|x) / max(|y|, 1)."""
    B, K, L = tokens.shape
    T, V = ctc_log_probs.shape[1:]
    lp = ctc_log_probs[:, None].expand(B, K, T, V).reshape(B * K, T, V)
    nf = torch.as_tensor(n_frames, device=lp.device).reshape(B, 1).expand(B, K)
    nll = ctc_neg_log_likelihood(lp, nf.reshape(-1), tokens.reshape(B * K, L),
                                 lengths.reshape(-1), blank=blank)
    return -nll.reshape(B, K) / lengths.clamp_min(1).to(nll.dtype)


def joint_rescore(aed_scores: torch.Tensor, ctc_scores: torch.Tensor,
                  ctc_weight: float):
    """(..., K) attention and CTC scores -> (best lane (...), mixed
    scores (..., K)): w * exp(s_ctc - max) + (1 - w) * exp(s_aed - max)."""
    sp = torch.exp(aed_scores - aed_scores.amax(-1, keepdim=True))
    sc = torch.exp(ctc_scores - ctc_scores.amax(-1, keepdim=True))
    s = ctc_weight * sc + (1.0 - ctc_weight) * sp
    return s.argmax(dim=-1), s


def rescore_batch(ctc_log_probs: torch.Tensor, n_frames, tokens: torch.Tensor,
                  lengths: torch.Tensor, aed_scores: torch.Tensor, *,
                  ctc_weight: float, blank: int = 0):
    """The beam's output of one exit (`beam_search_exit_batch`'s shapes)
    and that exit's CTC emissions (B, T, V) -> (best (B,), mixed (B, K),
    CTC lane scores (B, K))."""
    ctc_s = ctc_lane_scores(ctc_log_probs, n_frames, tokens, lengths, blank=blank)
    best, s = joint_rescore(aed_scores, ctc_s, ctc_weight)
    return best, s, ctc_s
