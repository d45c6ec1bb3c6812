"""Confidence-gated dynamic early exit (counterpart of
`early_exit_tpu/models/early_exit_gate.py`).

The trunk runs exit by exit and stops -- later layers are not executed --
once every item of the batch has cleared its threshold. Confidence is a
masked mean over valid frames of a per-frame statistic of the exit's CTC
posterior. The loop is batch-conservative: it goes on while any item is
below threshold, and each item keeps the log-probs of the first exit
that satisfied it. The JAX package's `lax.while_loop` is one
`torch.cond(done.all(), skip, run_exit_e, carry)` per exit in sequence,
each over its own stack and head: eagerly the predicate is read on the
host (one sync an exit, as a loop ending on `done.all()`) and only the
branch taken runs; a program captured by `torch.export` keeps both
branches and reads it at run time. The threshold may be a runtime
tensor.

Gated encoders: `early_conformer` and `splitformer`, whose first and last
exits add the parallel downsampled branch on the hidden state before
their stack (inside that exit's `run`, so later exits pay nothing). The
zipformer has a single exit: nothing to gate, the JAX package's
ValueError (`registry.require_gated`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch

from early_exit_tpu_torch.models.early_conformer import EarlyConformer
from early_exit_tpu_torch.models.registry import require_gated
from early_exit_tpu_torch.nn import core

GATED_MODEL_TYPES = ("early_conformer", "splitformer")
GATE_SCORES = ("maxprob", "margin", "negentropy")


def exit_confidence(log_probs: torch.Tensor, mask: torch.Tensor,
                    score: str = "maxprob") -> torch.Tensor:
    """(B, T', V) log-probs, (B, T') validity -> (B,) confidence in [0, 1].

    score selects the per-frame statistic, averaged over valid frames:
      maxprob    -- max posterior probability;
      margin     -- top-1 minus top-2 probability;
      negentropy -- 1 - H / log V."""
    if score == "maxprob":
        frame = torch.exp(log_probs.amax(-1))
    elif score == "margin":
        top2 = torch.topk(log_probs, 2, dim=-1).values
        frame = torch.exp(top2[..., 0]) - torch.exp(top2[..., 1])
    elif score == "negentropy":
        ent = -(torch.exp(log_probs) * log_probs).sum(-1)
        frame = 1.0 - ent / math.log(float(log_probs.shape[-1]))
    else:
        raise ValueError(f"score must be one of {GATE_SCORES}: {score!r}")
    m = mask.to(torch.float32)
    return (frame * m).sum(1) / m.sum(1).clamp_min(1.0)


def per_exit(value: Union[float, Sequence[float], None], n_exits: int):
    """A scalar or a per-exit sequence -> a list of n_exits floats."""
    if value is None:
        return None
    if hasattr(value, "__len__"):
        out = [float(v) for v in value]
        if len(out) != n_exits:
            raise ValueError(f"expected {n_exits} per-exit values, got {len(out)}")
        return out
    return [float(value)] * n_exits


def exit_thresholds(threshold, n_exits: int, device) -> torch.Tensor:
    """A scalar, a per-exit sequence, or a 0-d or (n_exits,) tensor (a
    runtime argument of an exported program) -> (n_exits,) float32."""
    if isinstance(threshold, torch.Tensor):
        return threshold.to(device=device, dtype=torch.float32).expand(n_exits)
    return torch.tensor(per_exit(threshold, n_exits), device=device)


def head_logp_conf(model: EarlyConformer, h: torch.Tensor, mask: torch.Tensor,
                   e: int, score: str, temperature: Optional[float],
                   with_conf: bool = True):
    """Exit e's head on its hidden state: float32 log-probs for decoding
    (never temperature-scaled) and the confidence of
    softmax(logits / temperature)."""
    logits = core.linear(h, model.heads_w[e], model.heads_b[e],
                         compute_dtype=model.cfg.dtype).float()
    logp = torch.log_softmax(logits, dim=-1)
    if not with_conf:
        return logp, None
    conf_lp = (logp if temperature is None else
               torch.log_softmax(logits / temperature, dim=-1))
    return logp, exit_confidence(conf_lp, mask, score)


def gate_exit(model: EarlyConformer, e: int, h: torch.Tensor, chosen_lp: torch.Tensor,
              chosen_exit: torch.Tensor, done: torch.Tensor, mask: torch.Tensor,
              thr: torch.Tensor, *, score: str, temperature: Optional[float],
              branch_ops=()):
    """Exit e (0-based) of the gate: exit e's blocks on h (B, T', D), the
    hidden state before them (and the splitformer's branch beside them at
    its branch exits, on the same h, with `branch_ops` from
    `branch_operands`), its head and confidence against thr (); the rows
    not yet done that clear it (every row at the last exit) take exit e's
    log-probs into chosen_lp (B, T', V) and e + 1 into chosen_exit (B,).
    Returns (the exit's hidden state, chosen_lp, chosen_exit, done)."""
    cfg = model.cfg
    npe = cfg.n_enc_layers_per_exit
    branches = model.branch_exits() if cfg.model_type == "splitformer" else {}
    out = model.stack(h, mask, first_layer=e * npe, n_layers=(e + 1) * npe)
    if e in branches:
        out = model.add_branch(branches[e], h, out, mask, *branch_ops)
    logp, conf = head_logp_conf(model, out, mask, e, score, temperature)
    ok = conf >= thr if e < cfg.n_enc_exits - 1 else torch.ones_like(done)
    newly = ~done & ok
    chosen_lp = torch.where(newly[:, None, None], logp, chosen_lp)
    chosen_exit = torch.where(newly, e + 1, chosen_exit).to(torch.int32)
    return out, chosen_lp, chosen_exit, done | ok


@torch.no_grad()
def gated_apply(model: EarlyConformer, feats: torch.Tensor,
                lengths: torch.Tensor, *, threshold, item_mask=None,
                score: str = "maxprob", temperatures=None):
    """Returns (log_probs (B, T', V) of each item's chosen exit,
    chosen_exit (B,) 1-based, sub_len (B,), n_exits_run () int32).

    threshold: a scalar, a per-exit sequence, or a 0-d or (E,) tensor
    (`exit_thresholds`). item_mask: optional (B,)
    0/1; rows with 0 pad the batch and count as already satisfied.
    temperatures: optional per-exit sequence; exit e's confidence is
    computed from softmax(logits / temperatures[e]), while the returned
    log-probs stay unscaled."""
    cfg = model.cfg
    require_gated(cfg)
    E = cfg.n_enc_exits
    branches = model.branch_exits() if cfg.model_type == "splitformer" else {}
    temps = per_exit(temperatures, E)
    h, sub_len, mask = model.frontend_embed(feats, lengths)
    thr = exit_thresholds(threshold, E, h.device)
    B, Tp, D = h.shape
    if item_mask is None:
        done = torch.zeros(B, dtype=torch.bool, device=h.device)
    else:
        done = torch.as_tensor(item_mask, device=h.device) < 0.5
    # the carry flat: a cond's branches must agree on their outputs'
    # strides, which a symbolic T' inside a shape would leave unprovable
    V = cfg.vocab_size
    # the branch's gathers and mask, made here: no cond branch derives a
    # size of its own
    branch_ops = model.branch_operands(Tp, lengths, sub_len) if branches else ()
    # the masks contiguous copies: the strides of a broadcast comparison
    # depend on B == 1, which the cond's capture would guard
    mask, *branch_ops = (t.clone(memory_format=torch.contiguous_format)
                         for t in (mask, *branch_ops))
    carry = (h.reshape(-1), torch.zeros(B * Tp * V, device=h.device),
             torch.zeros(B, dtype=torch.int32, device=h.device), done,
             torch.zeros((), dtype=torch.int32, device=h.device))

    def skip(*carry):
        return tuple(t.clone() for t in carry[:5])

    def run_exit(e):
        def run(h, chosen_lp, chosen_exit, done, n_run, mask, thr, *ops):
            shape = mask.shape
            h, chosen_lp, chosen_exit, done = gate_exit(
                model, e, h.view(*shape, D), chosen_lp.view(*shape, V), chosen_exit, done,
                mask, thr[e], score=score, temperature=None if temps is None else temps[e],
                branch_ops=ops)
            return (h.reshape(-1), chosen_lp.reshape(-1), chosen_exit, done, n_run + 1)
        return run

    for e in range(E):
        pred = carry[3].all()
        if not torch.compiler.is_compiling():
            pred = bool(pred)
        carry = torch.cond(pred, skip, run_exit(e), carry + (mask, thr, *branch_ops))
    _, chosen_lp, chosen_exit, _, n_run = carry
    return chosen_lp.view(B, Tp, V), chosen_exit, sub_len, n_run
