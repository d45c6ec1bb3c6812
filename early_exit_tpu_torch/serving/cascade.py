"""Two-phase cascade serving for confidence-gated early exit (counterpart
of `early_exit_tpu/serving/cascade.py`).

The gate of `models/early_exit_gate.py` is batch-conservative: one
unconfident row sends the whole batch through every remaining exit. The
cascade re-batches instead:

  Phase A (`shallow_apply`): exits 1..k on every row, at fixed cost. Rows
  whose calibrated confidence clears the per-exit threshold at some exit
  <= k are done. The layer-k*npe hidden state stays on the device.

  Re-batch (host): only the boolean accept mask crosses to the host;
  the indices of the unaccepted rows are packed into dense batches
  (`pack_escalation_indices`), and phase B gathers their hidden states
  with `index_select` on the device.

  Phase B (`continue_apply`): resumes the trunk from the cached hidden
  state for the packed rows only and runs exits k+1..E with the same
  earliest-confident-exit selection (final exit as fallback).

Per-utterance decisions are those of `gated_apply`; the computed cost is
k exits for accepted rows and E for escalated ones. `choose_k` minimises
the expected exits per utterance, k + (1 - cum_accept(k)) * (E - k).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from early_exit_tpu_torch.configs import ModelConfig
from early_exit_tpu_torch.models.early_conformer import EarlyConformer
from early_exit_tpu_torch.models.early_exit_gate import (exit_thresholds,
                                                         head_logp_conf, per_exit)
from early_exit_tpu_torch.models.registry import require_cascade
from early_exit_tpu_torch.serving.packing import pack_escalation_indices  # noqa: F401


_check_model = require_cascade      # the JAX package's name for the rule


def _check_k(cfg: ModelConfig, k: int) -> None:
    if not 1 <= k < cfg.n_enc_exits:
        raise ValueError(f"k must be in [1, {cfg.n_enc_exits - 1}]: {k}")


def _reachable(threshold, e0: int, M: int) -> List[bool]:
    """Which of exits e0..e0+M-1 can ever accept. Every confidence score
    lies in [0, 1], so a per-exit threshold above 1.0 (the calibrator
    writes 2.0 for "never accept here") makes that exit's head, softmax
    and confidence dead compute. A scalar threshold keeps every exit, and
    so does a tensor (a runtime argument of an exported program, whose
    value the program cannot know)."""
    if isinstance(threshold, torch.Tensor) or not hasattr(threshold, "__len__"):
        return [True] * M
    return [float(threshold[e0 + i]) <= 1.0 for i in range(M)]


def _exit_logp_conf(model: EarlyConformer, hidden: torch.Tensor,
                    mask: torch.Tensor, *, e0: int, score: str, temperatures,
                    reachable: Optional[List[bool]] = None):
    """hidden (M, B, T', D) of exits e0..e0+M-1 (0-based) -> (logp
    (M, B, T', V) float32, conf (M, B)). An exit marked unreachable gets
    conf = -inf, and a zero logp buffer without running its head unless it
    is the last slot, whose log-probs the caller may decode."""
    M, B, Tp, _ = hidden.shape
    if reachable is None:
        reachable = [True] * M
    temps = per_exit(temperatures, model.cfg.n_enc_exits)
    logp = torch.zeros(M, B, Tp, model.cfg.vocab_size, device=hidden.device)
    conf = torch.full((M, B), -torch.inf, device=hidden.device)
    for i in range(M):
        if not reachable[i] and i != M - 1:
            continue
        logp[i], c = head_logp_conf(
            model, hidden[i], mask, e0 + i, score,
            None if temps is None else temps[e0 + i], with_conf=reachable[i])
        if c is not None:
            conf[i] = c
    return logp, conf


def _earliest_ok(conf: torch.Tensor, thr: torch.Tensor, *, fallback_last: bool):
    """conf (M, B), thr (M,) -> (chosen_rel (B,) in 0..M-1, or M where no
    exit accepts and not fallback_last; accepted (B,))."""
    ok = conf >= thr[:, None]
    if fallback_last:
        ok[-1] = True
    accepted = ok.any(0)
    first = torch.argmax(ok.to(torch.int32), dim=0)     # the first True
    return torch.where(accepted, first, ok.shape[0]), accepted


def _select(logp: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
    """logp (M, B, T', V), rel (B,) -> (B, T', V): row b of exit rel[b]."""
    return logp[rel, torch.arange(logp.shape[1], device=logp.device)]


@torch.no_grad()
def shallow_apply(model: EarlyConformer, feats: torch.Tensor,
                  lengths: torch.Tensor, *, k: int, threshold,
                  score: str = "maxprob", temperatures=None, item_mask=None):
    """Phase A: exits 1..k at fixed cost.

    Returns (logp_sel (B, T', V): the chosen exit's log-probs for accepted
    rows, exit k's otherwise; chosen (B,) 1-based, 0 where unaccepted;
    accepted (B,) bool; sub_len (B,); h_k (B, T', D), the layer-k*npe
    hidden state to resume from).

    item_mask: rows with 0 are padding; they are reported accepted (they
    must not be escalated) with chosen = 0."""
    cfg = model.cfg
    _check_model(cfg)
    _check_k(cfg, k)
    E, npe = cfg.n_enc_exits, cfg.n_enc_layers_per_exit
    x, sub_len, mask = model.frontend_embed(feats, lengths)
    h_k, exit_h = model.stack(x, mask, n_layers=k * npe, collect_outputs=True,
                              collect_every=npe)             # (k, B, T', D)
    thr = exit_thresholds(threshold, E, x.device)
    logp, conf = _exit_logp_conf(model, exit_h, mask, e0=0, score=score,
                                 temperatures=temperatures,
                                 reachable=_reachable(threshold, 0, k))
    chosen_rel, accepted = _earliest_ok(conf, thr[:k], fallback_last=False)
    logp_sel = _select(logp, chosen_rel.clamp(max=k - 1))
    chosen = torch.where(accepted, chosen_rel + 1, 0).to(torch.int32)
    if item_mask is not None:
        pad = torch.as_tensor(item_mask, device=x.device) < 0.5
        accepted = accepted | pad
        chosen = torch.where(pad, 0, chosen).to(torch.int32)
    return logp_sel, chosen, accepted, sub_len, h_k


@torch.no_grad()
def continue_apply(model: EarlyConformer, h_k: torch.Tensor,
                   sub_len: torch.Tensor, *, k: int, threshold,
                   score: str = "maxprob", temperatures=None):
    """Phase B: resume the trunk from the layer-k*npe hidden state `h_k`
    (B', T', D; typically a packed gather of phase A's) and run exits
    k+1..E with earliest-confident selection, final exit as fallback.

    Returns (logp_sel (B', T', V), chosen (B',) 1-based absolute exit)."""
    cfg = model.cfg
    _check_model(cfg)
    _check_k(cfg, k)
    E, npe = cfg.n_enc_exits, cfg.n_enc_layers_per_exit
    Tp = h_k.shape[1]
    mask = torch.arange(Tp, device=h_k.device)[None, :] < sub_len[:, None]
    _, exit_h = model.stack(h_k, mask, first_layer=k * npe, n_layers=E * npe,
                            collect_outputs=True, collect_every=npe)
    thr = exit_thresholds(threshold, E, h_k.device)
    logp, conf = _exit_logp_conf(model, exit_h, mask, e0=k, score=score,
                                 temperatures=temperatures,
                                 reachable=_reachable(threshold, k, E - k))
    chosen_rel, _ = _earliest_ok(conf, thr[k:], fallback_last=True)
    return _select(logp, chosen_rel), (k + 1 + chosen_rel).to(torch.int32)


def choose_k(accept_shares, n_exits: int) -> int:
    """The phase-A depth that minimises the expected exits per utterance,
    cost(k) = k + (1 - cum_accept(k)) * (n_exits - k), from the
    calibration's per-exit accept shares (the share of utterances whose
    first confident exit is e). Shares past index k-1 count as
    escalations."""
    shares = list(accept_shares)[:n_exits]
    best_k, best_cost = 1, float("inf")
    for k in range(1, n_exits):
        cum = float(sum(shares[:k]))
        cost = k + (1.0 - min(cum, 1.0)) * (n_exits - k)
        if cost < best_cost:
            best_k, best_cost = k, cost
    return best_k
