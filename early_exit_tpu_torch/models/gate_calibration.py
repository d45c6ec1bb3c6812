"""Gate calibration: per-exit temperatures and thresholds fitted on
held-out data (counterpart of `early_exit_tpu/models/gate_calibration.py`).

`scaled_confidence` is the inference part, on the device. The fitting
functions are host-side numpy, as in the JAX package (calibration is a
one-off, not a hot path):

  * `fit_temperature`: per exit, the grid temperature minimizing the NLL
    of utterance-correctness under the scaled confidence (Guo et al.
    2017); `ece` scores the result;
  * `fit_sequential_thresholds`: exits cut in gate order so that the
    SIMULATED gated corpus WER stays within the target (per-exit
    accepted-set constraints, `pick_threshold`, do not compose);
  * `simulate_gate`: the gate's rule on the host, first exit whose
    confidence clears its threshold, the last exit as the fallback.

`python -m early_exit_tpu_torch.calibrate_gate` drives this end to end
and writes the JSON that `--gate_calibration` reads.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from early_exit_tpu_torch.models.early_exit_gate import exit_confidence

_grid = np.geomspace(0.25, 8.0, 21)
_grid[np.argmin(np.abs(_grid - 1.0))] = 1.0     # exact identity point
DEFAULT_TEMP_GRID = tuple(float(t) for t in _grid)


def scaled_confidence(log_probs: torch.Tensor, mask: torch.Tensor,
                      score: str, temperature: float) -> torch.Tensor:
    """Confidence after temperature scaling. Scaling normalized log-probs
    equals scaling the logits: softmax((z - c) / T) = softmax(z / T) for
    any per-frame constant c."""
    lp = torch.log_softmax(log_probs / temperature, dim=-1)
    return exit_confidence(lp, mask, score)


def ece(conf: np.ndarray, correct: np.ndarray, n_bins: int = 10) -> float:
    """Expected calibration error of P(utterance correct | confidence)."""
    conf = np.asarray(conf, np.float64)
    correct = np.asarray(correct, np.float64)
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    out = 0.0
    for lo, hi in zip(edges[:-1], edges[1:]):
        in_bin = (conf >= lo) & (conf < hi if hi < 1.0 else conf <= hi)
        if in_bin.any():
            out += (in_bin.sum() / len(conf)) * abs(conf[in_bin].mean()
                                                    - correct[in_bin].mean())
    return float(out)


def fit_temperature(conf_by_temp: np.ndarray, temps: Sequence[float],
                    correct: np.ndarray) -> int:
    """conf_by_temp (K, N): each utterance's confidence at each grid
    temperature; correct (N,) 0/1. The index of the grid temperature
    minimizing the binary NLL of correctness (confidence is monotone in
    T, so a grid is exact enough)."""
    conf = np.clip(np.asarray(conf_by_temp, np.float64), 1e-6, 1 - 1e-6)
    correct = np.asarray(correct, np.float64)[None, :]
    nll = -(correct * np.log(conf) + (1 - correct) * np.log1p(-conf)).mean(axis=1)
    return int(np.argmin(nll))


def _widest_prefix(ok: np.ndarray, sorted_conf: np.ndarray) -> int:
    """The longest prefix k with ok[k-1] that does not cut inside a tie:
    every utterance with conf >= the threshold must be accepted, so the
    prefix ends at a strict confidence drop. 0 if none."""
    n = len(sorted_conf)
    best = 0
    for k in np.flatnonzero(ok) + 1:
        if k < n and sorted_conf[k] == sorted_conf[k - 1]:
            continue
        best = max(best, int(k))
    return best


def pick_threshold(conf: np.ndarray, errors: np.ndarray,
                   words: np.ndarray, target_wer: float):
    """The smallest threshold whose accepted set {conf >= thr} has corpus
    WER (sum errors / sum words) <= target_wer, maximizing acceptance.
    Returns (threshold, accept_rate, accepted_wer); (2.0, 0.0, nan),
    unreachable, when even the most confident utterance misses it."""
    conf = np.asarray(conf, np.float64)
    errors = np.asarray(errors, np.float64)
    words = np.asarray(words, np.float64)
    order = np.argsort(-conf)                     # most confident first
    cum_err = np.cumsum(errors[order])
    cum_wrd = np.maximum(np.cumsum(words[order]), 1.0)
    best = _widest_prefix((cum_err / cum_wrd) <= target_wer + 1e-12, conf[order])
    if best == 0:
        return 2.0, 0.0, float("nan")
    return (float(conf[order[best - 1]]), best / len(conf),
            float(cum_err[best - 1] / cum_wrd[best - 1]))


def fit_sequential_thresholds(conf: np.ndarray, errors: np.ndarray,
                              words: np.ndarray, target_wer: float):
    """Per-exit thresholds under which the SIMULATED gated corpus WER on
    this set is <= target_wer. Exits are walked in gate order keeping
    "errors committed so far + the final exit's errors on everything not
    yet accepted <= target": exit e's threshold is the loosest cut of the
    remaining utterances that keeps it (2.0 where none does). conf,
    errors: (E, N); words: (N,). The last exit's threshold is 0.0."""
    conf = np.asarray(conf, np.float64)
    errors = np.asarray(errors, np.float64)
    words = np.asarray(words, np.float64)
    E, N = conf.shape
    budget = target_wer * max(float(words.sum()), 1.0) + 1e-9   # allowed errors
    committed = 0.0
    remaining = np.ones(N, bool)
    thresholds = []
    for e in range(E - 1):
        idx = np.flatnonzero(remaining)
        order = idx[np.argsort(-conf[e, idx])]
        # accepting the prefix k: committed + errors here on it + the
        # final exit's errors on the rest
        rest_final = errors[E - 1, idx].sum()
        ok = (committed + np.cumsum(errors[e, order])
              + (rest_final - np.cumsum(errors[E - 1, order])) <= budget)
        best = _widest_prefix(ok, conf[e, order])
        if best == 0:
            thresholds.append(2.0)
            continue
        thresholds.append(float(conf[e, order[best - 1]]))
        accepted = order[:best]
        committed += errors[e, accepted].sum()
        remaining[accepted] = False
    thresholds.append(0.0)                        # the final exit accepts
    return thresholds


def simulate_gate(conf: np.ndarray, thresholds: Sequence[float],
                  errors: np.ndarray, words: np.ndarray):
    """conf, errors: (E, N); words: (N,). Each utterance stops at the
    first exit with conf >= its threshold (the last exit always accepts).
    Returns (mean_exit, gated_wer, each utterance's chosen exit 1-based)."""
    conf = np.asarray(conf, np.float64)
    E, N = conf.shape
    accept = conf >= np.asarray(thresholds, np.float64).reshape(E, 1)
    accept[-1, :] = True
    chosen = np.argmax(accept, axis=0)            # the first True
    err = np.asarray(errors, np.float64)[chosen, np.arange(N)]
    w = max(float(np.sum(words)), 1.0)
    return float(chosen.mean() + 1.0), float(err.sum() / w), chosen + 1
