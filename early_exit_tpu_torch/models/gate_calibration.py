"""Gate calibration, inference part (counterpart of
`early_exit_tpu/models/gate_calibration.py::scaled_confidence`). The
fitting functions (temperature, threshold, ECE) are not ported."""

from __future__ import annotations

import torch

from early_exit_tpu_torch.models.early_exit_gate import exit_confidence


def scaled_confidence(log_probs: torch.Tensor, mask: torch.Tensor,
                      score: str, temperature: float) -> torch.Tensor:
    """Confidence after temperature scaling. Scaling normalized log-probs
    equals scaling the logits: softmax((z - c) / T) = softmax(z / T) for
    any per-frame constant c."""
    lp = torch.log_softmax(log_probs / temperature, dim=-1)
    return exit_confidence(lp, mask, score)
