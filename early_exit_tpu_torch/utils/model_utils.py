"""Parameter count (counterpart of
`early_exit_tpu/utils/model_utils.py::count_parameters`)."""

from __future__ import annotations

import torch


def count_parameters(model: torch.nn.Module) -> int:
    """Every parameter's element count (the JAX tree's leaves)."""
    return sum(p.numel() for p in model.parameters())
