"""Training metrics stream and parameter count (counterparts of
`early_exit_tpu/utils/metrics.py::MetricsLogger` and
`utils/model_utils.py::count_parameters`).

`MetricsLogger` appends one JSON object per `log` call to
`<log_dir>/metrics.jsonl`: {"step", "time", <metric>: float, ...}. The
JAX package's logger also writes TensorBoard events when
`torch.utils.tensorboard` imports; the port writes the JSONL stream only.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import torch


class MetricsLogger:
    def __init__(self, log_dir: str = "runs"):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a", buffering=1)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()


def count_parameters(model: torch.nn.Module) -> int:
    """Every parameter's element count (the JAX tree's leaves)."""
    return sum(p.numel() for p in model.parameters())
