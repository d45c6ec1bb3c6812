"""Word error rate and the training metrics stream (counterpart of
`early_exit_tpu/utils/metrics.py`).

`edit_ops`: the word-level Levenshtein distance the tools score with (the
JAX package's `_edit_ops`). `WerAccumulator`: substitutions + insertions
+ deletions over the reference words of a corpus. `MetricsLogger` appends
one JSON object per `log` call to `<log_dir>/metrics.jsonl`: {"step",
"time", <metric>: float, ...}. The JAX package's logger also writes
TensorBoard events when `torch.utils.tensorboard` imports; the port
writes the JSONL stream only.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List

from early_exit_tpu_torch.decoding.lexicon import edit_distance


def edit_ops(ref: List[str], hyp: List[str]) -> int:
    """Levenshtein distance over word lists."""
    return edit_distance(ref, hyp)


class WerAccumulator:
    """Corpus-level WER: total errors / total reference words."""

    def __init__(self):
        self.errors = 0
        self.words = 0
        self.utterances = 0

    def add(self, reference: str, hypothesis: str) -> None:
        ref = reference.split()
        self.errors += edit_ops(ref, hypothesis.split())
        self.words += len(ref)
        self.utterances += 1

    @property
    def value(self) -> float:
        return self.errors / self.words if self.words else 0.0


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
