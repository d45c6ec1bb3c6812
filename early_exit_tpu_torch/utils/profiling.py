"""Profiling and timing utilities (counterpart of
`early_exit_tpu/utils/profiling.py`).

- `trace(log_dir)`: a context manager around `torch.profiler` (CPU
  activity, plus CUDA activity when a GPU is present) that writes a Chrome
  trace (`trace.json`, loadable in Perfetto or chrome://tracing) into
  log_dir when the block ends.
- `annotate(name)`: a named span, `torch.profiler.record_function`, and on
  CUDA also an NVTX range, so that it shows in the trace's timeline.
- `StepTimer`: wall-clock per-step timing with warm-up discard, reporting
  steps/sec and (for ASR) the real-time factor given the audio seconds of
  each step.

CUDA launches are asynchronous, as JAX's dispatch is: `StepTimer.stop`
reads the host clock and so times only what the caller waited for. A
caller that times device work ends each step with something that blocks
until the device is done -- a read-back to the host (`.cpu()`,
`.tolist()`, `float(...)`) or `torch.cuda.synchronize()` -- before
`stop`, as the JAX package's callers block on their results.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str = "runs/profile"):
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    with contextlib.ExitStack() as stack:
        stack.enter_context(record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


class StepTimer:
    def __init__(self, warmup_steps: int = 2):
        self.warmup = warmup_steps
        self.n = 0
        self.total = 0.0
        self.audio_seconds = 0.0
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, audio_seconds: float = 0.0):
        dt = time.perf_counter() - self._t0
        if self.n >= self.warmup:
            self.total += dt
            self.audio_seconds += audio_seconds
        self.n += 1
        return dt

    @property
    def steps_per_sec(self) -> float:
        steps = max(self.n - self.warmup, 0)
        return steps / self.total if self.total else 0.0

    @property
    def rtf_x(self) -> float:
        """Audio seconds processed per wall second (>1 = faster than RT)."""
        return self.audio_seconds / self.total if self.total else 0.0
