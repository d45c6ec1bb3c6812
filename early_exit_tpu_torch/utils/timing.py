"""Device time of a callable, for the measuring tools."""

from __future__ import annotations

import time

import torch


def device_ms(fn, device, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of one `fn()` on `device`. On CUDA: CUDA events
    around `iters` calls queued back to back after `warmup` calls, so the
    host's dispatch overlaps the device's work as in a serving loop; on
    the CPU the wall clock."""
    for _ in range(warmup):
        fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
