"""Warm the card for every batch shape the pipeline can produce
(counterpart of `tools/warm_cache.py`).

    python -m early_exit_tpu_torch.warm_cache --decoder_mode ctc
        [--max_seconds 18] [--batches 8,16] [<train CLI flags>]

The JAX tool fills XLA's persistent compile cache; the port compiles
nothing per shape, and has no such cache. What a first call of a shape
costs here is the kernels' and the native library's build, the caching
allocator's first blocks and cuBLAS's and cuDNN's handles and algorithm
choices. This tool:
  - builds the CUDA kernels (`ops/kernels`, nvcc, in parallel) and the
    native library (`_native`, g++) up front;
  - for every (batch bucket, frame bucket) of `data/bucketing.py` up to
    --max_seconds (the batch buckets from --batch_size and
    --n_batch_split, or --batches), runs the train step once and the
    eval forward once, twice each, on zero features;
  - prints each bucket's first and second call in seconds.
The model and train flags are the train CLI's (`cli.get_args`); --device
defaults to cuda.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from early_exit_tpu_torch import runtime
from early_exit_tpu_torch.data import bucketing


def buckets(max_seconds, audio_cfg, batch_size, n_batch_split, batches=""):
    """The (batch bucket, frame bucket) pairs, each once, in the order
    they are warmed, and the label bucket of each frame bucket."""
    max_frames = int(max_seconds * audio_cfg.sample_rate / audio_cfg.hop_length) + 1
    frames = sorted({bucketing.bucket_frames(t) for t in range(100, max_frames + 100, 100)})
    if batches:
        sizes = [int(b) for b in batches.split(",")]
    else:
        per_split = max(batch_size // n_batch_split, 1)
        sizes = sorted({bucketing.bucket_batch_size(n) for n in
                        (per_split // 2, per_split, per_split * 2, batch_size)})
    labels = [bucketing.bucket_labels(n) for n in (16, 64, 128)]
    return [(nb, tf, labels[min(tf // 700, len(labels) - 1)]) for nb in sizes for tf in frames]


def build_native(device) -> float:
    """Builds the kernels (on CUDA) and the native library; seconds."""
    from early_exit_tpu_torch import _native
    from early_exit_tpu_torch.ops.kernels import KERNEL_SOURCES, _build
    t0 = time.perf_counter()
    if device.type == "cuda":
        _build.build_all(KERNEL_SOURCES)
    _native.build()
    return time.perf_counter() - t0


def main(argv=None):
    from early_exit_tpu_torch.cli import get_args
    from early_exit_tpu_torch.models.registry import build_model
    from early_exit_tpu_torch.training.trainer import Trainer

    argv = sys.argv[1:] if argv is None else argv
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--max_seconds", type=float, default=18.0)
    extra.add_argument("--batches", type=str, default="",
                       help="comma-separated batch buckets (default: those "
                            "reachable from --batch_size)")
    ex, rest = extra.parse_known_args(argv)
    args, model_cfg, train_cfg, audio_cfg, _ = get_args(rest)
    dev = runtime.resolve_device(args.device)
    print(f"built the kernels and the native library in {build_native(dev):.1f} s")
    model = build_model(model_cfg).init(torch.Generator().manual_seed(args.seed)).to(dev)
    trainer = Trainer(model, train_cfg, warmup=1000)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    visited = []
    for nb, tf, lb in buckets(ex.max_seconds, audio_cfg, args.batch_size,
                              args.n_batch_split, ex.batches):
        batch = {"feats": torch.zeros(nb, tf, model_cfg.n_mels, device=dev),
                 "feat_lengths": torch.full((nb,), tf, dtype=torch.int32, device=dev),
                 "labels": torch.full((nb, lb), model_cfg.bos_id, dtype=torch.int32,
                                      device=dev),
                 "label_lengths": torch.full((nb,), min(4, lb), dtype=torch.int32,
                                             device=dev),
                 "item_mask": torch.ones(nb, device=dev)}
        secs = []
        for _ in range(2):
            t0 = time.perf_counter()
            float(trainer.step(batch)["loss"])
            with torch.no_grad():
                model.eval()
                model.apply(batch["feats"], batch["feat_lengths"])
                model.train()
            sync()
            secs.append(time.perf_counter() - t0)
        visited.append((nb, tf, lb))
        print(f"warmed B={nb} T={tf} L={lb}: first call {secs[0]:.3f} s, "
              f"second {secs[1]:.3f} s")
    print(f"done: {len(visited)} shape combinations warmed")
    return visited


if __name__ == "__main__":
    main()
