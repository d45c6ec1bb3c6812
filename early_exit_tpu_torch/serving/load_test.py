"""StreamPool load test: churn and the latency distribution (the
counterpart of the JAX package's `tools/pool_load_test.py`).

Drives a `StreamPool` at serving geometry with ragged streams joining
and leaving continuously, and reports the per-poll-round latency
(p50/p90/p99), the chunk throughput and, gated, the share of chunks
that stayed at the fast exit.

    python -m early_exit_tpu_torch.serving.load_test --streams 16 --rounds 60
    python -m early_exit_tpu_torch.serving.load_test --gated --exit_threshold 0.85
    python -m early_exit_tpu_torch.serving.load_test --smoke --device cpu

Runs on CUDA unless --device cpu, and raises without a GPU otherwise.
One poll round is one batched dispatch for every stream with a ready
chunk (two for the gated pool when a row escalates), so a round's
latency is the serving budget per chunk_s of audio per stream.
`run_rounds` is the round loop on any built pool (the flagship's, say,
whose widths the flags below cannot describe).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from early_exit_tpu_torch import runtime
from early_exit_tpu_torch.configs import AudioConfig, ModelConfig
from early_exit_tpu_torch.models.early_conformer import EarlyConformer
from early_exit_tpu_torch.serving.streaming import StreamPool


def run_rounds(pool: StreamPool, *, rounds: int, chunk_s: float, draw, new_len,
               sample_rate: int = 16000) -> dict:
    """Warm the pool up, feed one round untimed, then `rounds` timed
    rounds: chunk_s of audio (`draw(n)`) to every stream, one poll, and
    each stream whose audio ran out (`new_len()` samples long) finished
    and its slot recycled. Returns the load test's JSON fields."""
    S = len(pool.recs)
    chunk_n = int(chunk_s * sample_rate)
    remaining = [new_len() for _ in range(S)]
    churned = 0
    pool.warmup()
    for i in range(S):
        pool.feed(i, draw(chunk_n))
    pool.poll()

    lat, chunks = [], 0
    t_start = time.perf_counter()
    for _ in range(rounds):
        for i in range(S):
            n = min(chunk_n, remaining[i])
            pool.feed(i, draw(n))
            remaining[i] -= n
        t0 = time.perf_counter()
        pool.poll()
        lat.append(time.perf_counter() - t0)
        chunks += S
        for i in range(S):
            if remaining[i] <= 0:          # a stream leaves, a new one joins
                pool.finish(i)
                pool.reset(i)
                remaining[i] = new_len()
                churned += 1
    wall = time.perf_counter() - t_start

    lat_ms = np.asarray(sorted(lat)) * 1e3
    r0 = pool.recs[0]
    result = {
        "streams": S, "rounds": rounds,
        "gated": r0.exit_threshold is not None, "churned_streams": churned,
        "round_ms_p50": round(float(np.percentile(lat_ms, 50)), 2),
        "round_ms_p90": round(float(np.percentile(lat_ms, 90)), 2),
        "round_ms_p99": round(float(np.percentile(lat_ms, 99)), 2),
        "chunks_per_s": round(chunks / wall, 1),
        "audio_x_realtime": round(chunks * chunk_s / wall, 1),
    }
    if r0.exit_threshold is not None:
        exits = [e for rec in pool.recs for e in rec.exits_run]
        if exits:
            result["fast_exit_rate"] = round(
                float(np.mean(np.asarray(exits) == r0.fast_exit)), 3)
    return result


def audio_source(kind: str, rng: np.random.RandomState):
    """draw(n): n samples of white noise, or of the synthetic tone corpus
    (in distribution for a checkpoint trained on it), cut or padded."""
    if kind != "synthetic":
        return lambda n: 0.1 * rng.randn(n).astype(np.float32)
    from early_exit_tpu_torch.data.synthetic import SyntheticDataset
    ds = SyntheticDataset(n_items=256, seed=99, min_words=4, max_words=20)
    bank = [ds[i].waveform for i in range(len(ds))]
    bank_i = [0]

    def draw(n):
        w = bank[bank_i[0] % len(bank)]
        bank_i[0] += 1
        return w[:n] if len(w) >= n else np.pad(w, (0, n - len(w)))
    return draw


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--chunk_s", type=float, default=1.0)
    ap.add_argument("--left_s", type=float, default=3.0)
    ap.add_argument("--right_s", type=float, default=0.5)
    ap.add_argument("--gated", action="store_true")
    ap.add_argument("--exit_threshold", type=float, default=0.85)
    ap.add_argument("--d_model", type=int, default=256)
    ap.add_argument("--n_exits", type=int, default=6)
    ap.add_argument("--n_layers", type=int, default=2)
    ap.add_argument("--load_model_path", default=None,
                    help="optional trained checkpoint (else random init)")
    ap.add_argument("--audio", default="noise", choices=["noise", "synthetic"],
                    help="synthetic = tone-corpus utterances, so a trained "
                         "checkpoint's gate sees in-distribution audio")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny dims / few rounds")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.smoke:
        args.streams, args.rounds = 4, 6
        args.d_model, args.n_exits, args.n_layers = 32, 2, 1
        args.chunk_s, args.left_s, args.right_s = 0.3, 0.6, 0.2
    device = runtime.resolve_device(args.device)
    if device.type == "cuda":
        runtime.exact_float32()

    cfg = ModelConfig(d_model=args.d_model, n_heads=max(4, args.d_model // 32),
                      d_feed_forward=4 * args.d_model, n_enc_exits=args.n_exits,
                      n_enc_layers_per_exit=args.n_layers,
                      depthwise_kernel_size=7 if args.smoke else 31)
    acfg = AudioConfig()
    model = EarlyConformer(cfg).to(device)
    model.init(torch.Generator(device=device).manual_seed(0))
    if args.load_model_path:
        from early_exit_tpu_torch.training import checkpoint
        checkpoint.load_model_file(model, args.load_model_path)
    model.eval().requires_grad_(False)

    kw = dict(chunk_s=args.chunk_s, left_s=args.left_s, right_s=args.right_s)
    if args.gated:
        kw.update(exit_threshold=args.exit_threshold, fast_exit=1)
    pool = StreamPool(args.streams, model, acfg, **kw)

    rng = np.random.RandomState(0)
    sr = acfg.sample_rate

    def new_len():
        # ragged stream lengths: 2..14 s (0.5..1.5 s in smoke mode, so
        # that streams churn within the few smoke rounds)
        if args.smoke:
            return int((0.5 + 1.0 * rng.rand()) * sr)
        return int((2.0 + 12.0 * rng.rand()) * sr)

    result = run_rounds(pool, rounds=args.rounds, chunk_s=args.chunk_s,
                        draw=audio_source(args.audio, rng), new_len=new_len,
                        sample_rate=sr)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
