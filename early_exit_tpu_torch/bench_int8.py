"""Measure the W8A8 int8 inference path against bf16 on the card
(counterpart of `tools/bench_int8.py`).

    python -m early_exit_tpu_torch.bench_int8 [B ...] [--device cuda]
        [--mm 32768x256x2048] [--seconds 10] [--iters 50]
        [--weights flagship]

1. the product rates at the FFN's shape: torch.matmul in bf16 and
   torch._int_mm (int8 -> int32), the library calls that stand where the
   JAX package's XLA products stood, beside the port's own products at
   the same shape, `block_gemm` (bf16, the block's wgmma + TMA kernel)
   and `block_gemm_s8` (its int8 instantiation, with the rescale);
2. the serving forward (DFT mel -> 12 blocks -> heads -> the last exit's
   greedy decode) at each B (default 128, then 64) x --seconds: bf16
   unfused, bf16 fused (the block kernel), int8 unfused (W8A8 in
   PyTorch), int8 fused (the W8A8 block kernel), on B synthetic
   requests, each line in ms a call (CUDA events) and audio seconds
   served a second, with its last-exit tokens' disagreement against the
   bf16 unfused leg's.
"""

from __future__ import annotations

import argparse
import json

import torch

from early_exit_tpu_torch import runtime
from early_exit_tpu_torch.ablate_head_path import requests, serving_model
from early_exit_tpu_torch.ops import ctc, frontend
from early_exit_tpu_torch.ops.kernels import conformer_block as kcb
from early_exit_tpu_torch.ops.kernels import launch_counts
from early_exit_tpu_torch.utils.timing import device_ms

LEGS = {"bf16 unfused": dict(fused_block=False),
        "bf16 fused": dict(fused_block=True),
        "int8 unfused": dict(fused_block=False, quantize="int8"),
        "int8 fused": dict(fused_block=True, quantize="int8")}


def leg_matmul(device, M, K, N, iters, out=print):
    """The four products' ms at (M, K, N); returns {name: ms}."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(M, K, generator=gen).to(torch.bfloat16).to(device)
    w = torch.randn(K, N, generator=gen).to(torch.bfloat16).to(device)
    xq = x.float().round().clamp(-127, 127).to(torch.int8)
    wq = w.float().round().clamp(-127, 127).to(torch.int8)
    wt = wq.t().contiguous()
    bias_bf, bias_f = torch.zeros(N, dtype=torch.bfloat16, device=device), \
        torch.zeros(N, device=device)
    sx, sw = torch.ones(M, device=device), torch.ones(N, device=device)
    legs = {"torch.matmul bf16": lambda: torch.matmul(x, w),
            "torch._int_mm int8": lambda: torch._int_mm(xq, wq),
            "block_gemm bf16": lambda: kcb.block_gemm(x, w, bias_bf),
            "block_gemm_s8 int8": lambda: kcb.block_gemm_s8(xq, sx, wt, sw, bias_f)}
    ops = 2 * M * K * N
    times = {}
    for name, fn in legs.items():
        ms = device_ms(fn, device, iters=iters)
        times[name] = ms
        out(f"matmul {M}x{K}x{N} {name:20s} {ms:8.4f} ms  {ops / (ms / 1e3) / 1e12:7.1f} "
            f"T{'OPS' if 'int8' in name else 'FLOPS'}")
    return times


def infer_fn(model, acfg):
    """wav, counts -> the last exit's greedy tokens and counts."""
    def infer(wav, counts):
        feats = frontend.mel_spectrogram(wav, acfg, method="dft")
        lengths = frontend.mel_lengths(counts, acfg.hop_length)
        logits, sub_len = model.apply(feats, lengths, log_probs=False)
        return ctc.greedy_decode(logits[-1], sub_len, blank=model.cfg.blank_id)
    return infer


def disagreement(a, b):
    """Token disagreement of two (tokens, counts) decodes: differing kept
    tokens (counted position by position up to the longer count) over the
    reference's tokens."""
    (ta, na), (tb, nb) = a, b
    T = ta.shape[1]
    pos = torch.arange(T, device=ta.device)[None, :]
    upto = torch.maximum(na, nb)[:, None]
    diff = ((ta != tb) & (pos < upto)).sum()
    return int(diff), int(nb.sum())


def leg_model(device, batches, seconds, iters, weights="flagship", out=print):
    """{(B, leg): (ms, audio-s/s, (disagreeing, reference tokens))}: each
    leg's model built once, the requests drawn once at the largest B."""
    models = {name: serving_model(device, weights, **profile)
              for name, profile in LEGS.items()}
    acfg = next(iter(models.values()))[1]
    wav_all, counts_all, _ = requests(max(batches), seconds, acfg, device)
    results = {}
    for B in batches:
        wav, counts, ref = wav_all[:B], counts_all[:B], None
        for name, (model, acfg) in models.items():
            infer = infer_fn(model, acfg)
            with torch.no_grad():
                toks = infer(wav, counts)
                ref = toks if ref is None else ref
                ms = device_ms(lambda: infer(wav, counts), device, iters=iters)
            dis = disagreement(toks, ref)
            results[B, name] = (ms, B * seconds / (ms / 1e3), dis)
            out(f"B={B} {name:13s}: {ms:8.2f} ms  {B * seconds / (ms / 1e3):10,.0f} "
                f"audio-s/s  tokens vs bf16 unfused: {dis[0]}/{dis[1]}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batches", nargs="*", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mm", default="32768x256x2048")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--weights", choices=("flagship", "random"), default="flagship")
    a = ap.parse_args(argv)
    dev = runtime.resolve_device(a.device)
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")
    M, K, N = (int(v) for v in a.mm.lower().split("x"))
    leg_matmul(dev, M, K, N, a.iters)
    leg_model(dev, a.batches or [128, 64], a.seconds, a.iters, a.weights)
    print(f"launches: {json.dumps(launch_counts())}")


if __name__ == "__main__":
    main()
