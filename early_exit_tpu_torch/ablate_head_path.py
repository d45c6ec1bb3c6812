"""Split the all-exit serving time between the trunk, the head paths and
the decode (counterpart of `tools/ablate_head_path.py`).

    [AB_B=128] python -m early_exit_tpu_torch.ablate_head_path
        [--device cuda] [--seconds 10] [--iters 30] [--weights flagship]

Variants, each from the waveform (DFT mel) through the fused trunk (the
block kernel, 12 launches):
  trunk       the trunk only (`apply_hidden`)
  last_only   the trunk, the last exit's head by torch.matmul, its argmax
              and greedy decode
  kernel_all  the trunk, every exit's head and argmax by the head kernel
              (`head_argmax`), every exit's greedy decode
  matmul_all  the trunk, every exit's head by torch.matmul (bf16 product,
              rounded to bf16, + bf16 bias), torch.argmax, every exit's
              greedy decode
B (AB_B, default 128) requests of --seconds of the synthetic corpus (the
calibration file's `bench_eval` knobs); --weights flagship (the committed
checkpoint) or random (seeded). Each line: ms a call (CUDA events) and
the audio seconds served a second. The ids of kernel_all and matmul_all
must agree wherever the bf16 logits do not tie (within one bf16 step).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from early_exit_tpu_torch import runtime
from early_exit_tpu_torch.ops import ctc, frontend
from early_exit_tpu_torch.ops.kernels import head_argmax as kha
from early_exit_tpu_torch.ops.kernels import launch_counts
from early_exit_tpu_torch.utils.timing import device_ms


def serving_model(device, weights: str = "flagship", **profile):
    """The flagship model in the inference profile (fused blocks unless
    told), with the committed or seeded random weights, and its audio
    configuration."""
    from early_exit_tpu_torch import checkpoint, interop
    from early_exit_tpu_torch.configs import AudioConfig, inference_profile
    from early_exit_tpu_torch.models.registry import build_model
    if torch.device(device).type == "cuda":
        runtime.exact_float32()           # the mel features in full float32
    cfg = inference_profile(**{"fused_block": True, **profile})
    if weights == "flagship":
        tree = checkpoint.load_tree(checkpoint.FLAGSHIP_CKPT)
        model = interop.from_jax_params(tree["params"], tree["model_state"], cfg)
    else:
        model = build_model(cfg).init(torch.Generator().manual_seed(0))
    return model.to(device).eval(), AudioConfig(mel_method="dft")


def requests(B: int, seconds: float, acfg, device, seed: int = 4242):
    """B synthetic utterances cut or padded to `seconds`: (wav, counts,
    transcripts)."""
    from early_exit_tpu_torch import checkpoint
    from early_exit_tpu_torch.data.synthetic import synth_batch
    knobs = checkpoint.load_calib().get("bench_eval", {})
    wav_np, counts_np, refs = synth_batch(knobs, B, seed=seed)
    N = int(seconds * acfg.sample_rate)
    wav = np.zeros((B, N), np.float32)
    m = min(N, wav_np.shape[1])
    wav[:, :m] = wav_np[:, :m]
    counts = np.minimum(counts_np, N).astype(np.int32)
    return torch.from_numpy(wav).to(device), torch.from_numpy(counts).to(device), refs


def matmul_ids(model, hidden):
    """Every exit's head by torch.matmul in bf16, + bf16 bias, argmax
    (the lowest index wins a tie): (E, B, T) int32, and the logits."""
    logits = torch.matmul(hidden.to(torch.bfloat16), model.heads_w.to(torch.bfloat16)[:, None])
    logits = logits + model.heads_b.to(torch.bfloat16)[:, None, None]
    return torch.argmax(logits, dim=-1).to(torch.int32), logits


def variants(model, acfg):
    def front(wav, counts):
        feats = frontend.mel_spectrogram(wav, acfg, method="dft")
        return feats, frontend.mel_lengths(counts, acfg.hop_length)

    def decode_all(ids, sub_len):
        E, B, T = ids.shape
        return ctc.greedy_decode_ids(ids.reshape(E * B, T), sub_len.repeat(E),
                                     blank=model.cfg.blank_id)

    def trunk(wav, counts):
        return model.apply_hidden(*front(wav, counts))

    def last_only(wav, counts):
        hidden, sub_len = model.apply_hidden(*front(wav, counts))
        ids, _ = matmul_ids(model, hidden[-1:])
        return ctc.greedy_decode_ids(ids[0], sub_len, blank=model.cfg.blank_id)

    def kernel_all(wav, counts):
        hidden, sub_len = model.apply_hidden(*front(wav, counts))
        ids = kha.head_argmax(hidden.to(torch.bfloat16).contiguous(),
                              model.heads_w.to(torch.bfloat16).contiguous(),
                              model.heads_b.to(torch.bfloat16).contiguous())
        return decode_all(ids, sub_len), ids

    def matmul_all(wav, counts):
        hidden, sub_len = model.apply_hidden(*front(wav, counts))
        ids, logits = matmul_ids(model, hidden)
        return decode_all(ids, sub_len), ids, logits

    return {"trunk": trunk, "last_only": last_only, "kernel_all": kernel_all,
            "matmul_all": matmul_all}


def ids_at_ties(ids_k, ids_m, logits):
    """(ids that differ, of them those where the two ids' bf16 logits are
    not within one bf16 step of each other)."""
    diff = ids_k != ids_m
    lk = logits.gather(-1, ids_k.long()[..., None])[..., 0].float()
    lm = logits.gather(-1, ids_m.long()[..., None])[..., 0].float()
    step = torch.maximum(lk.abs(), lm.abs()) * 2.0 ** -7
    return int(diff.sum()), int((diff & ((lk - lm).abs() > step)).sum())


def run(device, B, seconds, iters, weights="flagship", out=print):
    model, acfg = serving_model(device, weights)
    wav, counts, _ = requests(B, seconds, acfg, device)
    fns = variants(model, acfg)
    times = {}
    with torch.no_grad():
        _, ids_k = fns["kernel_all"](wav, counts)
        _, ids_m, logits = fns["matmul_all"](wav, counts)
        n_diff, n_nontie = ids_at_ties(ids_k, ids_m, logits)
        for name, fn in fns.items():
            ms = device_ms(lambda: fn(wav, counts), device, iters=iters)
            times[name] = ms
            out(f"{name:12s} {ms:8.3f} ms   {B * seconds / (ms / 1e3):10,.0f} audio-s/s")
    out(f"ids kernel_all vs matmul_all: {n_diff} of {ids_k.numel()} differ, "
        f"{n_nontie} not at a bf16 tie")
    return times, (n_diff, n_nontie)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--weights", choices=("flagship", "random"), default="flagship")
    a = ap.parse_args(argv)
    dev = runtime.resolve_device(a.device)
    B = int(os.environ.get("AB_B", "128"))
    print(f"head paths at B={B} x {a.seconds:g} s on {dev} ({a.weights} weights)")
    _, (_, n_nontie) = run(dev, B, a.seconds, a.iters, a.weights)
    print(f"launches: {json.dumps(launch_counts())}")
    if n_nontie:
        raise SystemExit("ablate_head_path: the head kernel's ids differ from "
                         "torch.matmul's at a non-tie")


if __name__ == "__main__":
    main()
