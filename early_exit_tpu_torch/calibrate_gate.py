"""Calibrate the confidence gate on held-out data (the counterpart of
`tools/calibrate_gate.py`).

Fits, per exit: (1) a temperature (the NLL grid fit of
`models/gate_calibration.py`) and (2) an operating threshold, the
loosest under which the simulated gated corpus WER stays within
--target_wer_delta percentage points of the final exit's, for each
confidence score (maxprob / margin / negentropy); then simulates the gate
and recommends the score with the lowest mean exit. Writes the JSON that
`--gate_calibration` reads:

    python -m early_exit_tpu_torch.calibrate_gate --out gate_calib.json \\
        --decoder_mode ctc --load_model_path CKPT --data_root DIR \\
        --eval_splits dev-clean [--target_wer_delta 0.0] [--fused_block true]
    python -m early_exit_tpu_torch.inference --gate_calibration gate_calib.json ...

The flags, the printed lines and the JSON keys are the JAX tool's; the
model flags are the inference CLI's. Calibrate on another split than the
one you evaluate: the thresholds meet the constraint on the calibration
set. Gated models only (early_conformer, splitformer). One batched
forward per batch gives every exit's float32 log-probs (through the block
kernel with --fused_block true on the card), their confidences under
every grid temperature (`scaled_confidence`) and their greedy tokens
(`ops/ctc.py`); the fits run on the host in numpy. Runs on CUDA unless
--device cpu.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from early_exit_tpu_torch import runtime
from early_exit_tpu_torch.cli import get_args
from early_exit_tpu_torch.data.librispeech import LibriSpeechDataset, SyntheticDataset
from early_exit_tpu_torch.data.pipeline import Pipeline
from early_exit_tpu_torch.inference import load_model
from early_exit_tpu_torch.models import gate_calibration
from early_exit_tpu_torch.models.early_exit_gate import GATED_MODEL_TYPES
from early_exit_tpu_torch.ops import ctc
from early_exit_tpu_torch.utils.metrics import edit_ops


@torch.no_grad()
def _batch_figures(model, batch, scores, temps, blank):
    """One batch: confidences (S, K, E, B) under every score and grid
    temperature, and the greedy tokens (E, B, T') with their counts."""
    lp, sub_len = model.apply(batch["feats"], batch["feat_lengths"])
    E, B, Tp, V = lp.shape
    flat = lp.reshape(E * B, Tp, V)
    mask = (torch.arange(Tp, device=lp.device)[None, :] < sub_len[:, None]).repeat(E, 1)
    conf = torch.stack([torch.stack([
        gate_calibration.scaled_confidence(flat, mask, score, t).reshape(E, B)
        for t in temps]) for score in scores])
    toks, n_toks = ctc.greedy_decode(flat, sub_len.repeat(E), blank=blank)
    return (conf.cpu().numpy(), toks.reshape(E, B, Tp).cpu().numpy(),
            n_toks.reshape(E, B).cpu().numpy())


def calibration_set(model, pipe, tokenizer, scores, temps, blank):
    """Every real utterance of the pipeline's epoch: its confidences
    (S, K, E, N) under each score and grid temperature, its word errors
    at each exit (E, N) and its reference word count (N,), in the
    pipeline's order."""
    conf_chunks, err_chunks, word_chunks = [], [], []
    for batch in pipe.epoch(0):
        conf, toks, n_toks = _batch_figures(model, batch, scores, temps, blank)
        E, B = toks.shape[:2]
        mask = batch["item_mask"].cpu().numpy().astype(bool)
        labels = batch["labels"].cpu().numpy()
        lab_len = batch["label_lengths"].cpu().numpy()
        errs = np.zeros((E, B))
        words = np.zeros((B,))
        for b in range(B):
            if not mask[b]:
                continue
            ref = tokenizer.decode(
                [int(t) for t in labels[b][1:lab_len[b]]]).lower().split()
            words[b] = max(len(ref), 1)
            for e in range(E):
                hyp = tokenizer.decode(
                    [int(t) for t in toks[e, b][:n_toks[e, b]]]).lower().split()
                errs[e, b] = edit_ops(ref, hyp)
        conf_chunks.append(conf[:, :, :, mask])
        err_chunks.append(errs[:, mask])
        word_chunks.append(words[mask])
    return (np.concatenate(conf_chunks, axis=3), np.concatenate(err_chunks, axis=1),
            np.concatenate(word_chunks))


def main(argv=None):
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--out", default="gate_calibration.json")
    ap.add_argument("--target_wer_delta", type=float, default=0.0,
                    help="accepted-set corpus WER may exceed the final "
                         "exit's by this many percentage points")
    ap.add_argument("--scores", default="maxprob,margin,negentropy")
    tool_args, rest = ap.parse_known_args(argv)

    args, model_cfg, train_cfg, audio_cfg, tokenizer = get_args(rest, mode="infer")
    if model_cfg.model_type not in GATED_MODEL_TYPES:
        sys.exit(f"gate calibration needs a multi-exit encoder "
                 f"({', '.join(GATED_MODEL_TYPES)})")
    scores = [s for s in tool_args.scores.split(",") if s]
    temps = list(gate_calibration.DEFAULT_TEMP_GRID)
    if args.load_model_path is None and None in (
            args.load_model_dir, args.avg_model_start, args.avg_model_end):
        sys.exit("need --load_model_path or --load_model_dir + "
                 "--avg_model_start/--avg_model_end")
    device = runtime.resolve_device(args.device)
    if device.type == "cuda":
        runtime.exact_float32()
    model = load_model(args, model_cfg, device)

    if args.synthetic_data:
        ds = SyntheticDataset(n_items=max(args.batch_size, 8), seed=args.seed + 7)
        split = "synthetic"
    else:
        split = args.eval_splits.split(",")[0]
        ds = LibriSpeechDataset(args.data_root, split)
    pipe = Pipeline(ds, tokenizer, audio_cfg, train_cfg, bpe=args.bpe, shuffle=False,
                    infer_mode=True, workers=args.n_workers, device=device)

    conf, errors, words = calibration_set(model, pipe, tokenizer, scores, temps,
                                          model_cfg.blank_id)
    n_utts = len(words)
    E = errors.shape[0]
    final_wer = errors[-1].sum() / max(words.sum(), 1.0)
    target = final_wer + tool_args.target_wer_delta / 100.0
    print(f"{split}: {n_utts} utts, final-exit WER "
          f"{100 * final_wer:.2f}%, accepted-set target "
          f"{100 * target:.2f}%")

    report = {"split": split, "eval_utts": n_utts,
              "target_wer_delta_pp": tool_args.target_wer_delta,
              "final_exit_wer_pct": round(100 * final_wer, 2),
              "checkpoint": args.load_model_path or args.load_model_dir,
              "per_score": {}}
    best = None
    for si, score in enumerate(scores):
        temperatures, stats = [], []
        for e in range(E):
            correct = (errors[e] == 0).astype(np.float64)
            ki = gate_calibration.fit_temperature(conf[si, :, e], temps, correct)
            temperatures.append(temps[ki])
            stats.append({
                "exit": e + 1, "temperature": round(temps[ki], 4),
                "exit_wer_pct": round(
                    100 * errors[e].sum() / max(words.sum(), 1.0), 2),
                "ece_raw": round(gate_calibration.ece(
                    conf[si, temps.index(1.0), e], correct), 4),
                "ece_cal": round(gate_calibration.ece(conf[si, ki, e], correct), 4),
            })
        cal_conf = np.stack([conf[si, temps.index(t), e]
                             for e, t in enumerate(temperatures)])
        # fitted in gate order, so the simulated gated WER is <= target
        thresholds = gate_calibration.fit_sequential_thresholds(
            cal_conf, errors, words, target)
        mean_exit, gated_wer, chosen = gate_calibration.simulate_gate(
            cal_conf, thresholds, errors, words)
        for e in range(E):
            stats[e]["threshold"] = round(thresholds[e], 6)
            stats[e]["accept_share"] = round(float(np.mean(chosen == e + 1)), 4)
        report["per_score"][score] = {
            "temperatures": temperatures, "thresholds": thresholds,
            "mean_exit": round(mean_exit, 3),
            "gated_wer_pct": round(100 * gated_wer, 2), "per_exit": stats}
        print(f"  {score:10s}: mean exit {mean_exit:.2f}/{E}, "
              f"gated WER {100 * gated_wer:.2f}%")
        if best is None or mean_exit < best[1]:
            best = (score, mean_exit)
    report["score"] = best[0]
    report["thresholds"] = report["per_score"][best[0]]["thresholds"]
    report["temperatures"] = report["per_score"][best[0]]["temperatures"]
    with open(tool_args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"recommended score: {best[0]} -> {tool_args.out}")
    return report


if __name__ == "__main__":
    main()
