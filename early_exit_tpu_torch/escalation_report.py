"""Per-utterance evidence of the calibrated gate's escalation (the
counterpart of `tools/escalation_report.py`).

One dense pass computes every exit's greedy decode and calibrated
confidence for a fresh-seed `SyntheticDataset` split drawn with the calib
file's `bench_eval` knobs; the gate (the earliest exit whose confidence
clears its threshold, the final exit as the fallback: `gated_apply`'s
rule) is then simulated on the host at the calib file's operating point
and along a threshold sweep of its first reachable exit. Each point
reports the accept histogram, a table of noise-sigma buckets (mean chosen
exit and gated WER per bucket), the sigma / chosen-exit Pearson and
Spearman correlations, and the gated WER beside the per-exit ladder.

    python -m early_exit_tpu_torch.escalation_report \\
        --ckpt assets/flagship_ckpt --calib assets/flagship_calib.json \\
        --out report.json --sweep 0.8,0.9,0.95 [--fused_block] [--device cpu]

The flags and the JSON are the JAX tool's, plus the port's --device
(CUDA unless cpu). The model is an early_conformer in the bf16 inference
profile (DFT mel, bf16 attention softmax); --fused_block runs its trunk
through the block kernel on the card; --model_json overrides
`ModelConfig` fields.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from early_exit_tpu_torch import runtime
from early_exit_tpu_torch.checkpoint import REPO


def wer_counts(ref_words, hyp_words):
    """(edit_distance, n_ref_words)."""
    R, H = len(ref_words), len(hyp_words)
    D = np.zeros((R + 1, H + 1), np.int32)
    D[:, 0] = np.arange(R + 1)
    D[0, :] = np.arange(H + 1)
    for a in range(1, R + 1):
        for b in range(1, H + 1):
            D[a, b] = min(D[a - 1, b] + 1, D[a, b - 1] + 1,
                          D[a - 1, b - 1] + (ref_words[a - 1] != hyp_words[b - 1]))
    return int(D[R, H]), max(R, 1)


def pearson(a, b):
    a = np.asarray(a, np.float64) - np.mean(a)
    b = np.asarray(b, np.float64) - np.mean(b)
    den = float(np.sqrt((a * a).sum() * (b * b).sum()))
    return float((a * b).sum() / den) if den else 0.0


def spearman(a, b):
    return pearson(np.argsort(np.argsort(a)).astype(np.float64),
                   np.argsort(np.argsort(b)).astype(np.float64))


def simulate_point(thresholds, conf, sig, eerr, words, E, n_buckets):
    """The gate's rule (`gated_apply`): the earliest exit with conf >=
    threshold, the final exit as the fallback; conf (E, N). `escalated`:
    chose an exit deeper than the policy's shallowest reachable one."""
    thr = np.asarray(thresholds, np.float64)
    shallowest = next((e + 1 for e in range(E) if thr[e] <= 1.0), E)
    ok = conf >= thr[:, None]                       # (E, N)
    ok[-1] = True
    chosen = np.argmax(ok, axis=0) + 1              # (N,) 1-based
    gerr = eerr[chosen - 1, np.arange(len(chosen))]
    hist = {f"exit{e + 1}": round(float(np.mean(chosen == e + 1)), 4)
            for e in range(E)}
    qs = np.quantile(sig, np.linspace(0, 1, n_buckets + 1))
    qs[-1] += 1e-9
    buckets = []
    for b in range(n_buckets):
        m = (sig >= qs[b]) & (sig < qs[b + 1])
        if not m.any():
            continue
        buckets.append({
            "sigma_range": [round(float(qs[b]), 3), round(float(qs[b + 1]), 3)],
            "n_utts": int(m.sum()),
            "mean_chosen_exit": round(float(chosen[m].mean()), 3),
            "escalated_share": round(float(np.mean(chosen[m] > shallowest)), 4),
            "gated_wer_pct": round(100 * gerr[m].sum() / words[m].sum(), 2),
        })
    return {
        "thresholds": [round(float(t), 6) for t in thr],
        "accept_histogram": hist,
        "mean_exits": round(float(chosen.mean()), 3),
        "escalated_share": round(float(np.mean(chosen > shallowest)), 4),
        "gated_wer_pct": round(100 * gerr.sum() / words.sum(), 2),
        "sigma_exit_pearson": round(pearson(sig, chosen), 3),
        "sigma_exit_spearman": round(spearman(sig, chosen), 3),
        "snr_buckets": buckets,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=os.path.join(REPO, "assets", "flagship_ckpt"))
    ap.add_argument("--calib", default=os.path.join(REPO, "assets",
                                                    "flagship_calib.json"))
    ap.add_argument("--out", default=None, help="output JSON path")
    ap.add_argument("--n_utts", type=int, default=256)
    ap.add_argument("--seed", type=int, default=9999,
                    help="eval corpus seed, fresh against the train (1001), "
                         "test (2002), dev (4004) and bench (7777) draws")
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--n_buckets", type=int, default=4)
    ap.add_argument("--sweep", default="",
                    help="comma-separated thresholds for the FIRST reachable "
                         "exit (the others kept from the calib): the "
                         "operating curve from the promoted point toward "
                         "deeper escalation")
    ap.add_argument("--fused_block", action="store_true",
                    help="run the trunk through the block kernel (the card)")
    ap.add_argument("--model_json", default=None,
                    help="ModelConfig field overrides as JSON (tests, other "
                         "widths); default: the reference's")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from early_exit_tpu_torch.cli import resolve_bpe_model
    from early_exit_tpu_torch.configs import AudioConfig, ModelConfig
    from early_exit_tpu_torch.data.synthetic import SyntheticDataset
    from early_exit_tpu_torch.models import gate_calibration
    from early_exit_tpu_torch.models.early_conformer import EarlyConformer
    from early_exit_tpu_torch.ops import ctc, frontend
    from early_exit_tpu_torch.tokenizer import load_decoder
    from early_exit_tpu_torch.training import checkpoint

    with open(args.calib) as f:
        calib = json.load(f)
    knobs = calib.get("bench_eval", {})
    tok_path = calib.get("tokenizer")
    if tok_path and not os.path.isabs(tok_path):
        tok_path = os.path.join(REPO, tok_path)
    tok = load_decoder(tok_path or resolve_bpe_model(""))

    device = runtime.resolve_device(args.device)
    if device.type == "cuda":
        runtime.exact_float32()
    acfg = AudioConfig(mel_method="dft")
    overrides = json.loads(args.model_json) if args.model_json else {}
    cfg = ModelConfig(attn_softmax_dtype="bfloat16", fused_block=args.fused_block,
                      **overrides)
    model = EarlyConformer(cfg)
    checkpoint.load_model_file(model, args.ckpt)
    model = model.to(device).eval().requires_grad_(False)

    ds = SyntheticDataset(n_items=args.n_utts, seed=args.seed,
                          min_words=knobs.get("min_words", 18),
                          max_words=knobs.get("max_words", 22),
                          noise=knobs.get("noise", 0.02),
                          noise_hi=knobs.get("noise_hi"),
                          speaker_warp=knobs.get("speaker_warp", 0.0),
                          dur_jitter=knobs.get("dur_jitter", 0.0),
                          amp_jitter=knobs.get("amp_jitter", 0.0))
    utts = [ds[i] for i in range(args.n_utts)]
    max_n = max(len(u.waveform) for u in utts)

    THRESHOLDS = [float(t) for t in calib["thresholds"]]
    TEMPS = [float(t) for t in calib["temperatures"]]
    SCORE = calib["score"]
    E = cfg.n_enc_exits

    @torch.no_grad()
    def dense(wav, n):
        feats = frontend.mel_spectrogram(wav, acfg, method="dft")
        lengths = frontend.mel_lengths(n, acfg.hop_length)
        logp, sub_len = model.apply(feats, lengths)
        mask = torch.arange(logp.shape[2], device=device)[None, :] < sub_len[:, None]
        conf = torch.stack([gate_calibration.scaled_confidence(
            logp[e], mask, SCORE, TEMPS[e]) for e in range(E)])
        toks, ntoks = ctc.greedy_decode(logp.reshape((-1,) + logp.shape[2:]),
                                        sub_len.repeat(E), blank=cfg.blank_id)
        return (toks.reshape(E, -1, toks.shape[-1]).cpu().numpy(),
                ntoks.reshape(E, -1).cpu().numpy(), conf.float().cpu().numpy())

    B = args.batch_size
    sig, words_l, eerr_l, conf_l = [], [], [], []
    for k0 in range(0, args.n_utts, B):
        chunk = utts[k0:k0 + B]
        wav = np.zeros((B, max_n), np.float32)
        n = np.zeros((B,), np.int32)
        for j, u in enumerate(chunk):
            wav[j, :len(u.waveform)] = u.waveform
            n[j] = len(u.waveform)
        dt, dn, conf = dense(torch.from_numpy(wav).to(device),
                             torch.from_numpy(n).to(device))
        for j, u in enumerate(chunk):
            ref = u.transcript.lower().split()
            errs = []
            for e in range(E):
                h = tok.decode([int(t) for t in dt[e, j][:dn[e, j]]]).lower()
                errs.append(wer_counts(ref, h.split())[0])
            sig.append(u.noise_sigma)
            words_l.append(max(len(ref), 1))
            eerr_l.append(errs)
            conf_l.append(conf[:, j])

    sig = np.asarray(sig)
    words = np.asarray(words_l, np.float64)
    eerr = np.asarray(eerr_l, np.float64).T            # (E, N)
    conf = np.asarray(conf_l, np.float64).T            # (E, N)

    promoted = simulate_point(THRESHOLDS, conf, sig, eerr, words, E, args.n_buckets)
    promoted["point"] = "promoted"
    points = [promoted]
    first_reach = next((e for e in range(E) if THRESHOLDS[e] <= 1.0), E - 1)
    for t in [float(x) for x in args.sweep.split(",") if x]:
        thr = list(THRESHOLDS)
        thr[first_reach] = t
        pt = simulate_point(thr, conf, sig, eerr, words, E, args.n_buckets)
        pt["point"] = f"sweep_exit{first_reach + 1}@{t}"
        points.append(pt)

    report = {
        "ckpt": args.ckpt, "calib": args.calib,
        "n_utts": args.n_utts, "seed": args.seed,
        "eval_knobs": knobs, "score": SCORE,
        "temperatures": TEMPS,
        "exit_wer_ladder": {
            f"exit{e + 1}": round(100 * eerr[e].sum() / words.sum(), 2)
            for e in range(E)},
        "sigma_conf_pearson_first_reachable": round(
            pearson(sig, conf[first_reach]), 3),
        "operating_points": points,
        # top-level copies of the promoted point, as the JAX tool writes them
        "accept_histogram": promoted["accept_histogram"],
        "mean_exits": promoted["mean_exits"],
        "gated_wer_pct": promoted["gated_wer_pct"],
        "sigma_exit_pearson": promoted["sigma_exit_pearson"],
        "sigma_exit_spearman": promoted["sigma_exit_spearman"],
        "snr_buckets": promoted["snr_buckets"],
        "thresholds": promoted["thresholds"],
    }
    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.out}")
    return report


if __name__ == "__main__":
    main()
