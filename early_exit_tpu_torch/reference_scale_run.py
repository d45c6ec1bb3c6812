"""Reference-scale run (the counterpart of `tools/reference_scale_run.py`).

Trains the FULL flagship config -- the reference's defaults: d_model=256,
6 exits x 2 conformer layers, ffn 2048, kernel 31, 8 heads, batch 64,
n_batch_split 4 -- on an hours-scale generated disk corpus with a
realistic length distribution (2..28 words ~= 1..15 s), through the
product pipeline (FLAC corpus -> `python -m early_exit_tpu_torch.train`
-> `python -m early_exit_tpu_torch.inference`), and reports the 6-exit
WER ladder (greedy + lexicon beam + prefix beam + gated) on a >=200
utterance held-out split, plus epoch wall times.

    python -m early_exit_tpu_torch.reference_scale_run --workdir refscale \
        --n_train 6000 --n_test 240 --epochs 12 [--device cpu]

CTC mode reports the greedy / lexicon-beam / prefix-beam / gated WER
ladders, the gate calibrated on dev-clean (`calibrate_gate`) and the
calibrated cascade; `--decoder_mode aed` trains the full_conformer joint
model and reports the AED beam ladder on the last checkpoint and on the
checkpoint average. `--skip_train` evaluates the newest
`mod*-transformer` already in `<workdir>/model_<tag>`.

The flags, the corpus (every split's seed and knobs), the printed lines
and the summary JSON are the JAX tool's; its --platform is --device here
(default cuda, passed to every child process; a missing GPU raises). The
summary adds `eval_audio_s` (each evaluation split's audio seconds) and
`legs` (each child process's name, splits and wall seconds, process start
and model load included). The default --workdir is under the temporary
directory.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

from early_exit_tpu_torch import runtime


def make_corpus(root: str, split: str, n_items: int, seed: int,
                min_words: int, max_words: int, *, noise: float = 0.02,
                speaker_warp: float = 0.0, dur_jitter: float = 0.0,
                amp_jitter: float = 0.0, noise_hi: float | None = None,
                speaker: str = "1001") -> float:
    """Returns total audio seconds written. `speaker` must differ when
    writing one split in multiple calls (file stems are speaker-keyed)."""
    from early_exit_tpu_torch.data.flac import write_flac_verbatim
    from early_exit_tpu_torch.data.synthetic import SyntheticDataset

    ds = SyntheticDataset(n_items=n_items, seed=seed, min_words=min_words,
                          max_words=max_words, noise=noise,
                          speaker_warp=speaker_warp,
                          dur_jitter=dur_jitter, amp_jitter=amp_jitter,
                          noise_hi=noise_hi)
    per_chapter = 64
    total_s = 0.0
    for i in range(n_items):
        utt = ds[i]
        spk, chap = speaker, f"{i // per_chapter:04d}"
        cdir = os.path.join(root, "LibriSpeech", split, spk, chap)
        os.makedirs(cdir, exist_ok=True)
        stem = f"{spk}-{chap}-{i % per_chapter:04d}"
        fp = os.path.join(cdir, stem + ".flac")
        if not os.path.exists(fp):
            write_flac_verbatim(fp, utt.waveform, utt.sample_rate)
        with open(os.path.join(cdir, f"{spk}-{chap}.trans.txt"), "a",
                  encoding="utf-8") as f:
            f.write(f"{stem} {utt.transcript}\n")
        total_s += len(utt.waveform) / utt.sample_rate
    return total_s


def run(cmd, env, log_path=None):
    """Runs one child process; its output goes to log_path too. Exits on
    a failure with the tail of its output."""
    print("+", " ".join(cmd), flush=True)
    p = subprocess.run(cmd, capture_output=True, text=True, env=env)
    if log_path:
        with open(log_path, "a", encoding="utf-8") as f:
            f.write("+ " + " ".join(cmd) + "\n" + p.stdout + p.stderr)
    if p.returncode != 0:
        sys.stdout.write(p.stdout[-3000:])
        sys.stderr.write(p.stderr[-3000:])
        sys.exit(f"command failed (rc={p.returncode}): {' '.join(cmd)}")
    return p.stdout


def parse_wers(out: str, split="test-clean"):
    return {f"exit{m[0]}": float(m[1]) for m in re.findall(
        rf"{split} WER exit (\d+): ([0-9.]+)%", out)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "refscale"))
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--n_train", type=int, default=6000)
    ap.add_argument("--n_test", type=int, default=240)
    ap.add_argument("--min_words", type=int, default=2)
    ap.add_argument("--max_words", type=int, default=28)
    ap.add_argument("--seed", type=int, default=1,
                    help="corpus + init seed (repeat runs: vary this)")
    ap.add_argument("--noise", type=float, default=0.02,
                    help="additive noise sigma (0.2 tone amp; 0.2 = 0 dB)")
    ap.add_argument("--noise_hi", type=float, default=None,
                    help="per-utterance SNR spread: each utterance draws "
                         "sigma ~ U[noise, noise_hi]. De-saturates the "
                         "in-distribution WER ladder (VERDICT r3 item 3)")
    ap.add_argument("--n_dev", type=int, default=240,
                    help="dev-clean split size (gate calibration fits "
                         "thresholds here, never on the eval splits)")
    ap.add_argument("--target_wer_delta", type=float, default=0.5,
                    help="calibrated-gate leg: accepted WER may exceed "
                         "the final exit's by this many pp on dev")
    ap.add_argument("--speaker_warp", type=float, default=0.0,
                    help="per-utterance frequency warp range (hard mode)")
    ap.add_argument("--dur_jitter", type=float, default=0.0,
                    help="per-char duration jitter range (hard mode)")
    ap.add_argument("--amp_jitter", type=float, default=0.0,
                    help="per-char amplitude jitter range (hard mode)")
    ap.add_argument("--device", default="cuda",
                    help="--device of every child process (cuda unless cpu)")
    ap.add_argument("--beam_size", type=int, default=10)
    ap.add_argument("--avg_last", type=int, default=10,
                    help="AED leg: checkpoint-average the last N epochs "
                         "(late window; a 0..N average is dominated by "
                         "early garbage epochs)")
    ap.add_argument("--exit_threshold", type=float, default=0.85)
    ap.add_argument("--rescore_ctc_weight", type=float, default=0.3,
                    help="CTC weight for the AED n-best rescoring leg "
                         "(decoding/rescore.py)")
    ap.add_argument("--skip_train", action="store_true",
                    help="reuse an existing checkpoint in workdir")
    ap.add_argument("--distill", action="store_true",
                    help="train with self-distillation (--distill true): "
                         "the deepest exit teaches earlier exits — the "
                         "reference's reserved flag (util/conf.py:48-57); "
                         "its real-data-scale benefit is the open "
                         "question this runner measures")
    ap.add_argument("--specaugment", action="store_true",
                    help="train with SpecAugment masking (pairs with the "
                         "hard-mode corpus knobs for a robustness A/B)")
    ap.add_argument("--compute_dtype", default="bfloat16",
                    help="production profile (bfloat16 matmuls / fp32 "
                         "softmax+norms); float32 for parity debugging")
    ap.add_argument("--model_type", default="early_conformer",
                    choices=["early_conformer", "splitformer",
                             "early_zipformer"],
                    help="CTC model family (early_zipformer forces the "
                         "reference's 19x1 single-exit layout, "
                         "README.md:61)")
    ap.add_argument("--decoder_mode", default="ctc",
                    choices=["ctc", "aed"],
                    help="aed = full_conformer joint 0.7*CE+0.3*CTC at "
                         "reference dims (6 exits x 2 enc layers, 6-layer "
                         "decoder per exit), evaluated with the AED beam "
                         "search (beam 10) and with checkpoint averaging "
                         "(reference BASELINE config #3)")
    args = ap.parse_args(argv)

    work = args.workdir
    corpus = os.path.join(work, "corpus")
    tag = (f"seed{args.seed}" if args.model_type == "early_conformer"
           else f"{args.model_type}_seed{args.seed}")
    if args.decoder_mode == "aed":
        tag = f"aed_seed{args.seed}"
    if args.distill:
        tag += "_distill"
    moddir = os.path.join(work, f"model_{tag}")
    log = os.path.join(work, f"log_{tag}.txt")
    os.makedirs(corpus, exist_ok=True)

    marker = os.path.join(corpus, ".done")
    hard = dict(noise=args.noise, speaker_warp=args.speaker_warp,
                dur_jitter=args.dur_jitter, amp_jitter=args.amp_jitter,
                noise_hi=args.noise_hi)
    if not os.path.exists(marker):
        print("generating corpus ...", flush=True)
        tr_s = make_corpus(corpus, "train-clean-100", args.n_train,
                           seed=1000 + 1, min_words=args.min_words,
                           max_words=args.max_words, **hard)
        te_s = make_corpus(corpus, "test-clean", args.n_test, seed=2000 + 2,
                           min_words=args.min_words,
                           max_words=args.max_words, **hard)
        with open(marker, "w") as f:
            json.dump({"train_audio_s": tr_s, "test_audio_s": te_s}, f)
    # dev-clean: same distribution as test-clean, DISJOINT seed — gate
    # calibration fits temperatures/thresholds here (calibrate on dev,
    # evaluate on test; calibrate_gate's docstring)
    marker_dev = os.path.join(corpus, ".done_dev")
    if not os.path.exists(marker_dev) and args.n_dev > 0:
        print("generating dev-clean ...", flush=True)
        dv_s = make_corpus(corpus, "dev-clean", args.n_dev, seed=4000 + 4,
                           min_words=args.min_words,
                           max_words=args.max_words, **hard)
        with open(marker_dev, "w") as f:
            json.dump({"dev_audio_s": dv_s}, f)
    # "test-other": the reference's harder eval split (inference.py:225)
    # mapped to the synthetic corpus's hard-mode knobs — unseen speakers
    # (frequency warp), timing/amplitude jitter, and 3x the noise.
    marker_other = os.path.join(corpus, ".done_other")
    if not os.path.exists(marker_other):
        print("generating test-other ...", flush=True)
        to_s = make_corpus(corpus, "test-other", args.n_test,
                           seed=3000 + 3, min_words=args.min_words,
                           max_words=args.max_words, noise=1.5 * args.noise,
                           noise_hi=(1.5 * args.noise_hi if args.noise_hi
                                     else 3 * args.noise),
                           speaker_warp=max(args.speaker_warp * 1.25, 0.1),
                           dur_jitter=max(args.dur_jitter, 0.2),
                           amp_jitter=max(args.amp_jitter, 0.3))
        with open(marker_other, "w") as f:
            json.dump({"test_other_audio_s": to_s}, f)
    with open(marker) as f:
        audio = json.load(f)
    print(f"corpus: {audio['train_audio_s']/3600:.2f} h train, "
          f"{audio['test_audio_s']/3600:.2f} h test", flush=True)
    eval_audio_s = {}
    for path, key, split in ((marker, "test_audio_s", "test-clean"),
                             (marker_dev, "dev_audio_s", "dev-clean"),
                             (marker_other, "test_other_audio_s", "test-other")):
        if os.path.exists(path):
            with open(path) as f:
                eval_audio_s[split] = json.load(f)[key]

    env = runtime.child_env()
    legs = []

    def leg(name, cmd, splits):
        """`run` of one leg, its wall seconds kept in `legs`."""
        t0 = time.perf_counter()
        out = run(cmd, env, log)
        legs.append({"leg": name, "splits": splits.split(","),
                     "wall_s": time.perf_counter() - t0})
        return out

    # reference defaults: NO architecture overrides — ModelConfig defaults
    # ARE the reference's (d=256, 6x2, ffn 2048, k=31, 8 heads)
    common = ["--data_root", corpus,
              "--batch_size", "64", "--n_batch_split", "4",
              "--n_workers", "4", "--compute_dtype", args.compute_dtype,
              "--log_dir", os.path.join(work, "runs"), "--device", args.device]
    if args.model_type != "early_conformer":
        common += ["--model_type", args.model_type]
    if args.model_type == "early_zipformer":
        # the reference's required zipformer layout (README.md:61)
        common += ["--n_enc_exits", "19", "--n_enc_layers_per_exit", "1"]

    summary = {"seed": args.seed, "model_type": args.model_type,
               "specaugment": args.specaugment, "distill": args.distill,
               "decoder_mode": args.decoder_mode, "epochs": args.epochs,
               "n_train": args.n_train, "n_test": args.n_test,
               "words_range": [args.min_words, args.max_words],
               "train_audio_h": round(audio["train_audio_s"] / 3600, 2),
               "compute_dtype": args.compute_dtype,
               "corpus_knobs": {"noise": args.noise,
                                "noise_hi": args.noise_hi,
                                "speaker_warp": args.speaker_warp,
                                "dur_jitter": args.dur_jitter,
                                "amp_jitter": args.amp_jitter},
               "eval_audio_s": eval_audio_s}

    if not args.skip_train:
        sa = (["--specaugment", "true"] if args.specaugment else [])
        if args.distill:
            sa += ["--distill", "true"]
        # retention: reference-dims checkpoints are ~1 GB/epoch (model +
        # optimizer); keeping every epoch filled the disk at epoch 119 of
        # a 192-epoch run. Keep enough for the --avg_last window plus
        # slack for eval-time choices.
        keep = max(3 * args.avg_last, 24)
        train_out = leg("train", [*runtime.module_command("train"),
                                  "--decoder_mode", args.decoder_mode,
                                  "--n_epochs", str(args.epochs),
                                  "--seed", str(args.seed),
                                  "--keep_last_ckpts", str(keep),
                                  "--save_model_dir", moddir, *sa, *common],
                        "train-clean-100")
        losses = [float(m) for m in re.findall(
            r"LOSS_TOTAL-\d+ := ([0-9.]+)", train_out)]
        epoch_s = [float(m) for m in re.findall(
            r"LOSS_TOTAL-\d+ := [0-9.]+\s+\(([0-9.]+)s", train_out)]
        summary["loss_first"] = losses[0]
        summary["loss_last"] = losses[-1]
        summary["epoch_wall_s"] = epoch_s
        summary["steady_epoch_s"] = (sorted(epoch_s[2:])[len(epoch_s[2:])
                                     // 2] if len(epoch_s) > 3 else None)

    ckpts = sorted(f for f in os.listdir(moddir)
                   if f.startswith("mod") and f.endswith("-transformer"))
    ckpt = os.path.join(moddir, ckpts[-1])
    summary["checkpoint"] = ckpt
    # the reference evaluates both splits (inference.py:225); test-other
    # here is the hard-mode synthetic split (unseen warp/jitter/noise)
    splits = "test-clean,test-other"
    infer_base = [*runtime.module_command("inference"),
                  "--decoder_mode", args.decoder_mode,
                  "--eval_splits", splits,
                  "--load_model_path", ckpt, *common]

    def both(out):
        return {"test-clean": parse_wers(out, "test-clean"),
                "test-other": parse_wers(out, "test-other")}

    if args.decoder_mode == "aed":
        # BASELINE config #3: AED beam search (beam 10) per exit, on the
        # best checkpoint AND on the reference's checkpoint average
        # (util/model_utils.py:15-48 semantics: missing epochs skipped).
        out = leg("aed_beam", infer_base + ["--beam_size", str(args.beam_size)],
                  splits)
        summary["aed_beam_wer_pct"] = both(out)
        summary["eval_utts"] = len(re.findall(r"test-clean EXPECTED:", out))
        # joint CTC+attention rescoring of the n-best (the reference's
        # commented-out util/beam_infer.py:309-383 path, completed)
        out = leg("aed_rescored",
                  infer_base + ["--beam_size", str(args.beam_size),
                                "--rescore_ctc_weight",
                                str(args.rescore_ctc_weight)], splits)
        summary["aed_rescored_wer_pct"] = both(out)
        summary["rescore_ctc_weight"] = args.rescore_ctc_weight
        last_epoch = int(re.match(r"mod(\d+)-transformer", ckpts[-1])[1])
        # average a LATE window, not the full history: early garbage
        # epochs dominate a 0..N average (the JAX package's record: 96.2%
        # vs 28.8% WER at exit 6 on its 48-epoch run). The reference's own usage
        # averages once converged (util/model_utils.py:15-48). The
        # window start must be an EXISTING checkpoint (the trainer skips
        # non-improving epochs and avg_models loads the start epoch
        # unconditionally), so take the last N saved files.
        window = ckpts[-args.avg_last:]
        avg_start = int(re.match(r"mod(\d+)-transformer", window[0])[1])
        avg_base = [*runtime.module_command("inference"),
                    "--decoder_mode", "aed", "--eval_splits", splits,
                    "--load_model_dir", moddir,
                    "--avg_model_start", str(avg_start),
                    "--avg_model_end", str(last_epoch), *common]
        out = leg("aed_beam_avg", avg_base + ["--beam_size", str(args.beam_size)],
                  splits)
        summary["aed_beam_avg_wer_pct"] = both(out)
        summary["avg_model_range"] = [avg_start, last_epoch,
                                      len(window)]  # start, end, averaged
    else:
        out = leg("greedy", infer_base + ["--decode", "greedy"], splits)
        summary["greedy_wer_pct"] = parse_wers(out)
        summary["greedy_wer_other_pct"] = parse_wers(out, "test-other")
        n_utts = len(re.findall(r"test-clean EXPECTED:", out))
        summary["eval_utts"] = n_utts

        out = leg("lexicon_beam", infer_base + ["--decode", "lexicon_beam",
                                                "--beam_size", str(args.beam_size)],
                  splits)
        summary["lexicon_beam_wer_pct"] = parse_wers(out)
        summary["lexicon_beam_wer_other_pct"] = parse_wers(
            out, "test-other")

        # BASELINE config #2: the cuda_ctc_decoder equivalent — the device
        # prefix beam with blank-skip pruning (beam_infer.py:79-80 parity)
        out = leg("prefix_beam", infer_base + ["--decode", "prefix_beam",
                                               "--beam_size", str(args.beam_size)],
                  splits)
        summary["prefix_beam_wer_pct"] = parse_wers(out)
        summary["prefix_beam_wer_other_pct"] = parse_wers(
            out, "test-other")

        if args.model_type != "early_zipformer":
            # single-exit models have nothing to gate (the inference CLI
            # rejects --exit_threshold for them)
            out = leg("gated", infer_base + ["--decode", "greedy",
                                             "--exit_threshold",
                                             str(args.exit_threshold)], splits)
            for split in ("test-clean", "test-other"):
                m = re.search(
                    rf"{split} gated WER: ([0-9.]+)% "
                    rf"\(mean exits run ([0-9.]+)", out)
                if m:
                    key = "" if split == "test-clean" else "_other"
                    summary[f"gated{key}_wer_pct"] = float(m.group(1))
                    summary[f"gated{key}_mean_exits"] = float(m.group(2))

            # CALIBRATED gate (VERDICT r3 item 1): fit per-exit
            # temperatures + thresholds on dev-clean, then evaluate the
            # gated path with them on test-clean/test-other. The raw
            # 0.85-maxprob leg above is the uncalibrated baseline it is
            # compared against.
            calib_path = os.path.join(work, f"gate_calib_{tag}.json")
            leg("calibrate_gate", [*runtime.module_command("calibrate_gate"),
                                   "--out", calib_path,
                                   "--target_wer_delta", str(args.target_wer_delta),
                                   "--decoder_mode", "ctc",
                                   "--load_model_path", ckpt,
                                   "--eval_splits", "dev-clean", *common],
                "dev-clean")
            with open(calib_path) as f:
                calib = json.load(f)
            summary["gate_calibration"] = {
                "score": calib["score"],
                "thresholds": calib["thresholds"],
                "temperatures": calib["temperatures"],
                "dev_final_exit_wer_pct": calib["final_exit_wer_pct"],
                "dev_mean_exit": calib["per_score"][calib["score"]][
                    "mean_exit"],
                "target_wer_delta_pp": args.target_wer_delta}
            out = leg("gated_cal", infer_base + ["--decode", "greedy",
                                                 "--gate_calibration", calib_path],
                      splits)
            for split in ("test-clean", "test-other"):
                m = re.search(
                    rf"{split} gated WER: ([0-9.]+)% "
                    rf"\(mean exits run ([0-9.]+)", out)
                if m:
                    key = "" if split == "test-clean" else "_other"
                    summary[f"gated_cal{key}_wer_pct"] = float(m.group(1))
                    summary[f"gated_cal{key}_mean_exits"] = float(
                        m.group(2))

            # calibrated CASCADE leg (serving/cascade.py): same
            # decisions, per-utterance computed-exit accounting + a
            # per-exit accept histogram instead of the while_loop's
            # batch-max count
            from early_exit_tpu_torch.serving.cascade import choose_k
            shares = [st.get("accept_share", 0.0) for st in
                      calib.get("per_score", {}).get(
                          calib["score"], {}).get("per_exit", [])]
            k = choose_k(shares, len(calib["thresholds"])) if shares \
                else 2
            out = leg("cascade", infer_base + ["--decode", "greedy",
                                               "--gate_calibration", calib_path,
                                               "--cascade_k", str(k)], splits)
            summary["cascade_k"] = k
            for split in ("test-clean", "test-other"):
                key = "" if split == "test-clean" else "_other"
                m = re.search(
                    rf"{split} gated WER: ([0-9.]+)% "
                    rf"\(mean exits run ([0-9.]+)", out)
                if m:
                    summary[f"cascade{key}_wer_pct"] = float(m.group(1))
                    summary[f"cascade{key}_mean_exits_computed"] = float(
                        m.group(2))
                m = re.search(
                    rf"{split} cascade exit histogram "
                    rf"\(utts per exit\): (\{{[^}}]*\}})", out)
                if m:
                    summary[f"cascade{key}_exit_histogram"] = m.group(1)

    summary["legs"] = legs
    out_path = os.path.join(work, f"summary_{tag}.json")
    with open(out_path, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
