"""Gate calibration under domain shift: an end-to-end evidence run (the
counterpart of `tools/calibrate_shift_demo.py`).

Setting: a hard-mode reference-scale checkpoint
(`python -m early_exit_tpu_torch.reference_scale_run --workdir W ...`)
whose per-exit WER ladder on the shifted test-other split has structure
while test-clean is near 0% everywhere, so that a raw maxprob gate stays
at exit 1 even on test-other (overconfidence under shift).

This tool:
  1. generates dev-clean / dev-other / dev-mixed calibration splits in
     the workdir corpus (the eval splits' generator knobs, DIFFERENT
     seeds: calibration never sees the eval utterances);
  2. fits gate calibrations on dev-other and on dev-mixed
     (`python -m early_exit_tpu_torch.calibrate_gate`);
  3. evaluates test-clean and test-other through the inference CLI with
     (a) the raw scalar gate, (b) each calibration JSON;
  4. prints one JSON summary (gated WER + mean exits per setting).

    python -m early_exit_tpu_torch.calibrate_shift_demo --workdir W \
        --ckpt W/model_seed1/mod017-transformer [--device cpu]

The flags, the splits and the JSON are the JAX tool's, plus --device
(default cuda, passed to every child process). The default --workdir is
under the temporary directory.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import tempfile

from early_exit_tpu_torch import runtime


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "refscale_hard"))
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--n_dev", type=int, default=240)
    ap.add_argument("--noise", type=float, default=0.06,
                    help="the workdir corpus's train-split noise knob")
    ap.add_argument("--target_wer_delta", type=float, default=0.5)
    ap.add_argument("--threshold", type=float, default=0.85)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="--device of every child process (cuda unless cpu)")
    args = ap.parse_args(argv)

    from early_exit_tpu_torch.reference_scale_run import make_corpus, run

    corpus = os.path.join(args.workdir, "corpus")
    log = os.path.join(args.workdir, "log_shift_demo.txt")
    # hard-split knobs mirror reference_scale_run's test-other mapping
    hard = dict(noise=3 * args.noise, speaker_warp=0.1, dur_jitter=0.2,
                amp_jitter=0.3)
    clean = dict(noise=args.noise, speaker_warp=0.1, dur_jitter=0.2,
                 amp_jitter=0.3)   # the TRAIN distribution of hard mode
    marker = os.path.join(corpus, ".done_dev")
    if not os.path.exists(marker):
        print("generating dev splits ...", flush=True)
        make_corpus(corpus, "dev-clean", args.n_dev, seed=5005,
                    min_words=2, max_words=28, **clean)
        make_corpus(corpus, "dev-other", args.n_dev, seed=4004,
                    min_words=2, max_words=28, **hard)
        # mixed: half in-domain, half shifted (fresh seeds again;
        # distinct speaker ids so the two halves' file stems differ)
        make_corpus(corpus, "dev-mixed", args.n_dev // 2, seed=6006,
                    min_words=2, max_words=28, speaker="1001", **clean)
        make_corpus(corpus, "dev-mixed", args.n_dev // 2, seed=7007,
                    min_words=2, max_words=28, speaker="2002", **hard)
        open(marker, "w").write("ok")

    env = runtime.child_env()
    common = ["--decoder_mode", "ctc", "--load_model_path", args.ckpt,
              "--data_root", corpus, "--batch_size", "64",
              "--n_batch_split", "4", "--n_workers", "4",
              "--compute_dtype", "bfloat16", "--device", args.device]

    calibs = {}
    for dev in ("dev-other", "dev-mixed"):
        cj = os.path.join(args.workdir, f"calib_{dev}.json")
        run([*runtime.module_command("calibrate_gate"), "--out", cj, "--target_wer_delta", str(args.target_wer_delta),
             "--eval_splits", dev, *common], env, log)
        with open(cj) as f:
            calibs[dev] = {"path": cj, "report": json.load(f)}

    def gated_eval(extra, tag):
        out = run([*runtime.module_command("inference"),
                   "--eval_splits", "test-clean,test-other",
                   *common, *extra], env, log)
        res = {}
        for split in ("test-clean", "test-other"):
            m = re.search(rf"{split} gated WER: ([0-9.]+)% "
                          rf"\(mean exits run ([0-9.]+)", out)
            res[split] = {"gated_wer_pct": float(m.group(1)),
                          "mean_exits": float(m.group(2))}
        print(tag, res, flush=True)
        return res

    summary = {"checkpoint": args.ckpt,
               "raw_scalar": gated_eval(
                   ["--exit_threshold", str(args.threshold)],
                   f"raw maxprob {args.threshold}")}
    for dev, c in calibs.items():
        summary[f"calibrated_{dev}"] = gated_eval(
            ["--gate_calibration", c["path"]], f"calibrated on {dev}")
        summary[f"calibration_{dev}"] = {
            "score": c["report"]["score"],
            "thresholds": c["report"]["thresholds"],
            "temperatures": c["report"]["temperatures"],
            "dev_gated_wer_pct":
                c["report"]["per_score"][c["report"]["score"]]
                ["gated_wer_pct"],
            "dev_mean_exit":
                c["report"]["per_score"][c["report"]["score"]]
                ["mean_exit"],
        }
    out_path = args.out or os.path.join(args.workdir, "shift_demo.json")
    with open(out_path, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
