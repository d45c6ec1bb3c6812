"""Gated-streaming escalation report (the counterpart of
`tools/streaming_gate_report.py`).

Runs `python -m early_exit_tpu_torch.inference --streaming true
--exit_threshold T` over a threshold sweep, parses the per-chunk
escalation histogram and WER each run prints, and writes one JSON report.
Also runs the ungated streaming ladder (all exits) as the quality frame.

    python -m early_exit_tpu_torch.streaming_gate_report \\
        --ckpt assets/flagship_ckpt --data_root <corpus> \\
        --out streaming_gated.json --thresholds 0.5,0.7,0.85,0.95 [--device cpu]

The flags, the parsed dict and the JSON are the JAX tool's (--out defaults
to the working directory, not the repository's reports/); the JSON adds
`wall_s`, each leg's wall seconds (process start and model load
included), keyed "ungated" or by threshold. Every leg is
one child process of the inference CLI with `--decoder_mode ctc
--streaming true --n_workers 2 --compute_dtype bfloat16`, --device
(default cuda) and any flag the tool does not know (model dims,
--streaming_chunk_s, --fused_block, ...) passed through verbatim.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import subprocess
import time

from early_exit_tpu_torch import runtime


def run_leg(args, extra, wall_s=None, name=None):
    """Runs one leg; its wall seconds go into wall_s[name] when given."""
    cmd = runtime.module_command("inference") + [
        "--decoder_mode", "ctc", "--streaming", "true",
        "--load_model_path", args.ckpt,
        "--data_root", args.data_root,
        "--eval_splits", args.splits,
        "--batch_size", str(args.batch_size),
        "--n_workers", "2",
        "--compute_dtype", "bfloat16",
        "--device", args.device] + args.passthrough + extra
    print("+", " ".join(cmd), flush=True)
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True, env=runtime.child_env())
    if wall_s is not None:
        wall_s[name] = time.perf_counter() - t0
    if p.returncode != 0:
        print(p.stdout[-2000:])
        print(p.stderr[-2000:])
        raise RuntimeError(f"leg failed rc={p.returncode}")
    return p.stdout


def parse(out):
    """Parse per-split streaming WER lines + escalation histograms."""
    res = {}
    for m in re.finditer(
            r"^(\S+) streaming exit histogram \(chunks per exit\): (.*)$",
            out, re.M):
        # the histogram prints as a python dict with int keys
        res.setdefault(m.group(1), {})["exit_histogram"] = {
            str(k): v for k, v in ast.literal_eval(m.group(2)).items()}
    for m in re.finditer(
            r"^(\S+) streaming WER exit (\d+): ([\d.]+)% \((\d+) utts\)"
            r"(?: \(gated: mean exit ([\d.]+)/(\d+), (\d+)% of chunks at "
            r"exit 1\))?", out, re.M):
        split = m.group(1)
        d = res.setdefault(split, {})
        d.setdefault("wer_pct", {})[f"exit{m.group(2)}"] = float(m.group(3))
        d["eval_utts"] = int(m.group(4))
        if m.group(5) is not None:
            d["mean_exit"] = float(m.group(5))
            d["pct_chunks_at_exit1"] = int(m.group(7))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--splits", default="test-clean,test-other")
    ap.add_argument("--thresholds", default="0.5,0.7,0.85,0.95")
    ap.add_argument("--gate_score", default="maxprob")
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="the inference CLI's --device (cuda unless cpu)")
    ap.add_argument("--out", default="streaming_gated.json")
    # anything after the known flags is handed to the inference CLI
    # verbatim (non-default dims, --streaming_chunk_s, ... -- the tool
    # otherwise assumes the reference architecture)
    args, args.passthrough = ap.parse_known_args(argv)

    report = {"ckpt": args.ckpt, "data_root": args.data_root,
              "gate_score": args.gate_score}
    wall_s = {}
    report["ungated_all_exits"] = parse(run_leg(args, [], wall_s, "ungated"))
    sweep = {}
    for t in [float(x) for x in args.thresholds.split(",") if x]:
        sweep[str(t)] = parse(run_leg(
            args, ["--exit_threshold", str(t),
                   "--gate_score", args.gate_score], wall_s, str(t)))
    report["gated"] = sweep
    report["wall_s"] = wall_s
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}")
    return report


if __name__ == "__main__":
    main()
