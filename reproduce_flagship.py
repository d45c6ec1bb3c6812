"""Reproduce the committed flagship reports with the port's tools.

    python reproduce_flagship.py [--workdir DIR] [--device cuda]

`reports/refscale_v3_seed1.json` and `reports/streaming_gated_v3.json`
were taken with the JAX package from checkpoint mod085 of the refscale_v3
seed-1 run, which promoted to bf16 is `assets/flagship_ckpt`. Their
corpora are synthetic and seeded, so this script rebuilds them and reruns
both tools through the port, with every setting read from the two
reports:

1. `assets/flagship_ckpt` linked as the report's checkpoint
   (`<workdir>/model_seed1/mod085-transformer`), then
   `python -m early_exit_tpu_torch.reference_scale_run --skip_train` with
   the report's seed, n_test, word range and corpus knobs (test-clean seed
   2002, test-other 3003, dev-clean 4004; --n_train 1: the evaluation
   splits' seeds do not depend on it; n_dev is not in the report, so the
   tool's default, 240, the JAX tool's): the greedy, lexicon-beam and
   prefix-beam ladders, the raw gate, the gate calibrated on dev-clean,
   the calibrated gate and the cascade;
2. `python -m early_exit_tpu_torch.streaming_gate_report` over the same
   corpus with the flagship, the report's thresholds and, as --fast_exit,
   the shallowest exit its gated chunks sit at (2).

Each leg's wall time (process start and model load included) is the one
the tool records in its summary; its audio-s/s is the audio of the splits
it decoded over that time. Writes `<workdir>/reproduction.json` (both
reports, the committed figures, the legs) and prints the comparison: per
exit, the port's WER beside the committed one and the difference. The
acceptance bounds it prints: greedy and streaming exits 2-6 within 1.0
point of the committed WER on both splits, and at every threshold each
exit's share of chunks within 2 points. Runs on CUDA unless --device cpu.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPORTS = os.path.join(HERE, "reports")
WER_PP, SHARE_PP = 1.0, 2.0


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def load_reports():
    """The two committed reports: (refscale, streaming)."""
    out = []
    for name in ("refscale_v3_seed1.json", "streaming_gated_v3.json"):
        with open(os.path.join(REPORTS, name)) as f:
            out.append(json.load(f))
    return tuple(out)


def refscale_argv(ref, workdir, device):
    """reference_scale_run's flags for the report's corpus and seed."""
    knobs = ref["corpus_knobs"]
    lo, hi = ref["words_range"]
    return ["--workdir", workdir, "--skip_train", "--seed", str(ref["seed"]),
            "--n_train", "1", "--n_test", str(ref["n_test"]),
            "--min_words", str(lo), "--max_words", str(hi),
            "--device", device] + [
        a for k in ("noise", "noise_hi", "speaker_warp", "dur_jitter", "amp_jitter")
        for a in (f"--{k}", str(knobs[k]))]


def fast_exit(streaming) -> int:
    """The shallowest exit that the report's gated chunks sit at."""
    return min(int(e) for sweep in streaming["gated"].values()
               for split in sweep.values()
               for e, n in split["exit_histogram"].items() if n)


def ladder_rows(name, port, committed):
    rows, misses = [], []
    for e in range(1, 7):
        k = f"exit{e}"
        a, b = port.get(k), committed.get(k)
        d = None if a is None or b is None else a - b
        rows.append(f"{name} {k}: port {a} committed {b} diff "
                    f"{'n/a' if d is None else f'{d:+.2f}'}")
        if e >= 2 and (d is None or abs(d) > WER_PP):
            misses.append(f"{name} {k}: {a} vs {b}")
    return rows, misses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "refscale_v3"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    from early_exit_tpu_torch import reference_scale_run, streaming_gate_report

    ref_c, str_c = load_reports()
    card = card_line()
    print(card, flush=True)
    moddir = os.path.join(args.workdir, f"model_seed{ref_c['seed']}")
    os.makedirs(moddir, exist_ok=True)
    ckpt = os.path.join(moddir, os.path.basename(ref_c["checkpoint"]))
    if not os.path.exists(ckpt):
        os.symlink(os.path.join(HERE, "assets", "flagship_ckpt"), ckpt)
    corpus = os.path.join(args.workdir, "corpus")

    t0 = time.perf_counter()
    refscale = reference_scale_run.main(refscale_argv(ref_c, args.workdir, args.device))
    t1 = time.perf_counter()
    splits = "test-clean,test-other"
    streaming = streaming_gate_report.main(
        ["--ckpt", os.path.join(HERE, "assets", "flagship_ckpt"), "--data_root", corpus,
         "--splits", splits, "--thresholds", ",".join(str_c["gated"]),
         "--device", args.device, "--out", os.path.join(args.workdir, "streaming_gated.json"),
         "--fast_exit", str(fast_exit(str_c))])
    t2 = time.perf_counter()

    audio_s = refscale["eval_audio_s"]
    legs = [("reference_scale_run", leg["leg"], leg["splits"], leg["wall_s"])
            for leg in refscale["legs"]]
    legs += [("streaming_gate_report", name if name == "ungated" else f"threshold {name}",
              splits.split(","), wall) for name, wall in streaming["wall_s"].items()]
    legs = [{"module": mod, "leg": name, "splits": sp, "wall_s": wall,
             "audio_s": sum(audio_s[s] for s in sp),
             "audio_s_per_s": sum(audio_s[s] for s in sp) / wall}
            for mod, name, sp, wall in legs]
    for leg in legs:
        print(f"leg {leg['module']} {leg['leg']}: {leg['wall_s']:.1f} s, "
              f"{leg['audio_s']:.1f} s of audio, {leg['audio_s_per_s']:.1f} audio-s/s")

    lines, misses = [], []
    for key in ("greedy_wer_pct", "greedy_wer_other_pct", "lexicon_beam_wer_pct",
                "lexicon_beam_wer_other_pct", "prefix_beam_wer_pct",
                "prefix_beam_wer_other_pct"):
        rows, miss = ladder_rows(key, refscale.get(key, {}), ref_c.get(key, {}))
        lines += rows
        if key.startswith("greedy"):
            misses += miss
    for key in ("gated_wer_pct", "gated_mean_exits", "gated_other_wer_pct",
                "gated_other_mean_exits", "gated_cal_wer_pct", "gated_cal_mean_exits",
                "gated_cal_other_wer_pct", "gated_cal_other_mean_exits", "cascade_k",
                "cascade_wer_pct", "cascade_mean_exits_computed",
                "cascade_exit_histogram", "cascade_other_wer_pct",
                "cascade_other_mean_exits_computed", "cascade_other_exit_histogram"):
        lines.append(f"{key}: port {refscale.get(key)} committed {ref_c.get(key)}")
    lines.append(f"gate_calibration: port {refscale.get('gate_calibration')} committed "
                 f"{ref_c.get('gate_calibration')}")
    for split in ("test-clean", "test-other"):
        rows, miss = ladder_rows(f"streaming {split}",
                                 streaming["ungated_all_exits"].get(split, {}).get("wer_pct", {}),
                                 str_c["ungated_all_exits"][split]["wer_pct"])
        lines += rows
        misses += miss
        for t, sweep in streaming["gated"].items():
            got = sweep.get(split, {})
            want = str_c["gated"].get(t, {}).get(split)
            if want is None:
                lines.append(f"streaming {split} threshold {t}: port {got} (no committed figure)")
                continue
            hg, hw = got.get("exit_histogram", {}), want["exit_histogram"]
            ng, nw = max(sum(hg.values()), 1), max(sum(hw.values()), 1)
            shares = {e: (100 * hg.get(e, 0) / ng, 100 * hw[e] / nw) for e in hw}
            worst = max(abs(a - b) for a, b in shares.values())
            lines.append(f"streaming {split} threshold {t}: histogram port {hg} committed {hw}; "
                         f"WER port {got.get('wer_pct')} committed {want['wer_pct']}; "
                         f"mean exit port {got.get('mean_exit')} committed "
                         f"{want['mean_exit']}; largest share difference {worst:.2f} points")
            if worst > SHARE_PP:
                misses.append(f"streaming {split} threshold {t}: shares {shares}")
    for ln in lines:
        print(ln)
    out = {"card": card, "refscale": refscale, "streaming": streaming,
           "committed": {"refscale": ref_c, "streaming": str_c}, "legs": legs,
           "audio_s": audio_s, "refscale_s": t1 - t0, "streaming_s": t2 - t1,
           "misses": misses}
    with open(os.path.join(args.workdir, "reproduction.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(f"reference_scale_run {t1 - t0:.1f} s, streaming_gate_report {t2 - t1:.1f} s on {card}")
    print(json.dumps({"misses": misses}))
    return out


if __name__ == "__main__":
    main()
