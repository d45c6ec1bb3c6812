"""End-to-end dress rehearsal on a disk corpus (the counterpart of
`tools/dress_rehearsal.py`).

Exercises the path a real LibriSpeech corpus takes, as ONE command:

  1. writes a mini corpus in the standard on-disk layout
     (<root>/LibriSpeech/<split>/<spk>/<chap>/*.flac + *.trans.txt),
     FLAC-encoded with the port's own writer (`data/flac.py`),
     transcripts drawn from the synthetic tone-corpus generator
     (`data/synthetic.py`: the audio encodes the text, so training
     really learns)
  2. runs `python -m early_exit_tpu_torch.train --data_root <corpus> ...`
     in a child process (the CLI surface)
  3. runs `python -m early_exit_tpu_torch.inference --decode lexicon_beam
     ...` over the test split (the native lexicon-trie beam + per-exit WER)
  4. parses the per-exit WER lines and prints one JSON summary

and checks that the loss fell and that every test utterance was decoded.
More legs with --legs: lm (`train_arpa` over the train transcripts, then
shallow fusion; the output must say "shallow fusion"), gated, aed,
streaming.

Usage:
  python -m early_exit_tpu_torch.dress_rehearsal                 # moderate run
  python -m early_exit_tpu_torch.dress_rehearsal --fast          # CI-sized smoke
  python -m early_exit_tpu_torch.dress_rehearsal --workdir dr --epochs 8 --device cpu

The flags, the checks and the JSON are the JAX tool's; its --platform is
--device here, passed to every child process. Its default is cuda (the
JAX tool's is the CPU): a missing GPU raises, it never falls back.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

from early_exit_tpu_torch import runtime


def make_corpus(root: str, split: str, n_items: int, seed: int) -> None:
    from early_exit_tpu_torch.data.flac import write_flac_verbatim
    from early_exit_tpu_torch.data.synthetic import SyntheticDataset

    ds = SyntheticDataset(n_items=n_items, seed=seed, min_words=2,
                          max_words=6)
    per_chapter = 8
    for i in range(n_items):
        utt = ds[i]
        spk, chap = "1001", f"{i // per_chapter:04d}"
        cdir = os.path.join(root, "LibriSpeech", split, spk, chap)
        os.makedirs(cdir, exist_ok=True)
        stem = f"{spk}-{chap}-{i % per_chapter:04d}"
        write_flac_verbatim(os.path.join(cdir, stem + ".flac"),
                            utt.waveform, utt.sample_rate)
        with open(os.path.join(cdir, f"{spk}-{chap}.trans.txt"), "a",
                  encoding="utf-8") as f:
            f.write(f"{stem} {utt.transcript}\n")


def run(cmd, env):
    print("+", " ".join(cmd), flush=True)
    p = subprocess.run(cmd, capture_output=True, text=True, env=env)
    sys.stdout.write(p.stdout[-4000:])
    if p.returncode != 0:
        sys.stderr.write(p.stderr[-4000:])
        sys.exit(f"command failed (rc={p.returncode}): {' '.join(cmd)}")
    return p.stdout


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--n_train", type=int, default=96)
    ap.add_argument("--n_test", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="--device of the child processes (cuda unless cpu)")
    ap.add_argument("--decode", default="lexicon_beam",
                    choices=["greedy", "prefix_beam", "lexicon_beam"])
    ap.add_argument("--legs", default="ctc",
                    help="comma list of extra end-to-end legs after the "
                         "CTC one: lm (train an ARPA from the corpus "
                         "transcripts + shallow-fusion decode), gated "
                         "(confidence-gated dynamic early exit), aed "
                         "(full_conformer joint CE+CTC train + AED "
                         "beam), streaming (chunked serving path incl. "
                         "the gated fast/deep variant)")
    ap.add_argument("--fast", action="store_true",
                    help="CI-sized: tiny corpus, 2 epochs, greedy checks")
    ap.add_argument("--d_model", type=int, default=64)
    ap.add_argument("--n_exits", type=int, default=2)
    ap.add_argument("--n_layers", type=int, default=1,
                    help="encoder layers per exit")
    ap.add_argument("--conv_norm", default="batch",
                    choices=["batch", "group"],
                    help="Conformer conv-module norm for the rehearsal "
                         "model (batch = reference parity).")
    ap.add_argument("--warmup", type=int, default=-1,
                    help="Noam warmup steps (-1 = one epoch of "
                         "sub-batches, the trainer's default). Long toy "
                         "runs are a basin lottery whatever the warmup "
                         "(the JAX package's record: 600 steps or "
                         "GroupNorm made it worse, not better; "
                         "BENCH_NOTES.md).")
    args = ap.parse_args(argv)
    if args.fast:
        args.epochs = min(args.epochs, 2)
        args.n_train, args.n_test = 24, 6

    work = args.workdir or tempfile.mkdtemp(prefix="dress_rehearsal_")
    corpus = os.path.join(work, "corpus")
    moddir = os.path.join(work, "model")
    os.makedirs(corpus, exist_ok=True)

    print(f"dress rehearsal in {work}")
    make_corpus(corpus, "train-clean-100", args.n_train, seed=1)
    make_corpus(corpus, "test-clean", args.n_test, seed=2)

    env = runtime.child_env()
    tiny = ["--d_model", str(args.d_model),
            "--n_enc_exits", str(args.n_exits),
            "--n_enc_layers_per_exit", str(args.n_layers),
            "--n_heads", "4",
            "--d_feed_forward", str(2 * args.d_model),
            "--depthwise_kernel_size", "7",
            "--conv_norm", args.conv_norm,
            "--compute_dtype", "float32", "--device", args.device]
    train_out = run([*runtime.module_command("train"),
                     "--decoder_mode", "ctc", "--data_root", corpus,
                     "--n_epochs", str(args.epochs),
                     "--warmup", str(args.warmup),
                     "--batch_size", "8", "--n_batch_split", "1",
                     "--save_model_dir", moddir, "--n_workers", "2",
                     "--log_dir", os.path.join(work, "runs"), *tiny], env)

    losses = [float(m) for m in re.findall(
        r"LOSS_TOTAL-\d+ := ([0-9.]+)", train_out)]
    if len(losses) >= 2 and not losses[-1] < losses[0]:
        sys.exit(f"training did not improve: {losses[0]} -> {losses[-1]}")

    ckpts = sorted(f for f in os.listdir(moddir) if f.endswith(
        "-transformer") and f.startswith("mod"))
    infer_out = run([*runtime.module_command("inference"),
                     "--decoder_mode", "ctc", "--data_root", corpus,
                     "--eval_splits", "test-clean",
                     "--load_model_path", os.path.join(moddir, ckpts[-1]),
                     "--decode", args.decode,
                     "--beam_size", "4", "--batch_size", "8",
                     "--n_batch_split", "1", "--n_workers", "2",
                     "--log_dir", os.path.join(work, "runs"), *tiny], env)

    wers = {f"exit{m[0]}": float(m[1]) for m in re.findall(
        r"test-clean WER exit (\d+): ([0-9.]+)%", infer_out)}
    n_utts = len(re.findall(r"test-clean EXPECTED:", infer_out))
    if not wers:
        sys.exit("no per-exit WER lines in inference output")
    if n_utts != args.n_test:
        sys.exit(f"decoded {n_utts}/{args.n_test} test utterances")

    summary = {
        "corpus": corpus, "epochs": args.epochs,
        "loss_first": losses[0] if losses else None,
        "loss_last": losses[-1] if losses else None,
        "decode": args.decode, "test_utts": n_utts, "wer_pct": wers,
    }
    legs = [l.strip() for l in args.legs.split(",") if l.strip()
            and l.strip() != "ctc"]
    ckpt = os.path.join(moddir, ckpts[-1])
    infer_base = [*runtime.module_command("inference"),
                  "--decoder_mode", "ctc", "--data_root", corpus,
                  "--eval_splits", "test-clean", "--load_model_path", ckpt,
                  "--batch_size", "8", "--n_batch_split", "1",
                  "--n_workers", "2",
                  "--log_dir", os.path.join(work, "runs"), *tiny]

    if "lm" in legs:
        # train an ARPA from the TRAIN transcripts, decode with fusion —
        # the reference's KenLM flow (util/beam_infer.py:77-78), entirely
        # in-framework (train_arpa + csrc/beam/arpa_lm.cc)
        text = os.path.join(work, "train_text.txt")
        with open(text, "w", encoding="utf-8") as f:
            root = os.path.join(corpus, "LibriSpeech", "train-clean-100")
            for dirpath, _, files in os.walk(root):
                for fn in sorted(files):
                    if fn.endswith(".trans.txt"):
                        with open(os.path.join(dirpath, fn),
                                  encoding="utf-8") as t:
                            for line in t:
                                _, _, words = line.partition(" ")
                                f.write(words.strip().lower() + "\n")
        arpa = os.path.join(work, "lm.arpa")
        run([*runtime.module_command("train_arpa"), "--text", text, "--out", arpa, "--order", "2"], env)
        lm_out = run(infer_base + ["--decode", "lexicon_beam",
                                   "--beam_size", "4",
                                   "--lm_path", arpa, "--lm_weight", "0.5"],
                     env)
        lm_wers = {f"exit{m[0]}": float(m[1]) for m in re.findall(
            r"test-clean WER exit (\d+): ([0-9.]+)%", lm_out)}
        if not lm_wers:
            sys.exit("lm leg: no WER lines")
        if "shallow fusion" not in lm_out:
            sys.exit("lm leg: fusion not engaged")
        summary["lm_wer_pct"] = lm_wers

    if "gated" in legs:
        g_out = run(infer_base + ["--decode", args.decode,
                                  "--beam_size", "4",
                                  "--exit_threshold", "0.7"], env)
        m = re.search(r"gated WER: ([0-9.]+)% \(mean exits run ([0-9.]+)",
                      g_out)
        if not m:
            sys.exit("gated leg: no gated WER line")
        summary["gated_wer_pct"] = float(m.group(1))
        summary["gated_mean_exits"] = float(m.group(2))

    if "streaming" in legs:
        # chunked serving path through the product CLI (greedy per
        # chunk; compare against wer_pct above which used args.decode)
        s_out = run(infer_base + ["--streaming", "true"], env)
        m = re.search(r"streaming WER exit \d+: ([0-9.]+)%", s_out)
        if not m:
            sys.exit("streaming leg: no streaming WER line")
        summary["streaming_wer_pct"] = float(m.group(1))
        g_out = run(infer_base + ["--streaming", "true",
                                  "--exit_threshold", "0.7"], env)
        m = re.search(r"streaming WER exit \d+: ([0-9.]+)% .*mean exit "
                      r"([0-9.]+)", g_out)
        if not m:
            sys.exit("streaming leg: no gated streaming WER line")
        summary["streaming_gated_wer_pct"] = float(m.group(1))
        summary["streaming_gated_mean_exit"] = float(m.group(2))

    if "aed" in legs:
        aed_moddir = os.path.join(work, "model_aed")
        aed_out = run([*runtime.module_command("train"),
                       "--decoder_mode", "aed", "--data_root", corpus,
                       "--n_epochs", str(max(2, args.epochs // 2)),
                       "--batch_size", "8", "--n_batch_split", "1",
                       "--save_model_dir", aed_moddir, "--n_workers", "2",
                       "--log_dir", os.path.join(work, "runs"), *tiny], env)
        aed_losses = [float(m) for m in re.findall(
            r"LOSS_TOTAL-\d+ := ([0-9.]+)", aed_out)]
        aed_ckpts = sorted(f for f in os.listdir(aed_moddir)
                           if f.startswith("mod") and
                           f.endswith("-transformer"))
        aed_inf = run([*runtime.module_command("inference"),
                       "--decoder_mode", "aed", "--data_root", corpus,
                       "--eval_splits", "test-clean",
                       "--load_model_path",
                       os.path.join(aed_moddir, aed_ckpts[-1]),
                       "--beam_size", "4", "--batch_size", "8",
                       "--n_batch_split", "1", "--n_workers", "2",
                       "--log_dir", os.path.join(work, "runs"), *tiny], env)
        aed_wers = {f"exit{m[0]}": float(m[1]) for m in re.findall(
            r"test-clean WER exit (\d+): ([0-9.]+)%", aed_inf)}
        if not aed_wers:
            sys.exit("aed leg: no WER lines")
        summary["aed_loss_first"] = aed_losses[0] if aed_losses else None
        summary["aed_loss_last"] = aed_losses[-1] if aed_losses else None
        summary["aed_wer_pct"] = aed_wers

    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
