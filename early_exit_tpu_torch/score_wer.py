"""Offline WER scorer over inference transcripts (the counterpart of
`tools/score_wer.py`).

The inference CLI prints `EXPECTED:` / `BEAM_OUT_ n :` pairs (and
`GATED_OUT (exit n):` under the gate); this scores a saved log:

    python -m early_exit_tpu_torch.inference ... | tee decode.log
    python -m early_exit_tpu_torch.score_wer decode.log

Prints the corpus WER of each exit (and of the gated output), the JAX
tool's lines. Hypotheses are paired with references by their order within
each exit. No device is involved.
"""

import argparse
import re
import sys

from early_exit_tpu_torch.utils.metrics import WerAccumulator

EXPECTED = re.compile(r"EXPECTED:\s*(.*)$")
BEAM = re.compile(r"BEAM_OUT_\s*(\d+)\s*:\s*(.*)$")
GATED = re.compile(r"GATED_OUT \(exit (\d+)\):\s*(.*)$")


def score(lines):
    """The printed lines for an iterable of log lines."""
    refs = []           # EXPECTED lines in order
    hyps = {}           # exit -> list of (ref_index, hyp)
    gated = []          # (ref_index, hyp)
    for line in lines:
        m = EXPECTED.search(line)
        if m:
            refs.append(m.group(1).strip())
            continue
        m = BEAM.search(line)
        if m:
            per_exit = hyps.setdefault(int(m.group(1)), [])
            per_exit.append((len(per_exit), m.group(2).strip()))
            continue
        m = GATED.search(line)
        if m:
            gated.append((len(gated), m.group(2).strip()))

    if not refs:
        sys.exit("no EXPECTED lines found")
    out = []
    for e in sorted(hyps):
        acc = WerAccumulator()
        for idx, hyp in hyps[e]:
            if idx < len(refs):
                acc.add(refs[idx], hyp)
        out.append(f"exit {e}: WER {100 * acc.value:.2f}% "
                   f"({acc.utterances} utts, {acc.words} ref words)")
    if gated:
        acc = WerAccumulator()
        for idx, hyp in gated:
            if idx < len(refs):
                acc.add(refs[idx], hyp)
        out.append(f"gated: WER {100 * acc.value:.2f}% ({acc.utterances} utts)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("log", nargs="?", default="-")
    args = ap.parse_args(argv)
    if args.log == "-":
        out = score(sys.stdin)
    else:
        with open(args.log) as f:
            out = score(f)
    for line in out:
        print(line)
    return out


if __name__ == "__main__":
    main()
