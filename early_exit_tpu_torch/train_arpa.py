"""Train a small ARPA n-gram word LM from a text file (the counterpart of
`tools/train_arpa.py`; pure Python, its output byte for byte).

The reference pipeline assumes an externally-trained KenLM binary/ARPA
for shallow fusion (util/beam_infer.py:77-78 `lm="lm.bin"`,
`4gram_small.arpa.lm`); this makes the framework self-sufficient: train
an ARPA here, decode with `python -m early_exit_tpu_torch.inference
--decode lexicon_beam --lm_path out.arpa --lm_weight ...` (the
Katz-backoff reader of `decoding/ngram_lm.py`, csrc/beam/arpa_lm.cc).

Estimator: absolute discounting with backoff (Ney et al.) -- for each
history h with continuation w:

    p(w|h)  = max(c(h,w) - D, 0) / c(h)            (seen n-grams)
    bow(h)  = (D * N1+(h)) / c(h) / (1 - sum_{w seen after h} p_lower(w))

which guarantees a proper distribution and non-positive log10 probs, as
arpa_lm.cc expects. Sentence boundaries use <s>/</s>; OOV mass goes to
<unk>.

Usage:
  python -m early_exit_tpu_torch.train_arpa --text corpus.txt --out lm.arpa [--order 2]
"""

from __future__ import annotations

import argparse
import math
import sys
from collections import Counter

LOG10_MIN = -99.0        # ARPA convention for "effectively zero"


def _read_sentences(path: str) -> list[list[str]]:
    sents = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            words = line.strip().lower().split()
            if words:
                sents.append(words)
    if not sents:
        sys.exit(f"no sentences in {path}")
    return sents


def train(sents: list[list[str]], order: int, discount: float = 0.75):
    """Returns {n: {ngram_tuple: (log10_prob, log10_bow|None)}}."""
    counts = {n: Counter() for n in range(1, order + 1)}
    for words in sents:
        toks = ["<s>"] + words + ["</s>"]
        for n in range(1, order + 1):
            for i in range(len(toks) - n + 1):
                if n == 1 and toks[i] == "<s>":
                    # <s> is context-only: it gets a prob entry of -99
                    continue
                counts[n][tuple(toks[i:i + n])] += 1
    counts[1][("<unk>",)] += 1           # reserve OOV mass
    counts[1][("<s>",)] = 0              # listed, never predicted

    tables: dict[int, dict[tuple, list]] = {n: {} for n in range(1, order + 1)}

    # unigrams: ML with one discount share to <unk> via add-to-count above
    total = sum(counts[1].values())
    for w, c in counts[1].items():
        lp = LOG10_MIN if c == 0 else math.log10(c / total)
        tables[1][w] = [lp, None]

    def prob_of(ngram: tuple) -> float:
        """Backoff probability of ngram under the tables built so far."""
        n = len(ngram)
        ent = tables[n].get(ngram)
        if ent is not None:
            return 10.0 ** ent[0]
        if n == 1:
            return 10.0 ** tables[1][("<unk>",)][0]
        bow_ent = tables[n - 1].get(ngram[:-1])
        bow = 10.0 ** bow_ent[1] if bow_ent is not None and \
            bow_ent[1] is not None else 1.0
        return bow * prob_of(ngram[1:])

    for n in range(2, order + 1):
        ctx_count: Counter = Counter()
        successors: dict[tuple, list[tuple]] = {}
        for ng, c in counts[n].items():
            ctx = ng[:-1]
            ctx_count[ctx] += c
            successors.setdefault(ctx, []).append(ng)
        for ng, c in counts[n].items():
            p = max(c - discount, 0.0) / ctx_count[ng[:-1]]
            tables[n][ng] = [math.log10(p) if p > 0 else LOG10_MIN, None]
        # backoff weights live on (n-1)-grams that appear as contexts
        for ctx, succ in successors.items():
            reserved = discount * len(succ) / ctx_count[ctx]
            covered = sum(prob_of(ng[1:]) for ng in succ)
            leftover = 1.0 - covered
            if leftover < 1e-9:
                # degenerate corpus: the lower order assigns ~all mass to
                # this context's successors, so reserved/leftover blows
                # up; cap at 1 to keep the distribution proper
                print(f"warning: backoff for context {ctx} clamped "
                      f"(lower-order coverage {covered:.6f})")
                bow = min(reserved, 1.0)
            else:
                bow = reserved / leftover
            ent = tables[n - 1].get(ctx)
            if ent is None:     # e.g. (<s>,) contexts for n=3
                ent = tables[n - 1].setdefault(ctx, [LOG10_MIN, None])
            ent[1] = math.log10(max(bow, 1e-99))
    return tables


def write_arpa(tables, path: str) -> None:
    order = max(tables)
    with open(path, "w", encoding="utf-8") as f:
        f.write("\\data\\\n")
        for n in range(1, order + 1):
            f.write(f"ngram {n}={len(tables[n])}\n")
        f.write("\n")
        for n in range(1, order + 1):
            f.write(f"\\{n}-grams:\n")
            for ng in sorted(tables[n]):
                lp, bow = tables[n][ng]
                line = f"{lp:.6f}\t{' '.join(ng)}"
                if bow is not None and n < order:
                    line += f"\t{bow:.6f}"
                f.write(line + "\n")
            f.write("\n")
        f.write("\\end\\\n")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--text", required=True,
                    help="training text, one sentence per line")
    ap.add_argument("--out", required=True, help="output .arpa path")
    ap.add_argument("--order", type=int, default=2, choices=(1, 2, 3))
    ap.add_argument("--discount", type=float, default=0.75)
    args = ap.parse_args(argv)

    sents = _read_sentences(args.text)
    tables = train(sents, args.order, args.discount)
    write_arpa(tables, args.out)
    print(f"wrote {args.out}: order {args.order}, "
          + ", ".join(f"{len(tables[n])} {n}-grams"
                      for n in sorted(tables)))


if __name__ == "__main__":
    main()
