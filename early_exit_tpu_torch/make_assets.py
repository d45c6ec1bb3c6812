"""Build the tokenizer assets (`assets/spm/`) with the port's own tools
(counterpart of `tools/make_assets.py`, the same recipe byte for byte).

    python -m early_exit_tpu_torch.make_assets --out DIR [--lines 20000]
        [--seed 0] [--vocab_size 256] [--input text.txt]

Recipe:
  * text: a deterministic transcript sample (`np.random.RandomState(seed)`)
    drawing 2..28 words a line, alternately from the synthetic corpus's
    word list (`data/synthetic.py` `_WORDS`) and from its morphological
    expansion (`expand_words`), written to DIR/train_text.txt; or
    --input, a text file of one's own;
  * `eet_spm train --model_type=bpe --vocab_size=256
    --character_coverage=1.0 --pad_id=126 --unk_id=127 --bos_id=1
    --eos_id=2 --user_defined_symbols=@` (blank "@" = id 0), the program
    built by `_native.build_cli()`;
  * .tok: the pieces in id order, lowercased;
  * .lex: every expanded word, lowercased, TAB, its pieces lowercased
    (encoded by the port's `load_tokenizer`);
  * words.txt: the lexicon's words, one a line.

--out is required: the tool never rewrites the committed `assets/spm/`
unless told to. At its defaults it reproduces the five committed files
(synth.bpe-256.model / .vocab / .tok / .lex and words.txt).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

STEM = "synth.bpe-256"


def expand_words(words):
    """The corpus word list with its morphological expansion (plurals,
    -ING/-ED/-ER/-EST/-LY, UN-/RE-), so that the BPE learns stems and
    affixes rather than one piece a word."""
    out = set(words)
    for w in words:
        if not w.isalpha():
            continue
        out.add(w + "S" if not w.endswith("S") else w + "ES")
        stem = w[:-1] if w.endswith("E") else w
        out.update((stem + "ING", stem + "ED", stem + "ER", stem + "EST"))
        out.update((w + "LY", "UN" + w, "RE" + w))
    return sorted(out)


def write_transcripts(path: str, lines: int, seed: int, words, full) -> None:
    """`lines` lines of 2..28 words, even lines from `words`, odd ones from
    `full`, drawn by `np.random.RandomState(seed)`."""
    rng = np.random.RandomState(seed)
    with open(path, "w", encoding="utf-8") as f:
        for k in range(lines):
            src = words if k % 2 == 0 else full
            n = rng.randint(2, 29)
            f.write(" ".join(src[rng.randint(len(src))] for _ in range(n)) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True,
                    help="directory for the model, .tok, .lex and words.txt")
    ap.add_argument("--lines", type=int, default=20000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--vocab_size", type=int, default=256)
    ap.add_argument("--input", default=None,
                    help="train on this text file instead of the generated "
                         "synthetic transcripts")
    args = ap.parse_args(argv)

    from early_exit_tpu_torch import _native
    from early_exit_tpu_torch.data.synthetic import _WORDS
    from early_exit_tpu_torch.tokenizer import load_tokenizer

    os.makedirs(args.out, exist_ok=True)
    words = list(_WORDS)
    full = expand_words(words)
    text_path = args.input
    if text_path is None:
        text_path = os.path.join(args.out, "train_text.txt")
        write_transcripts(text_path, args.lines, args.seed, words, full)

    prefix = os.path.join(args.out, STEM)
    subprocess.run([_native.build_cli(), "train", f"--input={text_path}",
                    f"--model_prefix={prefix}", f"--vocab_size={args.vocab_size}",
                    "--character_coverage=1.0", "--model_type=bpe",
                    "--pad_id=126", "--unk_id=127", "--bos_id=1",
                    "--eos_id=2", "--user_defined_symbols=@"], check=True)

    tok = load_tokenizer(prefix + ".model")
    n = tok.get_piece_size()
    if n != args.vocab_size:
        sys.exit(f"trained vocab {n} != requested {args.vocab_size}")
    with open(prefix + ".tok", "w", encoding="utf-8") as f:
        for i in range(n):
            f.write(tok.id_to_piece(i).lower() + "\n")
    lex_words = sorted({w.lower() for w in full})
    with open(prefix + ".lex", "w", encoding="utf-8") as f:
        for w in lex_words:
            pieces = " ".join(tok.id_to_piece(i).lower() for i in tok.encode(w.upper()))
            f.write(f"{w}\t{pieces}\n")
    with open(os.path.join(args.out, "words.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(lex_words) + "\n")
    print(f"wrote {prefix}.model/.tok/.lex ({n} pieces, "
          f"{len(lex_words)} lexicon words)")


if __name__ == "__main__":
    main()
