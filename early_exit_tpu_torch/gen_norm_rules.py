"""Generate the normalization rule TSVs (nfkc, nmt_nfkc) from CPython's
`unicodedata` tables (counterpart of `tools/gen_norm_rules.py`, the same
files byte for byte).

    python -m early_exit_tpu_torch.gen_norm_rules OUTDIR

Rules:
- every codepoint whose NFKC form differs from itself;
- every codepoint's NFKD expansion mapped to its NFKC form (the
  composition direction: "e" + COMBINING ACUTE -> "é", Hangul jamo L V T
  -> the precomposed syllable);
- halfwidth katakana + voicing-mark pairs (compatibility sequences that
  are no single codepoint's decomposition);
- for nmt_nfkc also the NMT whitespace and control handling: C0/C1
  controls and zero-width characters removed or mapped to a space.

Format (the public SentencePiece rule format): the source sequence's hex
codepoints, a tab, the replacement's. OUTDIR is required; the committed
tables live in `csrc/tokenizer/data/`, which `_native` compiles with
`eet_charsmap_compile`.
"""

from __future__ import annotations

import argparse
import os
import unicodedata

# the first line of each table, as the committed tables carry it
HEADER = "# generated by tools/gen_norm_rules.py — do not edit\n"


def _cps(s: str) -> str:
    return " ".join(f"{ord(c):04X}" for c in s)


def nfkc_rules() -> dict:
    rules = {}
    for cp in range(0x110000):
        if 0xD800 <= cp <= 0xDFFF:
            continue
        c = chr(cp)
        k = unicodedata.normalize("NFKC", c)
        if k != c:
            rules[c] = k
        d = unicodedata.normalize("NFKD", c)
        if d != c and len(d) > 1:
            kd = unicodedata.normalize("NFKC", d)
            if kd != d:
                rules[d] = kd
    for base in range(0xFF61, 0xFF9E):
        for mark in (0xFF9E, 0xFF9F):
            seq = chr(base) + chr(mark)
            k = unicodedata.normalize("NFKC", seq)
            naive = (unicodedata.normalize("NFKC", chr(base))
                     + unicodedata.normalize("NFKC", chr(mark)))
            if k != naive:
                rules[seq] = k
    return rules


def nmt_extras() -> dict:
    """The NMT whitespace and control handling over NFKC."""
    drop = list(range(0x01, 0x09)) + [0x0B] + list(range(0x0E, 0x20)) + [0x7F]
    to_space = [0x09, 0x0A, 0x0C, 0x0D, 0x200B, 0x200C, 0xFEFF, 0x2028, 0x2029]
    return {**{chr(cp): "" for cp in drop}, **{chr(cp): " " for cp in to_space}}


def write_tsv(rules: dict, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(HEADER)
        for src in sorted(rules):
            f.write(f"{_cps(src)}\t{_cps(rules[src])}\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("outdir", help="directory for nfkc.tsv and nmt_nfkc.tsv")
    outdir = ap.parse_args(argv).outdir
    os.makedirs(outdir, exist_ok=True)
    nfkc = nfkc_rules()
    write_tsv(nfkc, os.path.join(outdir, "nfkc.tsv"))
    nmt = {**nfkc, **nmt_extras()}
    write_tsv(nmt, os.path.join(outdir, "nmt_nfkc.tsv"))
    print(f"nfkc: {len(nfkc)} rules, nmt_nfkc: {len(nmt)} rules -> {outdir}")


if __name__ == "__main__":
    main()
