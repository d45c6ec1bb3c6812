"""Transcript cleaning and target encoding (a copy of
`early_exit_tpu/data/text.py`).

- training labels: drop "<unk>" and "[ unclear ]", then strip #^$?:;.![]
- inference labels: strip #^$,?:;.! and <unk>; utterances containing
  "ignore_time_segment_in_scoring" are skipped (None)
- BPE targets are [bos] + encode(label) + [eos]; character targets are
  "^label$" lowercased
"""

from __future__ import annotations

import re
from typing import List, Optional

_TRAIN_DROP = re.compile(r"<unk>|\[ unclear \]")
_TRAIN_PUNCT = re.compile(r"[#^$?:;.!\[\]]+")
_INFER_PUNCT = re.compile(r"[#^$,?:;.!]+|<unk>")


def clean_train_label(label: str) -> str:
    return _TRAIN_PUNCT.sub("", _TRAIN_DROP.sub("", label))


def clean_infer_label(label: str) -> Optional[str]:
    label = _INFER_PUNCT.sub("", label)
    if "ignore_time_segment_in_scoring" in label:
        return None
    return label


def encode_target(label: str, tokenizer, *, bpe: bool = True) -> List[int]:
    """Target ids with BOS/EOS, as the CTC loss takes them."""
    if bpe:
        return ([tokenizer.bos_id()] + tokenizer.encode_as_ids(label)
                + [tokenizer.eos_id()])
    return tokenizer.text_to_int("^" + label.lower() + "$")
