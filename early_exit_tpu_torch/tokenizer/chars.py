"""The legacy 32-symbol character tokenizer (`--bpe false`), a copy of
`early_exit_tpu/tokenizer/chars.py`: '@'=0 is the CTC blank, '^'=1 SOS,
'$'=31 EOS, '#'=30 PAD, space=28, a-z = 2..27, apostrophe=29."""

from __future__ import annotations

from typing import List


class CharTokenizer:
    BLANK, SOS, EOS, PAD, SPACE = 0, 1, 31, 30, 28

    def __init__(self):
        self.char_to_id = {"@": 0, "^": 1, "'": 29, "#": 30, "$": 31, " ": 28}
        for i, c in enumerate("abcdefghijklmnopqrstuvwxyz"):
            self.char_to_id[c] = 2 + i
        self.id_to_char = {v: k for k, v in self.char_to_id.items()}

    def get_piece_size(self) -> int:
        return 32

    def bos_id(self) -> int:
        return self.SOS

    def eos_id(self) -> int:
        return self.EOS

    def pad_id(self) -> int:
        return self.PAD

    def text_to_int(self, text: str) -> List[int]:
        return [self.char_to_id[c] for c in text]

    def int_to_text(self, ids) -> str:
        return "".join(self.id_to_char[int(i)] for i in ids)

    def encode_as_ids(self, text: str) -> List[int]:
        return self.text_to_int(text.lower())

    def decode(self, ids) -> str:
        return "".join(self.id_to_char[int(i)] for i in ids
                       if int(i) not in (self.SOS, self.EOS, self.PAD, self.BLANK))
