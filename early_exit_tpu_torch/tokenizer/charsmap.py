"""SentencePiece's precompiled character-map normalizer, in plain Python
(the port's copy of `early_exit_tpu/tokenizer/charsmap.py`).

A `.model` file's NormalizerSpec may carry a `precompiled_charsmap`
(field 2) with the normalization rules the model was trained with, such
as `nmt_nfkc` (the rules of `csrc/tokenizer/data/nmt_nfkc.tsv`). This
module reads and applies that blob, so that text is normalized as the
model that produced the vocabulary normalized it.

Blob layout (the public SentencePiece/darts-clone serialization):

    [uint32 LE: trie_bytes]
    [trie_bytes of uint32 double-array units]   (darts-clone trie)
    [string pool: NUL-terminated replacement strings]

Trie keys are UTF-8 source sequences; the value stored at a key is the
byte offset of its replacement in the string pool. Normalization is
leftmost longest-match: at each position, the longest key that matches
is replaced; otherwise one UTF-8 character is copied through.

Double-array unit semantics (darts-clone, public BSD library):
    has_leaf(u) = (u >> 8) & 1        -- node has a value
    value(u)    = u & 0x7fffffff      -- valid on the dedicated value unit
    label(u)    = u & 0x800000ff      -- low byte, bit31 poisons mismatch
    offset(u)   = (u >> 10) << ((u & 0x200) >> 6)
Child of node at position p via byte c: p ^ offset ^ c. The value unit
of a node sits at p ^ offset (label 0).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

_HAS_LEAF = 1 << 8
_VALUE_MASK = 0x7FFFFFFF
_LABEL_MASK = 0x800000FF


class Charsmap:
    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError("charsmap blob too short")
        trie_bytes = struct.unpack("<I", blob[:4])[0]
        if 4 + trie_bytes > len(blob):
            raise ValueError("charsmap trie size exceeds blob")
        self.units = struct.unpack(f"<{trie_bytes // 4}I",
                                   blob[4:4 + trie_bytes])
        self.pool = blob[4 + trie_bytes:]

    def _value_at(self, node_pos: int) -> int:
        return self.units[node_pos] & _VALUE_MASK

    def longest_match(self, data: bytes, start: int
                      ) -> Optional[Tuple[int, bytes]]:
        """Longest key of the trie matching data[start:].

        Returns (match_byte_len, replacement_bytes) or None.
        """
        units = self.units
        node_pos = 0
        unit = units[0]
        node_pos ^= (unit >> 10) << ((unit & 0x200) >> 6)
        best: Optional[Tuple[int, bytes]] = None
        for i in range(start, len(data)):
            c = data[i]
            pos = node_pos ^ c
            if pos >= len(units):
                break
            unit = units[pos]
            if (unit & _LABEL_MASK) != c:
                break
            node_pos = pos ^ ((unit >> 10) << ((unit & 0x200) >> 6))
            if unit & _HAS_LEAF:
                off = self._value_at(node_pos)
                # malformed/truncated blob may lack the NUL terminator:
                # clamp to pool end like the C++ reader (charsmap.h)
                end = self.pool.find(b"\0", off)
                if end < 0:
                    end = len(self.pool)
                best = (i - start + 1, self.pool[off:end])
        return best

    def normalize_bytes(self, data: bytes) -> bytes:
        out = bytearray()
        i = 0
        n = len(data)
        while i < n:
            m = self.longest_match(data, i)
            if m is not None:
                out += m[1]
                i += m[0]
            else:
                # copy one UTF-8 character through unchanged
                step = _utf8_len(data[i])
                if i + step > n:
                    step = 1
                out += data[i:i + step]
                i += step
        return bytes(out)

    def normalize(self, text: str) -> str:
        return self.normalize_bytes(text.encode("utf-8")).decode(
            "utf-8", errors="replace")

    def extract_rules(self, max_rules: int = 1 << 22) -> Dict[bytes, bytes]:
        """Walks the whole trie (DFS over all byte labels) and returns the
        complete source→replacement map.  Test/diagnostic helper."""
        units = self.units
        rules: Dict[bytes, bytes] = {}
        root = units[0]
        stack: List[Tuple[int, bytes]] = [
            ((root >> 10) << ((root & 0x200) >> 6), b"")]
        while stack and len(rules) < max_rules:
            node_pos, prefix = stack.pop()
            for c in range(1, 256):
                pos = node_pos ^ c
                if pos >= len(units):
                    continue
                unit = units[pos]
                if (unit & _LABEL_MASK) != c:
                    continue
                child = pos ^ ((unit >> 10) << ((unit & 0x200) >> 6))
                key = prefix + bytes([c])
                if unit & _HAS_LEAF:
                    off = units[child] & _VALUE_MASK
                    # clamp to pool end on a truncated blob, like the
                    # C++ reader (charsmap.h)
                    end = self.pool.find(b"\0", off)
                    if end < 0:
                        end = len(self.pool)
                    rules[key] = self.pool[off:end]
                stack.append((child, key))
        return rules


def _utf8_len(b: int) -> int:
    if b < 0x80:
        return 1
    if b >> 5 == 0x6:
        return 2
    if b >> 4 == 0xE:
        return 3
    if b >> 3 == 0x1E:
        return 4
    return 1
