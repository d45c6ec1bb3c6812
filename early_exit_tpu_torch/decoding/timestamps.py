"""Word timestamps from CTC forced alignment (counterpart of
`early_exit_tpu/decoding/timestamps.py`).

A decoded hypothesis is aligned back to its emission
(`decoding/forced_align.py`), subword pieces are grouped into words at
the SentencePiece word-boundary marker, and each word gets its start and
end seconds and a confidence. The alignment is softmax-invariant (both
transitions of a frame add an emission of that frame), so raw logits
align as log-probs do; the confidences are normalised on the host over
the aligned frames only.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from early_exit_tpu_torch.decoding.forced_align import forced_align


@dataclasses.dataclass
class WordSpan:
    word: str
    start: float          # seconds
    end: float            # seconds
    score: float          # exp(mean per-piece log-prob), in (0, 1]


def pieces_of(tokenizer, ids: Sequence[int]) -> List[str]:
    """The surface pieces of a decoded id sequence (SentencePiece's
    id_to_piece; one character an id for the character tokenizer)."""
    if hasattr(tokenizer, "id_to_piece"):
        return [tokenizer.id_to_piece(int(i)) for i in ids]
    return [tokenizer.int_to_text([int(i)]) for i in ids]


def _is_control(piece: str) -> bool:
    return len(piece) > 2 and piece[0] == "<" and piece[-1] == ">"


def word_timestamps(emission, n_frames: int, token_ids: Sequence[int],
                    pieces: Sequence[str], *, blank: int = 0,
                    seconds_per_frame: float) -> List[WordSpan]:
    """One utterance's hypothesis aligned to its emission (T, V) of
    log-probs or raw logits, n_frames of it valid. Control pieces (<s>,
    </s>, ...) are aligned but emit no word. Returns [] when the
    hypothesis has more tokens than the frames can hold."""
    ids = [int(i) for i in token_ids]
    if len(ids) != len(pieces):
        raise ValueError("token_ids and pieces length mismatch")
    if not ids:
        return []
    em = torch.as_tensor(emission)[: int(n_frames)].float().cpu().numpy()
    starts, ends, _ = forced_align(em, ids, blank)
    if np.any(starts < 0):
        return []
    rows = em[starts].astype(np.float64)                       # (L, V)
    logz = np.log(np.sum(np.exp(rows - rows.max(axis=1, keepdims=True)),
                         axis=1)) + rows.max(axis=1)
    piece_logp = rows[np.arange(len(ids)), ids] - logz

    words: List[WordSpan] = []
    cur: List[int] = []
    text = ""

    def flush():
        nonlocal cur, text
        if cur and text:
            t0 = float(starts[cur[0]]) * seconds_per_frame
            # end-exclusive: the final piece's last aligned frame + 1
            t1 = (float(ends[cur[-1]]) + 1.0) * seconds_per_frame
            words.append(WordSpan(text, round(t0, 3), round(t1, 3),
                                  float(np.exp(piece_logp[cur].mean()))))
        cur, text = [], ""

    for i, piece in enumerate(pieces):
        if _is_control(piece) or piece.strip() in ("", "▁"):
            flush()
            continue
        if piece.startswith("▁"):
            flush()
            piece = piece[1:]
        cur.append(i)
        text += piece
    flush()
    return words


def format_spans(spans: List[WordSpan]) -> str:
    return " ".join(f"{w.word}[{w.start:.2f}-{w.end:.2f}|{w.score:.2f}]" for w in spans)
