"""Length bucketing (a copy of `early_exit_tpu/data/bucketing.py`).

Each batch is sorted by length and cut into `--n_batch_split` sub-batches
of roughly equal total samples; each sub-batch's time axis is rounded up
to a bucket boundary and its batch and label axes to small multiples.
PyTorch needs no static shapes, but the port keeps the JAX package's
buckets so both packages see the same batches (and the CUDA caching
allocator sees few distinct sizes).
"""

from __future__ import annotations

from typing import List, Sequence, TypeVar

T = TypeVar("T")


def split_equal_total(items: Sequence[T], sizes: Sequence[int],
                      n_split: int) -> List[List[T]]:
    """Sort desc by size and greedily cut into ~equal-total chunks
    (util/data_loader.py:166-188 semantics, including the trailing
    remainder chunk)."""
    order = sorted(range(len(items)), key=lambda i: sizes[i], reverse=True)
    total = sum(sizes)
    target = total / max(n_split, 1)
    chunks: List[List[T]] = []
    cur: List[T] = []
    acc = 0
    for idx in order:
        cur.append(items[idx])
        acc += sizes[idx]
        if acc >= target and len(chunks) < n_split - 1:
            chunks.append(cur)
            cur = []
            acc = 0
    if cur:
        chunks.append(cur)
    return chunks


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


_BATCH_BUCKETS = (1, 2, 4, 8, 12, 16, 24, 32, 48, 64, 96, 128)


def bucket_batch_size(n: int) -> int:
    for b in _BATCH_BUCKETS:
        if n <= b:
            return b
    return round_up(n, 32)


def bucket_frames(t: int, granularity: int = 100) -> int:
    """Quantise a frame count (~1 s granularity at 10 ms hop)."""
    return max(round_up(t, granularity), granularity)


def bucket_labels(l: int, granularity: int = 16) -> int:
    return max(round_up(l, granularity), granularity)
