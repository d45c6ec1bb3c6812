"""The cascade's host-side re-batching plan (`serving/cascade.py`), apart
from any model code so that `serving/export.py`'s consumer can use it.

Only phase A's boolean accept mask crosses to the host; the unaccepted
rows are packed into batches of a multiple of `PACK_BATCH` rows, padded
with index 0 at item_mask 0, and phase B runs on those rows alone.
"""

from __future__ import annotations

import numpy as np

PACK_BATCH = 8   # phase-B rows are padded up to a multiple of this


def pack_escalation_indices(accepted, pack_batch: int):
    """Host-side re-batching plan. accepted: (B,) bool, the only thing of
    phase A that crosses to the host. Returns (idx (M,) int32, item_mask
    (M,) float32) with M the escalated count rounded up to a multiple of
    `pack_batch` (both empty when no row escalates, and phase B is then
    skipped). Padding repeats index 0 with item_mask 0."""
    accepted = np.asarray(accepted, bool)
    esc = np.nonzero(~accepted)[0].astype(np.int32)
    n = len(esc)
    if n == 0:
        return np.zeros((0,), np.int32), np.zeros((0,), np.float32)
    m = ((n + pack_batch - 1) // pack_batch) * pack_batch
    idx = np.zeros((m,), np.int32)
    idx[:n] = esc
    item_mask = np.zeros((m,), np.float32)
    item_mask[:n] = 1.0
    return idx, item_mask
