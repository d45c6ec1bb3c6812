"""Time the greedy CTC collapse variants at the serving geometry
(counterpart of `tools/ablate_decode.py`).

    python -m early_exit_tpu_torch.ablate_decode [--device cuda]
        [--exits 6] [--batch 128] [--frames 249] [--vocab 256] [--iters 100]

The all-exit greedy decode collapses (E=6, B=128, T'=249) argmax ids:
drop repeats and blanks, keep the rest in order. Variants, all over the
E * B rows at once:
  greedy_decode_ids  the port's `ops/ctc.py` (running count by a product
                     with the (T, T) upper-triangular ones, then a scatter)
  onehot_f32         the JAX package's: a (B, T, T) one-hot product in float32
  onehot_bf16        the same one-hot product in bf16 (ids < 256 are exact)
  sort               a stable sort of the values by scatter position
  scatter            a scatter with the dropped frames sent past the end
Every variant must give the same ids (up to each row's count) and counts.
Each line: ms a call (CUDA events) and the bytes its tensors move
(each op's inputs read once and outputs written once, from the shapes).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from early_exit_tpu_torch import runtime
from early_exit_tpu_torch.ops import ctc
from early_exit_tpu_torch.utils.timing import device_ms

BLANK = 0


def _keep(best, lengths):
    """keep (R, T), each kept frame's output slot (T for the dropped), and
    the counts (R,)."""
    R, T = best.shape
    t = torch.arange(T, device=best.device)[None, :]
    prev = torch.cat([torch.full((R, 1), -1, dtype=best.dtype, device=best.device),
                      best[:, :-1]], dim=1)
    keep = (best != BLANK) & (best != prev) & (t < lengths[:, None])
    pos = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    return keep, torch.where(keep, pos, T), keep.sum(1)


def collapse_onehot(best, lengths, dtype):
    keep, slot, n = _keep(best, lengths)
    T = best.shape[1]
    onehot = (slot[:, :, None] == torch.arange(T, device=best.device)).to(dtype)
    vals = torch.where(keep, best, 0).to(dtype)
    out = torch.bmm(vals[:, None, :], onehot)[:, 0]
    return out.float().to(best.dtype), n


def collapse_sort(best, lengths):
    keep, slot, n = _keep(best, lengths)
    order = torch.sort(slot, dim=1, stable=True).indices
    return torch.where(keep, best, 0).gather(1, order), n


def collapse_scatter(best, lengths):
    keep, slot, n = _keep(best, lengths)
    R, T = best.shape
    out = torch.zeros(R, T + 1, dtype=best.dtype, device=best.device)
    out.scatter_(1, slot, torch.where(keep, best, 0))
    return out[:, :T], n


def variants():
    return {
        "greedy_decode_ids": lambda b, n: ctc.greedy_decode_ids(b, n, blank=BLANK),
        "onehot_f32": lambda b, n: collapse_onehot(b, n, torch.float32),
        "onehot_bf16": lambda b, n: collapse_onehot(b, n, torch.bfloat16),
        "sort": collapse_sort,
        "scatter": collapse_scatter,
    }


def bytes_moved(name: str, R: int, T: int) -> int:
    """The bytes of each variant's main tensors, from the shapes: the ids
    in and out (int32 here, int64 inside the port's decoder), the keep
    mask and slots, and what the variant materializes beyond them."""
    base = R * T * (4 + 4 + 1 + 8)            # ids in, ids out, keep, slots
    extra = {"greedy_decode_ids": R * T * 8 + T * T * 4,   # running count, (T, T) ones
             "onehot_f32": 2 * R * T * T * 4,             # one-hot written, read
             "onehot_bf16": 2 * R * T * T * 2,
             "sort": 2 * R * T * 8,                       # sorted keys, indices
             "scatter": R * (T + 1) * 4}
    return base + extra[name]


def run(device, E, B, T, V, iters, seed=0, out=print):
    """Checks every variant against the port's decoder and times it;
    returns {name: (ms, bytes)} and the reference (ids, counts)."""
    rng = np.random.RandomState(seed)
    ids = torch.from_numpy(rng.randint(0, V, size=(E * B, T)).astype(np.int32)).to(device)
    lengths = torch.from_numpy(
        np.tile(rng.randint(T // 2, T, size=(B,)), E).astype(np.int32)).to(device)
    ref = None
    times = {}
    for name, fn in variants().items():
        toks, n = fn(ids, lengths)
        toks, n = toks.cpu().numpy(), n.cpu().numpy()
        if ref is None:
            ref = (toks, n)
        else:
            if not np.array_equal(n, ref[1]):
                raise AssertionError(f"{name}: counts differ from greedy_decode_ids")
            for r in range(E * B):
                k = int(n[r])
                if not np.array_equal(toks[r, :k], ref[0][r, :k]):
                    raise AssertionError(f"{name}: ids differ at row {r}")
        ms = device_ms(lambda: fn(ids, lengths), device, iters=iters)
        nbytes = bytes_moved(name, E * B, T)
        times[name] = (ms, nbytes)
        out(f"{name:18s} {ms:8.4f} ms  {nbytes / 1e9:7.3f} GB  "
            f"({nbytes / 1e9 / (ms / 1e3):8.1f} GB/s)")
    return times, ref, (ids, lengths)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--exits", type=int, default=6)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--frames", type=int, default=249)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--iters", type=int, default=100)
    a = ap.parse_args(argv)
    dev = runtime.resolve_device(a.device)
    print(f"collapse of ({a.exits}, {a.batch}, {a.frames}) ids on {dev}")
    run(dev, a.exits, a.batch, a.frames, a.vocab, a.iters)
    print("every variant's ids and counts equal greedy_decode_ids'")


if __name__ == "__main__":
    main()
