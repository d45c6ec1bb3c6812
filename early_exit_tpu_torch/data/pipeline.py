"""Data pipeline: load -> clean -> tokenize -> bucket on the host, mel
on the device (counterpart of `early_exit_tpu/data/pipeline.py`).

Training cleans labels with `clean_train_label` and drops items whose
label reaches `max_utterance_length`; `infer_mode=True` (the inference
CLI) cleans with `clean_infer_label` and drops only the items it marks
as not scored.

Host threads build each sub-batch: the items' waveforms, cleaned and
encoded labels, the equal-total split into `n_batch_split` sub-batches,
and padding to bucketed shapes, the waveform in the int16 wire format
(half the bytes of float32). The consumer copies a sub-batch to the
device (from pinned memory on CUDA) and computes the mel features there
(`ops/frontend.mel_spectrogram`, the configured method). Sub-batches are
yielded in order from a bounded window of futures; a failed build raises
in the consumer.

Each yielded batch: {"feats" (B, T, n_mels) float32, "feat_lengths" (B,)
int32, "labels" (B, L) int32 padded with pad_id, "label_lengths" (B,)
int32, "item_mask" (B,) float32} on the pipeline's device, B and T and L
bucketed; rows past the real items have no frames, no label and mask 0.

Data parallelism (`shard=(index, count)`, a rank's batch index and the
number of batch shards): every rank walks the same shuffled epoch and
reads each batch's transcripts and sample counts (`dataset.meta(i)`, no
audio), which decide the split into sub-batches and each one's T and L;
it then reads the audio of only its block of rows of each global
sub-batch, padding rows included, and builds, copies and featurizes
those at the global T and L, so that shapes and the chunk mask are the
single-rank step's. A bucketed B that count does not divide raises.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from early_exit_tpu_torch import runtime
from early_exit_tpu_torch.configs import AudioConfig, TrainConfig
from early_exit_tpu_torch.data import bucketing, text as text_mod
from early_exit_tpu_torch.ops import frontend


FRAME_BUCKET = 100     # frames (1 s at a 10 ms hop)
LABEL_BUCKET = 16      # label ids
PREFETCH = 4           # sub-batches built ahead of the consumer


class Pipeline:
    def __init__(self, dataset, tokenizer, audio_cfg: AudioConfig,
                 train_cfg: TrainConfig, *, bpe: bool = True,
                 shuffle: bool = True, seed: int = 0, infer_mode: bool = False,
                 workers: int = 4, device=None,
                 shard: Optional[Tuple[int, int]] = None):
        self.ds = dataset
        self.tok = tokenizer
        self.acfg = audio_cfg
        self.tcfg = train_cfg
        self.bpe = bpe
        self.shuffle = shuffle
        self.seed = seed
        self.infer_mode = infer_mode
        self.workers = max(workers, 1)
        self.device = runtime.resolve_device(device)
        self.shard = shard
        self._clip_warned = False

    def batches_per_epoch(self) -> int:
        return max(len(self.ds) // self.tcfg.batch_size, 1)

    def _target(self, transcript: str):
        """(label ids, label) of a transcript, or None where it is dropped."""
        if self.infer_mode:
            label = text_mod.clean_infer_label(transcript)
            if label is None:
                return None
        else:
            label = text_mod.clean_train_label(transcript)
            if len(label) >= self.tcfg.max_utterance_length:
                return None
        return text_mod.encode_target(label, self.tok, bpe=self.bpe), label

    def _load_item(self, i: int):
        utt = self.ds[i]
        target = self._target(utt.transcript)
        return None if target is None else (utt.waveform, *target)

    def _item_meta(self, i: int):
        """(i, label ids, label, sample count) without reading the audio."""
        n_samples, transcript = self.ds.meta(i)
        target = self._target(transcript)
        return None if target is None else (i, *target, n_samples)

    def _read_audio(self, i: int, n_samples: int) -> np.ndarray:
        wav = self.ds[i].waveform
        if len(wav) != n_samples:
            raise ValueError(f"utterance {i}: {len(wav)} samples where its metadata "
                             f"says {n_samples}; the ranks would pad apart")
        return wav

    @staticmethod
    def _rows(nb: int, shard: Optional[Tuple[int, int]]) -> range:
        """The rows of a bucketed sub-batch of nb that a shard takes."""
        if shard is None:
            return range(nb)
        index, count = shard
        if nb % count:
            raise ValueError(
                f"a global sub-batch of B={nb} rows (bucketed) is not a multiple of "
                f"dp x dcn = {count}: every rank takes an equal share of the rows")
        return range(index * nb // count, (index + 1) * nb // count)

    def host_subbatch(self, items, shard: Optional[Tuple[int, int]] = None,
                      lengths=None) -> dict:
        """items [(waveform, ids, label)] -> numpy arrays at bucketed
        shapes: "wav" (B, N) int16, "n_samples", "labels",
        "label_lengths", "item_mask". shard (index, count): only the
        index-th of count equal row blocks of the global sub-batch, at the
        global sub-batch's N and L; the waveforms outside it are not read
        (they may be None) where `lengths` gives every item's sample
        count."""
        n = len(items)
        nb = bucketing.bucket_batch_size(n)
        rows = self._rows(nb, shard)
        max_samples = max(len(w) for w, _, _ in items) if lengths is None else max(lengths)
        # quantise frames, then the sample count that yields them
        frames = 1 + max_samples // self.acfg.hop_length
        frames_b = bucketing.bucket_frames(frames, FRAME_BUCKET)
        samples_b = (frames_b - 1) * self.acfg.hop_length
        l_b = bucketing.bucket_labels(max(len(ids) for _, ids, _ in items),
                                      LABEL_BUCKET)
        wav = np.zeros((len(rows), samples_b), np.int16)
        labels = np.full((len(rows), l_b), self.tok.pad_id(), np.int32)
        n_samples = np.zeros((len(rows),), np.int32)
        label_len = np.zeros((len(rows),), np.int32)
        for j, (w, ids, _) in enumerate(items[rows.start:rows.stop]):
            scaled = np.asarray(w[:samples_b], np.float32) * 32768.0
            if not self._clip_warned and scaled.size and (
                    scaled.max() > 32767.0 or scaled.min() < -32768.0):
                print("warning: waveform samples outside [-1, 1) clipped "
                      "by the int16 wire format (normalize the source "
                      "audio); further clips are silent")
                self._clip_warned = True
            wav[j, :len(scaled)] = np.clip(scaled, -32768, 32767).astype(np.int16)
            n_samples[j] = len(scaled)
            ids = ids[:l_b]
            labels[j, :len(ids)] = ids
            label_len[j] = len(ids)
        return {"wav": wav, "n_samples": n_samples, "labels": labels,
                "label_lengths": label_len,
                "item_mask": (np.asarray(rows) < n).astype(np.float32)}

    def _pinned(self, host: dict) -> dict:
        out = {k: torch.from_numpy(v) for k, v in host.items()}
        if self.device.type == "cuda":
            out["wav"] = out["wav"].pin_memory()
        return out

    def _build(self, items) -> dict:
        if self.shard is None:
            return self._pinned(self.host_subbatch(items))
        # items are _item_meta's: read the audio of this shard's rows only
        rows = self._rows(bucketing.bucket_batch_size(len(items)), self.shard)
        loaded = [(self._read_audio(i, n) if j in rows else None, ids, label)
                  for j, (i, ids, label, n) in enumerate(items)]
        return self._pinned(self.host_subbatch(loaded, self.shard,
                                               [m[3] for m in items]))

    def to_device(self, host: dict) -> dict:
        """The device half: the waveform copied, then its mel features."""
        dev = self.device
        wav = host["wav"].to(dev, non_blocking=True).float() * (1.0 / 32768.0)
        feats = frontend.mel_spectrogram(wav, self.acfg, method=self.acfg.mel_method)
        lengths = frontend.mel_lengths(host["n_samples"], self.acfg.hop_length)
        return {"feats": feats, "feat_lengths": lengths.to(dev),
                "labels": host["labels"].to(dev),
                "label_lengths": host["label_lengths"].to(dev),
                "item_mask": host["item_mask"].to(dev)}

    def _epoch_host(self, epoch: int, pool) -> Iterator[List]:
        """Yields each batch's non-empty sub-batches (lists of items)."""
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(idx)
        bs = self.tcfg.batch_size
        # the trailing partial batch is kept (drop_last=False)
        for start in range(0, len(idx), bs):
            ids = [int(i) for i in idx[start:start + bs]]
            load = self._load_item if self.shard is None else self._item_meta
            chunk = [it for it in pool.map(load, ids) if it is not None]
            if not chunk:
                continue
            sizes = ([len(w) for w, _, _ in chunk] if self.shard is None
                     else [m[3] for m in chunk])
            splits = bucketing.split_equal_total(chunk, sizes, self.tcfg.n_batch_split)
            yield [s for s in splits if s]

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        """Device batches of one epoch, in order; the host builds of the
        next PREFETCH sub-batches overlap the consumer's steps."""
        with ThreadPoolExecutor(self.workers) as loaders, \
                ThreadPoolExecutor(PREFETCH) as assemblers:
            pending: deque = deque()
            for splits in self._epoch_host(epoch, loaders):
                for s in splits:
                    pending.append(assemblers.submit(self._build, s))
                    while len(pending) >= PREFETCH:
                        yield self.to_device(pending.popleft().result())
            while pending:
                yield self.to_device(pending.popleft().result())
