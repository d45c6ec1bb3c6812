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
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List

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
                 workers: int = 4, device=None):
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
        self._clip_warned = False

    def batches_per_epoch(self) -> int:
        return max(len(self.ds) // self.tcfg.batch_size, 1)

    def _load_item(self, i: int):
        utt = self.ds[i]
        if self.infer_mode:
            label = text_mod.clean_infer_label(utt.transcript)
            if label is None:
                return None
        else:
            label = text_mod.clean_train_label(utt.transcript)
            if len(label) >= self.tcfg.max_utterance_length:
                return None
        ids = text_mod.encode_target(label, self.tok, bpe=self.bpe)
        return utt.waveform, ids, label

    def host_subbatch(self, items) -> dict:
        """items [(waveform, ids, label)] -> numpy arrays at bucketed
        shapes: "wav" (B, N) int16, "n_samples", "labels",
        "label_lengths", "item_mask"."""
        n = len(items)
        nb = bucketing.bucket_batch_size(n)
        max_samples = max(len(w) for w, _, _ in items)
        # quantise frames, then the sample count that yields them
        frames = 1 + max_samples // self.acfg.hop_length
        frames_b = bucketing.bucket_frames(frames, FRAME_BUCKET)
        samples_b = (frames_b - 1) * self.acfg.hop_length
        l_b = bucketing.bucket_labels(max(len(ids) for _, ids, _ in items),
                                      LABEL_BUCKET)
        wav = np.zeros((nb, samples_b), np.int16)
        labels = np.full((nb, l_b), self.tok.pad_id(), np.int32)
        n_samples = np.zeros((nb,), np.int32)
        label_len = np.zeros((nb,), np.int32)
        for j, (w, ids, _) in enumerate(items):
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
                "item_mask": (np.arange(nb) < n).astype(np.float32)}

    def _pinned(self, host: dict) -> dict:
        out = {k: torch.from_numpy(v) for k, v in host.items()}
        if self.device.type == "cuda":
            out["wav"] = out["wav"].pin_memory()
        return out

    def _build(self, items) -> dict:
        return self._pinned(self.host_subbatch(items))

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
            chunk = [it for it in pool.map(self._load_item, ids) if it is not None]
            if not chunk:
                continue
            splits = bucketing.split_equal_total(
                chunk, [len(w) for w, _, _ in chunk], self.tcfg.n_batch_split)
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
