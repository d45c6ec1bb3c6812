"""Streaming (chunked) inference for serving (counterpart of
`early_exit_tpu/serving/streaming.py`).

Audio is fed incrementally and transcripts come out chunk by chunk, with
the same trained early-exit Conformer:

- the signal is processed in fixed windows [left ctx | chunk | right ctx]
  (sizes in subsampled frames);
- the x4 conv subsampling is local, so with the window aligned to
  W = 4K + 5 mel frames every chunk-region frame has the receptive field
  it has in the whole-utterance forward; the only approximation is the
  attention truncated to the window (`left_s`/`right_s`);
- positional encodings use global stream positions
  (`nn.core.sinusoidal_pe_at`), negative ones before the stream start;
- greedy CTC carries the last emitted token across chunk boundaries, so
  repeats collapse at the seam.

A window's validity mask marks the frames before the stream start
invalid too, so it is not a prefix of the row: the window programs run
the trunk's unfused blocks (`prefix_mask=False`), never the block
kernel, which takes lengths. With `attention_impl="pallas"` the
blocks' self-attention runs the attention kernel on those masks.

Every stream of a `StreamPool` shares the one model on its device; a
pool runs one batched dispatch per round (two when gated), assembled on
the host in one pinned buffer and read back once. The window programs
run under `torch.inference_mode()` whatever the calling thread's mode.

Latency per emitted word ~ chunk_s + right_s + model time. With chunk >=
the whole utterance and no context the output equals the batch path's.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from early_exit_tpu_torch.configs import AudioConfig
from early_exit_tpu_torch.models import subsampling
from early_exit_tpu_torch.models.early_conformer import EarlyConformer
from early_exit_tpu_torch.models.registry import require_streaming
from early_exit_tpu_torch.models.early_exit_gate import exit_confidence
from early_exit_tpu_torch.nn import core
from early_exit_tpu_torch.ops import frontend


def _sub_frames_for_mel(w: int) -> int:
    """Subsampled frames produced by w mel frames (two VALID k=3 s=2)."""
    return ((w - 3) // 2 + 1 - 3) // 2 + 1


def _embed_window(model: EarlyConformer, acfg: AudioConfig, Ls: int, Cs: int,
                  causal_attention: bool, wav, pos0, n_valid):
    """mel -> subsample -> global-position PE -> validity mask -> causal
    chunk mask. wav (S, win_samples) float32; pos0 (S,) the global sub
    index of each window's first frame; n_valid (S,) valid sub frames per
    window counted from its first. Returns (x, mask, attn_mask)."""
    cfg = model.cfg
    method = acfg.mel_method if acfg.mel_method in ("fft", "dft") else "fft"
    feats = frontend.mel_spectrogram(wav, acfg, method=method)
    x = subsampling.conv_subsample_apply(list(zip(model.sub_w, model.sub_b)),
                                         feats, compute_dtype=cfg.dtype)
    s, k = x.shape[0], x.shape[1]
    ar = torch.arange(k, device=x.device)
    pos = pos0[:, None] + ar[None, :]                          # (S, K)
    pe = core.sinusoidal_pe_at(pos.reshape(-1), cfg.d_model)
    x = x.float() + pe.reshape(s, k, -1)
    mask = (pos >= 0) & (ar[None, :] < n_valid[:, None])       # (S, K)
    x = torch.where(mask[..., None], x, torch.zeros((), device=x.device))
    attn_mask = None
    if causal_attention:
        # the dynamic-chunk training pattern inside the window, from
        # global chunk ids: no frame attends a later chunk. Window index
        # i lies in chunk g + (i - Ls) // Cs; g cancels in the comparison,
        # so one (K, K) mask serves every stream and window position
        qc = torch.div(ar - Ls, Cs, rounding_mode="floor")
        attn_mask = qc[None, :] <= qc[:, None]
    return x.to(cfg.rdtype), mask, attn_mask


def window_log_probs(model: EarlyConformer, acfg: AudioConfig, Ls: int, Cs: int,
                     causal_attention: bool, wav, pos0, n_valid, *, n_exit: int):
    """The trunk up to exit n_exit (1-based) and its head over a batch of
    windows: (float32 log-probs (S, K, V), validity mask (S, K))."""
    cfg = model.cfg
    x, mask, attn_mask = _embed_window(model, acfg, Ls, Cs, causal_attention,
                                       wav, pos0, n_valid)
    h = model.stack(x, mask, n_layers=n_exit * cfg.n_enc_layers_per_exit,
                    attn_mask=attn_mask, prefix_mask=False)
    logits = core.linear(h, model.heads_w[n_exit - 1], model.heads_b[n_exit - 1],
                         compute_dtype=cfg.dtype)
    return torch.log_softmax(logits.float(), dim=-1), mask


@torch.inference_mode()
def window_forward(model: EarlyConformer, acfg: AudioConfig, Ls: int, Cs: int,
                   blank: int, causal_attention: bool, wav, pos0, n_valid, *,
                   n_exit: int, with_confidence: bool = False,
                   gate_score: str = "maxprob"):
    """Each chunk region's best-path ids (S, Cs) at exit n_exit, and with
    with_confidence the (S,) gate confidence over the chunk's valid
    frames (1.0 for a chunk with none)."""
    logp, mask = window_log_probs(model, acfg, Ls, Cs, causal_attention, wav,
                                  pos0, n_valid, n_exit=n_exit)
    best = torch.argmax(logp, dim=-1)                          # (S, K)
    best = torch.where(mask, best, torch.full_like(best, blank))
    best = best[:, Ls:Ls + Cs].to(torch.int32)
    if not with_confidence:
        return best
    cmask = mask[:, Ls:Ls + Cs]
    conf = exit_confidence(logp[:, Ls:Ls + Cs], cmask, gate_score)
    conf = torch.where(cmask.any(dim=1), conf, torch.ones_like(conf))
    return best, conf


@torch.inference_mode()
def window_forward_all_exits(model: EarlyConformer, acfg: AudioConfig, Ls: int,
                             Cs: int, blank: int, causal_attention: bool, wav,
                             pos0, n_valid):
    """Every exit from one trunk pass over a batch of windows (the
    per-exit evaluation contract). Returns (E, S, Cs) best-path ids."""
    cfg = model.cfg
    x, mask, attn_mask = _embed_window(model, acfg, Ls, Cs, causal_attention,
                                       wav, pos0, n_valid)
    _, hidden = model.stack(x, mask, collect_outputs=True,
                            collect_every=cfg.n_enc_layers_per_exit,
                            attn_mask=attn_mask, prefix_mask=False)
    logits = model.apply_heads(hidden, log_probs=False)         # (E, S, K, V)
    best = torch.argmax(logits.float(), dim=-1)
    best = torch.where(mask[None], best, torch.full_like(best, blank))
    return best[:, :, Ls:Ls + Cs].to(torch.int32)


def _fetch(*tensors) -> List[np.ndarray]:
    """Device tensors -> numpy arrays, copied into pinned host memory and
    synchronised once."""
    if tensors[0].device.type == "cpu":
        return [t.numpy() for t in tensors]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [h.numpy() for h in host]


class StreamingRecognizer:
    """Incremental recognizer over one audio stream.

    Args:
      model: a trained `EarlyConformer`, on the device the windows run on.
      audio_cfg: frontend config (16 kHz LibriSpeech default).
      tokenizer: optional; with one, `accept_waveform` returns text,
        without, token id lists.
      chunk_s: emission granularity (seconds of audio per chunk).
      left_s/right_s: attention context kept around each chunk. right_s
        adds lookahead latency; left_s only memory and compute.
      n_exit: which exit decodes the stream (1-based; default the deepest).
      causal_attention: the dynamic-chunk training pattern inside the
        window (no frame attends a later chunk; right-context audio still
        feeds the convolutions), for checkpoints trained that way.
      exit_threshold/fast_exit/gate_score: each chunk first decodes at
        fast_exit; only chunks whose gate confidence is below
        exit_threshold run the trunk to n_exit.
      all_exits: decode every exit from one trunk pass (`ids_at`).

    The waveform is consumed as given (float32); the training pipeline
    ships int16-quantised audio, identical for 16-bit sources.
    """

    def __init__(self, model: EarlyConformer,
                 audio_cfg: Optional[AudioConfig] = None, tokenizer=None, *,
                 chunk_s: float = 1.0, left_s: float = 2.0,
                 right_s: float = 0.32, n_exit: Optional[int] = None,
                 blank: Optional[int] = None, causal_attention: bool = False,
                 exit_threshold: Optional[float] = None, fast_exit: int = 1,
                 gate_score: str = "maxprob", all_exits: bool = False):
        require_streaming(model.cfg)
        self.model = model
        self.mcfg = model.cfg
        self.acfg = audio_cfg or AudioConfig()
        self.tok = tokenizer
        self.device = model.heads_w.device
        self.blank = self.mcfg.blank_id if blank is None else blank
        hop = self.acfg.hop_length
        sub_s = 4 * hop / self.acfg.sample_rate     # seconds per sub frame
        # Python's round (half to even), as the JAX package: right_s=0.5
        # at 0.04 s a frame is round(12.5) = 12
        self.Cs = max(int(round(chunk_s / sub_s)), 1)
        self.Ls = max(int(round(left_s / sub_s)), 0)
        self.Rs = max(int(round(right_s / sub_s)), 0)
        self.K = self.Ls + self.Cs + self.Rs
        self.W = 4 * self.K + 5                     # window mel frames
        self.win_samples = (self.W - 1) * hop
        self.n_exit = n_exit or self.mcfg.n_enc_exits
        self.causal_attention = causal_attention
        self.all_exits = all_exits
        if all_exits and (exit_threshold is not None or n_exit is not None):
            raise ValueError("all_exits decodes every exit; drop "
                             "n_exit/exit_threshold")
        self._n_out = self.n_exit if all_exits else 1
        if exit_threshold is not None and not 1 <= fast_exit < self.n_exit:
            print(f"streaming: exit_threshold ignored (fast_exit="
                  f"{fast_exit} must be < n_exit={self.n_exit})")
            exit_threshold = None
        self.exit_threshold = exit_threshold
        self.gate_score = gate_score
        self.fast_exit = fast_exit
        self.exits_run: List[int] = []     # per-chunk exit actually used
        self._buf: List[np.ndarray] = []
        self._buf_offset = 0          # stream index of _buf[0][0]
        self._n_samples = 0
        self._next_chunk = 0
        # per-output collapse carry and emitted ids (one output, or one
        # per exit under all_exits)
        self._last_tokens = [-1] * self._n_out
        self._ids_out: List[List[int]] = [[] for _ in range(self._n_out)]
        self._finished = False

    # -- window programs -------------------------------------------------

    def _deep(self, wav, pos0, n_valid):
        geo = (self.model, self.acfg, self.Ls, self.Cs, self.blank,
               self.causal_attention, wav, pos0, n_valid)
        if self.all_exits:
            return window_forward_all_exits(*geo)
        return window_forward(*geo, n_exit=self.n_exit)

    def _fast(self, wav, pos0, n_valid):
        return window_forward(self.model, self.acfg, self.Ls, self.Cs,
                              self.blank, self.causal_attention, wav, pos0,
                              n_valid, n_exit=self.fast_exit,
                              with_confidence=True, gate_score=self.gate_score)

    # -- internals -------------------------------------------------------

    def _window_bounds(self, g: int):
        """Sample range of the window for chunk g (may exceed the stream)."""
        s0 = 4 * (g * self.Cs - self.Ls) * self.acfg.hop_length
        return s0, s0 + self.win_samples

    def _have(self) -> np.ndarray:
        if len(self._buf) > 1:
            self._buf = [np.concatenate(self._buf)]
        return self._buf[0] if self._buf else np.zeros((0,), np.float32)

    def _trim(self) -> None:
        """Drop samples no future window needs: memory stays O(window)."""
        keep_from = max(self._window_bounds(self._next_chunk)[0], 0)
        if keep_from > self._buf_offset:
            wav = self._have()
            self._buf = [wav[keep_from - self._buf_offset:]]
            self._buf_offset = keep_from

    def _total_sub_frames(self) -> int:
        """Valid sub frames of the whole stream under the model's length
        convention: the reference rule (len/4, the training default)
        gives 1-2 more frames than exact conv arithmetic, and trained
        models place utterance-final tokens there."""
        mel = 1 + self._n_samples // self.acfg.hop_length
        if self.mcfg.length_mode == "reference":
            return max(mel // 4, 0)
        return max(_sub_frames_for_mel(mel), 0)

    def _fill_window(self, g: int, out: np.ndarray) -> int:
        """Write chunk g's window into out (win_samples,): zeros before
        the stream start and past its end. Returns the window's pos0."""
        s0, s1 = self._window_bounds(g)
        wav = self._have()
        lo = max(s0, 0) - self._buf_offset
        hi = min(s1 - self._buf_offset, len(wav))
        seg = wav[lo:hi]
        left_pad = max(-s0, 0)
        out[:left_pad] = 0.0
        out[left_pad:left_pad + len(seg)] = seg
        out[left_pad + len(seg):] = 0.0
        return g * self.Cs - self.Ls

    def _advance(self, best_row: np.ndarray) -> List[int]:
        """Collapse one chunk's best-path ids across the seam and advance.
        best_row: (Cs,), or (n_out, Cs) under all_exits. Returns the
        deepest output's new ids."""
        rows = best_row if best_row.ndim == 2 else best_row[None]
        out_last: List[int] = []
        for e in range(self._n_out):
            out = []
            last = self._last_tokens[e]
            for t in rows[e].tolist():
                if t != self.blank and t != last:
                    out.append(t)
                last = t
            self._last_tokens[e] = last
            self._ids_out[e].extend(out)
            out_last = out
        self._next_chunk += 1
        self._trim()
        return out_last

    def _run_chunk(self, g: int, n_valid_sub: int) -> List[int]:
        seg = np.empty((1, self.win_samples), np.float32)
        pos0 = self._fill_window(g, seg[0])
        wav = torch.from_numpy(seg).to(self.device)
        p0 = torch.tensor([pos0], dtype=torch.int64, device=self.device)
        nv = torch.tensor([n_valid_sub], dtype=torch.int64, device=self.device)
        if self.exit_threshold is not None:
            fbest, conf = self._fast(wav, p0, nv)
            if float(conf[0]) >= self.exit_threshold:
                self.exits_run.append(self.fast_exit)
                return self._advance(_fetch(fbest)[0][0])
        best = _fetch(self._deep(wav, p0, nv))[0]
        best = best[:, 0] if self.all_exits else best[0]
        if self.exit_threshold is not None:
            self.exits_run.append(self.n_exit)
        return self._advance(best)

    def _chunk_ready(self) -> bool:
        return self._window_bounds(self._next_chunk)[1] <= self._n_samples

    def _emit(self, ids: List[int]):
        return ids if self.tok is None else self.tok.decode(ids)

    def _append(self, samples) -> None:
        assert not self._finished, "stream already finished"
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._buf.append(samples)
        self._n_samples += len(samples)

    # -- public API ------------------------------------------------------

    def accept_waveform(self, samples):
        """Feed more audio; returns newly finalised text (or token ids)."""
        self._append(samples)
        new: List[int] = []
        # a chunk is ready once every sample its window needs has arrived;
        # mid-stream the whole window is valid context
        while self._chunk_ready():
            new += self._run_chunk(self._next_chunk, self.K)
        return self._emit(new)

    def finish(self):
        """Flush: decode the remaining tail with zero-padded lookahead."""
        assert not self._finished, "stream already finished"
        self._finished = True
        total = self._total_sub_frames()
        new: List[int] = []
        while self._next_chunk * self.Cs < total:
            g = self._next_chunk
            n_valid = min(total - (g * self.Cs - self.Ls), self.K)
            new += self._run_chunk(g, n_valid)
        return self._emit(new)

    @property
    def ids(self) -> List[int]:
        """The deepest output's ids (every mode)."""
        return list(self._ids_out[-1])

    @property
    def transcript(self):
        return self._emit(self._ids_out[-1])

    def ids_at(self, n_exit: int) -> List[int]:
        """Per-exit ids (all_exits mode; 1-based)."""
        if not self.all_exits:
            raise ValueError("ids_at requires all_exits=True")
        return list(self._ids_out[n_exit - 1])

    def transcript_at(self, n_exit: int):
        return self._emit(self.ids_at(n_exit))


class StreamPool:
    """Fixed-capacity pool of independent audio streams decoded by one
    batched window dispatch per round: a server holds a pool per device,
    `feed`s audio as it arrives per connection, and `poll`s to run every
    stream's ready chunk at once (rows of idle streams are masked with
    n_valid = 0). All streams share the geometry and the model; results
    equal per-stream `StreamingRecognizer`s'."""

    def __init__(self, n_streams: int, model: EarlyConformer,
                 audio_cfg: Optional[AudioConfig] = None, tokenizer=None,
                 **kwargs):
        assert n_streams >= 1
        self._ctor = (model, audio_cfg, tokenizer, dict(kwargs))
        self.recs = [StreamingRecognizer(model, audio_cfg, tokenizer, **kwargs)
                     for _ in range(n_streams)]
        r0 = self.recs[0]
        self.device = r0.device
        pin = self.device.type == "cuda"
        # the host side of one round: the (S, win) windows, and pos0 and
        # n_valid in one (2, S) buffer
        self._wav = torch.zeros((n_streams, r0.win_samples), dtype=torch.float32,
                                pin_memory=pin)
        self._pos = torch.zeros((2, n_streams), dtype=torch.int64, pin_memory=pin)

    def reset(self, stream_id: int) -> None:
        """Recycle one slot for a new stream (a connection closed, another
        takes its place): recognizer bookkeeping only."""
        model, audio_cfg, tokenizer, kwargs = self._ctor
        self.recs[stream_id] = StreamingRecognizer(model, audio_cfg, tokenizer,
                                                   **kwargs)

    def warmup(self) -> None:
        """Dispatch every program `poll()` and `finish()` can run, the
        batched (S, win) round and the single-row (1, win) flush, fast and
        deep alike, on fully masked rows: the kernels are built and the
        libraries initialised before the first real round. No stream
        state is read or advanced."""
        r0 = self.recs[0]
        for S in (len(self.recs), 1):
            wav = torch.zeros((S, r0.win_samples), device=self.device)
            z = torch.zeros((S,), dtype=torch.int64, device=self.device)
            outs = [r0._deep(wav, z, z)]
            if r0.exit_threshold is not None:
                outs += list(r0._fast(wav, z, z))
            _fetch(*outs)

    def feed(self, stream_id: int, samples) -> None:
        """Buffer audio for one stream (no compute until poll())."""
        self.recs[stream_id]._append(samples)

    def poll(self) -> dict:
        """Run ready chunks, one batched dispatch per round, until no
        stream has a complete window. Returns {stream_id: newly emitted
        text or ids} for the streams that produced output."""
        r0 = self.recs[0]
        gated = r0.exit_threshold is not None
        hw, hp = self._wav.numpy(), self._pos.numpy()
        emitted: dict = {}
        while True:
            ready = [i for i, rec in enumerate(self.recs)
                     if not rec._finished and rec._chunk_ready()]
            if not ready:
                break
            hp[:] = 0                                  # idle rows: all masked
            ready_rows = set(ready)
            for i, rec in enumerate(self.recs):
                if i in ready_rows:
                    hp[0, i] = rec._fill_window(rec._next_chunk, hw[i])
                    hp[1, i] = rec.K
                else:
                    hw[i] = 0.0
            wav = self._wav.to(self.device, non_blocking=True)
            pos = self._pos.to(self.device, non_blocking=True)
            pos0, n_valid = pos[0], pos[1]
            deep = ready
            if gated:
                # one fast-exit dispatch for every ready row; only the
                # unconfident rows take the deep dispatch
                fbest, conf = _fetch(*r0._fast(wav, pos0, n_valid))
                deep = []
                for i in ready:
                    if conf[i] >= r0.exit_threshold:
                        self.recs[i].exits_run.append(r0.fast_exit)
                        out = self.recs[i]._advance(fbest[i])
                        if out:
                            emitted.setdefault(i, []).extend(out)
                    else:
                        deep.append(i)
                if not deep:
                    continue
                keep = np.zeros_like(hp[1])
                keep[deep] = hp[1, deep]
                n_valid = torch.from_numpy(keep).to(self.device)
            best = _fetch(r0._deep(wav, pos0, n_valid))[0]
            for i in deep:
                if gated:
                    self.recs[i].exits_run.append(r0.n_exit)
                out = self.recs[i]._advance(best[:, i] if r0.all_exits else best[i])
                if out:
                    emitted.setdefault(i, []).extend(out)
        return {i: self.recs[i]._emit(ids) for i, ids in emitted.items()}

    def finish(self, stream_id: int):
        """Flush one stream's tail (single-row dispatches)."""
        return self.recs[stream_id].finish()

    def transcript(self, stream_id: int):
        return self.recs[stream_id].transcript
