"""The port's entry point: all-exit greedy transcription and
confidence-gated cascade serving.

    rec = Recognizer.from_flagship()            # CUDA, block + head kernels
    out = rec.transcribe(wav, sample_counts)     # every exit, greedy CTC
    out = rec.transcribe_gated(wav, sample_counts)   # one exit per request

The flagship's path: waveform -> DFT log-mel frontend (no log) -> conv
subsampling x4 + PE -> 12 Conformer blocks (the block kernel when
`fused`) -> the 6 exit hiddens -> heads + argmax (the head kernel when
`fused`, else float logits + argmax) -> greedy CTC collapse of every exit
-> BPE detokenisation. It decodes every exit, the reference's inference
semantics.

The gated path (`transcribe_gated`) is the flagship's serving mode: the
two-phase cascade of `serving/cascade.py` under the committed calibration
(`assets/flagship_calib.json`: score, per-exit thresholds and
temperatures, `cascade_k`), each request decoded at the earliest exit
whose calibrated confidence clears its threshold.

`Recognizer(model, tokenizer)` serves any CTC model of the registry:
the splitformer decodes its six exits, the early_zipformer its one,
through the same head kernel. The gate runs `GATED_MODEL_TYPES` (the
zipformer has nothing to gate) and the cascade the flagship only; the
others raise the JAX package's ValueError.

`from_flagship` also takes the serving configurations that select the
other kernels: `quantize="int8"` (the W8A8 block kernel),
`compute_dtype="float32"` (the float32 block kernel) and
`attention_impl="pallas"` with `fused=False` (the attention kernel).

Run a few synthetic requests from the command line:

    python -m early_exit_tpu_torch.serving.recognizer --n 8 [--gated]
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

import torch

from early_exit_tpu_torch import checkpoint, interop, runtime
from early_exit_tpu_torch.configs import AudioConfig, inference_profile
from early_exit_tpu_torch.data.synthetic import synth_batch
from early_exit_tpu_torch.decoding.lexicon import edit_distance
from early_exit_tpu_torch.models.early_exit_gate import gated_apply
from early_exit_tpu_torch.ops import ctc, frontend
from early_exit_tpu_torch.ops.kernels.head_argmax import head_argmax
from early_exit_tpu_torch.serving import cascade
from early_exit_tpu_torch.serving.packing import PACK_BATCH
from early_exit_tpu_torch.tokenizer import SentencePieceBPE, load_decoder


@dataclasses.dataclass
class Transcripts:
    tokens: torch.Tensor        # (E, B, T') greedy token ids, blank-padded
    n_tokens: torch.Tensor      # (E, B)
    texts: List[List[str]]      # [exit][item]


@dataclasses.dataclass
class GatedTranscripts:
    tokens: torch.Tensor        # (B, T') greedy tokens of each row's chosen exit
    n_tokens: torch.Tensor      # (B,)
    texts: List[str]            # [item]
    chosen_exit: torch.Tensor   # (B,) 1-based
    escalated_share: float      # rows that went through phase B (cascade)
    rows_packed: int            # phase-B rows computed, padding included


class Recognizer:
    def __init__(self, model: torch.nn.Module, tokenizer: SentencePieceBPE,
                 *, acfg: AudioConfig = AudioConfig(mel_method="dft"),
                 device=None, calib: Optional[dict] = None):
        self.device = runtime.resolve_device(device)
        if self.device.type == "cuda":
            runtime.exact_float32()
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.acfg = acfg
        self.fused = model.cfg.fused_block
        self.calib = calib or {}

    @classmethod
    def from_flagship(cls, device="cuda", fused: bool = True, *,
                      quantize: str = "none",
                      compute_dtype: Optional[str] = None,
                      attention_impl: str = "xla"):
        """The committed flagship checkpoint in the inference profile (bf16
        compute and residual, bf16 attention softmax, DFT mel), decoded
        with the tokenizer its calib file binds by sha256, and gated with
        that file's calibration. fused: the block and head kernels;
        otherwise the unfused PyTorch path. quantize="int8": W8A8 blocks.
        compute_dtype="float32": everything float32. attention_impl=
        "pallas": the attention kernel on the unfused path (with `fused`
        the block kernel runs instead, as in the JAX package)."""
        device = runtime.resolve_device(device)
        calib = checkpoint.load_calib()
        tok = load_decoder(checkpoint.bound_tokenizer(calib))
        cfg = inference_profile(fused_block=fused, quantize=quantize,
                                compute_dtype=compute_dtype,
                                attention_impl=attention_impl)
        tree = checkpoint.load_tree(checkpoint.FLAGSHIP_CKPT)
        model = interop.from_jax_params(tree["params"], tree["model_state"], cfg)
        return cls(model, tok, device=device, calib=calib)

    def _features(self, wav, sample_counts):
        wav = torch.as_tensor(wav, dtype=torch.float32).to(self.device)
        counts = torch.as_tensor(sample_counts).to(self.device)
        feats = frontend.mel_spectrogram(wav, self.acfg,
                                         method=self.acfg.mel_method)
        return feats, frontend.mel_lengths(counts, self.acfg.hop_length)

    @torch.no_grad()
    def exit_ids(self, wav: torch.Tensor, sample_counts: torch.Tensor):
        """(B, N) float32 waveform, (B,) sample counts -> per-frame argmax
        ids (E, B, T') int32 of every exit, and the sub-lengths (B,)."""
        feats, lengths = self._features(wav, sample_counts)
        if self.fused and self.model.cfg.dtype == torch.bfloat16:
            hidden, sub_len = self.model.apply_hidden(feats, lengths)
            ids = head_argmax(hidden.to(torch.bfloat16).contiguous(),
                              self.model.heads_w.to(torch.bfloat16),
                              self.model.heads_b.to(torch.bfloat16))
        else:
            logits, sub_len = self.model.apply(feats, lengths, log_probs=False)
            ids = torch.argmax(logits, dim=-1).to(torch.int32)
        return ids, sub_len

    @torch.no_grad()
    def transcribe(self, wav, sample_counts) -> Transcripts:
        ids, sub_len = self.exit_ids(wav, sample_counts)
        E, B, T = ids.shape
        toks, n = ctc.greedy_decode_ids(ids.reshape(E * B, T),
                                        sub_len.repeat(E),
                                        blank=self.model.cfg.blank_id)
        toks, n = toks.reshape(E, B, T).cpu(), n.reshape(E, B).cpu()
        texts = [[self.tokenizer.decode(toks[e, b, :n[e, b]].tolist())
                  for b in range(B)] for e in range(E)]
        return Transcripts(toks, n, texts)

    def gate_settings(self) -> dict:
        """threshold / score / temperatures of the calibration (0.85 on
        maxprob without one, as the JAX package's benchmark)."""
        c = self.calib
        if "thresholds" not in c:
            return dict(threshold=0.85, score="maxprob", temperatures=None)
        return dict(threshold=c["thresholds"], score=c.get("score", "maxprob"),
                    temperatures=c.get("temperatures"))

    @torch.no_grad()
    def cascade_pass(self, wav, sample_counts, *, k: Optional[int] = None,
                     pack_batch: int = PACK_BATCH):
        """One cascade pass: phase A on every row, the accept mask to the
        host, the escalated rows packed and resumed in phase B. Returns
        (tokens (B, T'), n_tokens (B,), chosen (B,) int32, escalated rows,
        packed rows), all tensors on the device."""
        gate = self.gate_settings()
        k = int(self.calib.get("cascade_k") or 2) if k is None else k
        blank = self.model.cfg.blank_id
        feats, lengths = self._features(wav, sample_counts)
        logp, chosen, accepted, sub_len, h_k = cascade.shallow_apply(
            self.model, feats, lengths, k=k, **gate)
        toks, n = ctc.greedy_decode(logp, sub_len, blank=blank)
        idx, real = cascade.pack_escalation_indices(accepted.cpu().numpy(),
                                                    pack_batch)
        if idx.size:
            n_real = int(real.sum())
            idx_d = torch.as_tensor(idx, device=self.device, dtype=torch.long)
            sl = sub_len.index_select(0, idx_d)
            b_logp, b_chosen = cascade.continue_apply(
                self.model, h_k.index_select(0, idx_d), sl, k=k, **gate)
            b_toks, b_n = ctc.greedy_decode(b_logp, sl, blank=blank)
            rows = idx_d[:n_real]
            toks[rows], n[rows] = b_toks[:n_real], b_n[:n_real]
            chosen[rows] = b_chosen[:n_real]
        return toks, n, chosen, int(real.sum()), int(idx.size)

    @torch.no_grad()
    def transcribe_gated(self, wav, sample_counts, *,
                         strategy: str = "cascade") -> GatedTranscripts:
        """Each request decoded at the earliest exit whose calibrated
        confidence clears its threshold (the final exit otherwise).
        strategy "cascade": the two-phase cascade (the flagship only);
        "whileloop": the batch-conservative gate `gated_apply`, whose
        per-row decisions the cascade reproduces (the flagship and the
        splitformer)."""
        if strategy == "cascade":
            toks, n, chosen, n_esc, n_packed = self.cascade_pass(wav, sample_counts)
        elif strategy == "whileloop":
            feats, lengths = self._features(wav, sample_counts)
            logp, chosen, sub_len, _ = gated_apply(self.model, feats, lengths,
                                                   **self.gate_settings())
            toks, n = ctc.greedy_decode(logp, sub_len,
                                        blank=self.model.cfg.blank_id)
            n_esc = n_packed = 0
        else:
            raise ValueError(f"strategy must be 'cascade' or 'whileloop': "
                             f"{strategy!r}")
        toks, n, chosen = toks.cpu(), n.cpu(), chosen.cpu()
        texts = [self.tokenizer.decode(toks[b, :n[b]].tolist())
                 for b in range(toks.shape[0])]
        return GatedTranscripts(toks, n, texts, chosen,
                                n_esc / max(toks.shape[0], 1), n_packed)


def word_errors(ref: str, hyp: str) -> tuple:
    """(edit distance in words, reference word count)."""
    r = ref.lower().split()
    return edit_distance(r, hyp.lower().split()), len(r)


def wer_pct(refs: List[str], hyps: List[str]) -> float:
    err = tot = 0
    for r, h in zip(refs, hyps):
        e, n = word_errors(r, h)
        err, tot = err + e, tot + n
    return 100.0 * err / max(tot, 1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=8, help="requests to answer")
    ap.add_argument("--seed", type=int, default=4242)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--unfused", action="store_true",
                    help="plain PyTorch trunk and heads instead of the kernels")
    ap.add_argument("--gated", action="store_true",
                    help="cascade serving under the committed calibration: "
                         "one exit per request")
    ap.add_argument("--quantize", default="none", choices=["none", "int8"],
                    help="W8A8 int8 quantization of the encoder blocks")
    ap.add_argument("--attention_impl", default="xla", choices=["xla", "pallas"],
                    help="pallas: the CUDA attention kernel (with --unfused)")
    ap.add_argument("--compute_dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    args = ap.parse_args(argv)
    rec = Recognizer.from_flagship(
        args.device, fused=not args.unfused, quantize=args.quantize,
        compute_dtype=args.compute_dtype, attention_impl=args.attention_impl)
    knobs = checkpoint.load_calib().get("bench_eval", {})
    wav, counts, refs = synth_batch(knobs, args.n, args.seed)
    if args.gated:
        out = rec.transcribe_gated(wav, counts)
        for ref, text, e in zip(refs, out.texts, out.chosen_exit.tolist()):
            print(f"EXPECTED: {ref}")
            print(f"EXIT_{e}: {text}")
        print(f"gated WER: {wer_pct(refs, out.texts):.2f}%  mean exit "
              f"{out.chosen_exit.float().mean():.2f}  escalated "
              f"{100 * out.escalated_share:.1f}%")
        return
    out = rec.transcribe(wav, counts)
    for b, ref in enumerate(refs):
        print(f"EXPECTED: {ref}")
        for e, texts in enumerate(out.texts):
            print(f"EXIT_{e + 1}: {texts[b]}")
    for e, texts in enumerate(out.texts):
        print(f"exit {e + 1} WER: {wer_pct(refs, texts):.2f}%")


if __name__ == "__main__":
    main()
