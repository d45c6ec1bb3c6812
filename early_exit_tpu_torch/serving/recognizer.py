"""The port's entry point: all-exit greedy transcription.

    rec = Recognizer.from_flagship()            # CUDA, block + head kernels
    out = rec.transcribe(wav, sample_counts)     # every exit, greedy CTC

The path: waveform -> DFT log-mel frontend (no log) -> conv subsampling
x4 + PE -> 12 Conformer blocks (the block kernel when `fused`) -> the 6
exit hiddens -> heads + argmax (the head kernel when `fused`, else
float logits + argmax) -> greedy CTC collapse of every exit -> BPE
detokenisation. It decodes every exit, the reference's inference
semantics.

Run a few synthetic requests from the command line:

    python -m early_exit_tpu_torch.serving.recognizer --n 8
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List

import numpy as np
import torch

from early_exit_tpu_torch import checkpoint, interop, runtime
from early_exit_tpu_torch.configs import AudioConfig, inference_profile
from early_exit_tpu_torch.data.synthetic import synth_batch
from early_exit_tpu_torch.models.early_conformer import EarlyConformer
from early_exit_tpu_torch.ops import ctc, frontend
from early_exit_tpu_torch.ops.kernels.head_argmax import head_argmax
from early_exit_tpu_torch.tokenizer import SentencePieceDecoder, load_decoder


@dataclasses.dataclass
class Transcripts:
    tokens: torch.Tensor        # (E, B, T') greedy token ids, blank-padded
    n_tokens: torch.Tensor      # (E, B)
    texts: List[List[str]]      # [exit][item]


class Recognizer:
    def __init__(self, model: EarlyConformer, tokenizer: SentencePieceDecoder,
                 *, acfg: AudioConfig = AudioConfig(mel_method="dft"),
                 device=None):
        self.device = runtime.resolve_device(device)
        if self.device.type == "cuda":
            runtime.exact_float32()
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.acfg = acfg
        self.fused = model.cfg.fused_block

    @classmethod
    def from_flagship(cls, device="cuda", fused: bool = True):
        """The committed flagship checkpoint in the inference profile (bf16
        compute and residual, bf16 attention softmax, DFT mel), decoded
        with the tokenizer its calib file binds by sha256. fused: the
        block and head kernels; otherwise the unfused PyTorch path."""
        device = runtime.resolve_device(device)
        tok = load_decoder(checkpoint.bound_tokenizer(checkpoint.load_calib()))
        cfg = inference_profile(fused_block=fused)
        tree = checkpoint.load_tree(checkpoint.FLAGSHIP_CKPT)
        model = interop.from_jax_params(tree["params"], tree["model_state"], cfg)
        return cls(model, tok, device=device)

    @torch.no_grad()
    def exit_ids(self, wav: torch.Tensor, sample_counts: torch.Tensor):
        """(B, N) float32 waveform, (B,) sample counts -> per-frame argmax
        ids (E, B, T') int32 of every exit, and the sub-lengths (B,)."""
        wav = torch.as_tensor(wav, dtype=torch.float32).to(self.device)
        counts = torch.as_tensor(sample_counts).to(self.device)
        feats = frontend.mel_spectrogram(wav, self.acfg,
                                         method=self.acfg.mel_method)
        lengths = frontend.mel_lengths(counts, self.acfg.hop_length)
        if self.fused:
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


def word_errors(ref: str, hyp: str) -> tuple:
    """(edit distance in words, reference word count)."""
    r, h = ref.lower().split(), hyp.lower().split()
    d = np.arange(len(h) + 1)
    for i in range(1, len(r) + 1):
        prev, d[0] = d.copy(), i
        for j in range(1, len(h) + 1):
            d[j] = min(prev[j] + 1, d[j - 1] + 1,
                       prev[j - 1] + (r[i - 1] != h[j - 1]))
    return int(d[len(h)]), len(r)


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
    args = ap.parse_args(argv)
    rec = Recognizer.from_flagship(args.device, fused=not args.unfused)
    knobs = checkpoint.load_calib().get("bench_eval", {})
    wav, counts, refs = synth_batch(knobs, args.n, args.seed)
    out = rec.transcribe(wav, counts)
    for b, ref in enumerate(refs):
        print(f"EXPECTED: {ref}")
        for e, texts in enumerate(out.texts):
            print(f"EXIT_{e + 1}: {texts[b]}")
    for e, texts in enumerate(out.texts):
        print(f"exit {e + 1} WER: {wer_pct(refs, texts):.2f}%")


if __name__ == "__main__":
    main()
