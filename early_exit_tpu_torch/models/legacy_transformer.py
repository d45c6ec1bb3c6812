"""The legacy vanilla-Transformer family (counterpart of
`early_exit_tpu/models/legacy_transformer.py`), the reference's models
from before the Conformer. No CLI reaches them, in either package, and
they run no kernel.

- `CTCSelfAttention`: conv subsample x4 -> PE -> one encoder stack -> a
  CTC head, (B, T', V) log-probs;
- `EarlyEncoder`: the same front, then n_enc_exits encoder stacks in
  sequence, each with its own CTC head, (E, B, T', V);
- `EarlyTransformer`: `EarlyEncoder`'s trunk and, per exit, a decoder
  over the exit's memory (a shared token embedding + PE and a shared
  final LayerNorm): per-exit decoder and CTC log-probs;
- `LegacyTransformer`: one encoder and one decoder with a CTC head
  (`encode`, `ctc_encoder`, `decode`, `apply`).

The encoder layer is pre-norm: x + Drop(MHA(LN1(x))), then x +
Drop(W2(Drop(ReLU(W1(LN2(x)))))); each stack ends in a LayerNorm. The
decoder is the AED model's (`transformer_decoder.DecoderStack`). As in
the JAX package the encoder gets no padding mask (the reference's
behaviour), and wherever a mask is given it masks for real (the
reference's -1e-9 masking quirk is not kept). Dropout runs only with a
`seed` (and drop_prob > 0), its masks drawn in order from one generator;
the JAX package's draws differ, so only dropout 0 compares.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from early_exit_tpu_torch.configs import ModelConfig
from early_exit_tpu_torch.models import subsampling
from early_exit_tpu_torch.models.transformer_decoder import DecoderStack, Projections
from early_exit_tpu_torch.nn import core


def _weight(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape))


def _generator(seed: Optional[int], cfg: ModelConfig, device) -> Optional[torch.Generator]:
    if seed is None or cfg.drop_prob <= 0.0:
        return None
    return torch.Generator(device=device).manual_seed(seed)


class EncoderLayer(nn.Module):
    def __init__(self, d: int, d_ff: int):
        super().__init__()
        self.ln1_g, self.ln1_b = _weight(d), _weight(d)
        self.attn = Projections(d)
        self.ln2_g, self.ln2_b = _weight(d), _weight(d)
        self.w1, self.b1 = _weight(d, d_ff), _weight(d_ff)
        self.w2, self.b2 = _weight(d_ff, d), _weight(d)

    def init(self, gen: torch.Generator) -> None:
        core.norm_init_(self.ln1_g, self.ln1_b)
        core.norm_init_(self.ln2_g, self.ln2_b)
        self.attn.init(gen)
        core.linear_init_(self.w1, self.b1, gen)
        core.linear_init_(self.w2, self.b2, gen)

    def forward(self, x, cfg: ModelConfig, gen=None):
        rate, lin = cfg.drop_prob, dict(compute_dtype=cfg.dtype)
        y = core.layer_norm(x, self.ln1_g, self.ln1_b)
        y = core.mha(self.attn.params(), y, y, cfg.n_heads, compute_dtype=cfg.dtype)
        x = x + core.dropout(y, rate, gen)
        y = core.layer_norm(x, self.ln2_g, self.ln2_b)
        y = core.dropout(torch.relu(core.linear(y, self.w1, self.b1, **lin)), rate, gen)
        return x + core.dropout(core.linear(y, self.w2, self.b2, **lin), rate, gen)


class EncoderStack(nn.Module):
    def __init__(self, cfg: ModelConfig, n_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(cfg.d_model, cfg.d_feed_forward)
                                    for _ in range(n_layers))
        self.final_ln_g, self.final_ln_b = _weight(cfg.d_model), _weight(cfg.d_model)

    def init(self, gen: torch.Generator) -> None:
        for layer in self.layers:
            layer.init(gen)
        core.norm_init_(self.final_ln_g, self.final_ln_b)

    def forward(self, x, cfg: ModelConfig, gen=None):
        for layer in self.layers:
            x = layer(x, cfg, gen)
        return core.layer_norm(x, self.final_ln_g, self.final_ln_b)


class _Legacy(nn.Module):
    """The conv subsampling x4, PE and dropout every legacy model starts
    with, and its CTC-style heads."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.sub_w, self.sub_b = subsampling.conv_subsample_params(cfg.n_mels, cfg.d_model)

    def init(self, generator: torch.Generator):
        """Fresh weights in place: Xavier-uniform products and
        convolutions, zero biases, unit norms, a standard-normal
        embedding."""
        subsampling.conv_subsample_init_(list(zip(self.sub_w, self.sub_b)), generator)
        for m in self.children():
            if hasattr(m, "init"):
                m.init(generator)
            elif isinstance(m, nn.ModuleList):
                for sub in m:
                    sub.init(generator)
        for w, b in self._linears():
            core.linear_init_(w, b, generator)
        if hasattr(self, "emb"):
            core.embedding_init_(self.emb, generator)
            core.norm_init_(self.final_ln_g, self.final_ln_b)
        return self

    def _linears(self):
        return []

    def frontend(self, feats: torch.Tensor, gen=None) -> torch.Tensor:
        cfg = self.cfg
        x = subsampling.conv_subsample_apply(list(zip(self.sub_w, self.sub_b)), feats,
                                             compute_dtype=cfg.dtype)
        pe = core.sinusoidal_pe(x.shape[1], cfg.d_model, device=x.device)
        return core.dropout(x.float() + pe[None], cfg.drop_prob, gen)

    def log_probs(self, w, b, h) -> torch.Tensor:
        logits = core.linear(h, w, b, compute_dtype=self.cfg.dtype)
        return torch.log_softmax(logits.float(), dim=-1)

    def embed_targets(self, trg: torch.Tensor, gen=None) -> torch.Tensor:
        x = core.embedding_lookup(self.emb, trg)
        x = x + core.sinusoidal_pe(trg.shape[1], self.cfg.d_model, device=x.device)[None]
        return core.dropout(x, self.cfg.drop_prob, gen)

    def _decoder_stack(self) -> DecoderStack:
        cfg = self.cfg
        return DecoderStack(cfg.d_model, cfg.d_feed_forward, cfg.n_dec_layers, cfg.n_heads)

    def _decode(self, dec: DecoderStack, x, memory, valid, gen):
        # the decoder's dropout masks come from seeds drawn off `gen`
        seeds = (None if gen is None else
                 torch.randint(0, 2 ** 62, (len(dec.layers),), generator=gen,
                               device=gen.device).tolist())
        return dec(x, memory, (self.final_ln_g, self.final_ln_b), tgt_valid=valid,
                   compute_dtype=self.cfg.dtype, seeds=seeds, rate=self.cfg.drop_prob)


class CTCSelfAttention(_Legacy):
    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        self.encoder = EncoderStack(cfg, cfg.n_enc_layers_per_exit)
        self.head_w, self.head_b = _weight(cfg.d_model, cfg.vocab_size), _weight(cfg.vocab_size)

    def _linears(self):
        return [(self.head_w, self.head_b)]

    def apply(self, feats: torch.Tensor, *, seed: Optional[int] = None) -> torch.Tensor:
        """(B, T, n_mels) -> (B, T', V) log-probs."""
        gen = _generator(seed, self.cfg, feats.device)
        x = self.encoder(self.frontend(feats, gen), self.cfg, gen)
        return self.log_probs(self.head_w, self.head_b, x)


class EarlyEncoder(_Legacy):
    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        E, d, V = cfg.n_enc_exits, cfg.d_model, cfg.vocab_size
        self.encoders = nn.ModuleList(EncoderStack(cfg, cfg.n_enc_layers_per_exit)
                                      for _ in range(E))
        self.heads_w = nn.ParameterList(_weight(d, V) for _ in range(E))
        self.heads_b = nn.ParameterList(_weight(V) for _ in range(E))

    def _linears(self):
        return list(zip(self.heads_w, self.heads_b))

    def apply(self, feats: torch.Tensor, *, seed: Optional[int] = None) -> torch.Tensor:
        """(B, T, n_mels) -> (E, B, T', V) log-probs, one exit per stack."""
        gen = _generator(seed, self.cfg, feats.device)
        x, outs = self.frontend(feats, gen), []
        for enc, w, b in zip(self.encoders, self.heads_w, self.heads_b):
            x = enc(x, self.cfg, gen)
            outs.append(self.log_probs(w, b, x))
        return torch.stack(outs)


class EarlyTransformer(_Legacy):
    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        E, d, V = cfg.n_enc_exits, cfg.d_model, cfg.vocab_size
        self.encoders = nn.ModuleList(EncoderStack(cfg, cfg.n_enc_layers_per_exit)
                                      for _ in range(E))
        self.ctc_w = nn.ParameterList(_weight(d, V) for _ in range(E))
        self.ctc_b = nn.ParameterList(_weight(V) for _ in range(E))
        self.out_w = nn.ParameterList(_weight(d, V) for _ in range(E))
        self.out_b = nn.ParameterList(_weight(V) for _ in range(E))
        self.decoders = nn.ModuleList(self._decoder_stack() for _ in range(E))
        self.emb = _weight(V, d)
        self.final_ln_g, self.final_ln_b = _weight(d), _weight(d)

    def _linears(self):
        return list(zip(self.ctc_w, self.ctc_b)) + list(zip(self.out_w, self.out_b))

    def apply(self, feats: torch.Tensor, trg: torch.Tensor, *,
              seed: Optional[int] = None):
        """feats (B, T, n_mels), trg (B, L) -> (decoder log-probs
        (E, B, L, V), CTC log-probs (E, B, T', V))."""
        gen = _generator(seed, self.cfg, feats.device)
        x = self.frontend(feats, gen)
        y = self.embed_targets(trg, gen)
        valid = trg != self.cfg.pad_id
        dec_out, enc_out = [], []
        for e, (enc, dec) in enumerate(zip(self.encoders, self.decoders)):
            x = enc(x, self.cfg, gen)
            h = self._decode(dec, y, x, valid, gen)
            dec_out.append(self.log_probs(self.out_w[e], self.out_b[e], h))
            enc_out.append(self.log_probs(self.ctc_w[e], self.ctc_b[e], x))
        return torch.stack(dec_out), torch.stack(enc_out)


class LegacyTransformer(_Legacy):
    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        d, V = cfg.d_model, cfg.vocab_size
        self.encoder = EncoderStack(cfg, cfg.n_enc_layers_per_exit)
        self.decoder = self._decoder_stack()
        self.ctc_w, self.ctc_b = _weight(d, V), _weight(V)
        self.out_w, self.out_b = _weight(d, V), _weight(V)
        self.emb = _weight(V, d)
        self.final_ln_g, self.final_ln_b = _weight(d), _weight(d)

    def _linears(self):
        return [(self.ctc_w, self.ctc_b), (self.out_w, self.out_b)]

    def encode(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, T, n_mels) -> the encoder's memory (B, T', D)."""
        return self.encoder(self.frontend(feats), self.cfg)

    def ctc_encoder(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, T, n_mels) -> CTC log-probs (B, T', V)."""
        return self.log_probs(self.ctc_w, self.ctc_b, self.encode(feats))

    def decode(self, trg: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
        """trg (B, L) over the memory enc (B, T', D) -> decoder log-probs
        (B, L, V); no target padding mask (causal only), as the JAX
        package's decode."""
        h = self._decode(self.decoder, self.embed_targets(trg), enc, None, None)
        return self.log_probs(self.out_w, self.out_b, h)

    def apply(self, feats: torch.Tensor, trg: torch.Tensor, *,
              seed: Optional[int] = None):
        """-> (decoder log-probs (B, L, V), CTC log-probs (B, T', V))."""
        gen = _generator(seed, self.cfg, feats.device)
        enc = self.encoder(self.frontend(feats, gen), self.cfg, gen)
        h = self._decode(self.decoder, self.embed_targets(trg, gen), enc,
                         trg != self.cfg.pad_id, gen)
        return (self.log_probs(self.out_w, self.out_b, h),
                self.log_probs(self.ctc_w, self.ctc_b, enc))
