"""The AED model: the early-exit Conformer trunk with, per exit, a CTC
head and a pre-norm Transformer decoder (counterpart of
`early_exit_tpu/models/full_conformer.py`).

- the trunk is `ConformerTrunk` (conv subsampling x4 -> PE -> the
  Conformer stack -> per-exit CTC heads), so with `fused_block` it runs
  through the block kernel on the card;
- per exit e: a stack of n_dec_layers decoder layers (`decoders[e]`) and
  its output Linear(d, V) (`out_w[e]`, `out_b[e]`); the token embedding,
  the target PE and the decoder's final LayerNorm are shared by the exits;
- `apply_train` (and `apply`, without dropout) -> (raw decoder logits
  (E, B, L, V), encoder log-probs (E, B, T', V), sub_len[, new_state]);
- `encode_exit` / `decode_exit`: the trunk up to exit n (1-based) and
  decoder n over a whole target, as log-probs.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from early_exit_tpu_torch.configs import ModelConfig
from early_exit_tpu_torch.models.early_conformer import ConformerTrunk
from early_exit_tpu_torch.models.transformer_decoder import DecoderStack
from early_exit_tpu_torch.nn import core
from early_exit_tpu_torch.parallel import collectives


class FullConformer(ConformerTrunk):
    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        d, E, V = cfg.d_model, cfg.n_enc_exits, cfg.vocab_size
        self.emb = nn.Parameter(torch.zeros(V, d))
        self.decoders = nn.ModuleList(
            DecoderStack(d, cfg.d_feed_forward, cfg.n_dec_layers, cfg.n_heads)
            for _ in range(E))
        self.out_w = nn.Parameter(torch.zeros(E, d, V))
        self.out_b = nn.Parameter(torch.zeros(E, V))
        self.final_ln_g = nn.Parameter(torch.ones(d))
        self.final_ln_b = nn.Parameter(torch.zeros(d))

    def init(self, generator: torch.Generator) -> "FullConformer":
        """The trunk's init, then a standard-normal embedding, Xavier
        decoders and output products, a unit final LayerNorm."""
        super().init(generator)
        core.embedding_init_(self.emb, generator)
        for dec in self.decoders:
            dec.init(generator)
        for e in range(self.cfg.n_enc_exits):
            core.linear_init_(self.out_w[e], self.out_b[e], generator)
        core.norm_init_(self.final_ln_g, self.final_ln_b)
        return self

    @property
    def final_ln(self):
        return self.final_ln_g, self.final_ln_b

    def embed_targets(self, trg: torch.Tensor,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Token embedding + sinusoidal PE, in float32, then dropout (with
        a generator)."""
        x = core.embedding_lookup(self.emb, trg)
        x = x + core.sinusoidal_pe(trg.shape[1], self.cfg.d_model, device=x.device)[None]
        return core.dropout(x, self.cfg.drop_prob, generator)

    def out_logits(self, n_exit: int, h: torch.Tensor) -> torch.Tensor:
        """Exit n's (1-based) output product: raw compute-dtype logits (under
        a mesh with tp > 1, the model group's V shards gathered)."""
        mesh = self.mesh
        if mesh is None or mesh.tp == 1:
            return core.linear(h, self.out_w[n_exit - 1], self.out_b[n_exit - 1],
                               compute_dtype=self.cfg.dtype)
        logits = core.linear(collectives.copy_to_model(h, mesh), self.out_w[n_exit - 1],
                             self.out_b[n_exit - 1], compute_dtype=self.cfg.dtype)
        return collectives.gather_from_model(logits, mesh, self.cfg.vocab_size)

    def _decode_all(self, trg, hidden, *, emb_gen=None, seeds=None):
        cfg = self.cfg
        x = self.embed_targets(trg, emb_gen)
        valid = trg != cfg.pad_id
        n = cfg.n_dec_layers
        return torch.stack([
            self.out_logits(e + 1, dec(
                x, hidden[e], self.final_ln, tgt_valid=valid,
                compute_dtype=cfg.dtype, rate=cfg.drop_prob,
                seeds=None if seeds is None else seeds[e * n:(e + 1) * n]))
            for e, dec in enumerate(self.decoders)])

    def encode(self, feats: torch.Tensor, lengths: torch.Tensor):
        """The trunk once for all exits: (exit hidden (E, B, T', D),
        sub_lengths (B,))."""
        return self.apply_hidden(feats, lengths)

    def apply(self, feats: torch.Tensor, lengths: torch.Tensor, trg: torch.Tensor):
        """Inference forward. trg (B, L): the decoder input (the targets
        without their last token). Returns (decoder logits (E, B, L, V)
        raw, encoder log-probs (E, B, T', V) float32, sub_lengths)."""
        hidden, sub_len = self.encode(feats, lengths)
        return self._decode_all(trg, hidden), self.apply_heads(hidden), sub_len

    def apply_train(self, feats: torch.Tensor, lengths: torch.Tensor,
                    trg: torch.Tensor, *, seed: Optional[int] = None):
        """The training forward with autograd: the trunk's (`train_hidden`),
        then every decoder, dropout derived from `seed` (none without).
        Returns (decoder logits (E, B, L, V) raw, encoder log-probs
        (E, B, T', V), sub_lengths, new_state)."""
        cfg = self.cfg
        n_dec = cfg.n_enc_exits * cfg.n_dec_layers
        hidden, sub_len, new_state, seeds = self.train_hidden(
            feats, lengths, seed=seed, extra_seeds=1 + n_dec)
        emb_gen = (None if seeds is None else
                   torch.Generator(device=feats.device).manual_seed(seeds[0]))
        dec = self._decode_all(trg, hidden, emb_gen=emb_gen,
                               seeds=None if seeds is None else seeds[1:])
        return dec, self.apply_heads(hidden), sub_len, new_state

    def encode_exit(self, feats: torch.Tensor, lengths: torch.Tensor, n_exit: int):
        """The trunk up to exit n_exit (1-based): (hidden (B, T', D),
        sub_lengths)."""
        x, sub_len, mask = self.frontend_embed(feats, lengths)
        return self.stack(x, mask, n_layers=n_exit * self.cfg.n_enc_layers_per_exit), sub_len

    def decode_exit(self, trg: torch.Tensor, memory: torch.Tensor,
                    n_exit: int) -> torch.Tensor:
        """Decoder n_exit (1-based) over the whole target trg (B, L) and
        memory (B, T', D) -> float32 log-probs (B, L, V)."""
        cfg = self.cfg
        h = self.decoders[n_exit - 1](
            self.embed_targets(trg), memory, self.final_ln,
            tgt_valid=trg != cfg.pad_id, compute_dtype=cfg.dtype)
        return torch.log_softmax(self.out_logits(n_exit, h).float(), dim=-1)
