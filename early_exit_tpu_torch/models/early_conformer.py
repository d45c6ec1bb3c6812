"""Early-exit Conformer CTC encoder (counterpart of
`early_exit_tpu/models/early_conformer.py`).

conv subsample x4 -> sinusoidal PE (+ dropout in training) -> n_exits x
n_layers Conformer blocks -> per-exit Linear(d, V) heads. The exit hidden
states are the outputs of layers k-1, 2k-1, ... (k =
n_enc_layers_per_exit). `init` draws fresh weights; `apply_train` is the
training forward, whose BatchNorm statistics the caller assigns with
`set_state` once the step is done. `ConformerTrunk` is what the AED
model (`full_conformer.FullConformer`) shares with this one: everything
up to and including the per-exit CTC heads.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from early_exit_tpu_torch.configs import ModelConfig
from early_exit_tpu_torch.models import conformer, subsampling
from early_exit_tpu_torch.nn import core
from early_exit_tpu_torch.parallel import collectives


def conformer_cfg(cfg: ModelConfig) -> conformer.ConformerConfig:
    """The blocks' configuration; a group-norm model with a fused block
    raises here (`conformer.GROUP_NORM_FUSED`)."""
    return conformer.ConformerConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, d_ff=cfg.d_feed_forward,
        kernel_size=cfg.depthwise_kernel_size, dropout=cfg.drop_prob,
        remat=cfg.remat, compute_dtype=cfg.compute_dtype,
        residual_dtype=(cfg.residual_dtype or cfg.compute_dtype),
        attn_softmax_dtype=cfg.attn_softmax_dtype,
        fused_block=cfg.fused_block, attention_impl=cfg.attention_impl,
        quantize=cfg.quantize, conv_norm=cfg.conv_norm)


class ConformerTrunk(nn.Module):
    """Conv subsampling, PE, the Conformer stack and the per-exit CTC
    heads: the part the CTC and the AED models share."""

    mesh = None             # set by `parallel.shard_params`

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.sub_w, self.sub_b = subsampling.conv_subsample_params(cfg.n_mels, d)
        self.stack = conformer.ConformerStack(
            conformer_cfg(cfg), cfg.n_enc_exits * cfg.n_enc_layers_per_exit)
        self.heads_w = nn.Parameter(
            torch.zeros(cfg.n_enc_exits, d, cfg.vocab_size))
        self.heads_b = nn.Parameter(
            torch.zeros(cfg.n_enc_exits, cfg.vocab_size))

    def init(self, generator: torch.Generator) -> "ConformerTrunk":
        """Fresh weights in place, drawn from `generator` (on the
        parameters' device): Xavier-uniform products and convolutions,
        zero biases, unit norm scales, BatchNorm statistics (0, 1)."""
        subsampling.conv_subsample_init_(list(zip(self.sub_w, self.sub_b)),
                                         generator)
        self.stack.init(generator)
        for e in range(self.cfg.n_enc_exits):
            core.linear_init_(self.heads_w[e], self.heads_b[e], generator)
        return self

    def stacks(self):
        """The fused stacks in the order they run: the trunk's one (the
        splitformer's branch blocks run unfused and are none of them)."""
        return [self.stack]

    def frontend_embed(self, feats: torch.Tensor, lengths: torch.Tensor, *,
                       generator: Optional[torch.Generator] = None):
        """Subsample + PE (added in float32) -> dropout (with a generator)
        -> padded frames zeroed -> residual dtype. Returns (x, sub_len,
        mask)."""
        cfg = self.cfg
        x = subsampling.conv_subsample_apply(
            list(zip(self.sub_w, self.sub_b)), feats, compute_dtype=cfg.dtype)
        t_sub = x.shape[1]
        pe = core.sinusoidal_pe(t_sub, cfg.d_model, device=x.device)
        x = core.dropout(x.float() + pe[None], cfg.drop_prob, generator)
        if cfg.length_mode == "reference":
            sub_len = subsampling.reference_subsampled_length(lengths, 4, t_sub)
        else:
            sub_len = subsampling.subsampled_length(lengths, 2).clamp(max=t_sub)
        mask = torch.arange(t_sub, device=x.device)[None, :] < sub_len[:, None]
        x = torch.where(mask[..., None], x, torch.zeros((), device=x.device))
        return x.to(cfg.rdtype), sub_len, mask

    def apply_hidden(self, feats: torch.Tensor, lengths: torch.Tensor):
        """(B, T, mels) -> per-exit hidden states (E, B, T', D) and the
        sub-lengths; no heads."""
        x, sub_len, mask = self.frontend_embed(feats, lengths)
        _, exit_hidden = self.stack(
            x, mask, collect_outputs=True,
            collect_every=self.cfg.n_enc_layers_per_exit)
        return exit_hidden, sub_len

    def apply_heads(self, hidden: torch.Tensor, *,
                    log_probs: bool = True) -> torch.Tensor:
        """(E, B, T, D) -> (E, B, T, V): float32 log-probs, or the raw
        compute-dtype logits with log_probs=False."""
        return heads_apply(self.heads_w, self.heads_b, hidden, self.cfg.dtype,
                           log_probs=log_probs, mesh=self.mesh, vocab=self.cfg.vocab_size)

    # blocks outside the stack whose dropout draws a seed of its own in
    # training (the splitformer's two branch blocks)
    n_extra_blocks = 0

    def train_hidden(self, feats: torch.Tensor, lengths: torch.Tensor, *,
                     seed: Optional[int] = None,
                     attn_mask: Optional[torch.Tensor] = None, extra_seeds: int = 0):
        """The trunk's training forward, with autograd: no kernel,
        unquantized, BatchNorm on the batch, and dropout (rate drop_prob)
        whose masks derive from `seed` (no dropout without one). attn_mask:
        (T', T') bool over the subsampled frames. Returns (hidden
        (E, B, T', D), sub_lengths (B,), new_state, seeds): new_state holds
        the BatchNorm running statistics as the JAX package's state tree
        does (`state()`); seeds are `extra_seeds` more seeds drawn after
        the trunk's, for the caller's own dropout (None without dropout)."""
        n_seeds = len(self.stack.blocks) + self.n_extra_blocks + 1
        seeds, extra = None, None
        if seed is not None and self.cfg.drop_prob > 0.0:
            host = torch.Generator().manual_seed(seed)
            seeds = torch.randint(0, 2 ** 62, (n_seeds,), generator=host).tolist()
            extra = torch.randint(0, 2 ** 62, (extra_seeds,),
                                  generator=host).tolist()
        pe_gen = (None if seeds is None else
                  torch.Generator(device=feats.device).manual_seed(seeds[-1]))
        x, sub_len, mask = self.frontend_embed(feats, lengths, generator=pe_gen)
        hidden, new_state = self.train_blocks(x, mask, lengths, sub_len,
                                              seeds=seeds, attn_mask=attn_mask)
        return hidden, sub_len, new_state, extra

    def train_blocks(self, x, mask, lengths, sub_len, *, seeds, attn_mask):
        """The blocks of the training forward on the embedded frames:
        (hidden (E, B, T', D), new_state). Block i of the stack draws its
        dropout from seeds[i]."""
        hidden, mean, var = self.stack.train_forward(
            x, mask, seeds=seeds, attn_mask=attn_mask,
            collect_every=self.cfg.n_enc_layers_per_exit)
        return hidden, {"blocks": {"conv_bn": {"mean": mean, "var": var}}}

    def state(self) -> dict:
        """The BatchNorm running statistics as `apply_train` returns them:
        {"blocks": {"conv_bn": {"mean", "var"}}}, (L, D) each."""
        return {"blocks": self.stack.bn_state()}

    def set_state(self, state: dict) -> None:
        bn = state["blocks"]["conv_bn"]
        self.stack.set_bn_state(bn["mean"], bn["var"])


def heads_apply(w: torch.Tensor, b: torch.Tensor, hidden: torch.Tensor,
                compute_dtype: torch.dtype, *, log_probs: bool = True,
                mesh=None, vocab: int = 0) -> torch.Tensor:
    """Per-exit heads w (E, D, V), b (E, V) on (E, B, T, D) -> (E, B, T, V):
    float32 log-probs, or the raw compute-dtype logits with
    log_probs=False. Under a mesh with tp > 1, w and b hold this rank's
    shard of the `vocab` columns, and the model group's logits are
    gathered before the softmax."""
    tp = mesh is not None and mesh.tp > 1
    if tp:
        hidden = collectives.copy_to_model(hidden, mesh)
    # each row's copy of its exit's head, as the batched product would
    # make it from a broadcast w[:, None]: made here, a capture over a
    # symbolic batch adds no guard on B == 1
    w = w.to(compute_dtype)[:, None].expand(-1, hidden.shape[1], -1, -1)
    w = w.clone(memory_format=torch.contiguous_format)
    logits = core.linear(hidden, w, b[:, None, None], compute_dtype=compute_dtype)
    if tp:
        logits = collectives.gather_from_model(logits, mesh, vocab)
    if not log_probs:
        return logits
    return torch.log_softmax(logits.float(), dim=-1)


class EarlyConformer(ConformerTrunk):
    def apply(self, feats: torch.Tensor, lengths: torch.Tensor, *,
              log_probs: bool = True):
        """feats (B, T, n_mels), lengths (B,) -> (per-exit outputs
        (E, B, T', V), sub_lengths (B,))."""
        hidden, sub_len = self.apply_hidden(feats, lengths)
        return self.apply_heads(hidden, log_probs=log_probs), sub_len

    def apply_train(self, feats: torch.Tensor, lengths: torch.Tensor, *,
                    seed: Optional[int] = None,
                    attn_mask: Optional[torch.Tensor] = None):
        """The training forward (`train_hidden`) and the heads. Returns
        (log_probs (E, B, T', V) float32, sub_lengths (B,), new_state)."""
        hidden, sub_len, new_state, _ = self.train_hidden(
            feats, lengths, seed=seed, attn_mask=attn_mask)
        return self.apply_heads(hidden), sub_len, new_state

    def encode_exit(self, feats: torch.Tensor, lengths: torch.Tensor,
                    n_exit: int):
        """Run the trunk only up to exit `n_exit` (1-based); returns that
        exit's log-probs and the sub-lengths."""
        x, sub_len, mask = self.frontend_embed(feats, lengths)
        h = self.stack(x, mask,
                       n_layers=n_exit * self.cfg.n_enc_layers_per_exit)
        logits = core.linear(h, self.heads_w[n_exit - 1],
                             self.heads_b[n_exit - 1],
                             compute_dtype=self.cfg.dtype)
        return torch.log_softmax(logits.float(), dim=-1), sub_len
