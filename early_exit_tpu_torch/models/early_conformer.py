"""Early-exit Conformer CTC encoder (counterpart of
`early_exit_tpu/models/early_conformer.py`), inference only.

conv subsample x4 -> sinusoidal PE -> n_exits x n_layers Conformer
blocks -> per-exit Linear(d, V) heads. The exit hidden states are the
outputs of layers k-1, 2k-1, ... (k = n_enc_layers_per_exit).
"""

from __future__ import annotations

import torch
from torch import nn

from early_exit_tpu_torch.configs import ModelConfig
from early_exit_tpu_torch.models import conformer, subsampling
from early_exit_tpu_torch.nn import core


def conformer_cfg(cfg: ModelConfig) -> conformer.ConformerConfig:
    if cfg.conv_norm != "batch":
        raise NotImplementedError("the port runs conv_norm='batch' only")
    return conformer.ConformerConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, d_ff=cfg.d_feed_forward,
        kernel_size=cfg.depthwise_kernel_size,
        compute_dtype=cfg.compute_dtype,
        residual_dtype=(cfg.residual_dtype or cfg.compute_dtype),
        attn_softmax_dtype=cfg.attn_softmax_dtype,
        fused_block=cfg.fused_block, attention_impl=cfg.attention_impl,
        quantize=cfg.quantize)


class EarlyConformer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.sub_w = nn.ParameterList([
            nn.Parameter(torch.zeros(3, cfg.n_mels, d), requires_grad=False),
            nn.Parameter(torch.zeros(3, d, d), requires_grad=False)])
        self.sub_b = nn.ParameterList([
            nn.Parameter(torch.zeros(d), requires_grad=False)
            for _ in range(2)])
        self.stack = conformer.ConformerStack(
            conformer_cfg(cfg), cfg.n_enc_exits * cfg.n_enc_layers_per_exit)
        self.heads_w = nn.Parameter(
            torch.zeros(cfg.n_enc_exits, d, cfg.vocab_size), requires_grad=False)
        self.heads_b = nn.Parameter(
            torch.zeros(cfg.n_enc_exits, cfg.vocab_size), requires_grad=False)

    def frontend_embed(self, feats: torch.Tensor, lengths: torch.Tensor):
        """Subsample + PE (added in float32) -> padded frames zeroed ->
        residual dtype. Returns (x, sub_len, mask)."""
        cfg = self.cfg
        x = subsampling.conv_subsample_apply(
            list(zip(self.sub_w, self.sub_b)), feats, compute_dtype=cfg.dtype)
        t_sub = x.shape[1]
        pe = core.sinusoidal_pe(t_sub, cfg.d_model, device=x.device)
        x = x.float() + pe[None]
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
        logits = core.linear(hidden, self.heads_w[:, None],
                             self.heads_b[:, None, None],
                             compute_dtype=self.cfg.dtype)
        if not log_probs:
            return logits
        return torch.log_softmax(logits.float(), dim=-1)

    def apply(self, feats: torch.Tensor, lengths: torch.Tensor, *,
              log_probs: bool = True):
        """feats (B, T, n_mels), lengths (B,) -> (per-exit outputs
        (E, B, T', V), sub_lengths (B,))."""
        hidden, sub_len = self.apply_hidden(feats, lengths)
        return self.apply_heads(hidden, log_probs=log_probs), sub_len

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
