"""Early_zipformer: a Zipformer-shaped U-Net of Conformer stacks with a
single exit (counterpart of `early_exit_tpu/models/zipformer.py`).

- one k=3 s=2 convolution (T/2), sinusoidal PE, dropout in training, the
  frames past each item's base length zeroed;
- two full-rate blocks (`pre`);
- five stages with downsampling factors FACTORS and block counts STACK:
  pad time to the factor, keep every factor-th frame, run the stage's
  stack under the stage mask, repeat each frame factor times, cut back,
  add the stage input, zero the frames outside the base mask;
- a further x2 downsample and one Linear(d, V) head, returned with a
  leading exit axis of size one: (1, B, T'', V).

19 blocks and one exit: the configuration must say n_enc_exits=19 (2 +
sum(STACK)) with n_enc_layers_per_exit=1 for the reference's layout.
Each stage mask is a prefix of the row, so with `fused_block` every
stack runs through the block kernel on the card (six stacks at falling
T'); on the CPU the JAX package's dispatch holds (the kernel's plain
version up to T' = 512). In reference mode the lengths keep the
reference's quirk: base int(frames / 2) and each stage's
int((frames + pad) / factor), from the ORIGINAL frame counts.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from early_exit_tpu_torch.configs import ModelConfig
from early_exit_tpu_torch.models import conformer, subsampling
from early_exit_tpu_torch.models.early_conformer import conformer_cfg, heads_apply
from early_exit_tpu_torch.nn import core

FACTORS = (2, 4, 8, 4, 2)
STACK = (2, 4, 5, 4, 2)
N_BLOCKS = 2 + sum(STACK)


class EarlyZipformer(nn.Module):
    mesh = None             # set by `parallel.shard_params`

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.n_enc_exits != N_BLOCKS:
            raise ValueError(
                f"early_zipformer requires n_enc_exits={N_BLOCKS} "
                f"(2 + sum({list(STACK)})); got {cfg.n_enc_exits}")
        self.cfg = cfg
        d, npe = cfg.d_model, cfg.n_enc_layers_per_exit
        ccfg = conformer_cfg(cfg)
        self.sub_w, self.sub_b = subsampling.conv_subsample_params(cfg.n_mels, d, 1)
        self.pre = conformer.ConformerStack(ccfg, 2 * npe)
        self.stages = nn.ModuleList(conformer.ConformerStack(ccfg, n * npe)
                                    for n in STACK)
        self.head_w = nn.Parameter(torch.zeros(d, cfg.vocab_size))
        self.head_b = nn.Parameter(torch.zeros(cfg.vocab_size))

    def init(self, generator: torch.Generator) -> "EarlyZipformer":
        """Fresh weights in place, as `ConformerTrunk.init` draws them."""
        subsampling.conv_subsample_init_(list(zip(self.sub_w, self.sub_b)), generator)
        for stack in self.stacks():
            stack.init(generator)
        core.linear_init_(self.head_w, self.head_b, generator)
        return self

    def stacks(self):
        """The six stacks in the order they run: pre, then the stages."""
        return [self.pre, *self.stages]

    # the single head as the per-exit heads of one exit, (1, D, V), (1, V)
    @property
    def heads_w(self) -> torch.Tensor:
        return self.head_w[None]

    @property
    def heads_b(self) -> torch.Tensor:
        return self.head_b[None]

    def _forward(self, feats, lengths, run, pe_gen=None):
        """The U-Net on (B, T, mels); run(i, stack, x, mask) runs stack i
        (0 = pre). Returns (hidden (1, B, T'', D), out_len (B,))."""
        cfg = self.cfg
        x = subsampling.conv_subsample_apply(list(zip(self.sub_w, self.sub_b)), feats,
                                             compute_dtype=cfg.dtype)
        t_sub = x.shape[1]
        pe = core.sinusoidal_pe(t_sub, cfg.d_model, device=x.device)
        x = core.dropout(x.float() + pe[None], cfg.drop_prob, pe_gen)
        if cfg.length_mode == "reference":
            base_len = subsampling.reference_subsampled_length(lengths, 2, t_sub)
        else:
            base_len = subsampling.subsampled_length(lengths, 1).clamp(max=t_sub)
        pos = torch.arange(t_sub, device=x.device)
        base_mask = (pos[None, :] < base_len[:, None])[..., None]
        zero = torch.zeros((), device=x.device)
        x = torch.where(base_mask, x, zero).to(cfg.rdtype)
        x = run(0, self.pre, x, base_mask[..., 0])
        for i, factor in enumerate(FACTORS):
            src, T = x, x.shape[1]
            x, pad = subsampling.pad_downsample(x, factor)
            t_ds = x.shape[1]
            if cfg.length_mode == "reference":
                ds_len = ((lengths + pad).float() / factor).to(torch.int32)
            else:
                ds_len = torch.div(base_len + pad + factor - 1, factor,
                                   rounding_mode="floor")
            mask = torch.arange(t_ds, device=x.device)[None, :] < ds_len.clamp(max=t_ds)[:, None]
            x = run(i + 1, self.stages[i], x, mask)
            x = subsampling.upsample_to(x, factor, T) + src
            x = torch.where(base_mask, x, zero.to(x.dtype))
        out = subsampling.downsample(x, 2)
        out_len = torch.div(base_len + 1, 2, rounding_mode="floor").clamp(max=out.shape[1])
        return out[None], out_len

    def apply_hidden(self, feats: torch.Tensor, lengths: torch.Tensor):
        """(B, T, mels) -> the exit's hidden state (1, B, T'', D) and the
        output lengths."""
        return self._forward(feats, lengths, lambda i, stack, x, mask: stack(x, mask))

    def apply_heads(self, hidden: torch.Tensor, *,
                    log_probs: bool = True) -> torch.Tensor:
        """(1, B, T'', D) -> (1, B, T'', V): float32 log-probs, or the raw
        compute-dtype logits with log_probs=False."""
        return heads_apply(self.heads_w, self.heads_b, hidden, self.cfg.dtype,
                           log_probs=log_probs, mesh=self.mesh, vocab=self.cfg.vocab_size)

    def apply(self, feats: torch.Tensor, lengths: torch.Tensor, *,
              log_probs: bool = True):
        """feats (B, T, n_mels), lengths (B,) -> ((1, B, T'', V), out_len
        (B,))."""
        hidden, out_len = self.apply_hidden(feats, lengths)
        return self.apply_heads(hidden, log_probs=log_probs), out_len

    def apply_train(self, feats: torch.Tensor, lengths: torch.Tensor, *,
                    seed: Optional[int] = None,
                    attn_mask: Optional[torch.Tensor] = None):
        """The training forward with autograd (no kernel, unquantized,
        BatchNorm on the batch, dropout from `seed`, none without).
        Returns (log_probs (1, B, T'', V) float32, out_len, new_state)."""
        if attn_mask is not None:
            raise ValueError("early_zipformer trains with full attention: its "
                             "stages run at other frame rates than a chunk mask's")
        seeds = None
        if seed is not None and self.cfg.drop_prob > 0.0:
            host = torch.Generator().manual_seed(seed)
            seeds = torch.randint(0, 2 ** 62, (len(self.stacks()) + 1,),
                                  generator=host).tolist()
        states = {}

        def run(i, stack, x, mask):
            block_seeds = None
            if seeds is not None:
                host = torch.Generator().manual_seed(seeds[i])
                block_seeds = torch.randint(0, 2 ** 62, (len(stack.blocks),),
                                            generator=host).tolist()
            outs, mean, var = stack.train_forward(x, mask, seeds=block_seeds)
            states[i] = {"conv_bn": {"mean": mean, "var": var}}
            return outs[-1]

        pe_gen = (None if seeds is None else
                  torch.Generator(device=feats.device).manual_seed(seeds[-1]))
        hidden, out_len = self._forward(feats, lengths, run, pe_gen)
        new_state = {"pre": states[0], "stages": [states[i + 1] for i in range(len(STACK))]}
        return self.apply_heads(hidden), out_len, new_state

    def state(self) -> dict:
        """{"pre": {"conv_bn": {"mean", "var"}}, "stages": [the same, x5]},
        (n, D) each, as `apply_train` returns them."""
        return {"pre": self.pre.bn_state(),
                "stages": [s.bn_state() for s in self.stages]}

    def set_state(self, state: dict) -> None:
        for stack, s in zip(self.stacks(), [state["pre"], *state["stages"]]):
            stack.set_bn_state(s["conv_bn"]["mean"], s["conv_bn"]["var"])
