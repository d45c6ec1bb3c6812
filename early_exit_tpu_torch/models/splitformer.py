"""Splitformer: the early-exit Conformer with a parallel downsampled
branch at its first and last exits (counterpart of
`early_exit_tpu/models/splitformer.py`).

Everything of `EarlyConformer`, plus two Conformer blocks
(`parallel[0]`, `parallel[1]`). At exit 1 and at exit E the branch runs
beside that exit's stack on the hidden state before it:

    pad T' to even with zeros -> every 2nd frame -> one unfused block
    under its own mask -> each frame repeated twice -> cut back to T'

and its output is added to the stack's, the padded rows zeroed again;
exits 2 to E-1 read the branch-corrected state of exit 1. The stack runs
exit by exit (`ConformerStack.forward` over a range of blocks), so with
`fused_block` every trunk block is a block-kernel launch on the card; the
branch blocks run unfused, as the JAX package runs them.

The branch's valid length keeps the reference's quirk in reference mode:
int((frames + pad) / 2) of the ORIGINAL frame counts, at most T'/2, which
saturates to "every frame valid" for real utterances; in true mode it is
ceil(sub_len / 2).
"""

from __future__ import annotations

import torch
from torch import nn

from early_exit_tpu_torch.configs import ModelConfig
from early_exit_tpu_torch.models import subsampling
from early_exit_tpu_torch.models.conformer import ConformerBlock
from early_exit_tpu_torch.models.early_conformer import (EarlyConformer, conformer_cfg,
                                                       heads_apply)

FACTOR = 2      # the branch's downsampling factor


class Splitformer(EarlyConformer):
    n_extra_blocks = 2

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        ccfg = conformer_cfg(cfg)
        self.parallel = nn.ModuleList(ConformerBlock(ccfg) for _ in range(2))

    def init(self, generator: torch.Generator) -> "Splitformer":
        super().init(generator)
        for block in self.parallel:
            block.init(generator)
        return self

    def branch_exits(self):
        """The 0-based exits that run a branch, each with its block index
        (a one-exit model runs block 0 there, as the JAX package)."""
        return {self.cfg.n_enc_exits - 1: 1, 0: 0}

    def branch_operands(self, T, lengths: torch.Tensor, sub_len: torch.Tensor):
        """What the branch takes from the lengths at a T'-frame exit, the
        same at both branch exits: the kept frames' indices (t_ds,), the
        branch mask (B, t_ds) and the upsampling gather (T',). Computed
        once, outside the gate's conds, so that no cond branch derives a
        size of its own."""
        down = subsampling.down_index(T, FACTOR, lengths.device)
        t_ds = down.shape[0]
        if self.cfg.length_mode == "reference":
            pad = (-T) % FACTOR
            ds_len = ((lengths + pad).float() / FACTOR).to(torch.int32).clamp(max=t_ds)
        else:
            ds_len = torch.div(sub_len + FACTOR - 1, FACTOR,
                               rounding_mode="floor").clamp(max=t_ds)
        ds_mask = torch.arange(t_ds, device=lengths.device)[None, :] < ds_len[:, None]
        up = subsampling.up_index(T, FACTOR, lengths.device)
        return down, ds_mask, up

    def add_branch(self, bi: int, branch_in: torch.Tensor, h: torch.Tensor,
                   mask: torch.Tensor, down: torch.Tensor, ds_mask: torch.Tensor,
                   up: torch.Tensor) -> torch.Tensor:
        """Inference: h (the exit's stack output) plus branch bi on
        branch_in (the hidden state before the stack), padded rows zeroed;
        down, ds_mask, up from `branch_operands`."""
        y = self.parallel[bi](branch_in.index_select(1, down), ds_mask).index_select(1, up)
        return torch.where(mask[..., None], h + y, torch.zeros((), dtype=h.dtype,
                                                                 device=h.device))

    def _exits(self, feats, lengths, n_exits: int):
        """The trunk through exit n_exits: ([each exit's hidden state],
        sub-lengths)."""
        x, sub_len, mask = self.frontend_embed(feats, lengths)
        npe, branches = self.cfg.n_enc_layers_per_exit, self.branch_exits()
        ops = self.branch_operands(x.shape[1], lengths, sub_len)
        hidden = []
        for e in range(n_exits):
            h = self.stack(x, mask, first_layer=e * npe, n_layers=(e + 1) * npe)
            if e in branches:
                h = self.add_branch(branches[e], x, h, mask, *ops)
            x = h
            hidden.append(h)
        return hidden, sub_len

    def apply_hidden(self, feats: torch.Tensor, lengths: torch.Tensor):
        """(B, T, mels) -> per-exit hidden states (E, B, T', D), branches
        included, and the sub-lengths."""
        hidden, sub_len = self._exits(feats, lengths, self.cfg.n_enc_exits)
        return torch.stack(hidden), sub_len

    def encode_exit(self, feats: torch.Tensor, lengths: torch.Tensor,
                    n_exit: int):
        """The trunk up to exit n_exit (1-based), branches included: that
        exit's log-probs and the sub-lengths."""
        hidden, sub_len = self._exits(feats, lengths, n_exit)
        w, b = self.heads_w[n_exit - 1:n_exit], self.heads_b[n_exit - 1:n_exit]
        return heads_apply(w, b, hidden[-1][None], self.cfg.dtype)[0], sub_len

    def train_blocks(self, x, mask, lengths, sub_len, *, seeds, attn_mask):
        """The training forward exit by exit, the branch blocks drawing
        their dropout from seeds[L] and seeds[L + 1]."""
        npe, branches = self.cfg.n_enc_layers_per_exit, self.branch_exits()
        L = len(self.stack.blocks)
        down, ds_mask, up = self.branch_operands(x.shape[1], lengths, sub_len)
        hidden, means, variances, par_state = [], [], [], []
        for e in range(self.cfg.n_enc_exits):
            out, m, v = self.stack.train_forward(
                x, mask, seeds=seeds, attn_mask=attn_mask, collect_every=npe,
                first_layer=e * npe, n_layers=(e + 1) * npe)
            h = out[-1]
            means.append(m)
            variances.append(v)
            if e in branches:
                bi = branches[e]
                y, bm, bv = self.parallel[bi](
                    x.index_select(1, down), ds_mask, train=True,
                    seed=None if seeds is None else seeds[L + bi])
                h = h + y.index_select(1, up)
                h = torch.where(mask[..., None], h, torch.zeros((), dtype=h.dtype,
                                                                  device=h.device))
                par_state.append({"conv_bn": {"mean": bm, "var": bv}})
            x = h
            hidden.append(h)
        new_state = {"blocks": {"conv_bn": {"mean": torch.cat(means),
                                            "var": torch.cat(variances)}},
                     "parallel": par_state}
        return torch.stack(hidden), new_state

    def state(self) -> dict:
        """{"blocks": {"conv_bn": {"mean", "var"}} (L, D) each, "parallel":
        [{"conv_bn": {"mean", "var"}} (D,) each, x2]}."""
        return {**super().state(),
                "parallel": [{"conv_bn": {"mean": b.conv.bn_mean, "var": b.conv.bn_var}}
                             for b in self.parallel]}

    def set_state(self, state: dict) -> None:
        super().set_state(state)
        with torch.no_grad():
            for block, s in zip(self.parallel, state["parallel"]):
                block.conv.bn_mean.copy_(s["conv_bn"]["mean"])
                block.conv.bn_var.copy_(s["conv_bn"]["var"])
