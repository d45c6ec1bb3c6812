"""Carry the JAX package's parameter trees across to the port's modules.

`from_jax_params(params, state, cfg)` takes the `early_conformer`
parameter and state trees -- as the JAX package builds them, or as the
port's checkpoint reader returns them -- with numpy or tensor leaves,
and returns an `EarlyConformer` on the CPU with float32 weights (the
compute-dtype casts happen per op, as in the JAX package).
"""

from __future__ import annotations

from typing import Mapping

import torch

from early_exit_tpu_torch.checkpoint import to_torch
from early_exit_tpu_torch.configs import ModelConfig
from early_exit_tpu_torch.models.conformer import ConformerStack
from early_exit_tpu_torch.models.early_conformer import EarlyConformer

# port block tensor name -> path in the JAX block tree
_BLOCK_PATHS = {
    "attn.ln_g": ("attn", "ln", "g"), "attn.ln_b": ("attn", "ln", "b"),
    "conv.ln_g": ("conv", "ln", "g"), "conv.ln_b": ("conv", "ln", "b"),
    "conv.pw1_w": ("conv", "pw1", "w"), "conv.pw1_b": ("conv", "pw1", "b"),
    "conv.dw_w": ("conv", "dw", "w"), "conv.dw_b": ("conv", "dw", "b"),
    "conv.bn_g": ("conv", "norm", "g"), "conv.bn_b": ("conv", "norm", "b"),
    "conv.pw2_w": ("conv", "pw2", "w"), "conv.pw2_b": ("conv", "pw2", "b"),
    "final_ln_g": ("final_ln", "g"), "final_ln_b": ("final_ln", "b"),
}
for _n in ("q", "k", "v", "o"):
    _BLOCK_PATHS[f"attn.w{_n}"] = ("attn", "mha", _n, "w")
    _BLOCK_PATHS[f"attn.b{_n}"] = ("attn", "mha", _n, "b")
for _pre in ("ffn1", "ffn2"):
    _BLOCK_PATHS.update({
        f"{_pre}.ln_g": (_pre, "ln", "g"), f"{_pre}.ln_b": (_pre, "ln", "b"),
        f"{_pre}.w1": (_pre, "w1", "w"), f"{_pre}.b1": (_pre, "w1", "b"),
        f"{_pre}.w2": (_pre, "w2", "w"), f"{_pre}.b2": (_pre, "w2", "b")})
_STATE_PATHS = {"conv.bn_mean": ("conv_bn", "mean"),
                "conv.bn_var": ("conv_bn", "var")}


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _f32(a) -> torch.Tensor:
    return to_torch(a).float()


def _item(seq, i):
    """Element i of a list, or of a list saved as a map keyed "0", "1"."""
    return seq[str(i)] if isinstance(seq, Mapping) else seq[i]


def load_stack(stack: ConformerStack, params, state) -> ConformerStack:
    """Layer-stacked JAX block trees (`conformer.stack_init` layout, a
    leading layer axis on every leaf) -> the stack's blocks."""
    blocks = {n: _f32(_get(params, p)) for n, p in _BLOCK_PATHS.items()}
    blocks.update({n: _f32(_get(state, p)) for n, p in _STATE_PATHS.items()})
    with torch.no_grad():
        for i, block in enumerate(stack.blocks):
            block.load_state_dict({n: t[i] for n, t in blocks.items()})
    stack.clear_folded()
    return stack


def from_jax_params(params, state, cfg: ModelConfig) -> EarlyConformer:
    model = EarlyConformer(cfg)
    load_stack(model.stack, params["blocks"], state["blocks"])
    with torch.no_grad():
        for i in range(2):
            conv = _item(params["subsample"]["convs"], i)
            model.sub_w[i].copy_(_f32(conv["w"]))
            model.sub_b[i].copy_(_f32(conv["b"]))
        model.heads_w.copy_(_f32(params["heads"]["w"]))
        model.heads_b.copy_(_f32(params["heads"]["b"]))
    return model
