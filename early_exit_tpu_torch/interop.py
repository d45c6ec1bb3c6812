"""Carry parameter trees between the JAX package's layout and the port's
modules.

`from_jax_params(params, state, cfg)` takes the `early_conformer` or
`full_conformer` parameter and state trees -- as the JAX package builds
them, or as the port's checkpoint reader returns them -- with numpy or
tensor leaves, and returns an `EarlyConformer` or `FullConformer` (by
cfg.model_type) on the CPU with float32 weights (the compute-dtype casts
happen per op, as in the JAX package).
`to_jax_params(model)` goes the other way, to numpy trees of the JAX
layout (block leaves stacked on a leading layer axis, decoder leaves on
leading (exit, layer) axes, the two subsampling convolutions a list).
`jax_tree(model, values)` lays out any per-parameter tensors (gradients,
Adam moments) the same way, and `from_jax_tree` reads such a tree back
into one tensor per parameter.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from early_exit_tpu_torch.checkpoint import to_torch
from early_exit_tpu_torch.configs import ModelConfig
from early_exit_tpu_torch.models.conformer import ConformerStack
from early_exit_tpu_torch.models.early_conformer import ConformerTrunk
from early_exit_tpu_torch.models.full_conformer import FullConformer
from early_exit_tpu_torch.models.registry import build_model

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
# port decoder-layer tensor name -> path in the JAX decoder-layer tree
_DECODER_PATHS = {"w1": ("w1", "w"), "b1": ("w1", "b"),
                  "w2": ("w2", "w"), "b2": ("w2", "b")}
for _i in (1, 2, 3):
    _DECODER_PATHS[f"ln{_i}_g"] = (f"ln{_i}", "g")
    _DECODER_PATHS[f"ln{_i}_b"] = (f"ln{_i}", "b")
for _att in ("self_attn", "cross_attn"):
    for _n in ("q", "k", "v", "o"):
        _DECODER_PATHS[f"{_att}.w{_n}"] = (_att, _n, "w")
        _DECODER_PATHS[f"{_att}.b{_n}"] = (_att, _n, "b")
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


def load_stack(stack: ConformerStack, params, state, *,
               trainable: bool = False) -> ConformerStack:
    """Layer-stacked JAX block trees (`conformer.stack_init` layout, a
    leading layer axis on every leaf) -> the stack's blocks, frozen unless
    trainable."""
    stack.requires_grad_(trainable)
    blocks = {n: _f32(_get(params, p)) for n, p in _BLOCK_PATHS.items()}
    blocks.update({n: _f32(_get(state, p)) for n, p in _STATE_PATHS.items()})
    with torch.no_grad():
        for i, block in enumerate(stack.blocks):
            block.load_state_dict({n: t[i] for n, t in blocks.items()})
    stack.clear_folded()
    return stack


def from_jax_params(params, state, cfg: ModelConfig, *,
                    trainable: bool = False) -> ConformerTrunk:
    """trainable=False (serving) freezes the parameters: no graph is built
    even outside `torch.no_grad`."""
    model = build_model(cfg).requires_grad_(trainable)
    load_stack(model.stack, params["blocks"], state["blocks"], trainable=trainable)
    src = from_jax_tree(model, params)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(src[p])
    return model


def _attr(module, name: str):
    mod, attr = name.rsplit(".", 1) if "." in name else (None, name)
    return getattr(module if mod is None else getattr(module, mod), attr)


def _param_paths(model: ConformerTrunk):
    """(JAX path, [port parameters], leading axes) per leaf of the JAX
    params tree: a block leaf lists the L blocks' tensors, stacked on one
    axis (L,); a decoder leaf the E x n_dec layers', on (E, n_dec)."""
    out = []
    for i in range(2):
        out.append((("subsample", "convs", i, "w"), [model.sub_w[i]], ()))
        out.append((("subsample", "convs", i, "b"), [model.sub_b[i]], ()))
    blocks = list(model.stack.blocks)
    for name, path in _BLOCK_PATHS.items():
        out.append((("blocks",) + path, [_attr(b, name) for b in blocks], (len(blocks),)))
    out.append((("heads", "w"), [model.heads_w], ()))
    out.append((("heads", "b"), [model.heads_b], ()))
    if isinstance(model, FullConformer):
        layers = [layer for dec in model.decoders for layer in dec.layers]
        lead = (len(model.decoders), len(model.decoders[0].layers))
        for name, path in _DECODER_PATHS.items():
            out.append((("decoders",) + path, [_attr(l, name) for l in layers], lead))
        out += [(("emb", "table"), [model.emb], ()),
                (("out_linear", "w"), [model.out_w], ()),
                (("out_linear", "b"), [model.out_b], ()),
                (("final_ln", "g"), [model.final_ln_g], ()),
                (("final_ln", "b"), [model.final_ln_b], ())]
    return out


def _set(tree, path, value) -> None:
    """tree[path] = value, making dicts (or lists, before an int key)."""
    for k, nxt in zip(path[:-1], path[1:]):
        make = list if isinstance(nxt, int) else dict
        if isinstance(k, int):
            while len(tree) <= k:
                tree.append(make())
            tree = tree[k]
        else:
            tree = tree.setdefault(k, make())
    tree[path[-1]] = value


def _np(t: torch.Tensor):
    """A float32 numpy copy (never a view of a live parameter)."""
    return t.detach().float().cpu().numpy().copy()


def jax_tree(model: ConformerTrunk, values=None) -> dict:
    """The JAX params tree of `values` (a dict from parameter to tensor;
    default the parameters themselves), float32 numpy leaves."""
    tree: dict = {}
    for path, params, lead in _param_paths(model):
        ts = [p if values is None else values[p] for p in params]
        leaf = (_np(ts[0]) if not lead else
                np.stack([_np(t) for t in ts]).reshape(lead + tuple(ts[0].shape)))
        _set(tree, path, leaf)
    return tree


def to_jax_params(model: ConformerTrunk):
    """(params, state) numpy trees in the JAX package's layout."""
    bn = model.state()["blocks"]["conv_bn"]
    state = {"blocks": {"conv_bn": {"mean": _np(bn["mean"]),
                                    "var": _np(bn["var"])}}}
    return jax_tree(model), state


def from_jax_tree(model: ConformerTrunk, tree) -> dict:
    """A tree in the JAX params layout -> {parameter: float32 CPU tensor}."""
    out = {}
    for path, params, lead in _param_paths(model):
        leaf = tree
        for k in path:
            leaf = _item(leaf, k) if isinstance(k, int) else leaf[k]
        leaf = _f32(leaf)
        if not lead:
            out[params[0]] = leaf
            continue
        leaf = leaf.reshape((-1,) + tuple(leaf.shape[len(lead):]))
        for i, p in enumerate(params):
            out[p] = leaf[i]
    return out
