"""Carry parameter trees between the JAX package's layout and the port's
modules.

`from_jax_params(params, state, cfg)` takes the parameter and state
trees of an `early_conformer`, `splitformer`, `early_zipformer` or
`full_conformer` -- as the JAX package builds them, or as the port's
checkpoint reader returns them -- with numpy or tensor leaves, and
returns the model of cfg.model_type on the CPU with float32 weights (the
compute-dtype casts happen per op, as in the JAX package).
`to_jax_params(model)` goes the other way, to numpy trees of the JAX
layout (block leaves stacked on a leading layer axis, decoder leaves on
leading (exit, layer) axes, the subsampling convolutions, the
splitformer's two branch blocks and the zipformer's five stages lists).
`jax_tree(model, values)` lays out any per-parameter tensors (gradients,
Adam moments) the same way, and `from_jax_tree` reads such a tree back
into one tensor per parameter; `state_tensors` reads a state tree. Each
model type has its own list of paths (`_PATHS`). `flagship_zoo_tree`
builds the zoo's trees from the committed flagship's trained blocks.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from early_exit_tpu_torch.checkpoint import FLAGSHIP_CKPT, load_tree, to_torch
from early_exit_tpu_torch.configs import ModelConfig
from early_exit_tpu_torch.models.conformer import ConformerStack
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


def state_tensors(tree):
    """A state tree (numpy or tensor leaves, lists perhaps saved as maps
    keyed "0", "1") -> the same tree of float32 CPU tensors, with lists."""
    if isinstance(tree, Mapping):
        if tree and all(isinstance(k, str) and k.isdigit() for k in tree):
            return [state_tensors(tree[str(i)]) for i in range(len(tree))]
        return {k: state_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [state_tensors(v) for v in tree]
    return _f32(tree)


def load_params(model, params, state=None) -> None:
    """The JAX trees -> the model's parameters and running statistics (if
    it has any), in place."""
    src = from_jax_tree(model, params)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(src[p])
    if state is not None:
        model.set_state(state_tensors(state))


def from_jax_params(params, state, cfg: ModelConfig, *, trainable: bool = False):
    """trainable=False (serving) freezes the parameters: no graph is built
    even outside `torch.no_grad`."""
    model = build_model(cfg).requires_grad_(trainable)
    load_params(model, params, state)
    return model


def _attr(module, name: str):
    mod, attr = name.rsplit(".", 1) if "." in name else (None, name)
    return getattr(module if mod is None else getattr(module, mod), attr)


# (JAX path, [port parameters], leading axes) per leaf of the JAX params
# tree: a stacked block leaf lists the L blocks' tensors, stacked on one
# axis (L,); a decoder leaf the E x n_dec layers', on (E, n_dec)

def _linear(prefix, w, b):
    return [(prefix + ("w",), [w], ()), (prefix + ("b",), [b], ())]


def _norm(prefix, g, b):
    return [(prefix + ("g",), [g], ()), (prefix + ("b",), [b], ())]


def _subsample_paths(model):
    return [(("subsample", "convs", i, n), [t], ())
            for i, (w, b) in enumerate(zip(model.sub_w, model.sub_b))
            for n, t in (("w", w), ("b", b))]


def _stack_paths(prefix, stack: ConformerStack):
    blocks = list(stack.blocks)
    return [(prefix + path, [_attr(b, name) for b in blocks], (len(blocks),))
            for name, path in _BLOCK_PATHS.items()]


def _early_conformer_paths(model):
    return (_subsample_paths(model) + _stack_paths(("blocks",), model.stack)
            + _linear(("heads",), model.heads_w, model.heads_b))


def _full_conformer_paths(model):
    layers = [layer for dec in model.decoders for layer in dec.layers]
    lead = (len(model.decoders), len(model.decoders[0].layers))
    return (_early_conformer_paths(model)
            + [(("decoders",) + path, [_attr(l, name) for l in layers], lead)
               for name, path in _DECODER_PATHS.items()]
            + _linear(("out_linear",), model.out_w, model.out_b)
            + _shared_decoder_paths(model))


def _splitformer_paths(model):
    """The flagship's tree and the two branch blocks, unstacked."""
    return _early_conformer_paths(model) + [
        (("parallel", i) + path, [_attr(block, name)], ())
        for i, block in enumerate(model.parallel) for name, path in _BLOCK_PATHS.items()]


def _zipformer_paths(model):
    out = _subsample_paths(model) + _stack_paths(("pre",), model.pre)
    for i, stage in enumerate(model.stages):
        out += _stack_paths(("stages", i), stage)
    return out + _linear(("head",), model.head_w, model.head_b)


# the legacy family's encoder layer: port tensor name -> path in its tree
_ENC_LAYER_PATHS = {"ln1_g": ("ln1", "g"), "ln1_b": ("ln1", "b"),
                    "ln2_g": ("ln2", "g"), "ln2_b": ("ln2", "b"),
                    "w1": ("w1", "w"), "b1": ("w1", "b"), "w2": ("w2", "w"), "b2": ("w2", "b")}
for _n in ("q", "k", "v", "o"):
    _ENC_LAYER_PATHS[f"attn.w{_n}"] = ("attn", _n, "w")
    _ENC_LAYER_PATHS[f"attn.b{_n}"] = ("attn", _n, "b")


def _encoder_paths(prefix, stack):
    layers = list(stack.layers)
    return ([(prefix + ("layers",) + path, [_attr(l, name) for l in layers], (len(layers),))
             for name, path in _ENC_LAYER_PATHS.items()]
            + _norm(prefix + ("final_ln",), stack.final_ln_g, stack.final_ln_b))


def _decoder_paths(prefix, dec):
    layers = list(dec.layers)
    return [(prefix + path, [_attr(l, name) for l in layers], (len(layers),))
            for name, path in _DECODER_PATHS.items()]


def _shared_decoder_paths(model):
    return ([(("emb", "table"), [model.emb], ())]
            + _norm(("final_ln",), model.final_ln_g, model.final_ln_b))


def _ctc_self_attention_paths(model):
    return (_subsample_paths(model) + _encoder_paths(("encoder",), model.encoder)
            + _linear(("head",), model.head_w, model.head_b))


def _early_encoder_paths(model):
    out = _subsample_paths(model)
    for e, enc in enumerate(model.encoders):
        out += _encoder_paths(("encoders", e), enc)
        out += _linear(("heads", e), model.heads_w[e], model.heads_b[e])
    return out


def _early_transformer_paths(model):
    out = _subsample_paths(model)
    for e, (enc, dec) in enumerate(zip(model.encoders, model.decoders)):
        out += _encoder_paths(("encoders", e), enc)
        out += _linear(("ctc_heads", e), model.ctc_w[e], model.ctc_b[e])
        out += _linear(("out_heads", e), model.out_w[e], model.out_b[e])
        out += _decoder_paths(("decoders", e), dec)
    return out + _shared_decoder_paths(model)


def _legacy_transformer_paths(model):
    return (_subsample_paths(model) + _encoder_paths(("encoder",), model.encoder)
            + _decoder_paths(("decoder",), model.decoder)
            + _linear(("ctc_head",), model.ctc_w, model.ctc_b)
            + _linear(("out_head",), model.out_w, model.out_b)
            + _shared_decoder_paths(model))


# model class -> its paths
_PATHS = {"EarlyConformer": _early_conformer_paths,
          "FullConformer": _full_conformer_paths,
          "Splitformer": _splitformer_paths,
          "EarlyZipformer": _zipformer_paths,
          "CTCSelfAttention": _ctc_self_attention_paths,
          "EarlyEncoder": _early_encoder_paths,
          "EarlyTransformer": _early_transformer_paths,
          "LegacyTransformer": _legacy_transformer_paths}


def _param_paths(model):
    return _PATHS[type(model).__name__](model)


def legacy_from_jax(kind: str, params, cfg: ModelConfig):
    """A legacy model (`models/legacy_transformer.py`: "CTCSelfAttention",
    "EarlyEncoder", "EarlyTransformer" or "LegacyTransformer") from the
    JAX package's params tree of it (it has no state), frozen, float32,
    on the CPU."""
    from early_exit_tpu_torch.models import legacy_transformer
    model = getattr(legacy_transformer, kind)(cfg).requires_grad_(False)
    load_params(model, params)
    return model


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


def jax_tree(model, values=None) -> dict:
    """The JAX params tree of `values` (a dict from parameter to tensor;
    default the parameters themselves), float32 numpy leaves."""
    tree: dict = {}
    for path, params, lead in _param_paths(model):
        ts = [p if values is None else values[p] for p in params]
        leaf = (_np(ts[0]) if not lead else
                np.stack([_np(t) for t in ts]).reshape(lead + tuple(ts[0].shape)))
        _set(tree, path, leaf)
    return tree


def numpy_tree(tree):
    """A tree of tensors (dicts and lists) -> the same tree of float32
    numpy copies."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [numpy_tree(v) for v in tree]
    return _np(tree)


def to_jax_params(model):
    """(params, state) numpy trees in the JAX package's layout."""
    return jax_tree(model), numpy_tree(model.state())


def from_jax_tree(model, tree) -> dict:
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


def _map(fn, tree):
    """fn on every leaf of a tree of dicts."""
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def flagship_zoo_tree(model_type: str, path: str = FLAGSHIP_CKPT):
    """(params, state) trees, float32 numpy leaves in the JAX package's
    layout, of a zoo model at the flagship's widths whose blocks,
    convolution and heads are the committed flagship's trained ones: the
    splitformer's trunk and heads are the flagship's, its branches blocks
    1 and 12; the zipformer's 19 blocks are blocks 1..12 in turn, its
    convolution the flagship's first and its head exit 6's. A seeded init
    gives near-tie logits, and a model trained a few steps emits almost no
    tokens; these transcribe."""
    tree = load_tree(path)
    fp, fs = (_map(lambda a: _f32(a).numpy(), tree[k]) for k in ("params", "model_state"))
    convs = [_item(fp["subsample"]["convs"], i) for i in (0, 1)]

    def stacked(blocks, idx):
        return _map(lambda a: a[np.asarray(idx)], blocks)

    if model_type == "splitformer":
        return ({"subsample": {"convs": convs}, "blocks": fp["blocks"],
                 "heads": fp["heads"],
                 "parallel": [stacked(fp["blocks"], 0), stacked(fp["blocks"], 11)]},
                {"blocks": fs["blocks"],
                 "parallel": [stacked(fs["blocks"], 0), stacked(fs["blocks"], 11)]})
    if model_type != "early_zipformer":
        raise ValueError(f"flagship_zoo_tree: splitformer or early_zipformer, "
                         f"not {model_type!r}")
    from early_exit_tpu_torch.models.zipformer import STACK
    idx = [i % 12 for i in range(2 + sum(STACK))]
    bounds = np.cumsum([2, *STACK])
    parts = [idx[a:b] for a, b in zip([0, *bounds[:-1]], bounds)]
    return ({"subsample": {"convs": convs[:1]}, "pre": stacked(fp["blocks"], parts[0]),
             "stages": [stacked(fp["blocks"], q) for q in parts[1:]],
             "head": {"w": fp["heads"]["w"][5], "b": fp["heads"]["b"][5]}},
            {"pre": stacked(fs["blocks"], parts[0]),
             "stages": [stacked(fs["blocks"], q) for q in parts[1:]]})
