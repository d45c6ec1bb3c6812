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

`from_reference_state_dict(sd, cfg)` reads the state_dict of the
reference's torch model (`augustgw/early-exit-transformer`'s
Early_conformer, Splitformer, Early_zipformer or full_conformer, as
numpy arrays) into (params, state) trees of the JAX package's layout,
which `from_jax_params` / `load_params` load; `to_reference_state_dict`
is its exact inverse, a state_dict the reference loads with strict=True.
Both give the same trees and arrays as the JAX package's functions of
those names.
"""

from __future__ import annotations

from typing import Dict, Mapping

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
    it has any), in place; a tensor-parallel shard takes its piece."""
    src = from_jax_tree(model, params)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(local(p, src[p]))
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


def param_paths(model):
    """[(JAX path, [port parameters], leading axes)] of the model's type."""
    return _PATHS[type(model).__name__](model)


def local(p: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """This rank's piece of a parameter's full tensor: the whole tensor,
    or the tensor-parallel shard a sharded parameter holds
    (`parallel.shard_params` marks it with `tp_shard`)."""
    shard = getattr(p, "tp_shard", None)
    return full if shard is None else shard.take(full)


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
    for path, params, lead in param_paths(model):
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
    for path, params, lead in param_paths(model):
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


# ---------------------------------------------------------------------------
# Reference checkpoints: the state_dict of the reference's torch modules
# <-> the JAX package's layout (the port's copy of
# `early_exit_tpu/interop.py`). The reference's encoders are torchaudio's
# `Conformer`, whose state_dict names are
#
#     conformer_layers.{l}.ffn1.sequential.{0 LN, 1 Linear, 4 Linear}
#     conformer_layers.{l}.self_attn_layer_norm
#     conformer_layers.{l}.self_attn.{in_proj_weight, in_proj_bias, out_proj}
#     conformer_layers.{l}.conv_module.layer_norm
#     conformer_layers.{l}.conv_module.sequential.{0 pw-Conv1d, 2 dw-Conv1d,
#                                                  3 BatchNorm1d, 5 pw-Conv1d}
#     conformer_layers.{l}.ffn2.sequential.{0, 1, 4}
#     conformer_layers.{l}.final_layer_norm
#
# Linears go from torch's (out, in) to (in, out), convolutions from
# (out, in, k) to "WIO" (k, in, out), the packed in_proj splits into q, k
# and v, and per-layer leaves stack on a leading axis. Every tensor must
# be consumed (an unknown key raises); the positional-encoding buffers are
# recomputed on export, not read on import.
# ---------------------------------------------------------------------------

_IGNORED_SUFFIXES = ("num_batches_tracked",)
_IGNORED_KEYS = ("positional_encoder.pe", "positional_encoder_1.pe",
                 "positional_encoder_2.pe")


class _Reader:
    """Tracks key consumption so leftovers fail loudly."""

    def __init__(self, sd: Dict[str, np.ndarray]):
        self.sd = {k: np.asarray(v, np.float32)
                   if np.asarray(v).dtype.kind == "f" else np.asarray(v)
                   for k, v in sd.items()}
        self.used = set()

    def take(self, key: str, shape=None) -> np.ndarray:
        if key not in self.sd:
            raise KeyError(f"reference state_dict is missing {key!r} — "
                           "wrong --model_type or architecture flags?")
        self.used.add(key)
        t = self.sd[key]
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{key}: shape {tuple(t.shape)} != expected "
                             f"{tuple(shape)} — check d_model/"
                             "d_feed_forward/vocab/kernel flags")
        return t.astype(np.float32)

    def finish(self):
        left = [k for k in self.sd
                if k not in self.used
                and k not in _IGNORED_KEYS
                and not k.endswith(_IGNORED_SUFFIXES)]
        if left:
            raise ValueError(
                "unmapped reference tensors (wrong model type?): "
                + ", ".join(sorted(left)[:8])
                + (" ..." if len(left) > 8 else ""))


def _ref_linear(r: _Reader, pre: str, d_in: int, d_out: int):
    return {"w": r.take(pre + ".weight", (d_out, d_in)).T.copy(),
            "b": r.take(pre + ".bias", (d_out,))}


def _layer_norm(r: _Reader, pre: str, d: int):
    return {"g": r.take(pre + ".weight", (d,)),
            "b": r.take(pre + ".bias", (d,))}


def _conv1d(r: _Reader, pre: str, c_in: int, c_out: int, k: int):
    # torch (out, in, k) -> WIO (k, in, out)
    return {"w": r.take(pre + ".weight",
                        (c_out, c_in, k)).transpose(2, 1, 0).copy(),
            "b": r.take(pre + ".bias", (c_out,))}


def _ffn(r: _Reader, pre: str, d: int, ff: int):
    return {"ln": _layer_norm(r, pre + ".sequential.0", d),
            "w1": _ref_linear(r, pre + ".sequential.1", d, ff),
            "w2": _ref_linear(r, pre + ".sequential.4", ff, d)}


def _mha(r: _Reader, pre: str, d: int):
    w = r.take(pre + ".in_proj_weight", (3 * d, d))
    b = r.take(pre + ".in_proj_bias", (3 * d,))
    out = {}
    for i, name in enumerate(("q", "k", "v")):
        out[name] = {"w": w[i * d:(i + 1) * d].T.copy(),
                     "b": b[i * d:(i + 1) * d].copy()}
    out["o"] = _ref_linear(r, pre + ".out_proj", d, d)
    return out


def _block(r: _Reader, pre: str, d: int, ff: int, k: int):
    """One torchaudio ConformerLayer -> (our block params, block state)."""
    cm = pre + ".conv_module"
    params = {
        "ffn1": _ffn(r, pre + ".ffn1", d, ff),
        "attn": {"ln": _layer_norm(r, pre + ".self_attn_layer_norm", d),
                 "mha": _mha(r, pre + ".self_attn", d)},
        "conv": {
            "ln": _layer_norm(r, cm + ".layer_norm", d),
            # pointwise convs are (out, in, 1) -> our Linear (in, out)
            "pw1": {"w": r.take(cm + ".sequential.0.weight",
                                (2 * d, d, 1))[:, :, 0].T.copy(),
                    "b": r.take(cm + ".sequential.0.bias", (2 * d,))},
            # depthwise (C, 1, k) -> ours (k, 1, C)
            "dw": {"w": r.take(cm + ".sequential.2.weight",
                               (d, 1, k)).transpose(2, 1, 0).copy(),
                   "b": r.take(cm + ".sequential.2.bias", (d,))},
            "norm": {"g": r.take(cm + ".sequential.3.weight", (d,)),
                     "b": r.take(cm + ".sequential.3.bias", (d,))},
            "pw2": {"w": r.take(cm + ".sequential.5.weight",
                                (d, d, 1))[:, :, 0].T.copy(),
                    "b": r.take(cm + ".sequential.5.bias", (d,))},
        },
        "ffn2": _ffn(r, pre + ".ffn2", d, ff),
        "final_ln": _layer_norm(r, pre + ".final_layer_norm", d),
    }
    state = {"conv_bn": {
        "mean": r.take(cm + ".sequential.3.running_mean", (d,)),
        "var": r.take(cm + ".sequential.3.running_var", (d,))}}
    return params, state


def _stack_trees(trees):
    """Trees of one structure (dicts and lists) -> one tree, each leaf the
    trees' leaves stacked on a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [_stack_trees([t[i] for t in trees]) for i in range(len(first))]
    return np.stack(trees)


def _stack(pairs):
    """[(params, state), ...] -> leaves stacked on a leading axis."""
    return (_stack_trees([p for p, _ in pairs]),
            _stack_trees([s for _, s in pairs]))


def _blocks_of(r, fmt, n_blocks, npe, d, ff, k):
    """Reference blocks fmt.format(block) each holding npe ConformerLayers,
    flattened in block-major order (matching conformer.stack_init)."""
    pairs = []
    for b in range(n_blocks):
        for l in range(npe):
            pairs.append(_block(r, f"{fmt.format(b)}.conformer_layers.{l}",
                                d, ff, k))
    return _stack(pairs)


def _decoder_layer(r: _Reader, pre: str, d: int, ff: int):
    """torch.nn.TransformerDecoderLayer (norm_first) -> our
    transformer_decoder.layer_init layout."""
    return {
        "ln1": _layer_norm(r, pre + ".norm1", d),
        "self_attn": _mha(r, pre + ".self_attn", d),
        "ln2": _layer_norm(r, pre + ".norm2", d),
        "cross_attn": _mha(r, pre + ".multihead_attn", d),
        "ln3": _layer_norm(r, pre + ".norm3", d),
        "w1": _ref_linear(r, pre + ".linear1", d, ff),
        "w2": _ref_linear(r, pre + ".linear2", ff, d),
    }


def _full_conformer(r: _Reader, cfg, d, ff, k, E, npe, V):
    """Reference full_conformer (early_exit.py:637-811): per-exit
    encoder stacks + CTC heads (linears_1) + torch TransformerDecoders
    with output heads (linears_2), a shared token embedding and a
    SHARED final LayerNorm (one module registered as `layer_norm` AND as
    every decoder's `norm` — all copies of the same tensor)."""
    sub = {"convs": [_conv1d(r, "conv_subsample.sequential.0",
                             cfg.n_mels, d, 3),
                     _conv1d(r, "conv_subsample.sequential.1", d, d, 3)]}
    block_p, block_s = _blocks_of(r, "conformer.{}", E, npe, d, ff, k)
    ctc_heads = _stack([(_ref_linear(r, f"linears_1.{e}", d, V), {})
                        for e in range(E)])[0]
    out_heads = _stack([(_ref_linear(r, f"linears_2.{e}", d, V), {})
                        for e in range(E)])[0]
    nd = cfg.n_dec_layers
    per_exit = []
    for e in range(E):
        layers = [_decoder_layer(r, f"decoders.{e}.layers.{l}", d, ff)
                  for l in range(nd)]
        per_exit.append(_stack_trees(layers))
        # each decoder registers the shared final LN under its own path
        r.take(f"decoders.{e}.norm.weight", (d,))
        r.take(f"decoders.{e}.norm.bias", (d,))
    decoders = _stack_trees(per_exit)
    params = {
        "subsample": sub,
        "blocks": block_p,
        "heads": ctc_heads,
        "emb": {"table": r.take("emb.weight", (V, d))},
        "decoders": decoders,
        "out_linear": out_heads,
        "final_ln": _layer_norm(r, "layer_norm", d),
    }
    r.finish()
    return params, {"blocks": block_s}


def from_reference_state_dict(sd: Dict[str, np.ndarray], cfg):
    """state_dict of the reference Early_conformer / Splitformer /
    Early_zipformer (early_exit.py:565/227/117) -> (params, state) for
    the matching model in our zoo (same ModelConfig contract)."""
    r = _Reader(sd)
    d, ff, k = cfg.d_model, cfg.d_feed_forward, cfg.depthwise_kernel_size
    E, npe, V = cfg.n_enc_exits, cfg.n_enc_layers_per_exit, cfg.vocab_size

    if cfg.model_type == "early_zipformer":
        from early_exit_tpu_torch.models.zipformer import STACK
        blocks = [2] + list(STACK)          # pre + the 5 U-Net stages
        assert E == sum(blocks), "n_enc_exits checked by zipformer.init"
        params = {"subsample": {"convs": [
            _conv1d(r, "conv_subsample.conv", cfg.n_mels, d, 3)]}}
        state = {}
        off = 0
        trees = []
        for n in blocks:
            # consecutive reference blocks off..off+n, npe layers each
            ps, ss = _stack([
                _block(r, f"conformer.{b}.conformer_layers.{l}", d, ff, k)
                for b in range(off, off + n) for l in range(npe)])
            trees.append((ps, ss))
            off += n
        params["pre"], state["pre"] = trees[0]
        params["stages"] = [t[0] for t in trees[1:]]
        state["stages"] = [t[1] for t in trees[1:]]
        params["head"] = _ref_linear(r, "linear", d, V)
        r.finish()
        return params, state

    if cfg.model_type == "full_conformer":
        return _full_conformer(r, cfg, d, ff, k, E, npe, V)

    if cfg.model_type not in ("early_conformer", "splitformer"):
        raise ValueError(f"no reference import for {cfg.model_type!r}")

    sub = {"convs": [_conv1d(r, "conv_subsample.sequential.0",
                             cfg.n_mels, d, 3),
                     _conv1d(r, "conv_subsample.sequential.1", d, d, 3)]}
    block_p, block_s = _blocks_of(r, "conformer.{}", E, npe, d, ff, k)
    heads = _stack([(_ref_linear(r, f"linears.{e}", d, V), {}) for e in
                    range(E)])[0]
    params = {"subsample": sub, "blocks": block_p, "heads": heads}
    state = {"blocks": block_s}
    if cfg.model_type == "splitformer":
        par = [_block(r, f"conformer_parallel.{i}.conformer_layers.0",
                      d, ff, k) for i in range(2)]
        params["parallel"] = [p for p, _ in par]
        state["parallel"] = [s for _, s in par]
    r.finish()
    return params, state


# ---------------------------------------------------------------------------
# Export (the exact inverse): our pytrees -> reference state_dict
# ---------------------------------------------------------------------------

class _Writer:
    def __init__(self):
        self.sd: Dict[str, np.ndarray] = {}

    def put(self, key: str, arr):
        self.sd[key] = np.ascontiguousarray(np.asarray(arr, np.float32))


def _w_linear(w: _Writer, pre: str, p):
    w.put(pre + ".weight", np.asarray(p["w"]).T)
    w.put(pre + ".bias", p["b"])


def _w_layer_norm(w: _Writer, pre: str, p):
    w.put(pre + ".weight", p["g"])
    w.put(pre + ".bias", p["b"])


def _w_conv1d(w: _Writer, pre: str, p):
    w.put(pre + ".weight", np.asarray(p["w"]).transpose(2, 1, 0))
    w.put(pre + ".bias", p["b"])


def _w_ffn(w: _Writer, pre: str, p):
    _w_layer_norm(w, pre + ".sequential.0", p["ln"])
    _w_linear(w, pre + ".sequential.1", p["w1"])
    _w_linear(w, pre + ".sequential.4", p["w2"])


def _w_mha(w: _Writer, pre: str, p):
    w.put(pre + ".in_proj_weight",
          np.concatenate([np.asarray(p[n]["w"]).T for n in ("q", "k", "v")]))
    w.put(pre + ".in_proj_bias",
          np.concatenate([np.asarray(p[n]["b"]) for n in ("q", "k", "v")]))
    _w_linear(w, pre + ".out_proj", p["o"])


def _w_block(w: _Writer, pre: str, p, s):
    cm = pre + ".conv_module"
    _w_ffn(w, pre + ".ffn1", p["ffn1"])
    _w_layer_norm(w, pre + ".self_attn_layer_norm", p["attn"]["ln"])
    _w_mha(w, pre + ".self_attn", p["attn"]["mha"])
    _w_layer_norm(w, cm + ".layer_norm", p["conv"]["ln"])
    w.put(cm + ".sequential.0.weight",
          np.asarray(p["conv"]["pw1"]["w"]).T[:, :, None])
    w.put(cm + ".sequential.0.bias", p["conv"]["pw1"]["b"])
    w.put(cm + ".sequential.2.weight",
          np.asarray(p["conv"]["dw"]["w"]).transpose(2, 1, 0))
    w.put(cm + ".sequential.2.bias", p["conv"]["dw"]["b"])
    w.put(cm + ".sequential.3.weight", p["conv"]["norm"]["g"])
    w.put(cm + ".sequential.3.bias", p["conv"]["norm"]["b"])
    w.put(cm + ".sequential.3.running_mean", s["conv_bn"]["mean"])
    w.put(cm + ".sequential.3.running_var", s["conv_bn"]["var"])
    w.sd[cm + ".sequential.3.num_batches_tracked"] = np.asarray(0,
                                                                np.int64)
    w.put(cm + ".sequential.5.weight",
          np.asarray(p["conv"]["pw2"]["w"]).T[:, :, None])
    w.put(cm + ".sequential.5.bias", p["conv"]["pw2"]["b"])
    _w_ffn(w, pre + ".ffn2", p["ffn2"])
    _w_layer_norm(w, pre + ".final_layer_norm", p["final_ln"])


def _tree_at(tree, i):
    """Element i of every leaf's leading axis."""
    if isinstance(tree, Mapping):
        return {k: _tree_at(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_at(v, i) for v in tree]
    return np.asarray(tree)[i]


def _pe_buffer(cfg) -> np.ndarray:
    """Reference PositionalEncoding buffer (max_len, 1, d) — same
    sinusoid as nn.sinusoidal_pe (positional_encoding.py:54-63)."""
    pos = np.arange(cfg.max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, cfg.d_model, 2, dtype=np.float32)
                 * (-np.log(10000.0) / cfg.d_model))
    pe = np.zeros((cfg.max_len, 1, cfg.d_model), np.float32)
    pe[:, 0, 0::2] = np.sin(pos * div)
    pe[:, 0, 1::2] = np.cos(pos * div)
    return pe


def _w_blocks(w: _Writer, fmt, block_p, block_s, n_blocks, npe):
    for b in range(n_blocks):
        for l in range(npe):
            flat = b * npe + l
            _w_block(w, f"{fmt.format(b)}.conformer_layers.{l}",
                     _tree_at(block_p, flat), _tree_at(block_s, flat))


def _w_decoder_layer(w: _Writer, pre: str, p):
    _w_layer_norm(w, pre + ".norm1", p["ln1"])
    _w_mha(w, pre + ".self_attn", p["self_attn"])
    _w_layer_norm(w, pre + ".norm2", p["ln2"])
    _w_mha(w, pre + ".multihead_attn", p["cross_attn"])
    _w_layer_norm(w, pre + ".norm3", p["ln3"])
    _w_linear(w, pre + ".linear1", p["w1"])
    _w_linear(w, pre + ".linear2", p["w2"])


def to_reference_state_dict(params, state, cfg) -> Dict[str, np.ndarray]:
    """(params, state) of our early_conformer / splitformer /
    early_zipformer / full_conformer -> a state_dict the reference's
    torch modules load with strict=True (includes positional-encoding
    buffers and BatchNorm bookkeeping). Exact inverse of
    from_reference_state_dict; round-trip pinned by tests."""
    w = _Writer()
    E, npe = cfg.n_enc_exits, cfg.n_enc_layers_per_exit

    if cfg.model_type == "early_zipformer":
        from early_exit_tpu_torch.models.zipformer import STACK
        _w_conv1d(w, "conv_subsample.conv", params["subsample"]["convs"][0])
        w.put("positional_encoder.pe", _pe_buffer(cfg))
        _w_linear(w, "linear", params["head"])
        blocks = [2] + list(STACK)
        off = 0
        trees = [(params["pre"], state["pre"])] + \
            list(zip(params["stages"], state["stages"]))
        for (bp, bs), n in zip(trees, blocks):
            for j in range(n):
                for l in range(npe):
                    flat = j * npe + l
                    _w_block(w, f"conformer.{off + j}.conformer_layers.{l}",
                             _tree_at(bp, flat), _tree_at(bs, flat))
            off += n
        return w.sd

    if cfg.model_type == "full_conformer":
        _w_conv1d(w, "conv_subsample.sequential.0",
                  params["subsample"]["convs"][0])
        _w_conv1d(w, "conv_subsample.sequential.1",
                  params["subsample"]["convs"][1])
        w.put("positional_encoder_1.pe", _pe_buffer(cfg))
        w.put("positional_encoder_2.pe", _pe_buffer(cfg))
        w.put("emb.weight", params["emb"]["table"])
        _w_layer_norm(w, "layer_norm", params["final_ln"])
        _w_blocks(w, "conformer.{}", params["blocks"], state["blocks"],
                  E, npe)
        for e in range(E):
            _w_linear(w, f"linears_1.{e}", _tree_at(params["heads"], e))
            _w_linear(w, f"linears_2.{e}", _tree_at(params["out_linear"],
                                                    e))
            dec_e = _tree_at(params["decoders"], e)
            for l in range(cfg.n_dec_layers):
                _w_decoder_layer(w, f"decoders.{e}.layers.{l}",
                                 _tree_at(dec_e, l))
            _w_layer_norm(w, f"decoders.{e}.norm", params["final_ln"])
        return w.sd

    if cfg.model_type not in ("early_conformer", "splitformer"):
        raise ValueError(f"no reference export for {cfg.model_type!r}")

    _w_conv1d(w, "conv_subsample.sequential.0",
              params["subsample"]["convs"][0])
    _w_conv1d(w, "conv_subsample.sequential.1",
              params["subsample"]["convs"][1])
    w.put("positional_encoder.pe", _pe_buffer(cfg))
    _w_blocks(w, "conformer.{}", params["blocks"], state["blocks"], E, npe)
    for e in range(E):
        _w_linear(w, f"linears.{e}", _tree_at(params["heads"], e))
    if cfg.model_type == "splitformer":
        for i in range(2):
            _w_block(w, f"conformer_parallel.{i}.conformer_layers.0",
                     params["parallel"][i], state["parallel"][i])
    return w.sd
