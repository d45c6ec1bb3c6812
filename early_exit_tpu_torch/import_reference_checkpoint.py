"""Convert a reference (torch) checkpoint into a checkpoint of this
repository (the counterpart of `tools/import_reference_checkpoint.py`).

A user of `augustgw/early-exit-transformer` brings their trained
`mod{epoch}-transformer` (a torch state_dict) and gets a checkpoint that
both packages' `--load_model_path` read, with the reference CLI's
architecture flags:

    python -m early_exit_tpu_torch.import_reference_checkpoint \\
        --torch_ckpt /path/to/mod016-transformer --out imported-ckpt \\
        --decoder_mode ctc --model_type early_conformer \\
        [--d_model 256 --n_enc_exits 6 ... reference flags] [--device cpu]

The state_dict is read on the host (`interop.from_reference_state_dict`),
checked leaf by leaf (structure and shapes) against the port model's own
layout (`interop.jax_tree`), then run once on the device (CUDA unless
--device cpu; with --fused_block true the block and head kernels): the
CTC models' greedy exit ids as the inference CLI takes them,
full_conformer with [bos, eos] targets. Supported: early_conformer,
splitformer, early_zipformer and (--decoder_mode aed) full_conformer.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from early_exit_tpu_torch import checkpoint, interop, runtime
from early_exit_tpu_torch.cli import get_args
from early_exit_tpu_torch.inference import exit_outputs
from early_exit_tpu_torch.models.registry import build_model


def _leaves(tree, prefix=""):
    """{path: shape} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tuple(np.shape(tree))}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}/{k}"))
    return out


def check_layout(name: str, got, want) -> None:
    """Exits naming the first leaf where got's structure or shapes leave
    want's."""
    g, w = _leaves(got), _leaves(want)
    if sorted(g) != sorted(w):
        sys.exit(f"{name}: mapped tree structure != model template\n"
                 f"  mapped:   {sorted(g)}\n  template: {sorted(w)}")
    for path in sorted(w):
        if g[path] != w[path]:
            sys.exit(f"{name}: leaf {path} shape {g[path]} != template {w[path]}")


def main(argv=None):
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--torch_ckpt", required=True)
    ap.add_argument("--out", required=True)
    tool_args, rest = ap.parse_known_args(argv)
    args, model_cfg, _, _, _ = get_args(rest, mode="infer")
    device = runtime.resolve_device(args.device)
    if device.type == "cuda":
        runtime.exact_float32()

    sd = torch.load(tool_args.torch_ckpt, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        sys.exit("--torch_ckpt must hold a state_dict (the reference "
                 "saves model.state_dict(), train.py:125)")
    sd = {k: v.numpy() for k, v in sd.items()}
    params, state = interop.from_reference_state_dict(sd, model_cfg)

    template = build_model(model_cfg)
    check_layout("params", params, interop.jax_tree(template))
    check_layout("model_state", state, interop.numpy_tree(template.state()))

    model = interop.from_jax_params(params, state, model_cfg).to(device)
    feats = torch.zeros(1, 63, model_cfg.n_mels, device=device)
    lengths = torch.tensor([63], device=device)
    with torch.no_grad():
        if model_cfg.model_type == "full_conformer":
            trg = torch.tensor([[model_cfg.bos_id, model_cfg.eos_id]], device=device)
            dec, out, _ = model.apply(feats, lengths, trg)
            print(f"forward ok: enc {tuple(out.shape)} dec {tuple(dec.shape)}")
        else:
            out, _, _ = exit_outputs(model, feats, lengths, greedy=True, timestamps=False)
            print(f"forward ok: exits x (B, T') = {tuple(out.shape)}")

    checkpoint.save_tree({"params": params, "model_state": state}, tool_args.out)
    n = sum(int(np.prod(shape)) for shape in _leaves(params).values())
    print(f"imported {len(sd)} reference tensors -> {tool_args.out} "
          f"({n:,} parameters); load with --load_model_path")


if __name__ == "__main__":
    main()
