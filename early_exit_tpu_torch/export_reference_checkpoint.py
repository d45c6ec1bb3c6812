"""Convert a checkpoint of this repository into the reference's torch
format (the counterpart of `tools/export_reference_checkpoint.py`).

The inverse of `python -m early_exit_tpu_torch.import_reference_checkpoint`:
a checkpoint (--ckpt, or the average of --load_model_dir's epochs
--avg_model_start..--avg_model_end) becomes a state_dict of CPU float32
tensors that the reference's model loads with strict=True, its
positional-encoding buffers and BatchNorm bookkeeping included:

    python -m early_exit_tpu_torch.export_reference_checkpoint \\
        --ckpt trained_model/mod016-transformer --out mod016-torch \\
        --decoder_mode ctc --model_type early_conformer [arch flags] [--device cpu]
    # then, in the reference repo:
    #   model.load_state_dict(torch.load("mod016-torch"))

The model is loaded on the device (CUDA unless --device cpu), as the
inference CLI loads it. Supports early_conformer, splitformer,
early_zipformer and (--decoder_mode aed) full_conformer.
"""

from __future__ import annotations

import argparse

import torch

from early_exit_tpu_torch import interop, runtime
from early_exit_tpu_torch.cli import get_args
from early_exit_tpu_torch.inference import load_model


def main(argv=None):
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--ckpt", default=None,
                    help="a checkpoint (e.g. modNNN-transformer); without it, the "
                         "average that --load_model_dir/--avg_model_start/"
                         "--avg_model_end name")
    ap.add_argument("--out", required=True)
    tool_args, rest = ap.parse_known_args(argv)
    args, model_cfg, _, _, _ = get_args(rest, mode="infer")
    if tool_args.ckpt is not None:
        args.load_model_path = tool_args.ckpt
    model = load_model(args, model_cfg, runtime.resolve_device(args.device))
    params, state = interop.to_jax_params(model)
    sd = interop.to_reference_state_dict(params, state, model_cfg)
    torch.save({k: torch.from_numpy(v.copy()) for k, v in sd.items()}, tool_args.out)
    print(f"exported {len(sd)} tensors -> {tool_args.out} (torch state_dict, "
          f"strict-loadable by the reference {model_cfg.model_type})")


if __name__ == "__main__":
    main()
