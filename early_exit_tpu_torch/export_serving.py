"""Export a trained recognizer as a self-contained serving bundle (the
counterpart of `tools/export_serving.py`).

    python -m early_exit_tpu_torch.export_serving --decoder_mode ctc \\
        --load_model_path ckpt/mod042-transformer \\
        --export_path model.eetx \\
        --export_shapes 8x160000,32x160000 \\
        --export_platforms cuda

The bundle (`serving/export.py`) holds each program captured by
`torch.export`, with the weights as its constants, and for "cuda" its
AOTInductor package, plus the vocab table; a consumer runs it with no
model code:

    from early_exit_tpu_torch.serving.export import ExportedRecognizer
    rec = ExportedRecognizer("model.eetx")          # CUDA; device="cpu"
    tokens, n_tok, conf = rec(wav, n_samples)       # for a "cpu" bundle
    text = rec.detokenize(tokens[-1][0][:n_tok[-1][0]])

The model flags are the inference CLI's (`python -m
early_exit_tpu_torch.inference`); the weights come from
--load_model_path or the average of --load_model_dir's epochs
--avg_model_start..--avg_model_end. Exporting for "cuda" needs a GPU.
Any CTC --model_type exports its all-exit program (early_zipformer: one
exit) and, with --export_symbolic_max, its shape-polymorphic program
over hop * 10 samples (the JAX package's bound, `min_samples` in the
manifest) up to that maximum, for "cpu" and "cuda";
--export_gated true takes early_conformer and splitformer, and
--export_cascade_k early_conformer only: other models raise the JAX
package's ValueError before the model is loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from early_exit_tpu_torch import runtime
from early_exit_tpu_torch.cli import get_args
from early_exit_tpu_torch.inference import load_model
from early_exit_tpu_torch.models import registry
from early_exit_tpu_torch.serving import export as exp


def _parse_shapes(spec: str):
    shapes = []
    for part in spec.split(","):
        b, s = part.lower().split("x")
        shapes.append((int(b), int(s)))
    return shapes


def main(argv=None):
    own = argparse.ArgumentParser(add_help=False)
    own.add_argument("--export_path", required=True)
    own.add_argument("--export_shapes", default="8x160000",
                     help="comma-separated BxS padded (batch, samples) "
                          "buckets, e.g. 8x160000,32x160000")
    own.add_argument("--export_platforms", default="cuda",
                     help="comma-separated targets (cuda, cpu); cuda also "
                          "compiles each program with AOTInductor")
    own.add_argument("--export_symbolic_max", type=int, default=None,
                     help="also export ONE shape-polymorphic program valid up "
                          "to this many samples, for any --model_type "
                          "(early_conformer, splitformer, early_zipformer); "
                          "its lower bound is hop * 10 samples, as the JAX "
                          "package's")
    own.add_argument("--export_gated", default="false",
                     help="true: also export confidence-gated variants (exit "
                          "by exit, threshold a runtime scalar) -- "
                          "rec.gated(wav, n, threshold)")
    own.add_argument("--export_cascade_k", type=int, default=None,
                     help="also export the two-phase cascade programs "
                          "(serving/cascade.py) at this phase-A depth -- "
                          "rec.cascade(wav, n, thresholds). Per-exit "
                          "thresholds stay runtime; --gate_calibration (if "
                          "given) bakes its temperatures in")
    mine, rest = own.parse_known_args(argv)

    args, model_cfg, _, audio_cfg, tokenizer = get_args(rest, mode="infer")
    if args.decoder_mode != "ctc":
        sys.exit("export: the AOT serving program is the CTC greedy "
                 "path; AED beam search is a host-driven loop")
    if args.load_model_path is None and None in (
            args.load_model_dir, args.avg_model_start, args.avg_model_end):
        sys.exit("export: need --load_model_path or --load_model_dir "
                 "with --avg_model_start/--avg_model_end")
    gated = mine.export_gated.lower() in ("true", "1", "yes")
    if gated:
        registry.require_gated(model_cfg)
    if mine.export_cascade_k is not None:
        registry.require_cascade(model_cfg)
    platforms = mine.export_platforms.split(",")
    model = load_model(args, model_cfg,
                       runtime.resolve_device("cuda" if "cuda" in platforms else "cpu"))
    shapes = _parse_shapes(mine.export_shapes) if mine.export_shapes else []
    gate = args.gate_score
    temps = None
    if args.gate_calibration is not None:
        with open(args.gate_calibration) as f:
            calib = json.load(f)
        gate = calib.get("score", gate)
        temps = calib.get("temperatures")
    bundle = exp.export_recognizer(
        model, audio_cfg, shapes, platforms=platforms, gate_score=gate,
        symbolic_max_samples=mine.export_symbolic_max,
        gated=gated,
        cascade_k=mine.export_cascade_k, gate_temperatures=temps,
        tokenizer=tokenizer)
    exp.save_bundle(mine.export_path, bundle)
    size = os.path.getsize(mine.export_path)
    n_prog = len(next(iter(bundle.programs.values())))
    print(f"exported {n_prog} program(s) x {platforms} "
          f"-> {mine.export_path} ({size / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
