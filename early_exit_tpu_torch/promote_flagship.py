"""Promote a trained reference-scale checkpoint to flagship assets (the
counterpart of `tools/promote_flagship.py`).

Writes into --out_dir:
  flagship_ckpt       -- the checkpoint with its float32 parameters cast
                         to bfloat16 (batch-norm statistics stay float32),
                         ~63 MB at reference dims
  flagship_calib.json -- the calibrated per-exit gate operating point
                         (from `python -m early_exit_tpu_torch.calibrate_gate`)
                         plus the `bench_eval` corpus knobs the gated leg
                         is evaluated on (the checkpoint's training
                         distribution), the tokenizer's path and sha256,
                         and the cascade's phase-A depth (`choose_k`)

    python -m early_exit_tpu_torch.promote_flagship --out_dir promoted \\
        --ckpt model_seed1/mod085-transformer \\
        --calib gate_calib_seed1.json \\
        --knobs '{"min_words": 18, "max_words": 22, "noise": 0.02,
                  "noise_hi": 0.55, "speaker_warp": 0.15,
                  "dur_jitter": 0.3, "amp_jitter": 0.4}'

The files are the JAX tool's, byte for byte. Unlike it, --out_dir has no
default: the repository's `assets/` hold the reference's own flagship,
which this tool must not overwrite by accident. The checkpoint is read
into a `ModelConfig()` (reference dims) model to check its layout; the
work is on the host.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os

import torch

from early_exit_tpu_torch import checkpoint
from early_exit_tpu_torch.checkpoint import REPO


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _cast(tree):
    if isinstance(tree, dict):
        return {k: _cast(v) for k, v in tree.items()}
    return tree.to(torch.bfloat16) if tree.dtype == torch.float32 else tree


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True,
                    help="trained mod{NNN}-transformer checkpoint")
    ap.add_argument("--calib", required=True,
                    help="calibrate_gate output JSON")
    ap.add_argument("--knobs", required=True,
                    help="JSON dict of SyntheticDataset knobs for the "
                         "gated eval (the checkpoint's training "
                         "distribution)")
    ap.add_argument("--tokenizer", default=None,
                    help="the BPE model the checkpoint was TRAINED with "
                         "(default: the CLIs' resolution, the committed "
                         "assets/spm model). Its path and sha256 go into "
                         "flagship_calib.json; the CLIs decode the "
                         "flagship with exactly this file and abort on a "
                         "hash mismatch")
    ap.add_argument("--out_dir", required=True,
                    help="directory for flagship_ckpt and "
                         "flagship_calib.json (required: the repository's "
                         "assets/ hold the reference's flagship and are "
                         "never a default target)")
    args = ap.parse_args(argv)

    from early_exit_tpu_torch.cli import resolve_bpe_model
    from early_exit_tpu_torch.configs import ModelConfig
    from early_exit_tpu_torch.models.registry import build_model
    from early_exit_tpu_torch.serving.cascade import choose_k
    from early_exit_tpu_torch.training.checkpoint import load_model_tree

    tree = checkpoint.load_tree(args.ckpt)
    # reference dims: the layout check raises on a checkpoint of others
    load_model_tree(build_model(ModelConfig()), tree)
    # params to bf16 (inference runs in bf16 anyway); keep model_state
    # (batch-norm statistics) fp32 -- they normalize in fp32
    os.makedirs(args.out_dir, exist_ok=True)
    out_ckpt = os.path.join(args.out_dir, "flagship_ckpt")
    checkpoint.save_tree({"params": _cast(tree["params"]),
                          "model_state": tree["model_state"]}, out_ckpt)
    print(f"wrote {out_ckpt} "
          f"({os.path.getsize(out_ckpt) / 1e6:.1f} MB)")

    with open(args.calib) as f:
        calib = json.load(f)
    knobs = json.loads(args.knobs)

    # the explicit checkpoint<->tokenizer binding: WHICH BPE model the
    # checkpoint decodes with, by path and content hash
    tok_path = os.path.abspath(args.tokenizer or resolve_bpe_model(""))
    tok_rel = os.path.relpath(tok_path, REPO)
    if tok_rel.startswith(".."):
        tok_rel = tok_path          # outside the repo: keep absolute
    # phase-A depth of the serving cascade: the fewest expected exits an
    # utterance under the dev accept shares
    per_exit = calib.get("per_score", {}).get(
        calib["score"], {}).get("per_exit", [])
    shares = [st.get("accept_share", 0.0) for st in per_exit]
    out = {
        "score": calib["score"],
        "thresholds": calib["thresholds"],
        "temperatures": calib["temperatures"],
        "tokenizer": tok_rel,
        "tokenizer_sha256": _sha256(tok_path),
        "cascade_k": (choose_k(shares, len(calib["thresholds"]))
                      if shares else 2),
        "provenance": {
            "ckpt": args.ckpt,
            "calib": args.calib,
            "calib_split": calib.get("split"),
            "dev_final_exit_wer_pct": calib.get("final_exit_wer_pct"),
            "dev_gated_wer_pct": calib.get("per_score", {}).get(
                calib["score"], {}).get("gated_wer_pct"),
            "dev_mean_exit": calib.get("per_score", {}).get(
                calib["score"], {}).get("mean_exit"),
            "target_wer_delta_pp": calib.get("target_wer_delta_pp"),
        },
        "bench_eval": knobs,
    }
    out_calib = os.path.join(args.out_dir, "flagship_calib.json")
    with open(out_calib, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {out_calib}")


if __name__ == "__main__":
    main()
