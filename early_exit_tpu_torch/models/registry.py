"""Model registry: ModelConfig.model_type -> the model (counterpart of
`early_exit_tpu/models/registry.py`).

The CTC models `early_conformer`, `splitformer` and `early_zipformer`
(--model_type), and `full_conformer`, which both CLIs build for
--decoder_mode aed (`cli.get_args`). An unknown name raises the JAX
package's ValueError; so do the serving modes a model cannot take (the
gate, the cascade, streaming), each with the JAX package's text.
"""

from __future__ import annotations

import importlib

from early_exit_tpu_torch.configs import ModelConfig

# name -> (module, class)
_MODELS = {
    "early_conformer": ("early_exit_tpu_torch.models.early_conformer", "EarlyConformer"),
    "splitformer": ("early_exit_tpu_torch.models.splitformer", "Splitformer"),
    "early_zipformer": ("early_exit_tpu_torch.models.zipformer", "EarlyZipformer"),
    "full_conformer": ("early_exit_tpu_torch.models.full_conformer", "FullConformer"),
}


def build_model(cfg: ModelConfig):
    """A model of cfg.model_type with zero weights, on the CPU (call
    `.to(device)` and `.init(generator)` or load a checkpoint)."""
    name = cfg.model_type
    if name not in _MODELS:
        raise ValueError(f"unknown model_type: {name} (choices: {sorted(_MODELS)})")
    module, cls = _MODELS[name]
    return getattr(importlib.import_module(module), cls)(cfg)


def require_gated(cfg: ModelConfig) -> None:
    """The gate runs the models of `GATED_MODEL_TYPES`; others raise the
    JAX package's ValueError (`gated_apply`)."""
    from early_exit_tpu_torch.models.early_exit_gate import GATED_MODEL_TYPES
    if cfg.model_type not in GATED_MODEL_TYPES:
        raise ValueError(
            f"gated_apply supports {GATED_MODEL_TYPES}; "
            f"{cfg.model_type!r} has a single output exit — nothing to "
            "gate (reference README.md:61)")


def require_cascade(cfg: ModelConfig) -> None:
    """The two-phase cascade resumes the flagship's trunk at layer k; other
    models raise the JAX package's ValueError (`serving/cascade.py`)."""
    if cfg.model_type != "early_conformer":
        raise ValueError(
            "cascade serving supports early_conformer (the flagship); "
            f"got {cfg.model_type!r} — splitformer's exit-1/exit-E "
            "parallel branches make the layer-k hidden non-resumable, "
            "use gated_apply for it")


def require_streaming(cfg: ModelConfig) -> None:
    """The chunked-window recognizer runs the early_conformer trunk; other
    models raise with the JAX CLI's message for --streaming."""
    if cfg.model_type != "early_conformer":
        raise ValueError(
            "--streaming: the chunked-window recognizer runs the "
            "early_conformer trunk (serving/streaming.py); "
            f"{cfg.model_type} checkpoints are batch-only")
