"""Model registry: ModelConfig.model_type -> the model (counterpart of
`early_exit_tpu/models/registry.py`).

The CTC models `early_conformer`, `splitformer` and `early_zipformer`
(--model_type), and `full_conformer`, which both CLIs build for
--decoder_mode aed (`cli.get_args`). An unknown name raises the JAX
package's ValueError.
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


def require_flagship(cfg: ModelConfig, what: str) -> None:
    """Raises by name unless cfg is an `early_conformer`: `what` serves
    the flagship's trunk only, and would silently drop the splitformer's
    branches or misread the zipformer's stacks."""
    if cfg.model_type != "early_conformer":
        raise NotImplementedError(
            f"{what} serves early_conformer models; --model_type "
            f"{cfg.model_type} is not served by it yet")
