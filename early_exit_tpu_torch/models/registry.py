"""Model registry: ModelConfig.model_type -> the model (counterpart of
`early_exit_tpu/models/registry.py`).

`full_conformer` is what both CLIs build for --decoder_mode aed
(`cli.get_args`). The zoo's other models are not ported and raise by
name; an unknown name raises the JAX package's ValueError.
"""

from __future__ import annotations

from early_exit_tpu_torch.configs import ModelConfig

_MODELS = ("early_conformer", "splitformer", "early_zipformer", "full_conformer")


def build_model(cfg: ModelConfig):
    """A model of cfg.model_type with zero weights, on the CPU (call
    `.to(device)` and `.init(generator)` or load a checkpoint)."""
    name = cfg.model_type
    if name not in _MODELS:
        raise ValueError(f"unknown model_type: {name} (choices: {sorted(_MODELS)})")
    if name == "early_conformer":
        from early_exit_tpu_torch.models.early_conformer import EarlyConformer
        return EarlyConformer(cfg)
    if name == "full_conformer":
        from early_exit_tpu_torch.models.full_conformer import FullConformer
        return FullConformer(cfg)
    raise NotImplementedError(
        f"--model_type {name}: not ported; the port builds early_conformer "
        "(--decoder_mode ctc) and full_conformer (--decoder_mode aed)")
