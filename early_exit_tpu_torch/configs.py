"""Model, training and audio configuration.

Same field names and defaults as `early_exit_tpu/configs.py`
(ModelConfig, TrainConfig, AudioConfig); the dtype properties return
torch dtypes. `inference_profile` and `train_profile` are the CLI's two
performance profiles (`early_exit_tpu/cli.py` get_args).
"""

from __future__ import annotations

import dataclasses

import torch


def _dt(name: str | None) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    model_type: str = "early_conformer"
    d_model: int = 256
    n_heads: int = 8
    d_feed_forward: int = 2048
    n_enc_exits: int = 6
    n_enc_layers_per_exit: int = 2
    n_dec_layers: int = 6
    depthwise_kernel_size: int = 31
    drop_prob: float = 0.1
    max_len: int = 2000
    n_mels: int = 80

    vocab_size: int = 256
    blank_id: int = 0
    pad_id: int = 126
    bos_id: int = 1
    eos_id: int = 2

    compute_dtype: str = "bfloat16"       # matmul dtype
    conv_norm: str = "batch"              # conformer conv-module norm
    length_mode: str = "reference"        # "reference": clamp(len/4); "true": conv arithmetic
    remat: bool = False                   # training: recompute each block in backward
    attention_impl: str = "xla"           # "pallas": the CUDA attention kernel (unfused path)
    residual_dtype: str | None = None     # None = compute_dtype
    attn_softmax_dtype: str = "float32"
    fused_block: bool = False             # route inference through the block kernel
    quantize: str = "none"                # "int8": W8A8 linears in the Conformer blocks

    @property
    def dtype(self) -> torch.dtype:
        return _dt(self.compute_dtype)

    @property
    def rdtype(self) -> torch.dtype:
        return _dt(self.residual_dtype or self.compute_dtype)

    @property
    def sm_dtype(self) -> torch.dtype:
        return _dt(self.attn_softmax_dtype)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 64
    n_batch_split: int = 4
    n_epochs: int = 10000
    warmup: int = -1
    adam_eps: float = 1e-9
    weight_decay: float = 5e-4
    clip: float = 1.0
    max_utterance_length: int = 360
    decoder_mode: str = "ctc"            # ctc | aed
    aed_ce_weight: float = 0.7
    aed_ctc_weight: float = 0.3
    # feed the padded frame count as every row's CTC input length (the
    # reference's quirk); off by default
    ctc_compat_padded_lengths: bool = False
    fast_rng: bool = True                 # a TPU PRNG choice; no effect here
    # self-distillation: KL(softmax(deepest exit) || exit e), per earlier exit
    distill: bool = False
    distill_weight: float = 1.0
    distill_temperature: float = 2.0
    # dynamic-chunk training: per step, full attention (50%) or a chunked mask
    dynamic_chunk: bool = False
    chunk_left: int = 1000                # chunks of left context kept
    specaugment: bool = False
    sa_freq_masks: int = 2
    sa_freq_width: int = 27
    sa_time_masks: int = 2
    sa_time_frac: float = 0.05
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    sample_rate: int = 16000
    n_fft: int = 512          # the actual FFT size is n_fft*2 (reference quirk)
    win_length: int = 320
    hop_length: int = 160
    n_mels: int = 80
    mel_method: str = "fft"


def inference_profile(fused_block: bool = True, *, quantize: str = "none",
                      compute_dtype: str | None = None,
                      attention_impl: str = "xla") -> ModelConfig:
    """The CLI's inference profile: bf16 compute and residual stream,
    bf16 attention softmax (early_exit_tpu/cli.py get_args, mode="infer").
    compute_dtype="float32" makes everything float32, the softmax
    included."""
    cd = compute_dtype or "bfloat16"
    return ModelConfig(compute_dtype=cd, attn_softmax_dtype=cd,
                       fused_block=fused_block, quantize=quantize,
                       attention_impl=attention_impl)


def train_profile(**over) -> ModelConfig:
    """The CLI's train profile: bf16 compute and residual stream, float32
    attention softmax, dropout 0.1 (early_exit_tpu/cli.py get_args,
    mode="train"; its mel is the FFT). `over` replaces fields."""
    return dataclasses.replace(
        ModelConfig(compute_dtype="bfloat16", attn_softmax_dtype="float32"),
        **over)
