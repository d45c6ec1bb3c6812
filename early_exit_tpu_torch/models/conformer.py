"""Conformer encoder blocks (counterpart of `early_exit_tpu/models/conformer.py`).

Inference only. Block structure (torchaudio ConformerLayer semantics,
convolution_first=False):

    x = x + 0.5 * FFN(LN(x))            # macaron half-FFN (SiLU)
    x = x + MHSA(LN(x), key_mask)
    x = x + ConvModule(x)               # LN -> PW(2d)+GLU -> DW(k) -> BN -> SiLU -> PW
    x = x + 0.5 * FFN(LN(x))
    x = LN(x), padded rows zeroed

`ConformerBlock.forward` is the unfused path (the JAX package's XLA
path, two-pass LayerNorm); with `attention_impl="pallas"` its
self-attention runs the CUDA attention kernel
(`ops/kernels/attention.py`), and with `quantize="int8"` its linears are
W8A8. `ConformerStack.forward` routes inference
through the block kernel (`ops/kernels/conformer_block.py`) when
`fused_block` is set. On the CPU, where the kernel's plain version runs,
it mirrors the JAX dispatch: the kernel up to T' = 512 (the TPU kernel's
VMEM budget), the unfused blocks beyond. On the GPU it always launches
the kernel, which raises past its own limit rather than leave the path.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch import nn

from early_exit_tpu_torch.configs import _dt
from early_exit_tpu_torch.nn import core
from early_exit_tpu_torch.ops.kernels import attention as katt
from early_exit_tpu_torch.ops.kernels import conformer_block as kcb

FUSED_MAX_T = 512


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    d_model: int
    n_heads: int
    d_ff: int
    kernel_size: int
    compute_dtype: str = "float32"
    residual_dtype: str = "float32"
    attn_softmax_dtype: str = "float32"
    fused_block: bool = False
    # "pallas" keeps the JAX package's value, so that its configurations
    # carry across unchanged: here it selects the CUDA attention kernel
    attention_impl: str = "xla"
    quantize: str = "none"          # "int8": W8A8 linears

    def __post_init__(self):
        if self.attention_impl not in ("xla", "pallas"):
            raise ValueError(f"attention_impl must be 'xla' or 'pallas': "
                             f"{self.attention_impl!r}")
        if self.quantize not in ("none", "int8"):
            raise ValueError(f"quantize must be 'none' or 'int8': "
                             f"{self.quantize!r}")

    @property
    def dtype(self) -> torch.dtype:
        return _dt(self.compute_dtype)

    @property
    def quant(self) -> Optional[str]:
        return None if self.quantize == "none" else self.quantize

    @property
    def rdtype(self) -> torch.dtype:
        return _dt(self.residual_dtype)

    @property
    def sm_dtype(self) -> torch.dtype:
        return _dt(self.attn_softmax_dtype)


def _weight(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape), requires_grad=False)


class FeedForward(nn.Module):
    def __init__(self, d: int, d_ff: int):
        super().__init__()
        self.ln_g, self.ln_b = _weight(d), _weight(d)
        self.w1, self.b1 = _weight(d, d_ff), _weight(d_ff)
        self.w2, self.b2 = _weight(d_ff, d), _weight(d)

    def forward(self, x, cfg: ConformerConfig):
        y = core.layer_norm(x, self.ln_g, self.ln_b)
        lin = dict(compute_dtype=cfg.dtype, quantize=cfg.quant)
        y = core.linear(y, self.w1, self.b1, **lin)
        y = torch.nn.functional.silu(y)
        return core.linear(y, self.w2, self.b2, **lin)


class SelfAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.ln_g, self.ln_b = _weight(d), _weight(d)
        for n in ("q", "k", "v", "o"):
            setattr(self, "w" + n, _weight(d, d))
            setattr(self, "b" + n, _weight(d))

    def forward(self, x, mask, cfg: ConformerConfig):
        y = core.layer_norm(x, self.ln_g, self.ln_b)
        p = {n: (getattr(self, "w" + n), getattr(self, "b" + n))
             for n in ("q", "k", "v", "o")}
        if cfg.attention_impl == "pallas":
            # float32 softmax and unquantized projections whatever the
            # configuration says, as the JAX package's kernel path
            return katt.mha_fused(p, y, cfg.n_heads, key_mask=mask,
                                  compute_dtype=cfg.dtype)
        return core.mha(p, y, y, cfg.n_heads, key_mask=mask,
                        compute_dtype=cfg.dtype, softmax_dtype=cfg.sm_dtype,
                        quantize=cfg.quant)


class ConvModule(nn.Module):
    def __init__(self, d: int, k: int):
        super().__init__()
        self.ln_g, self.ln_b = _weight(d), _weight(d)
        self.pw1_w, self.pw1_b = _weight(d, 2 * d), _weight(2 * d)
        self.dw_w, self.dw_b = _weight(k, 1, d), _weight(d)
        self.bn_g, self.bn_b = _weight(d), _weight(d)
        self.register_buffer("bn_mean", torch.zeros(d))
        self.register_buffer("bn_var", torch.ones(d))
        self.pw2_w, self.pw2_b = _weight(d, d), _weight(d)

    def forward(self, x, mask, cfg: ConformerConfig):
        y = core.layer_norm(x, self.ln_g, self.ln_b)
        lin = dict(compute_dtype=cfg.dtype, quantize=cfg.quant)
        y = core.linear(y, self.pw1_w, self.pw1_b, **lin)
        a, b = y.chunk(2, dim=-1)
        y = a * torch.sigmoid(b)                                  # GLU
        if mask is not None:
            y = torch.where(mask[..., None], y, torch.zeros((), dtype=y.dtype,
                                                            device=y.device))
        y = core.depthwise_conv1d(y, self.dw_w, self.dw_b,
                                  compute_dtype=cfg.dtype)
        y = core.masked_batch_norm(y, self.bn_g, self.bn_b,
                                   self.bn_mean, self.bn_var)
        y = torch.nn.functional.silu(y)
        return core.linear(y, self.pw2_w, self.pw2_b, **lin)


class ConformerBlock(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.ffn1 = FeedForward(d, cfg.d_ff)
        self.attn = SelfAttention(d)
        self.conv = ConvModule(d, cfg.kernel_size)
        self.ffn2 = FeedForward(d, cfg.d_ff)
        self.final_ln_g, self.final_ln_b = _weight(d), _weight(d)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        """Unfused block on (B, T, D); mask (B, T) bool validity."""
        cfg, rd = self.cfg, self.cfg.rdtype
        x = x.to(rd)
        x = x + 0.5 * self.ffn1(x, cfg).to(rd)
        x = x + self.attn(x, mask, cfg).to(rd)
        x = x + self.conv(x, mask, cfg).to(rd)
        x = x + 0.5 * self.ffn2(x, cfg).to(rd)
        x = core.layer_norm(x, self.final_ln_g, self.final_ln_b).to(rd)
        if mask is not None:
            x = torch.where(mask[..., None], x, torch.zeros((), dtype=rd,
                                                            device=x.device))
        return x


class ConformerStack(nn.Module):
    def __init__(self, cfg: ConformerConfig, n_layers: int):
        super().__init__()
        self.cfg = cfg
        self.blocks = nn.ModuleList(ConformerBlock(cfg)
                                    for _ in range(n_layers))
        self._folded: List[dict] = []
        self._folded_key = None

    def clear_folded(self) -> None:
        self._folded, self._folded_key = [], None

    def folded(self) -> List[dict]:
        """Per-block kernel layout (`fold_block_params`), built once per
        (device, quantize, compute dtype); inference weights do not
        change."""
        key = (self.blocks[0].final_ln_g.device, self.cfg.quantize,
               self.cfg.dtype)
        if self._folded_key != key:
            self._folded = [kcb.fold_block_params(b.state_dict(),
                                                  compute_dtype=self.cfg.dtype,
                                                  quantize=self.cfg.quant)
                            for b in self.blocks]
            self._folded_key = key
        return self._folded

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor], *,
                collect_outputs: bool = False, collect_every: int = 1,
                n_layers: Optional[int] = None, first_layer: int = 0):
        """Runs blocks first_layer .. n_layers-1 (default all). Returns y,
        or (y, outs) with collect_outputs: outs (L/k, B, T, D) holds every
        k-th output of the L layers run (their layers k-1, 2k-1, ...)."""
        last = len(self.blocks) if n_layers is None else n_layers
        if not 0 <= first_layer <= last <= len(self.blocks):
            raise ValueError(f"layers {first_layer}..{last} of "
                             f"{len(self.blocks)}")
        L = last - first_layer
        k = collect_every if collect_outputs else 1
        if L % k:
            raise ValueError(f"{L} layers are not a multiple of {k}")
        outs = None
        if collect_outputs:
            outs = torch.empty((L // k,) + tuple(x.shape), dtype=self.cfg.rdtype,
                               device=x.device)
        if self.cfg.fused_block and (x.device.type != "cpu"
                                     or x.shape[1] <= FUSED_MAX_T):
            if mask is not None:
                lengths = mask.sum(dim=1, dtype=torch.int32)
            else:
                lengths = torch.full((x.shape[0],), x.shape[1],
                                     dtype=torch.int32, device=x.device)
            h = x.to(self.cfg.rdtype).contiguous()
            for i, f in enumerate(self.folded()[first_layer:last]):
                dest = outs[i // k] if outs is not None and (i + 1) % k == 0 else None
                h = kcb.conformer_block(
                    f, h, lengths, n_heads=self.cfg.n_heads,
                    kernel_size=self.cfg.kernel_size,
                    compute_dtype=self.cfg.dtype,
                    residual_dtype=self.cfg.rdtype,
                    attn_softmax_dtype=self.cfg.sm_dtype,
                    quantize=self.cfg.quant, out=dest)
        else:
            h = x
            for i, block in enumerate(self.blocks[first_layer:last]):
                h = block(h, mask)
                if outs is not None and (i + 1) % k == 0:
                    outs[i // k] = h
        return (h, outs) if collect_outputs else h
