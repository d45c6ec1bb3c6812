"""Conformer encoder blocks (counterpart of `early_exit_tpu/models/conformer.py`).

Block structure (torchaudio ConformerLayer semantics,
convolution_first=False):

    x = x + 0.5 * FFN(LN(x))            # macaron half-FFN (SiLU)
    x = x + Drop(MHSA(LN(x), key_mask))
    x = x + ConvModule(x)               # LN -> PW(2d)+GLU -> DW(k) -> BN -> SiLU -> PW -> Drop
    x = x + 0.5 * FFN(LN(x))
    x = LN(x), padded rows zeroed

Training (`ConformerStack.train_forward`) runs the unfused blocks with
autograd, unquantized, with dropout at the JAX package's places (two in
each half-FFN, after SiLU and after W2; after the attention's Wo; after
PW2), masked BatchNorm on the batch's statistics (or, with
conv_norm="group", the masked GroupNorm(1) of each utterance, the same in
training and inference), and an optional (T, T) attention pair mask. A
block's dropout masks come from a generator on the activations' device
seeded with the block's own seed, so a block recomputed in backward
(`remat`, torch.utils.checkpoint) draws the same masks; BatchNorm's new
running statistics are returned, never written inside the block, so a
recomputation cannot apply them twice. No kernel runs in training.

`ConformerBlock.forward` is the unfused path (the JAX package's XLA
path, two-pass LayerNorm), for inference and, with `train=True`, for
training; with `attention_impl="pallas"` its
self-attention runs the CUDA attention kernel
(`ops/kernels/attention.py`), and with `quantize="int8"` its linears are
W8A8. `ConformerStack.forward` routes inference
through the block kernel (`ops/kernels/conformer_block.py`) when
`fused_block` is set. On the CPU, where the kernel's plain version runs,
it mirrors the JAX dispatch: the kernel up to T' = 512 (the TPU kernel's
VMEM budget), the unfused blocks beyond. On the GPU it always launches
the kernel, at any T'. The kernel layout is folded from the weights
when they change (`ConformerStack.folded`); an exported program pins
its own copy, held as buffers (`pin_folded`). A group-norm block
never takes the kernel: the kernel folds BatchNorm running statistics,
so a group-norm configuration with `fused_block` or W8A8 raises
(`GROUP_NORM_FUSED`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from early_exit_tpu_torch.configs import _dt
from early_exit_tpu_torch.nn import core
from early_exit_tpu_torch.ops.kernels import attention as katt
from early_exit_tpu_torch.ops.kernels import conformer_block as kcb
from early_exit_tpu_torch.parallel import collectives

FUSED_MAX_T = 512
# why a group-norm model never runs the block kernel (fused_block, and so
# quantize="int8", which only the kernel serves)
GROUP_NORM_FUSED = (
    "conv_norm='group' cannot run the fused block (fused_block=True or "
    "quantize='int8'): the block kernel folds the BatchNorm running statistics "
    "into a scale and shift and cannot compute a GroupNorm; serve a group-norm "
    "model with --fused_block false")


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    d_model: int
    n_heads: int
    d_ff: int
    kernel_size: int
    dropout: float = 0.1
    compute_dtype: str = "float32"
    residual_dtype: str = "float32"
    attn_softmax_dtype: str = "float32"
    fused_block: bool = False
    # "pallas" keeps the JAX package's value, so that its configurations
    # carry across unchanged: here it selects the CUDA attention kernel
    attention_impl: str = "xla"
    quantize: str = "none"          # "int8": W8A8 linears (inference)
    remat: bool = False             # training: recompute each block in backward
    conv_norm: str = "batch"        # the conv module's norm: "batch" | "group"

    def __post_init__(self):
        if self.attention_impl not in ("xla", "pallas"):
            raise ValueError(f"attention_impl must be 'xla' or 'pallas': "
                             f"{self.attention_impl!r}")
        if self.quantize not in ("none", "int8"):
            raise ValueError(f"quantize must be 'none' or 'int8': "
                             f"{self.quantize!r}")
        if self.conv_norm not in ("batch", "group"):
            raise ValueError(f"conv_norm must be 'batch' or 'group': "
                             f"{self.conv_norm!r}")
        if self.conv_norm == "group" and (self.fused_block or self.quantize != "none"):
            raise ValueError(GROUP_NORM_FUSED)

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
    return nn.Parameter(torch.zeros(*shape))


def _block_generator(seed: Optional[int], rate: float,
                     device: torch.device) -> Optional[torch.Generator]:
    """The generator of one block's dropout masks in one step (None: no
    dropout)."""
    if seed is None or rate <= 0.0:
        return None
    return torch.Generator(device=device).manual_seed(seed)


class FeedForward(nn.Module):
    """The half-FFN. Under a mesh with tp > 1 (`parallel.shard_params`) it
    holds its column shard of w1 / b1 and its row shard of w2: its input
    enters the model group (`copy_to_model`), the partial products of w2
    are summed over it (`reduce_from_model`), then b2 is added once. The
    first dropout mask is drawn at the full d_ff width and cut to the
    shard's columns, so the generator stays where every peer's is and the
    second mask, on the replicated output, is the peers' too."""

    mesh = None

    def __init__(self, d: int, d_ff: int):
        super().__init__()
        self.ln_g, self.ln_b = _weight(d), _weight(d)
        self.w1, self.b1 = _weight(d, d_ff), _weight(d_ff)
        self.w2, self.b2 = _weight(d_ff, d), _weight(d)

    def init(self, gen: torch.Generator) -> None:
        core.norm_init_(self.ln_g, self.ln_b)
        core.linear_init_(self.w1, self.b1, gen)
        core.linear_init_(self.w2, self.b2, gen)

    def forward(self, x, cfg: ConformerConfig, *, quant: Optional[str] = None,
                gen: Optional[torch.Generator] = None):
        y = core.layer_norm(x, self.ln_g, self.ln_b)
        lin = dict(compute_dtype=cfg.dtype, quantize=quant)
        mesh = self.mesh
        if mesh is None or mesh.tp == 1:
            y = core.linear(y, self.w1, self.b1, **lin)
            y = torch.nn.functional.silu(y)
            y = core.dropout(y, cfg.dropout, gen)
            y = core.linear(y, self.w2, self.b2, **lin)
            return core.dropout(y, cfg.dropout, gen)
        shard = self.w1.tp_shard
        y = core.linear(collectives.copy_to_model(y, mesh), self.w1, self.b1, **lin)
        y = torch.nn.functional.silu(y)
        y = core.dropout(y, cfg.dropout, gen, columns=(shard.offset, shard.full))
        y = collectives.reduce_from_model(core.linear(y, self.w2, None, **lin), mesh)
        return core.dropout(y + self.b2.to(y.dtype), cfg.dropout, gen)


class SelfAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.ln_g, self.ln_b = _weight(d), _weight(d)
        for n in ("q", "k", "v", "o"):
            setattr(self, "w" + n, _weight(d, d))
            setattr(self, "b" + n, _weight(d))

    def init(self, gen: torch.Generator) -> None:
        core.norm_init_(self.ln_g, self.ln_b)
        for n in ("q", "k", "v", "o"):
            core.linear_init_(getattr(self, "w" + n), getattr(self, "b" + n), gen)

    def forward(self, x, mask, cfg: ConformerConfig, *,
                quant: Optional[str] = None, train: bool = False,
                attn_mask: Optional[torch.Tensor] = None):
        y = core.layer_norm(x, self.ln_g, self.ln_b)
        p = {n: (getattr(self, "w" + n), getattr(self, "b" + n))
             for n in ("q", "k", "v", "o")}
        if cfg.attention_impl == "pallas" and attn_mask is None:
            if train:
                raise NotImplementedError(
                    "attention_impl='pallas' cannot train: the attention kernel "
                    "has no backward, and the JAX package cannot differentiate "
                    "its Pallas kernel either")
            # float32 softmax and unquantized projections whatever the
            # configuration says, as the JAX package's kernel path
            return katt.mha_fused(p, y, cfg.n_heads, key_mask=mask,
                                  compute_dtype=cfg.dtype)
        return core.mha(p, y, y, cfg.n_heads, key_mask=mask, pair_mask=attn_mask,
                        compute_dtype=cfg.dtype, softmax_dtype=cfg.sm_dtype,
                        quantize=quant)


class ConvModule(nn.Module):
    mesh = None             # training under a mesh: the global batch's BatchNorm

    def __init__(self, d: int, k: int):
        super().__init__()
        self.ln_g, self.ln_b = _weight(d), _weight(d)
        self.pw1_w, self.pw1_b = _weight(d, 2 * d), _weight(2 * d)
        self.dw_w, self.dw_b = _weight(k, 1, d), _weight(d)
        self.bn_g, self.bn_b = _weight(d), _weight(d)
        self.register_buffer("bn_mean", torch.zeros(d))
        self.register_buffer("bn_var", torch.ones(d))
        self.pw2_w, self.pw2_b = _weight(d, d), _weight(d)

    def init(self, gen: torch.Generator) -> None:
        core.norm_init_(self.ln_g, self.ln_b)
        core.linear_init_(self.pw1_w, self.pw1_b, gen)
        core.depthwise_conv1d_init_(self.dw_w, self.dw_b, gen)
        core.norm_init_(self.bn_g, self.bn_b)
        core.linear_init_(self.pw2_w, self.pw2_b, gen)
        with torch.no_grad():
            self.bn_mean.zero_()
            self.bn_var.fill_(1.0)

    def forward(self, x, mask, cfg: ConformerConfig, *,
                quant: Optional[str] = None, train: bool = False,
                gen: Optional[torch.Generator] = None):
        """Returns y, and with train the BatchNorm's new running (mean, var)."""
        y = core.layer_norm(x, self.ln_g, self.ln_b)
        lin = dict(compute_dtype=cfg.dtype, quantize=quant)
        y = core.linear(y, self.pw1_w, self.pw1_b, **lin)
        a, b = y.chunk(2, dim=-1)
        y = a * torch.sigmoid(b)                                  # GLU
        if mask is not None:
            y = torch.where(mask[..., None], y, torch.zeros((), dtype=y.dtype,
                                                            device=y.device))
        y = core.depthwise_conv1d(y, self.dw_w, self.dw_b,
                                  compute_dtype=cfg.dtype)
        if cfg.conv_norm == "group":
            # per utterance, the same in eval and in train; the BatchNorm's
            # running statistics pass through unchanged, as in the JAX package
            y = core.masked_group_norm(y, self.bn_g, self.bn_b, mask)
            new_mean, new_var = self.bn_mean, self.bn_var
        elif train:
            y, new_mean, new_var = core.masked_batch_norm_train(
                y, self.bn_g, self.bn_b, self.bn_mean, self.bn_var, mask,
                mesh=self.mesh)
        else:
            y = core.masked_batch_norm(y, self.bn_g, self.bn_b,
                                       self.bn_mean, self.bn_var)
        y = torch.nn.functional.silu(y)
        y = core.linear(y, self.pw2_w, self.pw2_b, **lin)
        if not train:
            return y
        return core.dropout(y, cfg.dropout, gen), new_mean, new_var


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

    def init(self, gen: torch.Generator) -> None:
        for m in (self.ffn1, self.attn, self.conv, self.ffn2):
            m.init(gen)
        core.norm_init_(self.final_ln_g, self.final_ln_b)

    def _finish(self, x, mask):
        rd = self.cfg.rdtype
        x = core.layer_norm(x, self.final_ln_g, self.final_ln_b).to(rd)
        if mask is not None:
            x = torch.where(mask[..., None], x, torch.zeros((), dtype=rd,
                                                            device=x.device))
        return x

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor], *,
                train: bool = False, seed: Optional[int] = None,
                attn_mask: Optional[torch.Tensor] = None):
        """Unfused block on (B, T, D); mask (B, T) bool validity; attn_mask
        (T, T) bool, True where q may attend to k. Returns y. With train:
        unquantized, dropout masks drawn from a generator seeded with
        `seed` (none without one), BatchNorm on the batch, and returns
        (y, new BN mean, new BN var)."""
        cfg, rd = self.cfg, self.cfg.rdtype
        q = None if train else cfg.quant
        gen = _block_generator(seed, cfg.dropout, x.device) if train else None
        x = x.to(rd)
        x = x + 0.5 * self.ffn1(x, cfg, quant=q, gen=gen).to(rd)
        y = self.attn(x, mask, cfg, quant=q, train=train, attn_mask=attn_mask)
        x = x + core.dropout(y, cfg.dropout, gen).to(rd)
        if train:
            y, new_mean, new_var = self.conv(x, mask, cfg, train=True, gen=gen)
        else:
            y = self.conv(x, mask, cfg, quant=q)
        x = x + y.to(rd)
        x = x + 0.5 * self.ffn2(x, cfg, quant=q, gen=gen).to(rd)
        y = self._finish(x, mask)
        return (y, new_mean, new_var) if train else y


class ConformerStack(nn.Module):
    def __init__(self, cfg: ConformerConfig, n_layers: int):
        super().__init__()
        self.cfg = cfg
        self.blocks = nn.ModuleList(ConformerBlock(cfg)
                                    for _ in range(n_layers))
        self._folded: List[dict] = []
        self._folded_key = None
        self._slots: List[tuple] = []
        self._pinned: Optional[List[dict]] = None

    def init(self, gen: torch.Generator) -> None:
        for b in self.blocks:
            b.init(gen)

    def clear_folded(self) -> None:
        self._folded, self._folded_key = [], None

    def folded(self) -> List[dict]:
        """Per-block kernel layout (`fold_block_params`), rebuilt whenever
        the device, quantize, compute dtype or any weight or running
        statistic changed: every in-place write (an optimizer step, a
        load) moves a tensor's version counter. A pinned layout is
        returned as it is."""
        if self._pinned is not None:
            return self._pinned
        if self.cfg.conv_norm != "batch":
            raise ValueError(GROUP_NORM_FUSED)
        if not self._slots:         # (dict, name) of every parameter and buffer
            self._slots = [(d, n) for m in self.modules()
                           for d in (m._parameters, m._buffers) for n in d]
        d0, n0 = self._slots[0]
        key = (d0[n0].device, self.cfg.quantize, self.cfg.dtype,
               tuple(d[n]._version for d, n in self._slots))
        if self._folded_key != key:
            self._folded = [kcb.fold_block_params(b.state_dict(),
                                                  compute_dtype=self.cfg.dtype,
                                                  quantize=self.cfg.quant)
                            for b in self.blocks]
            self._folded_key = key
        return self._folded

    def pin_folded(self, layers: Optional[List[dict]]) -> None:
        """Run the block kernel on `layers` (one layout per block, from
        `folded()` or an exported program's buffers of it) instead of
        folding; None unpins."""
        if layers is not None and len(layers) != len(self.blocks):
            raise ValueError(f"{len(layers)} layouts for {len(self.blocks)} blocks")
        self._pinned = layers

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor], *,
                collect_outputs: bool = False, collect_every: int = 1,
                n_layers: Optional[int] = None, first_layer: int = 0,
                attn_mask: Optional[torch.Tensor] = None,
                prefix_mask: bool = True):
        """Inference over blocks first_layer .. n_layers-1 (default all).
        Returns y, or (y, outs) with collect_outputs: outs (L/k, B, T, D)
        holds every k-th output of the L layers run (their layers k-1,
        2k-1, ...). An attn_mask takes the unfused path, and so does a
        mask that is not a prefix of each row (prefix_mask=False: a
        streaming window, whose frames before the stream start are
        invalid), since the block kernel takes lengths."""
        last = len(self.blocks) if n_layers is None else n_layers
        if not 0 <= first_layer <= last <= len(self.blocks):
            raise ValueError(f"layers {first_layer}..{last} of "
                             f"{len(self.blocks)}")
        L = last - first_layer
        k = collect_every if collect_outputs else 1
        if L % k:
            raise ValueError(f"{L} layers are not a multiple of {k}")
        outs = []          # every k-th output, stacked once at the end
        if (self.cfg.fused_block and attn_mask is None and prefix_mask
                and (x.device.type != "cpu" or x.shape[1] <= FUSED_MAX_T)):
            if mask is not None:
                lengths = mask.sum(dim=1, dtype=torch.int32)
            else:
                lengths = torch.full((x.shape[0],), x.shape[1],
                                     dtype=torch.int32, device=x.device)
            h = x.to(self.cfg.rdtype).contiguous()
            for i, f in enumerate(self.folded()[first_layer:last]):
                h = kcb.conformer_block(
                    f, h, lengths, n_heads=self.cfg.n_heads,
                    kernel_size=self.cfg.kernel_size,
                    compute_dtype=self.cfg.dtype,
                    residual_dtype=self.cfg.rdtype,
                    attn_softmax_dtype=self.cfg.sm_dtype,
                    quantize=self.cfg.quant)
                if collect_outputs and (i + 1) % k == 0:
                    outs.append(h)
        else:
            h = x
            for i, block in enumerate(self.blocks[first_layer:last]):
                h = block(h, mask, attn_mask=attn_mask)
                if collect_outputs and (i + 1) % k == 0:
                    outs.append(h)
        return (h, torch.stack(outs)) if collect_outputs else h

    def train_forward(self, x: torch.Tensor, mask: Optional[torch.Tensor], *,
                      seeds: Optional[List[int]] = None, collect_every: int = 1,
                      attn_mask: Optional[torch.Tensor] = None,
                      first_layer: int = 0, n_layers: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Training over blocks first_layer .. n_layers-1 (default all),
        with autograd: block i's dropout from seeds[i] (no dropout without
        seeds); with cfg.remat each block is recomputed in backward.
        Returns (outs (L/k, B, T, D) of the L blocks run, their new
        BatchNorm running means (L, D) and variances (L, D))."""
        last = len(self.blocks) if n_layers is None else n_layers
        outs, means, variances = [], [], []
        h = x
        for i in range(first_layer, last):
            block = self.blocks[i]
            seed = None if seeds is None else seeds[i]
            if self.cfg.remat:
                h, m, v = torch.utils.checkpoint.checkpoint(
                    block, h, mask, train=True, seed=seed, attn_mask=attn_mask,
                    use_reentrant=False, preserve_rng_state=False)
            else:
                h, m, v = block(h, mask, train=True, seed=seed,
                                attn_mask=attn_mask)
            means.append(m)
            variances.append(v)
            if (i - first_layer + 1) % collect_every == 0:
                outs.append(h)
        return torch.stack(outs), torch.stack(means), torch.stack(variances)

    def bn_state(self) -> dict:
        """The blocks' BatchNorm running statistics in the JAX package's
        stack layout: {"conv_bn": {"mean", "var"}}, (L, D) each."""
        convs = [b.conv for b in self.blocks]
        return {"conv_bn": {"mean": torch.stack([c.bn_mean for c in convs]),
                            "var": torch.stack([c.bn_var for c in convs])}}

    def set_bn_state(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Assign every block's BatchNorm running statistics ((L, D) each)."""
        with torch.no_grad():
            for i, b in enumerate(self.blocks):
                b.conv.bn_mean.copy_(mean[i])
                b.conv.bn_var.copy_(var[i])
