"""Pre-norm Transformer decoder with a KV cache (counterpart of
`early_exit_tpu/models/transformer_decoder.py`).

Layer (pre-norm, ReLU FFN):
    x = x + Drop(SelfAttn(LN1(x), causal + target-pad mask))
    x = x + Drop(CrossAttn(LN2(x), memory))      # no memory mask: the
                                                 # padded encoder frames are
                                                 # attended, as in the JAX
                                                 # package and the reference
    x = x + Drop(W2(Drop(ReLU(W1(LN3(x))))))
A stack of layers ends in a final LayerNorm that the caller owns (the
AED model shares one across its exits).

Incremental decoding (`init_cache`, `DecoderStack.step`): each step
appends the new position's self-attention keys and values to a float32
cache and attends over the positions written so far. The cross-attention
keys and values of the memory do not change from step to step, so
`memory_kv` projects them once per decode instead of every step as the
JAX package does: the inputs are identical, so the values are too.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from early_exit_tpu_torch.nn import core

_ATTN = ("q", "k", "v", "o")


def _weight(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape))


class Projections(nn.Module):
    """The q, k, v and o products of one attention, (d, d) each."""

    def __init__(self, d: int):
        super().__init__()
        for n in _ATTN:
            setattr(self, "w" + n, _weight(d, d))
            setattr(self, "b" + n, _weight(d))

    def init(self, gen: torch.Generator) -> None:
        for n in _ATTN:
            core.linear_init_(getattr(self, "w" + n), getattr(self, "b" + n), gen)

    def params(self) -> dict:
        return {n: (getattr(self, "w" + n), getattr(self, "b" + n)) for n in _ATTN}


class DecoderLayer(nn.Module):
    def __init__(self, d: int, d_ff: int):
        super().__init__()
        self.ln1_g, self.ln1_b = _weight(d), _weight(d)
        self.self_attn = Projections(d)
        self.ln2_g, self.ln2_b = _weight(d), _weight(d)
        self.cross_attn = Projections(d)
        self.ln3_g, self.ln3_b = _weight(d), _weight(d)
        self.w1, self.b1 = _weight(d, d_ff), _weight(d_ff)
        self.w2, self.b2 = _weight(d_ff, d), _weight(d)

    def init(self, gen: torch.Generator) -> None:
        for g, b in ((self.ln1_g, self.ln1_b), (self.ln2_g, self.ln2_b),
                     (self.ln3_g, self.ln3_b)):
            core.norm_init_(g, b)
        self.self_attn.init(gen)
        self.cross_attn.init(gen)
        core.linear_init_(self.w1, self.b1, gen)
        core.linear_init_(self.w2, self.b2, gen)

    def ffn(self, x, compute_dtype, gen=None, rate: float = 0.0):
        y = core.layer_norm(x, self.ln3_g, self.ln3_b)
        y = torch.relu(core.linear(y, self.w1, self.b1, compute_dtype=compute_dtype))
        y = core.dropout(y, rate, gen)
        y = core.linear(y, self.w2, self.b2, compute_dtype=compute_dtype)
        return core.dropout(y, rate, gen)

    def forward(self, x, memory, n_heads: int, *,
                tgt_valid: Optional[torch.Tensor] = None, causal: bool = True,
                compute_dtype: Optional[torch.dtype] = None,
                gen: Optional[torch.Generator] = None, rate: float = 0.0):
        """x (B, L, D) target, memory (B, T, D); tgt_valid (B, L) bool,
        True where the target position is valid. Dropout at `rate` with
        masks from `gen` (none without one)."""
        y = core.layer_norm(x, self.ln1_g, self.ln1_b)
        y = core.mha(self.self_attn.params(), y, y, n_heads, key_mask=tgt_valid,
                     causal=causal, compute_dtype=compute_dtype)
        x = x + core.dropout(y, rate, gen)
        y = core.layer_norm(x, self.ln2_g, self.ln2_b)
        y = core.mha(self.cross_attn.params(), y, memory, n_heads,
                     compute_dtype=compute_dtype)
        x = x + core.dropout(y, rate, gen)
        return x + self.ffn(x, compute_dtype, gen, rate)


def init_cache(n_layers: int, lanes: int, max_len: int, d_model: int,
               device=None) -> dict:
    """Per-layer self-attention K/V cache, float32 (n_layers, lanes,
    max_len, D), and the next position to write."""
    z = torch.zeros(n_layers, lanes, max_len, d_model, device=device)
    return {"k": z, "v": z.clone(), "pos": 0}


class DecoderStack(nn.Module):
    def __init__(self, d: int, d_ff: int, n_layers: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.layers = nn.ModuleList(DecoderLayer(d, d_ff) for _ in range(n_layers))

    def init(self, gen: torch.Generator) -> None:
        for layer in self.layers:
            layer.init(gen)

    def forward(self, x, memory, final_ln: Tuple[torch.Tensor, torch.Tensor], *,
                tgt_valid: Optional[torch.Tensor] = None, causal: bool = True,
                compute_dtype: Optional[torch.dtype] = None,
                seeds: Optional[List[int]] = None, rate: float = 0.0):
        """Every layer over the whole target, then the final LayerNorm.
        seeds: one per layer, for its dropout masks (none without)."""
        for i, layer in enumerate(self.layers):
            gen = None
            if seeds is not None and rate > 0.0:
                gen = torch.Generator(device=x.device).manual_seed(seeds[i])
            x = layer(x, memory, self.n_heads, tgt_valid=tgt_valid, causal=causal,
                      compute_dtype=compute_dtype, gen=gen, rate=rate)
        return core.layer_norm(x, *final_ln)

    def memory_kv(self, memory: torch.Tensor,
                  compute_dtype: Optional[torch.dtype] = None) -> List[tuple]:
        """Each layer's cross-attention keys and values of memory (B, T, D),
        as (B, H, T, dh) in the compute dtype."""
        B, T, D = memory.shape
        H = self.n_heads
        out = []
        for layer in self.layers:
            p = layer.cross_attn
            k = core.linear(memory, p.wk, p.bk, compute_dtype=compute_dtype)
            v = core.linear(memory, p.wv, p.bv, compute_dtype=compute_dtype)
            out.append(tuple(t.reshape(B, T, H, D // H).transpose(1, 2) for t in (k, v)))
        return out

    def step(self, x_t: torch.Tensor, final_ln, cache: dict, mem_kv: List[tuple], *,
             compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """One decode step of N = B * K lanes, K lanes per memory row:
        x_t (N, 1, D) at position cache["pos"]; mem_kv from `memory_kv` of
        the (B, T, D) memory. Writes the position's keys and values into
        the cache and advances "pos". Returns (N, 1, D) after the final
        LayerNorm."""
        N, _, D = x_t.shape
        H = self.n_heads
        dh = D // H
        pos = cache["pos"]
        P = pos + 1
        lin = dict(compute_dtype=compute_dtype)
        h = x_t
        for li, layer in enumerate(self.layers):
            # self-attention of the one query over the cached positions:
            # float32 cache, float32 scores and softmax, as the JAX package
            # (its positions past pos are masked to -1e9, whose weights are
            # exactly 0)
            y = core.layer_norm(h, layer.ln1_g, layer.ln1_b)
            sa = layer.self_attn
            q = core.linear(y, sa.wq, sa.bq, **lin)
            cache["k"][li, :, pos] = core.linear(y, sa.wk, sa.bk, **lin)[:, 0].float()
            cache["v"][li, :, pos] = core.linear(y, sa.wv, sa.bv, **lin)[:, 0].float()
            kh = cache["k"][li, :, :P].reshape(N, P, H, dh).transpose(1, 2)
            vh = cache["v"][li, :, :P].reshape(N, P, H, dh).transpose(1, 2)
            qh = q.reshape(N, 1, H, dh).transpose(1, 2).float()
            scores = torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(dh)
            ctx = torch.matmul(torch.softmax(scores, dim=-1), vh)
            h = h + core.linear(ctx.transpose(1, 2).reshape(N, 1, D), sa.wo, sa.bo, **lin)

            # cross-attention: the K lanes of a memory row are K queries
            y = core.layer_norm(h, layer.ln2_g, layer.ln2_b)
            ca = layer.cross_attn
            k_m, v_m = mem_kv[li]
            B = k_m.shape[0]
            q = core.linear(y, ca.wq, ca.bq, **lin)
            q = q.reshape(B, N // B, H, dh).transpose(1, 2)            # (B, H, K, dh)
            scores = torch.matmul(q.float(), k_m.float().transpose(-1, -2)) / math.sqrt(dh)
            attn = torch.softmax(scores, dim=-1)
            v = v_m
            if compute_dtype is not None:
                attn, v = attn.to(compute_dtype), v.to(compute_dtype)
            ctx = torch.matmul(attn.float(), v.float())                  # (B, H, K, dh)
            ctx = ctx.transpose(1, 2).reshape(N, 1, D)
            h = h + core.linear(ctx, ca.wo, ca.bo, **lin)

            h = h + layer.ffn(h, compute_dtype)
        cache["pos"] = P
        return core.layer_norm(h, *final_ln)

    @staticmethod
    def reorder_cache(cache: dict, parent: torch.Tensor) -> None:
        """Each lane's cache rows <- its parent lane's (global lane
        indices), over the positions written so far."""
        P = cache["pos"]
        for name in ("k", "v"):
            c = cache[name]
            c[:, :, :P] = c[:, :, :P].index_select(1, parent)
