"""Functional neural-net primitives.

Counterparts of `early_exit_tpu/nn/core.py` with the same rounding
points, on (B, T, C) tensors and the JAX package's weight layouts:
linear `w` is (d_in, d_out), conv `w` is (k, c_in, c_out), depthwise
`w` is (k, 1, C). The initialisers draw, in place, from an explicit
`torch.Generator` on the tensor's device, with the JAX package's
distributions and limits. Training differentiates through these ops
with autograd.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from early_exit_tpu_torch.parallel import collectives

# finite large negative for masked logits: a fully masked row gives a
# uniform distribution instead of NaN
NEG_INF = -1e9
# the bf16 score mask; -30000 is representable in bf16
NEG_BF16 = -30000.0


def xavier_uniform_(w: torch.Tensor, generator: torch.Generator, *,
                    fan_in: Optional[int] = None,
                    fan_out: Optional[int] = None) -> torch.Tensor:
    """Xavier/Glorot uniform in place: U(-l, l), l = sqrt(6 / (fan_in +
    fan_out)); the fans default to the last two axes (a vector: its
    length for both)."""
    shape = w.shape
    if fan_in is None:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    if fan_out is None:
        fan_out = shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return w.uniform_(-limit, limit, generator=generator)


def linear_init_(w: torch.Tensor, b: Optional[torch.Tensor],
                 generator: torch.Generator) -> None:
    """w (d_in, d_out) Xavier uniform, b zeros."""
    xavier_uniform_(w, generator)
    if b is not None:
        with torch.no_grad():
            b.zero_()


def conv1d_init_(w: torch.Tensor, b: Optional[torch.Tensor],
                 generator: torch.Generator) -> None:
    """w (k, c_in, c_out) Xavier uniform with fan_in = c_in * k and
    fan_out = c_out * k, b zeros."""
    k, c_in, c_out = w.shape
    xavier_uniform_(w, generator, fan_in=c_in * k, fan_out=c_out * k)
    if b is not None:
        with torch.no_grad():
            b.zero_()


def depthwise_conv1d_init_(w: torch.Tensor, b: Optional[torch.Tensor],
                           generator: torch.Generator) -> None:
    """w (k, 1, C) Xavier uniform with both fans = k, b zeros."""
    k = w.shape[0]
    xavier_uniform_(w, generator, fan_in=k, fan_out=k)
    if b is not None:
        with torch.no_grad():
            b.zero_()


def norm_init_(g: torch.Tensor, b: torch.Tensor) -> None:
    """LayerNorm or BatchNorm scale 1, shift 0."""
    with torch.no_grad():
        g.fill_(1.0)
        b.zero_()


def embedding_init_(table: torch.Tensor, generator: torch.Generator) -> None:
    """The (vocab, d) table in place: standard normal."""
    with torch.no_grad():
        table.normal_(generator=generator)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of the table at ids (any shape) -> ids.shape + (d,)."""
    return table[ids.long()]


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator], *,
            columns: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Inverted dropout: keep each value with probability 1 - rate, scaled
    by 1 / (1 - rate), in x's dtype. Identity at rate 0 or without a
    generator. columns (offset, full): x holds columns offset.. of a
    last axis `full` wide, and the mask is drawn at the full width and
    cut to them, so that the generator moves as the whole tensor's draw
    would (a tensor-parallel shard)."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    if columns is None:
        u = torch.rand(x.shape, generator=generator, device=x.device)
    else:
        offset, full = columns
        u = torch.rand(x.shape[:-1] + (full,), generator=generator,
                       device=x.device)[..., offset:offset + x.shape[-1]]
    mask = u < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device)).to(x.dtype)


def quantize_int8(x: torch.Tensor, axis: int = -1):
    """Symmetric int8 quantization along `axis`: (q int8, scale float32
    with the axis kept) with q * scale ~ x; scale = max(absmax, 1e-8) / 127,
    q = clip(round half to even of x / scale, -127, 127)."""
    x32 = x.float()
    scale = x32.abs().amax(axis, keepdim=True).clamp_min(1e-8) * (1.0 / 127.0)
    q = torch.clamp(torch.round(x32 / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 product, returned as float32 (rounded
    once, as int32 -> float32 is): the sums stay below 2^53, so float64
    carries them exactly on any device and in any order."""
    return torch.matmul(xq.double(), wq.double()).float()


def _linear_int8(x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None, *,
                 compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """W8A8 dynamically quantized linear: per-row activation scales,
    per-output-channel weight scales, int8 x int8 -> int32, rescaled by
    sx * sw in float32, float32 bias, then one cast to the compute dtype."""
    xq, sx = quantize_int8(x, axis=-1)            # (..., d_in), (..., 1)
    wq, sw = quantize_int8(w, axis=0)             # (d_in, d_out), (1, d_out)
    y = int8_matmul(xq, wq) * (sx * sw.reshape(-1))
    if b is not None:
        y = y + b
    if compute_dtype is not None:
        y = y.to(compute_dtype)
    return y


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           *, compute_dtype: Optional[torch.dtype] = None,
           quantize: Optional[str] = None) -> torch.Tensor:
    """y = x @ w + b, all in `compute_dtype`: the product is rounded to the
    compute dtype, then the bias is added in that dtype. quantize="int8"
    takes the W8A8 path (`_linear_int8`)."""
    if quantize == "int8":
        return _linear_int8(x, w, b, compute_dtype=compute_dtype)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def _time_pad(k: int, padding) -> Tuple[int, int]:
    if isinstance(padding, int):
        return padding, padding
    if padding == "SAME":
        return (k - 1) // 2, k // 2
    return 0, 0


def conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           *, stride: int = 1, padding="VALID",
           compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """1-D conv over time of (B, T, C); w (k, c_in, c_out). The conv runs
    in the compute dtype, its output is cast to float32, then the float32
    bias is added."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    xt = F.pad(x.transpose(1, 2), _time_pad(w.shape[0], padding))
    y = F.conv1d(xt, w.permute(2, 1, 0), stride=stride)
    # (B, T, C) contiguous: a product on the transposed layout cannot fold
    # the batch into its rows, and a capture over a symbolic batch then
    # guards on B == 1
    y = y.transpose(1, 2).clone(memory_format=torch.contiguous_format).float()
    if b is not None:
        y = y + b.float()
    return y


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, *,
                     compute_dtype: Optional[torch.dtype] = None
                     ) -> torch.Tensor:
    """Depthwise 'SAME' conv over time of (B, T, C); w (k, 1, C). Float32
    accumulation, one rounding to the compute dtype, then the float32
    bias."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    k, _, C = w.shape
    xt = F.pad(x.float().transpose(1, 2), _time_pad(k, "SAME"))
    y = F.conv1d(xt, w.float().permute(2, 1, 0), groups=C)
    # back to (B, T, C) as a contiguous copy: a later product on the
    # transposed view would copy it anyway, and a capture over a symbolic
    # T would guard on T == 1 deciding so
    y = y.transpose(1, 2).clone(memory_format=torch.contiguous_format)
    y = y.to(x.dtype).float()
    if b is not None:
        y = y + b.float()
    return y


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    """Two-pass float32 LayerNorm over the last axis."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + eps) * g.float() + b.float()


def masked_batch_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                      mean: torch.Tensor, var: torch.Tensor, *,
                      eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm in eval mode: the running statistics, in float32."""
    return ((x.float() - mean.float()) * torch.rsqrt(var.float() + eps)
            * g.float() + b.float())


def masked_batch_norm_train(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                            mean: torch.Tensor, var: torch.Tensor,
                            mask: Optional[torch.Tensor], *,
                            momentum: float = 0.1, eps: float = 1e-5, mesh=None):
    """BatchNorm in training mode over (batch, time) per channel of
    (B, T, C), counting only the valid frames (mask (B, T) bool).
    Normalises with the batch's biased statistics; the running estimate
    takes the unbiased variance, count / (count - 1), with momentum 0.1.
    Under a mesh the batch is the global one: the count, the masked sum
    and then the masked sum of squared deviations are summed over the
    batch group, their gradients summed back (`all_reduce_batch`).
    Returns (y, new_mean, new_var); the new statistics carry no graph."""
    x32 = x.float()
    if mask is not None or mesh is not None:
        m = (torch.ones(x.shape[:2], device=x.device) if mask is None
             else mask.float())[..., None]
        total = ((lambda t: t) if mesh is None
                 else (lambda t: collectives.all_reduce_batch(t, mesh)))
        count = total(m.sum()).clamp_min(1.0)
        mu = total((x32 * m).sum((0, 1))) / count
        v = total(((x32 - mu).square() * m).sum((0, 1))) / count
        unbiased = v * count / (count - 1.0).clamp_min(1.0)
    else:
        n = x32.shape[0] * x32.shape[1]
        mu = x32.mean((0, 1))
        v = x32.var((0, 1), unbiased=False)
        unbiased = v * n / max(n - 1, 1)
    with torch.no_grad():
        new_mean = (1 - momentum) * mean + momentum * mu
        new_var = (1 - momentum) * var + momentum * unbiased
    y = (x32 - mu) * torch.rsqrt(v + eps) * g.float() + b.float()
    return y, new_mean, new_var


def masked_group_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                      mask: Optional[torch.Tensor], *,
                      eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm(num_groups=1) of (B, T, C) over (T, C) per utterance, in
    float32, counting only the valid frames (mask (B, T) bool): count
    max(valid frames, 1) * C, so that an empty utterance stays finite;
    two-pass variance; the per-channel affine g, b."""
    x32 = x.float()
    if mask is not None:
        m = mask.float()[..., None]
        count = m.sum((1, 2), keepdim=True).clamp_min(1.0) * x32.shape[-1]
        mu = (x32 * m).sum((1, 2), keepdim=True) / count
        v = ((x32 - mu).square() * m).sum((1, 2), keepdim=True) / count
    else:
        mu = x32.mean((1, 2), keepdim=True)
        v = (x32 - mu).square().mean((1, 2), keepdim=True)
    return (x32 - mu) * torch.rsqrt(v + eps) * g.float() + b.float()


def _softmax_lowp(s: torch.Tensor) -> torch.Tensor:
    """Softmax with every elementwise op in the scores' own dtype."""
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    return e / e.sum(-1, keepdim=True)


def _heads(x: torch.Tensor, B: int, T: int, n_heads: int, dh: int, *,
           keys: bool = False) -> torch.Tensor:
    """(B, T, n_heads * dh) -> (B * n_heads, T, dh), or (B * n_heads, dh,
    T) with keys, as a contiguous copy: the operand that a batched product
    on the transposed view would copy to anyway. Made explicitly, it
    leaves a capture over a symbolic T with no guard on T == 1 (a view
    decision), so a poly program serves a one-frame axis."""
    x = x.reshape(B, T, n_heads, dh)
    x = x.permute(0, 2, 3, 1) if keys else x.permute(0, 2, 1, 3)
    return x.clone(memory_format=torch.contiguous_format).view(B * n_heads, *x.shape[2:])


def mha(p: Dict[str, Tuple[torch.Tensor, torch.Tensor]], q_in: torch.Tensor,
        kv_in: torch.Tensor, n_heads: int, *,
        key_mask: Optional[torch.Tensor] = None,
        causal: bool = False,
        pair_mask: Optional[torch.Tensor] = None,
        compute_dtype: Optional[torch.dtype] = None,
        softmax_dtype: torch.dtype = torch.float32,
        quantize: Optional[str] = None) -> torch.Tensor:
    """Multi-head attention on (B, Tq, D) / (B, Tk, D).

    p maps "q", "k", "v", "o" to (w, b). key_mask: (B, Tk) bool, True
    where the key is valid. causal: the lower-triangular mask (decoder
    self-attention), applied after the key mask. pair_mask: (Tq, Tk) or (B, Tq, Tk) bool, True
    where q may attend to k (dynamic-chunk training). With a bf16 softmax
    dtype the scores stay in bf16: scaled in bf16 and masked to -30000.
    quantize="int8" quantizes the four projections; scores and P V stay
    in the float path."""
    B, Tq, D = q_in.shape
    Tk = kv_in.shape[1]
    dh = D // n_heads
    lin = dict(compute_dtype=compute_dtype, quantize=quantize)
    q = linear(q_in, *p["q"], **lin)
    k = linear(kv_in, *p["k"], **lin)
    v = linear(kv_in, *p["v"], **lin)
    q = _heads(q, B, Tq, n_heads, dh)
    k = _heads(k, B, Tk, n_heads, dh, keys=True)
    v = _heads(v, B, Tk, n_heads, dh)

    lowp = softmax_dtype == torch.bfloat16
    if lowp:
        scores = torch.bmm(q, k) / math.sqrt(dh)
        neg = NEG_BF16
    else:
        scores = torch.bmm(q.float(), k.float())
        scores = scores / math.sqrt(dh)
        neg = NEG_INF
    scores = scores.view(B, n_heads, Tq, Tk)
    if key_mask is not None:
        scores = scores.masked_fill(~key_mask[:, None, None, :], neg)
    if causal:
        cm = torch.ones(Tq, Tk, dtype=torch.bool, device=scores.device).tril()
        scores = scores.masked_fill(~cm, neg)
    if pair_mask is not None:
        pm = pair_mask if pair_mask.dim() == 3 else pair_mask[None]
        scores = scores.masked_fill(~pm[:, None], neg)
    if lowp:
        out = torch.bmm(_softmax_lowp(scores).view(B * n_heads, Tq, Tk), v)
    else:
        attn = torch.softmax(scores.float(), dim=-1)
        if compute_dtype is not None:
            attn = attn.to(compute_dtype)
            v = v.to(compute_dtype)
        out = torch.bmm(attn.float().view(B * n_heads, Tq, Tk), v.float())
    out = out.view(B, n_heads, Tq, dh).permute(0, 2, 1, 3)
    out = out.clone(memory_format=torch.contiguous_format).view(B, Tq, D)
    return linear(out, *p["o"], **lin)


def sinusoidal_pe(max_len: int, d_model: int, *,
                  device=None) -> torch.Tensor:
    """(max_len, d_model) float32 sinusoidal table."""
    return sinusoidal_pe_at(torch.arange(max_len, device=device), d_model)


def sinusoidal_pe_at(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """(len(positions), d_model) float32 encodings at arbitrary positions,
    negative ones included: a streaming window is placed at its global
    stream offset (`serving/streaming.py`)."""
    device = positions.device
    pos = positions.to(torch.float32)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32,
                                 device=device)
                    * (-math.log(10000.0) / d_model))
    pe = torch.zeros(pos.shape[0], d_model, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe
