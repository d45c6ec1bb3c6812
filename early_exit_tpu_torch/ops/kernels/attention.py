"""Fused self-attention kernel (CUDA, `csrc/attention.cu`) and its plain
PyTorch version.

Replaces `early_exit_tpu/ops/pallas/attention.py::fused_attention` (body
`_attn_kernel`) and its caller `mha_pallas`. q, k, v (B, H, T, dh) in
bf16 or float32 are upcast to float32; Q K^T * (1/sqrt(dh)) -> key mask
to -1e9 -> softmax -> P V, with the (T, T) scores never in device
memory; the output is (B, H, T, dh) float32. A row whose keys are all
masked gets uniform probabilities (the mean of v), not zeros or NaN.
The kernel (register-tiled float32 products over streamed K and V
tiles, any T), its bound and design notes are in `csrc/attention_f32.cuh`.
The wrapper calls the op `eet::fused_attention`
(`ops/kernels/library.py`): the plain version on the CPU, the launch
(`_fused_attention_cuda`) on CUDA.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from early_exit_tpu_torch.nn import core
from early_exit_tpu_torch.ops.kernels import _build

NEG = -1e9
# the head widths the kernel is instantiated for (attention_f32.cuh); a
# head of another width up to 128 is padded with zero columns to the next,
# a head past 128 to the next multiple of 128 (`WIDE_CHUNK`: the chunked
# kernel takes such a head 128 columns at a time)
HEAD_WIDTHS = (16, 32, 48, 64, 128)
WIDE_CHUNK = 128


def padded_head(dh: int) -> int:
    """The width a head of dh is padded to on the card: the next of
    `HEAD_WIDTHS`, or past 128 the next multiple of `WIDE_CHUNK`. Both
    attentions and the block's layout take it."""
    if dh > HEAD_WIDTHS[-1]:
        return -(-dh // WIDE_CHUNK) * WIDE_CHUNK
    return next(w for w in HEAD_WIDTHS if w >= dh)


def fused_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """The kernel's function in PyTorch ops. mask: (B, T), true (or
    nonzero) where the key is valid."""
    q, k, v = q.float(), k.float(), v.float()
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    s = torch.where(mask.to(torch.bool)[:, None, None, :], s,
                    torch.full((), NEG, device=s.device))
    s = s - s.amax(-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(-1, keepdim=True)
    return torch.matmul(p, v)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Self-attention with a key-padding mask. q, k, v: (B, H, T, dh),
    all bf16 or all float32; mask: (B, T) bool, True where the key is
    valid. Returns (B, H, T, dh) float32.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes any dh and any T > 0 (K and V are streamed) and raises on
    anything else. A dh other than 16, 32, 48, 64 or 128 is padded with
    zero columns to the next of them, or past 128 to the next multiple of
    128 (`padded_head`; copies of q, k and v; zeros add nothing to the
    scores, which keep 1/sqrt of the true dh, and make zero output
    columns, which are cut off)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    return torch.ops.eet.fused_attention(q, k, v, mask.to(torch.bool))


def _fused_attention_fake(q, k, v, mask):
    return q.new_empty(q.shape, dtype=torch.float32)


def _fused_attention_cuda(q, k, v, mask):
    B, H, T, dh = q.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_attention kernel takes bf16 or float32 "
                         f"q/k/v, got {q.dtype}")
    dhp = padded_head(dh)
    if T <= 0:
        raise ValueError(f"fused_attention kernel needs T > 0, got {T}")
    lib = _lib()
    for name, t, dtype, shape in (("q", q, q.dtype, (B, H, T, dh)),
                                  ("k", k, q.dtype, (B, H, T, dh)),
                                  ("v", v, q.dtype, (B, H, T, dh)),
                                  ("mask", mask, torch.bool, (B, T))):
        if t.device != q.device or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"fused_attention: {name} must be a contiguous {dtype} tensor "
                f"of shape {shape} on {q.device}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if dhp != dh:
        q, k, v = (torch.nn.functional.pad(t, (0, dhp - dh)) for t in (q, k, v))
    out = torch.empty(B, H, T, dhp, dtype=torch.float32, device=q.device)
    err = lib.eet_attention(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(mask),
        _build.ptr(out), B, H, T, dhp, int(q.dtype == torch.bfloat16),
        1.0 / math.sqrt(dh), _build.stream_ptr(q.device))
    _build.check(lib, err, "fused_attention kernel")
    fused_attention.launches += 1
    return out if dhp == dh else out[..., :dh].contiguous()


fused_attention.launches = 0


def mha_fused(p: Dict[str, Tuple[torch.Tensor, torch.Tensor]], x: torch.Tensor,
              n_heads: int, *, key_mask: Optional[torch.Tensor],
              compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Self-attention block around the kernel (q = kv = x), the
    counterpart of `mha_pallas`: compute-dtype projections, float32
    softmax whatever the model's softmax dtype, the float32 kernel output
    straight into the o projection, no quantization of the projections."""
    B, T, D = x.shape
    dh = D // n_heads
    q, k, v = (core.linear(x, *p[n], compute_dtype=compute_dtype)
               .reshape(B, T, n_heads, dh).transpose(1, 2).contiguous()
               for n in ("q", "k", "v"))
    if key_mask is None:
        key_mask = torch.ones(B, T, dtype=torch.bool, device=x.device)
    o = fused_attention(q, k, v, key_mask.contiguous())
    o = o.transpose(1, 2).reshape(B, T, D)
    return core.linear(o, *p["o"], compute_dtype=compute_dtype)


def _lib():
    lib = _build.load("attention")
    fn = lib.eet_attention
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, ctypes.c_float, vp]
        fn.restype = i
    return lib
