"""Conformer block kernel (CUDA, `csrc/conformer_block.cu`) and its plain
PyTorch version.

Replaces `early_exit_tpu/ops/pallas/conformer_block.py::fused_block_apply`
(body `_block_kernel`, weights laid out by `fold_block_params`). The
plain version repeats the TPU kernel's arithmetic op for op -- including
its one-pass LayerNorm variance, max(E[x^2] - mu^2, 0) -- on any device
and in any compute dtype; the CPU path and the tests use it. The CUDA
kernel takes the bf16 profile the main path runs (bf16 compute and
residual, bf16 or float32 softmax). Its bound and design notes are in
the source.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Mapping

import torch
import torch.nn.functional as F

from early_exit_tpu_torch.ops.kernels import _build

# the C entry's weight order
PARAM_ORDER = (
    "ffn1_ln_g", "ffn1_ln_b", "ffn1_w1", "ffn1_b1", "ffn1_w2", "ffn1_b2",
    "attn_ln_g", "attn_ln_b", "wqkv", "bqkv", "wo", "bo",
    "conv_ln_g", "conv_ln_b", "pw1_w", "pw1_b", "dw_w", "dw_b",
    "bn_scale", "bn_shift", "pw2_w", "pw2_b",
    "ffn2_ln_g", "ffn2_ln_b", "ffn2_w1", "ffn2_b1", "ffn2_w2", "ffn2_b2",
    "final_ln_g", "final_ln_b",
)
_FLOAT32 = {n for n in PARAM_ORDER if "_ln_" in n} | {
    "dw_b", "bn_scale", "bn_shift"}


def fold_block_params(sd: Mapping[str, torch.Tensor], *,
                      compute_dtype: torch.dtype = torch.bfloat16,
                      eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """One block's tensors (a `ConformerBlock.state_dict()`) -> the
    kernel's layout: matmul weights and biases in the compute dtype,
    q/k/v concatenated into one (D, 3D) product, LayerNorm vectors float32,
    BatchNorm running statistics folded into float32 scale and shift."""
    cd = compute_dtype
    bn_scale = sd["conv.bn_g"].float() * torch.rsqrt(sd["conv.bn_var"].float() + eps)
    bn_shift = sd["conv.bn_b"].float() - sd["conv.bn_mean"].float() * bn_scale
    dw = sd["conv.dw_w"]
    out = {
        "wqkv": torch.cat([sd["attn.wq"], sd["attn.wk"], sd["attn.wv"]], 1),
        "bqkv": torch.cat([sd["attn.bq"], sd["attn.bk"], sd["attn.bv"]], 0),
        "wo": sd["attn.wo"], "bo": sd["attn.bo"],
        "attn_ln_g": sd["attn.ln_g"], "attn_ln_b": sd["attn.ln_b"],
        "conv_ln_g": sd["conv.ln_g"], "conv_ln_b": sd["conv.ln_b"],
        "pw1_w": sd["conv.pw1_w"], "pw1_b": sd["conv.pw1_b"],
        "dw_w": dw.reshape(dw.shape[0], dw.shape[-1]), "dw_b": sd["conv.dw_b"],
        "bn_scale": bn_scale, "bn_shift": bn_shift,
        "pw2_w": sd["conv.pw2_w"], "pw2_b": sd["conv.pw2_b"],
        "final_ln_g": sd["final_ln_g"], "final_ln_b": sd["final_ln_b"],
    }
    for pre in ("ffn1", "ffn2"):
        for k in ("ln_g", "ln_b", "w1", "b1", "w2", "b2"):
            out[f"{pre}_{k}"] = sd[f"{pre}.{k}"]
    return {k: (v.float() if k in _FLOAT32 else v.to(cd)).contiguous()
            for k, v in out.items()}


def _ln_one_pass(v, g, b, eps):
    v32 = v.float()
    mu = v32.mean(-1, keepdim=True)
    var = (v32.square().mean(-1, keepdim=True) - mu.square()).clamp_min(0.0)
    return (v32 - mu) * torch.rsqrt(var + eps) * g + b


def conformer_block_plain(f: Mapping[str, torch.Tensor], x: torch.Tensor,
                          lengths: torch.Tensor, *, n_heads: int,
                          kernel_size: int,
                          compute_dtype: torch.dtype = torch.bfloat16,
                          residual_dtype: torch.dtype = torch.bfloat16,
                          attn_softmax_dtype: torch.dtype = torch.float32,
                          eps: float = 1e-5) -> torch.Tensor:
    """The kernel's function in PyTorch ops. x: (B, T, D); lengths: (B,)."""
    cd, rd = compute_dtype, residual_dtype
    B, T, D = x.shape
    dh = D // n_heads
    valid = (torch.arange(T, device=x.device)[None, :]
             < lengths.to(x.device)[:, None])                   # (B, T)

    def mm(v, w, b):
        # compute-dtype operands, float32 accumulation, one rounding
        return torch.matmul(v.to(cd).float(), w.float()).to(cd) + b

    def silu(v):
        return v / (1 + torch.exp(-v))

    def ffn(v, pre):
        y = _ln_one_pass(v, f[pre + "_ln_g"], f[pre + "_ln_b"], eps)
        y = silu(mm(y, f[pre + "_w1"], f[pre + "_b1"]))
        return mm(y, f[pre + "_w2"], f[pre + "_b2"])

    x = x.to(rd)
    x = x + 0.5 * ffn(x, "ffn1").to(rd)

    # MHSA with a per-item key mask
    y = _ln_one_pass(x, f["attn_ln_g"], f["attn_ln_b"], eps)
    qkv = mm(y, f["wqkv"], f["bqkv"])
    q, k, v = (t.reshape(B, T, n_heads, dh).transpose(1, 2)
               for t in qkv.split(D, dim=-1))
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))     # (B,H,T,T)
    col_valid = valid[:, None, None, :]
    if attn_softmax_dtype == torch.bfloat16:
        s = s.to(torch.bfloat16) * torch.tensor(1.0 / math.sqrt(dh),
                                                dtype=torch.bfloat16)
        s = s.masked_fill(~col_valid, -30000.0)
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p = e / e.float().sum(-1, keepdim=True).to(torch.bfloat16)
        oh = torch.matmul(p.float(), v.float()).to(cd)
    else:
        s = (s * (1.0 / math.sqrt(dh))).masked_fill(~col_valid, -1e9)
        p = torch.softmax(s, dim=-1).to(cd)
        oh = torch.matmul(p.float(), v.to(cd).float())
    att = oh.transpose(1, 2).reshape(B, T, D)
    x = x + mm(att, f["wo"], f["bo"]).to(rd)

    # convolution module
    y = _ln_one_pass(x, f["conv_ln_g"], f["conv_ln_b"], eps)
    y = mm(y, f["pw1_w"], f["pw1_b"])
    a, g = y[..., :D], y[..., D:]
    y = a * (1 / (1 + torch.exp(-g)))                            # GLU
    y = torch.where(valid[..., None], y, torch.zeros((), dtype=y.dtype,
                                                     device=y.device))
    padl = (kernel_size - 1) // 2
    yp = F.pad(y, (0, 0, padl, kernel_size - 1 - padl))
    dw = f["dw_w"].float()
    acc = torch.zeros(B, T, D, dtype=torch.float32, device=x.device)
    for j in range(kernel_size):           # tap by tap, float32
        acc = acc + yp[:, j:j + T].float() * dw[j]
    y = acc.to(cd).float() + f["dw_b"]
    y = y * f["bn_scale"] + f["bn_shift"]
    y = y / (1 + torch.exp(-y))
    x = x + mm(y, f["pw2_w"], f["pw2_b"]).to(rd)

    x = x + 0.5 * ffn(x, "ffn2").to(rd)
    x = _ln_one_pass(x, f["final_ln_g"], f["final_ln_b"], eps).to(rd)
    return torch.where(valid[..., None], x,
                       torch.zeros((), dtype=rd, device=x.device))


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"conformer_block: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def conformer_block(f: Mapping[str, torch.Tensor], x: torch.Tensor,
                    lengths: torch.Tensor, *, n_heads: int, kernel_size: int,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    residual_dtype: torch.dtype = torch.bfloat16,
                    attn_softmax_dtype: torch.dtype = torch.float32,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """One inference Conformer block. x: (B, T, D); lengths: (B,) int32;
    f: from `fold_block_params`. Returns (B, T, D) in the residual dtype
    (written into `out` when given).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel, which takes bf16 compute and residual with T up to its
    shared-memory limit (`eet_conformer_block_max_t`, 1600) and raises
    on anything else."""
    if x.device.type == "cpu":
        y = conformer_block_plain(
            f, x, lengths, n_heads=n_heads, kernel_size=kernel_size,
            compute_dtype=compute_dtype, residual_dtype=residual_dtype,
            attn_softmax_dtype=attn_softmax_dtype)
        if out is not None:
            out.copy_(y)
            return out
        return y
    if x.device.type != "cuda":
        raise ValueError(f"conformer_block: unsupported device {x.device}")
    if compute_dtype != torch.bfloat16 or residual_dtype != torch.bfloat16:
        raise NotImplementedError(
            "conformer_block kernel: only the bf16 profile (bf16 compute "
            "and residual) is ported; the float32 and int8 variants are not")
    if attn_softmax_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported softmax dtype {attn_softmax_dtype}")
    B, T, D = x.shape
    Fd = f["ffn1_w1"].shape[1]
    if D % 128 or Fd % 128 or D // n_heads != 32 or D % n_heads:
        raise ValueError(
            f"conformer_block kernel needs d_model and d_ff multiples of 128 "
            f"and 32-wide heads; got D={D} F={Fd} heads={n_heads}")
    lib = _lib()
    max_t = lib.eet_conformer_block_max_t()
    if not 0 < T <= max_t:
        raise ValueError(f"conformer_block kernel needs 0 < T <= {max_t}, got {T}")
    dev = x.device
    _check(x, "x", torch.bfloat16, (B, T, D), dev)
    _check(lengths, "lengths", torch.int32, (B,), dev)
    shapes = {"ffn1_w1": (D, Fd), "ffn1_b1": (Fd,), "ffn1_w2": (Fd, D),
              "ffn2_w1": (D, Fd), "ffn2_b1": (Fd,), "ffn2_w2": (Fd, D),
              "wqkv": (D, 3 * D), "bqkv": (3 * D,), "wo": (D, D),
              "pw1_w": (D, 2 * D), "pw1_b": (2 * D,), "pw2_w": (D, D),
              "dw_w": (kernel_size, D)}
    for name in PARAM_ORDER:
        dtype = torch.float32 if name in _FLOAT32 else torch.bfloat16
        _check(f[name], name, dtype, shapes.get(name, (D,)), dev)
    y = torch.empty_like(x) if out is None else out
    _check(y, "out", torch.bfloat16, (B, T, D), dev)
    if y.data_ptr() == x.data_ptr():
        raise ValueError("conformer_block: out must not alias x")
    R = B * T
    s_ln = torch.empty(R, D, dtype=torch.bfloat16, device=dev)
    s_big = torch.empty(R, max(Fd, 3 * D), dtype=torch.bfloat16, device=dev)
    s_att = torch.empty(R, D, dtype=torch.bfloat16, device=dev)
    wptrs = (ctypes.c_void_p * len(PARAM_ORDER))(
        *[f[n].data_ptr() for n in PARAM_ORDER])
    scale = (torch.tensor(1.0 / math.sqrt(D // n_heads), dtype=torch.bfloat16).item()
             if attn_softmax_dtype == torch.bfloat16
             else 1.0 / math.sqrt(D // n_heads))
    err = lib.eet_conformer_block_bf16(
        _build.ptr(x), _build.ptr(y), _build.ptr(lengths), B, T, D, n_heads,
        Fd, kernel_size, int(attn_softmax_dtype == torch.bfloat16), scale,
        1e-5, wptrs, _build.ptr(s_ln), _build.ptr(s_big), _build.ptr(s_att),
        _build.stream_ptr(dev))
    _build.check(lib, err, "conformer_block kernel")
    conformer_block.launches += 1
    return y


conformer_block.launches = 0


def _lib():
    lib = _build.load("conformer_block")
    fn = lib.eet_conformer_block_bf16
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, i, i, i, i, i, i, i, ctypes.c_float,
                       ctypes.c_float, ctypes.POINTER(vp), vp, vp, vp, vp]
        fn.restype = i
        for entry in (lib.eet_conformer_block_param_count,
                      lib.eet_conformer_block_max_t):
            entry.argtypes, entry.restype = [], i
        if lib.eet_conformer_block_param_count() != len(PARAM_ORDER):
            raise RuntimeError("conformer_block.cu and PARAM_ORDER disagree")
    return lib
