"""Conformer block kernel (CUDA, `csrc/conformer_block.cu`) and its plain
PyTorch version.

Replaces `early_exit_tpu/ops/pallas/conformer_block.py::fused_block_apply`
(body `_block_kernel`, weights laid out by `fold_block_params`). The
plain version repeats the TPU kernel's arithmetic op for op -- including
its one-pass LayerNorm variance, max(E[x^2] - mu^2, 0) -- on any device,
in any compute dtype and with or without W8A8 quantization; the CPU path
and the tests use it. The CUDA source has three entries: the bf16
profile (bf16 compute and residual, bf16 or float32 softmax), float32
(everything float32) and W8A8 (`quantize="int8"` in the bf16 profile).
Any other mix raises on the card. Bounds and design notes are in the
source.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from early_exit_tpu_torch.nn.core import int8_matmul, quantize_int8
from early_exit_tpu_torch.ops.kernels import _build

# the C entries' weight order
PARAM_ORDER = (
    "ffn1_ln_g", "ffn1_ln_b", "ffn1_w1", "ffn1_b1", "ffn1_w2", "ffn1_b2",
    "attn_ln_g", "attn_ln_b", "wqkv", "bqkv", "wo", "bo",
    "conv_ln_g", "conv_ln_b", "pw1_w", "pw1_b", "dw_w", "dw_b",
    "bn_scale", "bn_shift", "pw2_w", "pw2_b",
    "ffn2_ln_g", "ffn2_ln_b", "ffn2_w1", "ffn2_b1", "ffn2_w2", "ffn2_b2",
    "final_ln_g", "final_ln_b",
)
# the products that get an int8 twin and a per-output-channel scale row in
# the W8A8 layout (scores, P V and the depthwise conv stay in the float
# path), each with its bias
_MATMULS = {"ffn1_w1": "ffn1_b1", "ffn1_w2": "ffn1_b2", "wqkv": "bqkv",
            "wo": "bo", "pw1_w": "pw1_b", "pw2_w": "pw2_b",
            "ffn2_w1": "ffn2_b1", "ffn2_w2": "ffn2_b2"}
# W8A8 layout: every product weight is followed by its scale row
PARAM_ORDER_INT8 = tuple(
    n for name in PARAM_ORDER
    for n in ((name, name + "_s") if name in _MATMULS else (name,)))
_FLOAT32 = {n for n in PARAM_ORDER if "_ln_" in n} | {
    "dw_b", "bn_scale", "bn_shift"}
_FLOAT32_INT8 = _FLOAT32 | set(_MATMULS.values()) | {
    n + "_s" for n in _MATMULS}


def fold_block_params(sd: Mapping[str, torch.Tensor], *,
                      compute_dtype: torch.dtype = torch.bfloat16,
                      eps: float = 1e-5,
                      quantize: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """One block's tensors (a `ConformerBlock.state_dict()`) -> the
    kernel's layout: matmul weights and biases in the compute dtype,
    q/k/v concatenated into one (D, 3D) product, LayerNorm vectors float32,
    BatchNorm running statistics folded into float32 scale and shift.

    quantize="int8" (`PARAM_ORDER_INT8`): each product weight becomes its
    int8 twin, quantized per output channel from the raw float32 weight,
    with its scale row `<name>_s` (float32, (N,)); the products' biases
    stay float32 (added after the int32 -> float32 rescale). `<name>_t`
    is the twin transposed to (N, K), the layout the CUDA kernel reads."""
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
    if quantize not in (None, "none", "int8"):
        raise ValueError(f"quantize must be None or 'int8': {quantize!r}")
    if quantize != "int8":
        return {k: (v.float() if k in _FLOAT32 else v.to(cd)).contiguous()
                for k, v in out.items()}
    for name in _MATMULS:
        q, scale = quantize_int8(out[name], axis=0)
        out[name], out[name + "_s"] = q, scale[0]
        out[name + "_t"] = q.t()
    return {k: (v if v.dtype == torch.int8 else
                v.float() if k in _FLOAT32_INT8 else v.to(cd)).contiguous()
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
                          quantize: Optional[str] = None,
                          eps: float = 1e-5) -> torch.Tensor:
    """The kernel's function in PyTorch ops. x: (B, T, D); lengths: (B,).
    With quantize="int8", f is the W8A8 layout and every product
    quantizes its float input row by row."""
    cd, rd = compute_dtype, residual_dtype
    int8 = quantize == "int8"
    B, T, D = x.shape
    dh = D // n_heads
    valid = (torch.arange(T, device=x.device)[None, :]
             < lengths.to(x.device)[:, None])                   # (B, T)

    def mm(v, w, b):
        if int8:
            # the unrounded float input is quantized; float32 bias before
            # the one rounding to the compute dtype
            xq, sx = quantize_int8(v)
            y = int8_matmul(xq, f[w]) * (sx * f[w + "_s"]) + f[b]
            return y.to(cd)
        # compute-dtype operands, float32 accumulation, one rounding
        return torch.matmul(v.to(cd).float(), f[w].float()).to(cd) + f[b]

    def silu(v):
        return v / (1 + torch.exp(-v))

    def ffn(v, pre):
        y = _ln_one_pass(v, f[pre + "_ln_g"], f[pre + "_ln_b"], eps)
        y = silu(mm(y, pre + "_w1", pre + "_b1"))
        return mm(y, pre + "_w2", pre + "_b2")

    x = x.to(rd)
    x = x + 0.5 * ffn(x, "ffn1").to(rd)

    # MHSA with a per-item key mask
    y = _ln_one_pass(x, f["attn_ln_g"], f["attn_ln_b"], eps)
    qkv = mm(y, "wqkv", "bqkv")
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
    x = x + mm(att, "wo", "bo").to(rd)

    # convolution module
    y = _ln_one_pass(x, f["conv_ln_g"], f["conv_ln_b"], eps)
    y = mm(y, "pw1_w", "pw1_b")
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
    x = x + mm(y, "pw2_w", "pw2_b").to(rd)

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


def _entry(compute_dtype, residual_dtype, attn_softmax_dtype, quantize) -> str:
    """Which C entry takes this profile on the card; raises by name for a
    mix none takes."""
    cd, rd, sm = compute_dtype, residual_dtype, attn_softmax_dtype
    if quantize not in (None, "none", "int8"):
        raise ValueError(f"quantize must be None or 'int8': {quantize!r}")
    if sm not in (torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported softmax dtype {sm}")
    if cd == rd == torch.bfloat16:
        return "w8a8" if quantize == "int8" else "bf16"
    if cd == rd == sm == torch.float32 and quantize != "int8":
        return "f32"
    raise NotImplementedError(
        f"conformer_block kernel: compute {cd}, residual {rd}, softmax {sm}, "
        f"quantize {quantize!r} is not ported; the card takes bf16 compute "
        "and residual (either softmax dtype, with or without "
        "quantize='int8') or float32 throughout without quantization")


def conformer_block(f: Mapping[str, torch.Tensor], x: torch.Tensor,
                    lengths: torch.Tensor, *, n_heads: int, kernel_size: int,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    residual_dtype: torch.dtype = torch.bfloat16,
                    attn_softmax_dtype: torch.dtype = torch.float32,
                    quantize: Optional[str] = None,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """One inference Conformer block. x: (B, T, D); lengths: (B,) int32;
    f: from `fold_block_params` (with the same `quantize`). Returns
    (B, T, D) in the residual dtype (written into `out` when given).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel: the bf16 entry, the W8A8 entry (`quantize="int8"`, bf16
    compute and residual) or the float32 entry, with T up to the entry's
    shared-memory limit (1600, 1600 and 785). Any other dtype mix, head
    width or T raises."""
    if x.device.type == "cpu":
        y = conformer_block_plain(
            f, x, lengths, n_heads=n_heads, kernel_size=kernel_size,
            compute_dtype=compute_dtype, residual_dtype=residual_dtype,
            attn_softmax_dtype=attn_softmax_dtype, quantize=quantize)
        if out is not None:
            out.copy_(y)
            return out
        return y
    if x.device.type != "cuda":
        raise ValueError(f"conformer_block: unsupported device {x.device}")
    entry = _entry(compute_dtype, residual_dtype, attn_softmax_dtype, quantize)
    B, T, D = x.shape
    Fd = f["ffn1_w1"].shape[1]
    if D % 128 or Fd % 128 or D // n_heads != 32 or D % n_heads:
        raise ValueError(
            f"conformer_block kernel needs d_model and d_ff multiples of 128 "
            f"and 32-wide heads; got D={D} F={Fd} heads={n_heads}")
    lib = _lib()
    max_t = (lib.eet_conformer_block_f32_max_t() if entry == "f32"
             else lib.eet_conformer_block_max_t())
    if not 0 < T <= max_t:
        raise ValueError(f"conformer_block kernel ({entry}) needs 0 < T <= "
                         f"{max_t}, got {T}")
    dev, xdt = x.device, residual_dtype
    _check(x, "x", xdt, (B, T, D), dev)
    _check(lengths, "lengths", torch.int32, (B,), dev)
    shapes = {"ffn1_w1": (D, Fd), "ffn1_b1": (Fd,), "ffn1_w2": (Fd, D),
              "ffn2_w1": (D, Fd), "ffn2_b1": (Fd,), "ffn2_w2": (Fd, D),
              "wqkv": (D, 3 * D), "bqkv": (3 * D,), "wo": (D, D),
              "pw1_w": (D, 2 * D), "pw1_b": (2 * D,), "pw2_w": (D, D),
              "dw_w": (kernel_size, D)}
    f32_names = _FLOAT32_INT8 if entry == "w8a8" else _FLOAT32
    ptrs, scale_ptrs = [], []
    for name in PARAM_ORDER:
        shape = shapes.get(name, (D,))
        if entry == "w8a8" and name in _MATMULS:
            _check(f[name + "_t"], name + "_t", torch.int8, shape[::-1], dev)
            _check(f[name + "_s"], name + "_s", torch.float32, shape[1:], dev)
            ptrs.append(f[name + "_t"].data_ptr())
            scale_ptrs.append(f[name + "_s"].data_ptr())
            continue
        dtype = torch.float32 if name in f32_names else compute_dtype
        _check(f[name], name, dtype, shape, dev)
        ptrs.append(f[name].data_ptr())
        scale_ptrs.append(None)
    y = torch.empty_like(x) if out is None else out
    _check(y, "out", xdt, (B, T, D), dev)
    if y.data_ptr() == x.data_ptr():
        raise ValueError("conformer_block: out must not alias x")
    R = B * T
    s_ln = torch.empty(R, D, dtype=xdt, device=dev)
    s_big = torch.empty(R, max(Fd, 3 * D), dtype=xdt, device=dev)
    s_att = torch.empty(R, D, dtype=xdt, device=dev)
    wptrs = (ctypes.c_void_p * len(PARAM_ORDER))(*ptrs)
    sm_bf16 = attn_softmax_dtype == torch.bfloat16
    scale = 1.0 / math.sqrt(D // n_heads)
    if sm_bf16:       # the scores are scaled in bf16
        scale = torch.tensor(scale, dtype=torch.bfloat16).item()
    head = (_build.ptr(x), _build.ptr(y), _build.ptr(lengths), B, T, D,
            n_heads, Fd, kernel_size)
    if entry == "bf16":
        err = lib.eet_conformer_block_bf16(
            *head, int(sm_bf16), scale, 1e-5, wptrs, _build.ptr(s_ln),
            _build.ptr(s_big), _build.ptr(s_att), _build.stream_ptr(dev))
    elif entry == "f32":
        err = lib.eet_conformer_block_f32(
            *head, scale, 1e-5, wptrs, _build.ptr(s_ln), _build.ptr(s_big),
            _build.ptr(s_att), _build.stream_ptr(dev))
    else:
        s_f = torch.empty(R, D, dtype=torch.float32, device=dev)
        s_q = torch.empty(R, max(Fd, D), dtype=torch.int8, device=dev)
        s_sx = torch.empty(R, dtype=torch.float32, device=dev)
        err = lib.eet_conformer_block_w8a8(
            *head, int(sm_bf16), scale, 1e-5, wptrs,
            (ctypes.c_void_p * len(PARAM_ORDER))(*scale_ptrs),
            _build.ptr(s_f), _build.ptr(s_q), _build.ptr(s_sx),
            _build.ptr(s_big), _build.ptr(s_att), _build.stream_ptr(dev))
    _build.check(lib, err, f"conformer_block kernel ({entry})")
    conformer_block.launches += 1
    conformer_block.entry_launches[entry] += 1
    return y


# launches of any entry, and of each: counted where a kernel is launched
conformer_block.launches = 0
conformer_block.entry_launches = {"bf16": 0, "f32": 0, "w8a8": 0}


def _lib():
    lib = _build.load("conformer_block")
    if lib.eet_conformer_block_bf16.argtypes is None:
        vp, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        pp = ctypes.POINTER(vp)
        head = [vp, vp, vp, i, i, i, i, i, i]
        lib.eet_conformer_block_bf16.argtypes = head + [i, fl, fl, pp, vp, vp, vp, vp]
        lib.eet_conformer_block_f32.argtypes = head + [fl, fl, pp, vp, vp, vp, vp]
        lib.eet_conformer_block_w8a8.argtypes = head + [i, fl, fl, pp, pp, vp, vp, vp,
                                                        vp, vp, vp]
        for entry in (lib.eet_conformer_block_bf16, lib.eet_conformer_block_f32,
                      lib.eet_conformer_block_w8a8,
                      lib.eet_conformer_block_param_count,
                      lib.eet_conformer_block_max_t,
                      lib.eet_conformer_block_f32_max_t):
            entry.restype = i
        for entry in (lib.eet_conformer_block_param_count,
                      lib.eet_conformer_block_max_t,
                      lib.eet_conformer_block_f32_max_t):
            entry.argtypes = []
        if lib.eet_conformer_block_param_count() != len(PARAM_ORDER):
            raise RuntimeError("conformer_block.cu and PARAM_ORDER disagree")
    return lib
