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
Any other mix raises on the card. The bf16 entry's ten products run
through one wgmma + TMA kernel (`csrc/gemm_bf16.cuh`), the W8A8 entry's
through its int8 instantiation (`csrc/gemm_s8.cuh`); `block_gemm` and
`block_gemm_s8` expose them on their own for checks and timing,
`layer_norm_quantize` the W8A8 entry's LayerNorm + quantize kernel and
`block_layer_norm` the bf16 entry's LayerNorm (no op: checks only).
Bounds and design notes are in the sources.

Each wrapper calls its `torch.library` op (`eet::conformer_block`,
`eet::block_gemm`, `eet::block_gemm_s8`, `eet::layer_norm_quantize`;
`ops/kernels/library.py`), whose CPU implementation is the plain version
and whose CUDA implementation is the launch below (`_*_cuda`), so that
`torch.export` captures a kernel as one node.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Mapping, Optional

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
# the op's `params` list in the W8A8 layout: each product weight as the
# (N, K) twin the kernel reads, then its scale row
OP_ORDER_INT8 = tuple(
    n for name in PARAM_ORDER
    for n in ((name + "_t", name + "_s") if name in _MATMULS else (name,)))
_FLOAT32 = {n for n in PARAM_ORDER if "_ln_" in n} | {
    "dw_b", "bn_scale", "bn_shift"}
_FLOAT32_INT8 = _FLOAT32 | set(_MATMULS.values()) | {
    n + "_s" for n in _MATMULS}
# the widest row the W8A8 LayerNorm + quantize kernel takes (LNQ_MAX_D in
# the source): one warp, two chunks of 8 values a lane
LNQ_MAX_D = 512
# the head widths D / n_heads the block's attention is instantiated for
HEAD_WIDTHS = (16, 32, 64)


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


# the parts of the block that `ablate` can take out, with the TPU kernel's
# names (early_exit_tpu/ops/pallas/conformer_block.py:179-351), and the
# ablation library's bits for them (AB_* in csrc/conformer_block.cu)
ABLATIONS = {"ln": 1, "ln2p": 2, "softmax": 4, "silu": 8, "glu": 16,
             "dwconv": 32, "attn": 64, "conv": 128, "ffn": 256}


def _ablate_bits(ablate) -> int:
    unknown = set(ablate) - set(ABLATIONS)
    if unknown:
        raise ValueError(f"ablate: unknown parts {sorted(unknown)}; the block's "
                         f"are {sorted(ABLATIONS)}")
    return sum(ABLATIONS[a] for a in set(ablate))


def conformer_block_plain(f: Mapping[str, torch.Tensor], x: torch.Tensor,
                          lengths: torch.Tensor, *, n_heads: int,
                          kernel_size: int,
                          compute_dtype: torch.dtype = torch.bfloat16,
                          residual_dtype: torch.dtype = torch.bfloat16,
                          attn_softmax_dtype: torch.dtype = torch.float32,
                          quantize: Optional[str] = None,
                          eps: float = 1e-5,
                          ablate=frozenset()) -> torch.Tensor:
    """The kernel's function in PyTorch ops. x: (B, T, D); lengths: (B,).
    With quantize="int8", f is the W8A8 layout and every product
    quantizes its float input row by row.

    ablate: for timing by difference only (`ablate_fused_block`), parts
    of the block taken out with the TPU kernel's semantics (`ABLATIONS`):
    "ln" (every LayerNorm x * g + b), "ln2p" (centred two-pass variance),
    "softmax" (P = the scaled, masked scores), "silu" (identity), "glu"
    (a passes through), "dwconv" (the GLU output passes through), "attn",
    "conv", "ffn" (the module skipped). The output is then not the
    block's."""
    cd, rd = compute_dtype, residual_dtype
    int8 = quantize == "int8"
    _ablate_bits(ablate)

    def ln(v, g, b):
        if "ln" in ablate:
            return v.float() * g + b
        if "ln2p" in ablate:
            v32 = v.float()
            mu = v32.mean(-1, keepdim=True)
            var = (v32 - mu).square().mean(-1, keepdim=True)
            return (v32 - mu) * torch.rsqrt(var + eps) * g + b
        return _ln_one_pass(v, g, b, eps)

    B, T, D = x.shape
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
        return v if "silu" in ablate else v / (1 + torch.exp(-v))

    def ffn(v, pre):
        y = ln(v, f[pre + "_ln_g"], f[pre + "_ln_b"])
        y = silu(mm(y, pre + "_w1", pre + "_b1"))
        return mm(y, pre + "_w2", pre + "_b2")

    x = x.to(rd)
    if "ffn" not in ablate:
        x = x + 0.5 * ffn(x, "ffn1").to(rd)
    if "attn" not in ablate:
        x = _mhsa(x, ln(x, f["attn_ln_g"], f["attn_ln_b"]), mm, valid, n_heads,
                  cd, rd, attn_softmax_dtype, "softmax" in ablate)
    if "conv" not in ablate:
        x = _conv_module(x, ln(x, f["conv_ln_g"], f["conv_ln_b"]), f, mm, silu, valid,
                         kernel_size, cd, rd, ablate)
    if "ffn" not in ablate:
        x = x + 0.5 * ffn(x, "ffn2").to(rd)
    x = ln(x, f["final_ln_g"], f["final_ln_b"]).to(rd)
    return torch.where(valid[..., None], x,
                       torch.zeros((), dtype=rd, device=x.device))


def _mhsa(x, y, mm, valid, n_heads, cd, rd, attn_softmax_dtype, no_softmax):
    """x + the MHSA module on its LayerNormed input y, per-item key mask."""
    B, T, D = x.shape
    dh = D // n_heads
    qkv = mm(y, "wqkv", "bqkv")
    q, k, v = (t.reshape(B, T, n_heads, dh).transpose(1, 2)
               for t in qkv.split(D, dim=-1))
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))     # (B,H,T,T)
    col_valid = valid[:, None, None, :]
    if attn_softmax_dtype == torch.bfloat16:
        s = s.to(torch.bfloat16) * torch.tensor(1.0 / math.sqrt(dh),
                                                dtype=torch.bfloat16)
        s = s.masked_fill(~col_valid, -30000.0)
        if no_softmax:
            p = s
        else:
            e = torch.exp(s - s.amax(-1, keepdim=True))
            p = e / e.float().sum(-1, keepdim=True).to(torch.bfloat16)
        oh = torch.matmul(p.float(), v.float()).to(cd)
    else:
        s = (s * (1.0 / math.sqrt(dh))).masked_fill(~col_valid, -1e9)
        p = (s if no_softmax else torch.softmax(s, dim=-1)).to(cd)
        oh = torch.matmul(p.float(), v.to(cd).float())
    att = oh.transpose(1, 2).reshape(B, T, D)
    return x + mm(att, "wo", "bo").to(rd)


def _conv_module(x, y, f, mm, silu, valid, kernel_size, cd, rd, ablate):
    """x + the convolution module on its LayerNormed input y."""
    B, T, D = x.shape
    y = mm(y, "pw1_w", "pw1_b")
    a, g = y[..., :D], y[..., D:]
    y = a if "glu" in ablate else a * (1 / (1 + torch.exp(-g)))   # GLU
    y = torch.where(valid[..., None], y, torch.zeros((), dtype=y.dtype,
                                                     device=y.device))
    if "dwconv" in ablate:
        y = y.float() + f["dw_b"]
    else:
        padl = (kernel_size - 1) // 2
        yp = F.pad(y, (0, 0, padl, kernel_size - 1 - padl))
        dw = f["dw_w"].float()
        acc = torch.zeros(B, T, D, dtype=torch.float32, device=x.device)
        for j in range(kernel_size):           # tap by tap, float32
            acc = acc + yp[:, j:j + T].float() * dw[j]
        y = acc.to(cd).float() + f["dw_b"]
    y = y * f["bn_scale"] + f["bn_shift"]
    return x + mm(silu(y), "pw2_w", "pw2_b").to(rd)


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"conformer_block: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def _device_ok(name: str, t: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def _check_epilogue(name: str, epilogue: str, res: Optional[torch.Tensor]) -> None:
    if epilogue not in GEMM_EPILOGUES:
        raise ValueError(f"epilogue must be one of {GEMM_EPILOGUES}: {epilogue!r}")
    if (res is not None) != epilogue.startswith("res"):
        raise ValueError(f"{name}: epilogue {epilogue!r} with res "
                         f"{'given' if res is not None else 'missing'}")


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


def op_params(f: Mapping[str, torch.Tensor],
              quantize: Optional[str] = None) -> List[torch.Tensor]:
    """A block's layout as the op's `params` list: `PARAM_ORDER`, or
    `OP_ORDER_INT8` with quantize="int8". The one place the order is
    fixed; the C entries read it through their pointer arrays."""
    return [f[n] for n in (OP_ORDER_INT8 if quantize == "int8" else PARAM_ORDER)]


def _layout(params: List[torch.Tensor], quantize: str) -> Dict[str, torch.Tensor]:
    """The op's `params` list -> the layout by name (`op_params` undone;
    a W8A8 product weight's (K, N) view beside its `_t` twin)."""
    if quantize != "int8":
        return dict(zip(PARAM_ORDER, params))
    f = dict(zip(OP_ORDER_INT8, params))
    for name in _MATMULS:
        f[name] = f[name + "_t"].t()
    return f


def conformer_block(f: Mapping[str, torch.Tensor], x: torch.Tensor,
                    lengths: torch.Tensor, *, n_heads: int, kernel_size: int,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    residual_dtype: torch.dtype = torch.bfloat16,
                    attn_softmax_dtype: torch.dtype = torch.float32,
                    quantize: Optional[str] = None,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """One inference Conformer block. x: (B, T, D); lengths: (B,) int32;
    f: from `fold_block_params` (with the same `quantize`). Returns
    (B, T, D) in the residual dtype (copied into `out` when given).

    Calls the op `eet::conformer_block`. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel: the bf16 entry, the W8A8
    entry (`quantize="int8"`, bf16 compute and residual, d_model <= 256)
    or the float32 entry, each at any T > 0 (their attention streams the
    keys through shared memory in tiles). Any other dtype mix, width or
    head width raises."""
    _device_ok("conformer_block", x)
    y = torch.ops.eet.conformer_block(
        x, lengths, op_params(f, quantize), n_heads, kernel_size,
        *(str(dt).removeprefix("torch.") for dt in
          (compute_dtype, residual_dtype, attn_softmax_dtype)), quantize or "none")
    if out is None:
        return y
    out.copy_(y)
    return out


# The op takes its dtypes by name ("bfloat16", "float32"): a compiled
# program's call through the dispatcher carries a ScalarType argument in
# the export format's numbering, which torch 2.11 reads as another type.

def _conformer_block_cpu(x, lengths, params, n_heads, kernel_size, compute_dtype,
                         residual_dtype, attn_softmax_dtype, quantize):
    return conformer_block_plain(
        _layout(params, quantize), x, lengths, n_heads=n_heads,
        kernel_size=kernel_size, compute_dtype=getattr(torch, compute_dtype),
        residual_dtype=getattr(torch, residual_dtype),
        attn_softmax_dtype=getattr(torch, attn_softmax_dtype), quantize=quantize)


def _conformer_block_fake(x, lengths, params, n_heads, kernel_size, compute_dtype,
                          residual_dtype, attn_softmax_dtype, quantize):
    return x.new_empty(x.shape, dtype=getattr(torch, residual_dtype))


def _conformer_block_cuda(x, lengths, params, n_heads, kernel_size, compute_dtype,
                          residual_dtype, attn_softmax_dtype, quantize, ablate=None):
    """The kernel launch: checks, scratch, the C entry of the profile.
    ablate (bits of `ABLATIONS`, the bf16 entry only): the ablation
    library's entry instead, counted by `conformer_block_ablate`."""
    compute_dtype, residual_dtype, attn_softmax_dtype = (
        getattr(torch, name) for name in (compute_dtype, residual_dtype,
                                          attn_softmax_dtype))
    entry = _entry(compute_dtype, residual_dtype, attn_softmax_dtype, quantize)
    if ablate is not None and entry != "bf16":
        raise NotImplementedError(f"conformer_block_ablate: the ablation library "
                                  f"has the bf16 entry only, not {entry}")
    f = _layout(params, quantize)
    B, T, D = x.shape
    Fd = f["ffn1_w1"].shape[1]
    if D % 128 or Fd % 128 or D % n_heads or D // n_heads not in HEAD_WIDTHS:
        raise ValueError(
            f"conformer_block kernel needs d_model and d_ff multiples of 128 "
            f"and heads {HEAD_WIDTHS} wide; got D={D} F={Fd} heads={n_heads}")
    if entry == "w8a8" and D > LNQ_MAX_D:
        raise ValueError(f"conformer_block kernel (w8a8) needs d_model <= "
                         f"{LNQ_MAX_D} (its LayerNorm + quantize keeps a row in "
                         f"one warp's registers); got D={D}")
    if T <= 0:
        raise ValueError(f"conformer_block kernel ({entry}) needs T > 0, got {T}")
    lib = _lib()
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
    y = torch.empty_like(x)
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
    if ablate is not None:
        lib = _ablate_lib()
        err = lib.eet_conformer_block_bf16_ablate(
            *head, int(sm_bf16), scale, 1e-5, wptrs, _build.ptr(s_ln),
            _build.ptr(s_big), _build.ptr(s_att), _build.stream_ptr(dev), ablate)
        _build.check(lib, err, "conformer_block_ablate kernel")
        conformer_block_ablate.launches += 1
        return y
    if entry == "bf16":
        err = lib.eet_conformer_block_bf16(
            *head, int(sm_bf16), scale, 1e-5, wptrs, _build.ptr(s_ln),
            _build.ptr(s_big), _build.ptr(s_att), _build.stream_ptr(dev))
    elif entry == "f32":
        err = lib.eet_conformer_block_f32(
            *head, scale, 1e-5, wptrs, _build.ptr(s_ln), _build.ptr(s_big),
            _build.ptr(s_att), _build.stream_ptr(dev))
    else:
        # float32 scratch only for the float32-softmax attention output
        s_f = None if sm_bf16 else torch.empty(R, D, dtype=torch.float32, device=dev)
        s_q = torch.empty(R, max(Fd, D), dtype=torch.int8, device=dev)
        s_sx = torch.empty(R, dtype=torch.float32, device=dev)
        err = lib.eet_conformer_block_w8a8(
            *head, int(sm_bf16), scale, 1e-5, wptrs,
            (ctypes.c_void_p * len(PARAM_ORDER))(*scale_ptrs),
            None if s_f is None else _build.ptr(s_f), _build.ptr(s_q), _build.ptr(s_sx),
            _build.ptr(s_big), _build.ptr(s_att), _build.stream_ptr(dev))
    _build.check(lib, err, f"conformer_block kernel ({entry})")
    conformer_block.launches += 1
    conformer_block.entry_launches[entry] += 1
    return y


# launches of any entry, and of each: counted where a kernel is launched
conformer_block.launches = 0
conformer_block.entry_launches = {"bf16": 0, "f32": 0, "w8a8": 0}


def conformer_block_ablate(f: Mapping[str, torch.Tensor], x: torch.Tensor,
                           lengths: torch.Tensor, *, n_heads: int, kernel_size: int,
                           attn_softmax_dtype: torch.dtype = torch.float32,
                           ablate=frozenset()) -> torch.Tensor:
    """The bf16 block with the parts in `ablate` (`ABLATIONS`) taken out,
    for timing by difference (`ablate_fused_block`); not an op. A CPU
    tensor takes the plain version with the same `ablate`; a CUDA tensor
    launches the ablation library's entry (`conformer_block.cu` built with
    -DEET_ABLATE), which with no part taken out launches exactly the bf16
    entry's kernels."""
    _device_ok("conformer_block_ablate", x)
    bits = _ablate_bits(ablate)
    kw = dict(n_heads=n_heads, kernel_size=kernel_size, compute_dtype=torch.bfloat16,
              residual_dtype=torch.bfloat16, attn_softmax_dtype=attn_softmax_dtype)
    if x.device.type == "cpu":
        return conformer_block_plain(f, x, lengths, ablate=ablate, **kw)
    return _conformer_block_cuda(
        x, lengths, op_params(f), n_heads, kernel_size, "bfloat16", "bfloat16",
        str(attn_softmax_dtype).removeprefix("torch."), "none", ablate=bits)


conformer_block_ablate.launches = 0

GEMM_EPILOGUES = ("bias", "silu", "res", "res_half")


def block_gemm_plain(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                     res: Optional[torch.Tensor] = None,
                     epilogue: str = "bias") -> torch.Tensor:
    """The bf16 entry's product in PyTorch ops, rounding where the kernel
    rounds: bf16(a @ w) in float32 -> + bias in bf16 -> the epilogue op by
    op in bf16 -> bf16."""
    bf = torch.bfloat16
    y = torch.matmul(a.float(), w.float()).to(bf) + bias
    if epilogue == "silu":
        return y / (1 + torch.exp(-y))
    if epilogue == "res":
        return (res.float() + y.float()).to(bf)
    if epilogue == "res_half":
        return (res.float() + 0.5 * y.float()).to(bf)
    if epilogue != "bias":
        raise ValueError(f"epilogue must be one of {GEMM_EPILOGUES}: {epilogue!r}")
    return y


def block_gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
               res: Optional[torch.Tensor] = None, epilogue: str = "bias",
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One product of the bf16 block on its own, as the block's C entry
    runs it: epilogue(bf16(a (M, K) @ w (K, N)) + bias (N)), all bf16,
    with epilogue "bias", "silu", "res" (res + y) or "res_half"
    (res + 0.5 y); `out` may be `res`, as in the block. For checks and
    timing: the block never calls it. Calls the op `eet::block_gemm`,
    which writes `out` (allocated when not given): a CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    _check_epilogue("block_gemm", epilogue, res)
    _device_ok("block_gemm", a)
    if out is None:
        out = torch.empty(a.shape[0], w.shape[1], dtype=torch.bfloat16,
                          device=a.device)
    torch.ops.eet.block_gemm(a, w, bias, res, epilogue, out)
    return out


def _block_gemm_cpu(a, w, bias, res, epilogue, out):
    out.copy_(block_gemm_plain(a, w, bias, res, epilogue))


def _block_gemm_cuda(a, w, bias, res, epilogue, out):
    (M, K), N = a.shape, w.shape[1]
    if M <= 0 or K % 8 or N % 8:
        raise ValueError(f"block_gemm kernel needs M > 0 and K, N multiples "
                         f"of 8; got M={M} K={K} N={N}")
    for name, t, shape in (("a", a, (M, K)), ("w", w, (K, N)), ("bias", bias, (N,)),
                           ("res", res, (M, N)), ("out", out, (M, N))):
        if t is not None:
            _check(t, name, torch.bfloat16, shape, a.device)
    lib = _lib()
    err = lib.eet_gemm_bf16(
        _build.ptr(a), _build.ptr(w), _build.ptr(bias),
        None if res is None else _build.ptr(res), _build.ptr(out), M, N, K,
        GEMM_EPILOGUES.index(epilogue), _build.stream_ptr(a.device))
    _build.check(lib, err, "block_gemm kernel")
    block_gemm.launches += 1


block_gemm.launches = 0


def block_gemm_s8_plain(aq: torch.Tensor, sx: torch.Tensor, wt: torch.Tensor,
                        sw: torch.Tensor, bias: torch.Tensor,
                        res: Optional[torch.Tensor] = None,
                        epilogue: str = "bias") -> torch.Tensor:
    """The W8A8 entry's product in PyTorch ops, rounding where the kernel
    rounds: the exact int32 sums of aq @ wt^T -> float32 * (sx * sw) ->
    + bias in float32 -> one rounding to bf16 -> the epilogue op by op in
    bf16 -> bf16."""
    bf = torch.bfloat16
    y = int8_matmul(aq, wt.t()) * (sx[:, None] * sw) + bias
    y = y.to(bf)
    if epilogue == "silu":
        return y / (1 + torch.exp(-y))
    if epilogue == "res":
        return (res.float() + y.float()).to(bf)
    if epilogue == "res_half":
        return (res.float() + 0.5 * y.float()).to(bf)
    if epilogue != "bias":
        raise ValueError(f"epilogue must be one of {GEMM_EPILOGUES}: {epilogue!r}")
    return y


def block_gemm_s8(aq: torch.Tensor, sx: torch.Tensor, wt: torch.Tensor,
                  sw: torch.Tensor, bias: torch.Tensor,
                  res: Optional[torch.Tensor] = None, epilogue: str = "bias",
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One product of the W8A8 block on its own, as the block's C entry
    runs it: epilogue(bf16(float(aq (M, K) @ wt (N, K)^T) * (sx (M) *
    sw (N)) + bias (N))), aq and wt int8 (wt the `<name>_t` twin of
    `fold_block_params`), sx, sw and bias float32, res and out bf16; the
    epilogues as `block_gemm`'s, and `out` may be `res`. For checks and
    timing: the block never calls it. Calls the op `eet::block_gemm_s8`,
    which writes `out` (allocated when not given): a CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    _check_epilogue("block_gemm_s8", epilogue, res)
    _device_ok("block_gemm_s8", aq)
    if out is None:
        out = torch.empty(aq.shape[0], wt.shape[0], dtype=torch.bfloat16,
                          device=aq.device)
    torch.ops.eet.block_gemm_s8(aq, sx, wt, sw, bias, res, epilogue, out)
    return out


def _block_gemm_s8_cpu(aq, sx, wt, sw, bias, res, epilogue, out):
    out.copy_(block_gemm_s8_plain(aq, sx, wt, sw, bias, res, epilogue))


def _block_gemm_s8_cuda(aq, sx, wt, sw, bias, res, epilogue, out):
    (M, K), N = aq.shape, wt.shape[0]
    if M <= 0 or K % 16 or N % 8:
        raise ValueError(f"block_gemm_s8 kernel needs M > 0, K a multiple of 16 "
                         f"and N of 8; got M={M} K={K} N={N}")
    for name, t, dtype, shape in (
            ("aq", aq, torch.int8, (M, K)), ("sx", sx, torch.float32, (M,)),
            ("wt", wt, torch.int8, (N, K)), ("sw", sw, torch.float32, (N,)),
            ("bias", bias, torch.float32, (N,)), ("res", res, torch.bfloat16, (M, N)),
            ("out", out, torch.bfloat16, (M, N))):
        if t is not None:
            _check(t, name, dtype, shape, aq.device)
    lib = _lib()
    err = lib.eet_gemm_s8(
        _build.ptr(aq), _build.ptr(sx), _build.ptr(wt), _build.ptr(sw),
        _build.ptr(bias), None if res is None else _build.ptr(res), _build.ptr(out),
        M, N, K, GEMM_EPILOGUES.index(epilogue), _build.stream_ptr(aq.device))
    _build.check(lib, err, "block_gemm_s8 kernel")
    block_gemm_s8.launches += 1


block_gemm_s8.launches = 0


def layer_norm_quantize_plain(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                              eps: float = 1e-5):
    """The W8A8 entry's LayerNorm + quantize in PyTorch ops, repeating the
    kernel's float32 arithmetic operation for operation: lane l of a warp
    sums the row's values 8 l .. 8 l + 7 in order, then 256 + 8 l .. 256 +
    8 l + 7 (x and x^2, the latter by fused multiply-add), a butterfly
    over the 32 lanes totals them, then the one-pass statistics of
    `_ln_one_pass` with the kernel's two fused multiply-adds; the output is
    quantized row by row as `quantize_int8` does. x (R, D), D a multiple
    of 8 up to 512 -> (q int8 (R, D), sx float32 (R,)). A fused
    multiply-add is taken in float64, where the product is exact, and
    rounded once to float32."""
    def fma(a, b_, c):
        return (a.double() * b_.double() + c.double()).float()

    R, D = x.shape
    if D % 8 or D > LNQ_MAX_D:
        raise ValueError(f"layer_norm_quantize needs D a multiple of 8 up to "
                         f"{LNQ_MAX_D}; got {D}")
    v = x.float()
    n_ch = LNQ_MAX_D // 256                     # chunks of 8 a lane
    ch = torch.zeros(R, n_ch * 32, 8, dtype=torch.float32, device=x.device)
    ch[:, :D // 8] = v.reshape(R, D // 8, 8)
    ch = ch.reshape(R, n_ch, 32, 8)             # [row][chunk][lane]
    s = torch.zeros(R, 32, dtype=torch.float32, device=x.device)
    ss = torch.zeros_like(s)
    for c in range(n_ch):
        for k in range(8):
            e = ch[:, c, :, k]
            s = s + e
            ss = fma(e, e, ss)
    lane = torch.arange(32, device=x.device)
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, lane ^ o]
        ss = ss + ss[:, lane ^ o]
    d = torch.full((R, 1), float(D), dtype=torch.float32, device=x.device)
    mu = s[:, :1] / d
    var = fma(-mu, mu, ss[:, :1] / d).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    y = fma((v - mu) * rstd, g.float(), b.float())
    q, sx = quantize_int8(y)
    return q, sx[:, 0]


def layer_norm_quantize(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                        eps: float = 1e-5):
    """The W8A8 entry's LayerNorm + quantize on its own: x (R, D) bf16, g
    and b (D,) float32 -> (q int8 (R, D), sx float32 (R,)), the int8 rows
    of the float32 LayerNorm and their scales. For checks: the block
    never calls it. Calls the op `eet::layer_norm_quantize`: a CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (D a
    multiple of 8 up to 512: a warp holds a row in registers, up to 16
    values a lane) or raises."""
    _device_ok("layer_norm_quantize", x)
    return torch.ops.eet.layer_norm_quantize(x, g, b, eps)


def _layer_norm_quantize_fake(x, g, b, eps):
    return (x.new_empty(x.shape, dtype=torch.int8),
            x.new_empty(x.shape[:1], dtype=torch.float32))


def _layer_norm_quantize_cuda(x, g, b, eps):
    R, D = x.shape
    if R <= 0 or D % 8 or D > LNQ_MAX_D:
        raise ValueError(f"layer_norm_quantize kernel needs rows > 0 and D a "
                         f"multiple of 8 up to {LNQ_MAX_D}; got {R} x {D}")
    _check(x, "x", torch.bfloat16, (R, D), x.device)
    _check(g, "g", torch.float32, (D,), x.device)
    _check(b, "b", torch.float32, (D,), x.device)
    q = torch.empty(R, D, dtype=torch.int8, device=x.device)
    sx = torch.empty(R, dtype=torch.float32, device=x.device)
    lib = _lib()
    err = lib.eet_layer_norm_quantize(
        _build.ptr(x), _build.ptr(g), _build.ptr(b), _build.ptr(q), _build.ptr(sx),
        R, D, eps, _build.stream_ptr(x.device))
    _build.check(lib, err, "layer_norm_quantize kernel")
    layer_norm_quantize.launches += 1
    return q, sx


layer_norm_quantize.launches = 0


def block_layer_norm_plain(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                           eps: float = 1e-5) -> torch.Tensor:
    """The block's LayerNorm as its plain version computes it, rounded to
    x's dtype."""
    return _ln_one_pass(x, g, b, eps).to(x.dtype)


def block_layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """The bf16 entry's LayerNorm kernel on its own: x (R, D) bf16, g and b
    (D,) float32 -> (R, D) bf16. For checks: the block never calls it. A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (D a multiple of 8) or raises."""
    _device_ok("block_layer_norm", x)
    if x.device.type == "cpu":
        return block_layer_norm_plain(x, g, b, eps)
    R, D = x.shape
    if R <= 0 or D % 8:
        raise ValueError(f"block_layer_norm kernel needs rows > 0 and D a multiple "
                         f"of 8; got {R} x {D}")
    _check(x, "x", torch.bfloat16, (R, D), x.device)
    _check(g, "g", torch.float32, (D,), x.device)
    _check(b, "b", torch.float32, (D,), x.device)
    y = torch.empty_like(x)
    lib = _lib()
    err = lib.eet_layer_norm_bf16(_build.ptr(x), _build.ptr(g), _build.ptr(b), _build.ptr(y),
                                  R, D, eps, _build.stream_ptr(x.device))
    _build.check(lib, err, "block_layer_norm kernel")
    block_layer_norm.launches += 1
    return y


block_layer_norm.launches = 0


def _ablate_lib():
    lib = _build.load("conformer_block_ablate")
    if lib.eet_conformer_block_bf16_ablate.argtypes is None:
        vp, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.eet_conformer_block_bf16_ablate.argtypes = (
            [vp, vp, vp, i, i, i, i, i, i, i, fl, fl, ctypes.POINTER(vp), vp, vp, vp, vp, i])
        lib.eet_conformer_block_bf16_ablate.restype = ctypes.c_int
    return lib


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
        lib.eet_gemm_bf16.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, vp]
        lib.eet_gemm_s8.argtypes = [vp, vp, vp, vp, vp, vp, vp, i, i, i, i, vp]
        lib.eet_layer_norm_quantize.argtypes = [vp, vp, vp, vp, vp, i, i, fl, vp]
        lib.eet_layer_norm_bf16.argtypes = [vp, vp, vp, vp, i, i, fl, vp]
        for entry in (lib.eet_conformer_block_bf16, lib.eet_conformer_block_f32,
                      lib.eet_conformer_block_w8a8, lib.eet_gemm_bf16,
                      lib.eet_gemm_s8, lib.eet_layer_norm_quantize,
                      lib.eet_layer_norm_bf16, lib.eet_conformer_block_param_count):
            entry.restype = i
        lib.eet_conformer_block_param_count.argtypes = []
        if lib.eet_conformer_block_param_count() != len(PARAM_ORDER):
            raise RuntimeError("conformer_block.cu and PARAM_ORDER disagree")
    return lib
