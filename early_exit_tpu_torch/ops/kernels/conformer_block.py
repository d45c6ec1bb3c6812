"""Conformer block kernel (CUDA, `csrc/conformer_block.cu`) and its plain
PyTorch version.

Replaces `early_exit_tpu/ops/pallas/conformer_block.py::fused_block_apply`
(body `_block_kernel`, weights laid out by `fold_block_params`). The
plain version repeats the TPU kernel's arithmetic op for op -- including
its one-pass LayerNorm variance, max(E[x^2] - mu^2, 0) -- on any device,
in any compute dtype and with or without W8A8 quantization; the CPU path
and the tests use it. The CUDA source has four entries for five
profiles (`_entry`): bf16 (bf16 compute and residual, bf16 or float32
softmax), W8A8 (`quantize="int8"` in the bf16 profile), float32
(everything float32, or with the bf16 softmax) and bf16 compute with a
float32 residual. The mixes none takes raise by name on the card.

The card takes every width the TPU kernel takes but heads wider than
128, through a padded layout (`block_plan`, `fold_block_params(...,
n_heads=H)`): d_model and d_ff round up to multiples of 16 (`PITCH`) and
each head to the next width the attentions are instantiated at
(`HEAD_WIDTHS`), with zero weights, biases, LayerNorm
vectors and BatchNorm rows in the padding, so the padded columns of
every intermediate are exact zeros; the LayerNorms count the true
d_model and the scores take 1/sqrt of the true head width. A residual
of a d_model that is not a multiple of 16 arrives padded to its pitch
(`ConformerStack` pads it once for a stack). The flagship's widths pad
nothing. The bf16 entry's ten products run
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
import dataclasses
import math
from typing import Dict, List, Mapping, Optional

import torch
import torch.nn.functional as F

from early_exit_tpu_torch.nn.core import int8_matmul, quantize_int8
from early_exit_tpu_torch.ops.kernels import _build
# the head widths both attentions are instantiated at (the mma.sync one of
# bf16 q, k, v in the bf16, W8A8 and float32-residual entries; the float32
# one of attention_f32.cuh, shared with row 3, in the float32 entry). A
# head of another width up to 128 is padded with zero columns to the next
from early_exit_tpu_torch.ops.kernels.attention import HEAD_WIDTHS

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
# the widest row the W8A8 LayerNorm + quantize kernel keeps in registers
# (LNQ_MAX_D in the source: one warp, two chunks of 8 values a lane); a
# wider one is read again for each of its passes
LNQ_MAX_D = 512
# d_model (the residual's row) and d_ff are padded to multiples of PITCH:
# 16-byte rows for TMA's int8 operands, 32-byte float32 rows
PITCH = 16
# the conv module's time tile and the shared memory a block may take
# (CONV_TT and SMEM_LIMIT in the source), for `conv_channels`
CONV_TT = 32
SMEM_LIMIT = 232448
# the entries' names, by (compute, residual, softmax) dtype name and
# whether quantized: the C entry each launches is in `_ENTRY_FN`
ENTRIES = ("bf16", "w8a8", "f32", "f32_sm_bf16", "bf16_res_f32")


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pitch(d_model: int) -> int:
    """The residual's row in the kernel layout: d_model padded to PITCH."""
    return _round_up(d_model, PITCH)


def padded_head(dh: int) -> int:
    """The instantiated width a head of dh is padded to; dh itself past 128 (the card refuses it by name,
    `block_plan`; the plain version takes it)."""
    return next((w for w in HEAD_WIDTHS if w >= dh), dh)


def conv_channels(d: int, kernel_size: int, elem_bytes: int, quant: bool) -> int:
    """Channels a conv-module block holds at pitch d (`conv_channels` in
    the source): d where the GLU tile with its halo (and, quantized, the
    float32 rows that wait for their absmax) fits in shared memory, else
    the most that fit, a multiple of 8; 0 where a quantized output, which
    needs whole rows, does not fit."""
    per = (CONV_TT + kernel_size - 1) * elem_bytes + (CONV_TT * 4 if quant else 0)
    if per * d <= SMEM_LIMIT:
        return d
    return 0 if quant else SMEM_LIMIT // per // 8 * 8


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """One launch of the block kernel as the card runs it (`block_plan`):
    the C entry, the model's widths and the padded ones of its layout (the
    head's is the attention's instantiation), and how the conv module and
    the W8A8 LayerNorm + quantize are laid out. Pure Python: the tests plan every width on the CPU, and
    the launch checks the layout's shapes against it."""
    entry: str
    d_model: int          # the LayerNorms' count
    pitch: int            # the residual's row
    n_heads: int
    head_dim: int         # the scores' scale is 1/sqrt(head_dim)
    head_pad: int         # the instantiated width of the attention
    d_ff: int
    ff_pad: int
    kernel_size: int
    conv_channels: int    # channels a conv block holds (pitch: all)
    conv_split: bool      # W8A8: the conv output quantized in a pass of its own
    lnq_wide: bool        # W8A8: the LayerNorm + quantize rereads its row

    @property
    def inner(self) -> int:
        """The attention's width, n_heads x head_pad."""
        return self.n_heads * self.head_pad


def block_plan(d_model: int, n_heads: int, d_ff: int, kernel_size: int, *,
               compute_dtype: torch.dtype = torch.bfloat16,
               residual_dtype: torch.dtype = torch.bfloat16,
               attn_softmax_dtype: torch.dtype = torch.float32,
               quantize: Optional[str] = None) -> BlockPlan:
    """How the card runs a block of these widths in this profile; raises
    by name for what it does not take (ROADMAP Queue B'): a profile no
    entry takes (`_entry`) and heads wider than 128."""
    entry = _entry(compute_dtype, residual_dtype, attn_softmax_dtype, quantize)
    if n_heads <= 0 or d_model % n_heads:
        raise ValueError(f"conformer_block: d_model {d_model} is not a multiple of "
                         f"n_heads {n_heads}")
    dh = d_model // n_heads
    f32 = compute_dtype == torch.float32
    head_pad = padded_head(dh)
    if head_pad > HEAD_WIDTHS[-1]:
        raise NotImplementedError(
            f"conformer_block kernel: heads of {dh} (d_model {d_model} / {n_heads}) are "
            f"not ported; the card's attentions take heads up to 128 wide")
    p = pitch(d_model)
    quant = entry == "w8a8"
    elem = 4 if f32 else 2
    ct = conv_channels(p, kernel_size, elem, quant)
    split = quant and ct == 0
    if split:
        ct = conv_channels(p, kernel_size, elem, False)
    if ct < 8:
        raise NotImplementedError(
            f"conformer_block kernel: a depthwise kernel of {kernel_size} taps does not "
            f"fit the conv module's shared-memory tile")
    return BlockPlan(
        entry=entry, d_model=d_model, pitch=p, n_heads=n_heads, head_dim=dh,
        head_pad=head_pad, d_ff=d_ff, ff_pad=_round_up(d_ff, PITCH),
        kernel_size=kernel_size, conv_channels=ct, conv_split=split, lnq_wide=quant and p > LNQ_MAX_D)


def _pad_layout(out: Dict[str, torch.Tensor], n_heads: int) -> Dict[str, torch.Tensor]:
    """The float layout (unpadded, `fold_block_params` before its casts)
    padded to the card's widths: d_model to `pitch`, d_ff to PITCH, each
    head to `padded_head`, every added weight, bias and vector zero.
    PW1's two halves (the GLU's a and gate) are padded each to the pitch,
    as the kernel splits its output at the pitch. Returns `out` itself
    where nothing is padded."""
    D, Fd = out["ffn1_w1"].shape
    H = n_heads
    dh = D // H
    P, Fp, dhp = pitch(D), _round_up(Fd, PITCH), padded_head(dh)
    if (P, Fp, dhp) == (D, Fd, dh):
        return out

    def pad(t, *sizes):      # zero-pad each axis to the size given (None: as is)
        widths = []
        for n, want in zip(reversed(t.shape), reversed(sizes)):
            widths += [0, 0 if want is None else want - n]
        return F.pad(t, widths)

    def heads(t):            # (..., H * dh) -> (..., H * dhp), head by head
        return pad(t.reshape(*t.shape[:-1], H, dh), *(None,) * t.dim(), dhp).reshape(
            *t.shape[:-1], H * dhp)

    r = {k: pad(v, P) for k, v in out.items() if v.dim() == 1 and v.shape[0] == D}
    for pre in ("ffn1", "ffn2"):
        r[pre + "_w1"] = pad(out[pre + "_w1"], P, Fp)
        r[pre + "_b1"] = pad(out[pre + "_b1"], Fp)
        r[pre + "_w2"] = pad(out[pre + "_w2"], Fp, P)
    r["wqkv"] = torch.cat([pad(heads(w), P, None) for w in out["wqkv"].split(D, 1)], 1)
    r["bqkv"] = torch.cat([heads(b) for b in out["bqkv"].split(D)])
    r["wo"] = pad(heads(out["wo"].t()).t(), None, P)
    r["pw1_w"] = torch.cat([pad(w, P, P) for w in out["pw1_w"].split(D, 1)], 1)
    r["pw1_b"] = torch.cat([pad(b, P) for b in out["pw1_b"].split(D)])
    r["pw2_w"] = pad(out["pw2_w"], P, P)
    r["dw_w"] = pad(out["dw_w"], None, P)
    return r


def fold_block_params(sd: Mapping[str, torch.Tensor], *,
                      compute_dtype: torch.dtype = torch.bfloat16,
                      eps: float = 1e-5,
                      quantize: Optional[str] = None,
                      n_heads: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """One block's tensors (a `ConformerBlock.state_dict()`) -> the
    kernel's layout: matmul weights and biases in the compute dtype,
    q/k/v concatenated into one (D, 3D) product, LayerNorm vectors float32,
    BatchNorm running statistics folded into float32 scale and shift.

    quantize="int8" (`PARAM_ORDER_INT8`): each product weight becomes its
    int8 twin, quantized per output channel from the raw float32 weight,
    with its scale row `<name>_s` (float32, (N,)); the products' biases
    stay float32 (added after the int32 -> float32 rescale). `<name>_t`
    is the twin transposed to (N, K), the layout the CUDA kernel reads.

    n_heads given: the card's padded layout (`_pad_layout`; the widths of
    `block_plan`), quantized after the padding (a zero row or column
    moves no scale). Without it the layout keeps the model's widths: the
    plain version's and the library yardstick's, against which the tests
    hold the padded layout value for value (the card refuses it where the
    two differ)."""
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
    if n_heads is not None:
        out = _pad_layout(out, n_heads)
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


def _ln_one_pass(v, g, b, eps, d=None):
    """The one-pass LayerNorm; d: the true width of a padded row (its
    statistics over the first d values, whose padding is zeros)."""
    v32 = v.float()
    s = v32 if d is None or d == v.shape[-1] else v32[..., :d]
    mu = s.mean(-1, keepdim=True)
    var = (s.square().mean(-1, keepdim=True) - mu.square()).clamp_min(0.0)
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
                          ablate=frozenset(),
                          d_model: Optional[int] = None) -> torch.Tensor:
    """The kernel's function in PyTorch ops. x: (B, T, D); lengths: (B,).
    With quantize="int8", f is the W8A8 layout and every product
    quantizes its float input row by row. On the card's padded layout
    (`fold_block_params(..., n_heads=H)`), x has the pitch's columns and
    d_model is the true width: the LayerNorms count it, the heads are
    split at the layout's padded width and scaled by 1/sqrt of the true
    one, and the padded columns stay zeros, as in the kernel.

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

    B, T, D = x.shape
    d_true = d_model or D

    def ln(v, g, b):
        if "ln" in ablate:
            return v.float() * g + b
        if "ln2p" in ablate:
            v32 = v.float()
            mu = v32.mean(-1, keepdim=True)
            var = (v32 - mu).square().mean(-1, keepdim=True)
            return (v32 - mu) * torch.rsqrt(var + eps) * g + b
        return _ln_one_pass(v, g, b, eps, d_true)

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
                  d_true // n_heads, cd, rd, attn_softmax_dtype, "softmax" in ablate)
    if "conv" not in ablate:
        x = _conv_module(x, ln(x, f["conv_ln_g"], f["conv_ln_b"]), f, mm, silu, valid,
                         kernel_size, cd, rd, ablate)
    if "ffn" not in ablate:
        x = x + 0.5 * ffn(x, "ffn2").to(rd)
    x = ln(x, f["final_ln_g"], f["final_ln_b"]).to(rd)
    return torch.where(valid[..., None], x,
                       torch.zeros((), dtype=rd, device=x.device))


def _mhsa(x, y, mm, valid, n_heads, dh, cd, rd, attn_softmax_dtype, no_softmax):
    """x + the MHSA module on its LayerNormed input y, per-item key mask;
    heads of dh, in the layout's width (padded past dh with zeros)."""
    B, T, _ = x.shape
    qkv = mm(y, "wqkv", "bqkv")
    inner = qkv.shape[-1] // 3
    q, k, v = (t.reshape(B, T, n_heads, inner // n_heads).transpose(1, 2)
               for t in qkv.split(inner, dim=-1))
    oh = _attention(q, k, v, valid, dh, cd, attn_softmax_dtype, no_softmax)
    att = oh.transpose(1, 2).reshape(B, T, inner)
    return x + mm(att, "wo", "bo").to(rd)


def _attention(q, k, v, valid, dh, cd, attn_softmax_dtype, no_softmax):
    """The block's attention: q, k, v (B, H, T, heads padded past dh) ->
    P V (B, H, T, the same width); a bf16 softmax gives it in the compute
    dtype, a float32 one unrounded."""
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
    return oh


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
    """Which of `ENTRIES` takes this profile on the card; raises by name
    for a mix none takes (ROADMAP Queue B')."""
    cd, rd, sm = compute_dtype, residual_dtype, attn_softmax_dtype
    bf, f32 = torch.bfloat16, torch.float32
    if quantize not in (None, "none", "int8"):
        raise ValueError(f"quantize must be None or 'int8': {quantize!r}")
    if sm not in (bf, f32):
        raise ValueError(f"unsupported softmax dtype {sm}")
    if quantize == "int8":
        if cd == rd == bf:
            return "w8a8"
    elif cd == rd == bf:
        return "bf16"
    elif cd == bf and rd == f32:
        return "bf16_res_f32"
    elif cd == rd == f32:
        return "f32" if sm == f32 else "f32_sm_bf16"
    raise NotImplementedError(
        f"conformer_block kernel: compute {cd}, residual {rd}, softmax {sm}, "
        f"quantize {quantize!r} is not ported; the card takes bf16 compute with a "
        "bf16 or float32 residual (either softmax dtype; quantize='int8' with the "
        "bf16 residual only) and float32 compute and residual (either softmax "
        "dtype) without quantization")


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
                    d_model: Optional[int] = None,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """One inference Conformer block. x: (B, T, D); lengths: (B,) int32;
    f: from `fold_block_params` (with the same `quantize`). Returns
    (B, T, D) in the residual dtype (copied into `out` when given). On
    the card's padded layout (`fold_block_params(..., n_heads=H)`) x has
    the pitch's columns and d_model is the model's width.

    Calls the op `eet::conformer_block`. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel of its profile (`_entry`)
    at any T > 0 (the attentions stream the keys through shared memory in
    tiles) on the layout `block_plan` describes, or raises by name."""
    _device_ok("conformer_block", x)
    y = torch.ops.eet.conformer_block(
        x, lengths, op_params(f, quantize), n_heads, kernel_size,
        *(str(dt).removeprefix("torch.") for dt in
          (compute_dtype, residual_dtype, attn_softmax_dtype)), quantize or "none",
        d_model or 0)
    if out is None:
        return y
    out.copy_(y)
    return out


# The op takes its dtypes by name ("bfloat16", "float32"): a compiled
# program's call through the dispatcher carries a ScalarType argument in
# the export format's numbering, which torch 2.11 reads as another type.

def _conformer_block_cpu(x, lengths, params, n_heads, kernel_size, compute_dtype,
                         residual_dtype, attn_softmax_dtype, quantize, d_model=0):
    return conformer_block_plain(
        _layout(params, quantize), x, lengths, n_heads=n_heads,
        kernel_size=kernel_size, compute_dtype=getattr(torch, compute_dtype),
        residual_dtype=getattr(torch, residual_dtype),
        attn_softmax_dtype=getattr(torch, attn_softmax_dtype), quantize=quantize,
        d_model=d_model or None)


def _conformer_block_fake(x, lengths, params, n_heads, kernel_size, compute_dtype,
                          residual_dtype, attn_softmax_dtype, quantize, d_model=0):
    return x.new_empty(x.shape, dtype=getattr(torch, residual_dtype))


# the C entry of each of `ENTRIES` (bf16 compute with a float32 residual
# has one of its own; float32 with either softmax shares one)
_ENTRY_FN = {"bf16": "eet_conformer_block_bf16", "w8a8": "eet_conformer_block_w8a8",
             "f32": "eet_conformer_block_f32", "f32_sm_bf16": "eet_conformer_block_f32",
             "bf16_res_f32": "eet_conformer_block_bf16_f32res"}


def _conformer_block_cuda(x, lengths, params, n_heads, kernel_size, compute_dtype,
                          residual_dtype, attn_softmax_dtype, quantize, d_model=0,
                          ablate=None):
    """The kernel launch: the plan, checks of the layout against it,
    scratch, the C entry of the profile. ablate (bits of `ABLATIONS`, the
    bf16 entry only): the ablation library's entry instead, counted by
    `conformer_block_ablate`."""
    compute_dtype, residual_dtype, attn_softmax_dtype = (
        getattr(torch, name) for name in (compute_dtype, residual_dtype,
                                          attn_softmax_dtype))
    B, T, P = x.shape
    f = _layout(params, quantize)
    plan = block_plan(d_model or P, n_heads, f["ffn1_w1"].shape[1], kernel_size,
                      compute_dtype=compute_dtype, residual_dtype=residual_dtype,
                      attn_softmax_dtype=attn_softmax_dtype, quantize=quantize)
    entry = plan.entry
    if ablate is not None and entry != "bf16":
        raise NotImplementedError(f"conformer_block_ablate: the ablation library "
                                  f"has the bf16 entry only, not {entry}")
    Fd, Di = plan.ff_pad, plan.inner
    if (P, f["ffn1_w1"].shape[1], f["wqkv"].shape[1]) != (plan.pitch, Fd, 3 * Di):
        raise ValueError(
            f"conformer_block kernel: the layout is not padded for the card: x has "
            f"{P} columns, d_ff {f['ffn1_w1'].shape[1]}, q|k|v {f['wqkv'].shape[1]}; "
            f"d_model {plan.d_model} with {n_heads} heads takes {plan.pitch}, {Fd} and "
            f"{3 * Di} (fold_block_params(..., n_heads={n_heads}), d_model=...)")
    if T <= 0:
        raise ValueError(f"conformer_block kernel ({entry}) needs T > 0, got {T}")
    lib = _lib()
    dev, xdt = x.device, residual_dtype
    _check(x, "x", xdt, (B, T, P), dev)
    _check(lengths, "lengths", torch.int32, (B,), dev)
    shapes = {"ffn1_w1": (P, Fd), "ffn1_b1": (Fd,), "ffn1_w2": (Fd, P),
              "ffn2_w1": (P, Fd), "ffn2_b1": (Fd,), "ffn2_w2": (Fd, P),
              "wqkv": (P, 3 * Di), "bqkv": (3 * Di,), "wo": (Di, P),
              "pw1_w": (P, 2 * P), "pw1_b": (2 * P,), "pw2_w": (P, P),
              "dw_w": (kernel_size, P)}
    f32_names = _FLOAT32_INT8 if entry == "w8a8" else _FLOAT32
    ptrs, scale_ptrs = [], []
    for name in PARAM_ORDER:
        shape = shapes.get(name, (P,))
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
    sdt = compute_dtype       # the scratch holds compute-dtype activations
    s_ln = torch.empty(R, P, dtype=sdt, device=dev)
    s_big = torch.empty(R, max(Fd, 3 * Di), dtype=sdt, device=dev)
    s_att = torch.empty(R, max(P, Di), dtype=sdt, device=dev)
    wptrs = (ctypes.c_void_p * len(PARAM_ORDER))(*ptrs)
    sm_bf16 = attn_softmax_dtype == torch.bfloat16
    scale = 1.0 / math.sqrt(plan.head_dim)
    if sm_bf16:       # the scores are scaled in bf16
        scale = torch.tensor(scale, dtype=torch.bfloat16).item()
    head = (_build.ptr(x), _build.ptr(y), _build.ptr(lengths), B, T, P, plan.d_model,
            n_heads, plan.head_pad, Fd, kernel_size, int(sm_bf16), scale, 1e-5, wptrs)
    scratch = (_build.ptr(s_ln), _build.ptr(s_big), _build.ptr(s_att), _build.stream_ptr(dev))
    if ablate is not None:
        lib = _ablate_lib()
        err = lib.eet_conformer_block_bf16_ablate(*head, *scratch, ablate)
        _build.check(lib, err, "conformer_block_ablate kernel")
        conformer_block_ablate.launches += 1
        return y
    if entry != "w8a8":
        err = getattr(lib, _ENTRY_FN[entry])(*head, *scratch)
    else:
        # float32 scratch for the float32-softmax attention output and for
        # conv rows quantized in a pass of their own
        s_f = (torch.empty(R, max(P, Di), dtype=torch.float32, device=dev)
               if not sm_bf16 or plan.conv_split else None)
        s_q = torch.empty(R, max(Fd, P, Di), dtype=torch.int8, device=dev)
        s_sx = torch.empty(R, dtype=torch.float32, device=dev)
        err = lib.eet_conformer_block_w8a8(
            *head, (ctypes.c_void_p * len(PARAM_ORDER))(*scale_ptrs),
            None if s_f is None else _build.ptr(s_f), _build.ptr(s_q), _build.ptr(s_sx),
            _build.ptr(s_big), _build.ptr(s_att), _build.stream_ptr(dev))
    _build.check(lib, err, f"conformer_block kernel ({entry})")
    conformer_block.launches += 1
    conformer_block.entry_launches[entry] += 1
    return y


# launches of any entry, and of each: counted where a kernel is launched
conformer_block.launches = 0
conformer_block.entry_launches = {e: 0 for e in ENTRIES}


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
                              eps: float = 1e-5, d_model: int = 0):
    """The W8A8 entry's LayerNorm + quantize in PyTorch ops, repeating the
    kernel's float32 arithmetic operation for operation: lane l of a warp
    sums the row's values 8 l .. 8 l + 7 in order, then 256 + 8 l .. 256 +
    8 l + 7, and so on to the end of the row (x and x^2, the latter by
    fused multiply-add), a butterfly over the 32 lanes totals them, then
    the one-pass statistics of `_ln_one_pass` over the true width d_model
    (0: all D; the padding past it is zeros) with the kernel's two fused
    multiply-adds; the output is quantized row by row as `quantize_int8`
    does. x (R, D), D a multiple of 8 -> (q int8 (R, D), sx float32 (R,)).
    A fused multiply-add is taken in float64, where the product is exact,
    and rounded once to float32."""
    def fma(a, b_, c):
        return (a.double() * b_.double() + c.double()).float()

    R, D = x.shape
    if D % 8:
        raise ValueError(f"layer_norm_quantize needs D a multiple of 8; got {D}")
    v = x.float()
    n_ch = max(LNQ_MAX_D, _round_up(D, 256)) // 256     # chunks of 8 a lane
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
    d = torch.full((R, 1), float(d_model or D), dtype=torch.float32, device=x.device)
    mu = s[:, :1] / d
    var = fma(-mu, mu, ss[:, :1] / d).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    y = fma((v - mu) * rstd, g.float(), b.float())
    q, sx = quantize_int8(y)
    return q, sx[:, 0]


def layer_norm_quantize(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                        eps: float = 1e-5, d_model: int = 0):
    """The W8A8 entry's LayerNorm + quantize on its own: x (R, D) bf16, g
    and b (D,) float32 -> (q int8 (R, D), sx float32 (R,)), the int8 rows
    of the float32 LayerNorm and their scales; d_model: the true width of
    a padded row (0: D). For checks: the block never calls it. Calls the
    op `eet::layer_norm_quantize`: a CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (D a multiple of 8: a warp holds a row
    of up to 512 in registers, and rereads a wider one) or raises."""
    _device_ok("layer_norm_quantize", x)
    return torch.ops.eet.layer_norm_quantize(x, g, b, eps, d_model)


def _layer_norm_quantize_fake(x, g, b, eps, d_model=0):
    return (x.new_empty(x.shape, dtype=torch.int8),
            x.new_empty(x.shape[:1], dtype=torch.float32))


def _layer_norm_quantize_cuda(x, g, b, eps, d_model=0):
    R, D = x.shape
    if R <= 0 or D % 8 or not 0 <= d_model <= D:
        raise ValueError(f"layer_norm_quantize kernel needs rows > 0, D a multiple "
                         f"of 8 and d_model <= D; got {R} x {D}, d_model {d_model}")
    _check(x, "x", torch.bfloat16, (R, D), x.device)
    _check(g, "g", torch.float32, (D,), x.device)
    _check(b, "b", torch.float32, (D,), x.device)
    q = torch.empty(R, D, dtype=torch.int8, device=x.device)
    sx = torch.empty(R, dtype=torch.float32, device=x.device)
    lib = _lib()
    err = lib.eet_layer_norm_quantize(
        _build.ptr(x), _build.ptr(g), _build.ptr(b), _build.ptr(q), _build.ptr(sx),
        R, D, d_model or D, eps, _build.stream_ptr(x.device))
    _build.check(lib, err, "layer_norm_quantize kernel")
    layer_norm_quantize.launches += 1
    return q, sx


layer_norm_quantize.launches = 0


def block_layer_norm_plain(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                           eps: float = 1e-5, d_model: int = 0) -> torch.Tensor:
    """The block's LayerNorm as its plain version computes it, rounded to
    bf16; d_model: the true width of a padded row (0: all of it)."""
    return _ln_one_pass(x, g, b, eps, d_model or None).to(torch.bfloat16)


def block_layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                     eps: float = 1e-5, d_model: int = 0) -> torch.Tensor:
    """The bf16 entries' LayerNorm kernel on its own: x (R, D) bf16 (or
    float32, bf16 compute with a float32 residual), g and b (D,) float32
    -> (R, D) bf16, statistics over the first d_model values (0: D). For
    checks: the block never calls it. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (D a multiple of 8) or
    raises."""
    _device_ok("block_layer_norm", x)
    if x.device.type == "cpu":
        return block_layer_norm_plain(x, g, b, eps, d_model)
    R, D = x.shape
    if R <= 0 or D % 8 or not 0 <= d_model <= D:
        raise ValueError(f"block_layer_norm kernel needs rows > 0, D a multiple of 8 "
                         f"and d_model <= D; got {R} x {D}, d_model {d_model}")
    in_f32 = x.dtype == torch.float32
    _check(x, "x", torch.float32 if in_f32 else torch.bfloat16, (R, D), x.device)
    _check(g, "g", torch.float32, (D,), x.device)
    _check(b, "b", torch.float32, (D,), x.device)
    y = torch.empty(R, D, dtype=torch.bfloat16, device=x.device)
    lib = _lib()
    err = lib.eet_layer_norm_bf16(_build.ptr(x), _build.ptr(g), _build.ptr(b), _build.ptr(y),
                                  R, D, d_model or D, eps, int(in_f32),
                                  _build.stream_ptr(x.device))
    _build.check(lib, err, "block_layer_norm kernel")
    block_layer_norm.launches += 1
    return y


block_layer_norm.launches = 0


def block_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          valid: torch.Tensor, head_dim: int,
                          attn_softmax_dtype: torch.dtype) -> torch.Tensor:
    """The bf16 entries' attention as the plain version computes it: q, k,
    v (B, H, T, padded heads) bf16, valid (B, T) bool -> P V (B, H, T,
    padded heads), bf16 with the bf16 softmax, float32 with the float32
    one."""
    return _attention(q, k, v, valid, head_dim, torch.bfloat16, attn_softmax_dtype, False)


def block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid: torch.Tensor,
                    head_dim: int, attn_softmax_dtype: torch.dtype) -> torch.Tensor:
    """The bf16 entries' attention kernel on its own (the mma.sync kernel
    the bf16, W8A8 and float32-residual entries launch between their QKV
    and Wo products), on q, k, v as `block_attention_plain` takes them;
    head_dim: the true width (the scale). For checks: the block never
    calls it. A CPU tensor takes the plain version; a CUDA tensor packs
    q|k|v into the block's rows, launches the kernel (valid must be a
    prefix of each row: lengths) or raises."""
    _device_ok("block_attention", q)
    if q.device.type == "cpu":
        return block_attention_plain(q, k, v, valid, head_dim, attn_softmax_dtype)
    B, H, T, dhp = q.shape
    lengths = torch.count_nonzero(valid, dim=1).to(torch.int32)
    if not torch.equal(valid, torch.arange(T, device=q.device)[None, :] < lengths[:, None]):
        raise ValueError("block_attention kernel takes a key mask that is a prefix of each row")
    qkv = torch.stack([q, k, v]).to(torch.bfloat16).permute(1, 3, 0, 2, 4).reshape(
        B * T, 3 * H * dhp).contiguous()
    sm_bf16 = attn_softmax_dtype == torch.bfloat16
    out = torch.empty(B * T, H * dhp, device=q.device,
                      dtype=torch.bfloat16 if sm_bf16 else torch.float32)
    scale = 1.0 / math.sqrt(head_dim)
    if sm_bf16:
        scale = torch.tensor(scale, dtype=torch.bfloat16).item()
    lib = _lib()
    err = lib.eet_block_attention(_build.ptr(qkv), _build.ptr(lengths), _build.ptr(out), B, T,
                                  H * dhp, H, scale, int(sm_bf16), int(not sm_bf16),
                                  _build.stream_ptr(q.device))
    _build.check(lib, err, "block_attention kernel")
    block_attention.launches += 1
    return out.reshape(B, T, H, dhp).transpose(1, 2)


block_attention.launches = 0


# the C entries' leading arguments: x, y, lengths, B, T, D (the pitch),
# Dt (the true width), H, DH (the padded head), F (padded), ksize,
# sm_bf16, scale, eps, the weights
def _head_args():
    vp, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return [vp, vp, vp, i, i, i, i, i, i, i, i, i, fl, fl, ctypes.POINTER(vp)]


def _ablate_lib():
    lib = _build.load("conformer_block_ablate")
    if lib.eet_conformer_block_bf16_ablate.argtypes is None:
        vp = ctypes.c_void_p
        lib.eet_conformer_block_bf16_ablate.argtypes = (
            _head_args() + [vp, vp, vp, vp, ctypes.c_int])
        lib.eet_conformer_block_bf16_ablate.restype = ctypes.c_int
    return lib


def _lib():
    lib = _build.load("conformer_block")
    if lib.eet_conformer_block_bf16.argtypes is None:
        vp, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        pp = ctypes.POINTER(vp)
        for fn in ("eet_conformer_block_bf16", "eet_conformer_block_f32",
                   "eet_conformer_block_bf16_f32res"):
            getattr(lib, fn).argtypes = _head_args() + [vp, vp, vp, vp]
        lib.eet_conformer_block_w8a8.argtypes = _head_args() + [pp, vp, vp, vp, vp, vp, vp]
        lib.eet_gemm_bf16.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, vp]
        lib.eet_gemm_s8.argtypes = [vp, vp, vp, vp, vp, vp, vp, i, i, i, i, vp]
        lib.eet_layer_norm_quantize.argtypes = [vp, vp, vp, vp, vp, i, i, i, fl, vp]
        lib.eet_layer_norm_bf16.argtypes = [vp, vp, vp, vp, i, i, i, fl, i, vp]
        lib.eet_block_attention.argtypes = [vp, vp, vp, i, i, i, i, fl, i, i, vp]
        for entry in (lib.eet_conformer_block_bf16, lib.eet_conformer_block_f32,
                      lib.eet_conformer_block_bf16_f32res,
                      lib.eet_conformer_block_w8a8, lib.eet_gemm_bf16,
                      lib.eet_gemm_s8, lib.eet_layer_norm_quantize,
                      lib.eet_layer_norm_bf16, lib.eet_block_attention,
                      lib.eet_conformer_block_param_count):
            entry.restype = i
        lib.eet_conformer_block_param_count.argtypes = []
        if lib.eet_conformer_block_param_count() != len(PARAM_ORDER):
            raise RuntimeError("conformer_block.cu and PARAM_ORDER disagree")
    return lib
