"""The port's kernels as `torch.library` ops, namespace `eet`.

One op per C entry, each with three implementations: CUDA (the wrapper
module's `_*_cuda`: the ctypes launch with its checks and its launch
counter), CPU (the kernel's plain version) and fake (shapes and dtypes
only, for `torch.export` and the compilers). A graph captured by
`torch.export` holds each kernel as one node, and a program compiled by
AOTInductor calls it through the dispatcher, so the CUDA implementation,
its checks and its counter run as they do eagerly.

The ops are defined with `torch.library.Library(..., "DEF")` and
`impl(..., "CPU" | "CUDA")` rather than `torch.library.custom_op`: the
latter wraps every call in Python of its own (autograd and functional
checks), and the block kernel is launched up to 12 times per forward.

    eet::conformer_block(x, lengths, params[], n_heads, kernel_size,
                         compute_dtype, residual_dtype, attn_softmax_dtype,
                         quantize, d_model=0) -> y
        params: the block layout in `conformer_block.op_params` order;
        the entry (`conformer_block.ENTRIES`) follows the dtypes (by
        name, "bfloat16" or "float32") and quantize ("none" or "int8");
        d_model: the true width of a padded layout (0: x's columns)
    eet::block_gemm(a, w, bias, res?, epilogue, out!) -> ()
    eet::block_gemm_s8(aq, sx, wt, sw, bias, res?, epilogue, out!) -> ()
        `out` is written in place and may be `res`, as in the block
    eet::layer_norm_quantize(x, g, b, eps, d_model=0) -> (q, sx)
    eet::head_argmax(hidden, w, b) -> ids
    eet::fused_attention(q, k, v, mask) -> o

Importing this module (which `ops/kernels/__init__.py` does) registers
the ops; nothing is built until a CUDA implementation first runs.
"""

from __future__ import annotations

import torch

from early_exit_tpu_torch.ops.kernels import attention as katt
from early_exit_tpu_torch.ops.kernels import conformer_block as kcb
from early_exit_tpu_torch.ops.kernels import head_argmax as kha

NAMESPACE = "eet"

_SCHEMAS = {
    "conformer_block": (
        "conformer_block(Tensor x, Tensor lengths, Tensor[] params, int n_heads, "
        "int kernel_size, str compute_dtype, str residual_dtype, "
        "str attn_softmax_dtype, str quantize, int d_model=0) -> Tensor",
        kcb._conformer_block_cpu, kcb._conformer_block_cuda,
        kcb._conformer_block_fake),
    "block_gemm": (
        "block_gemm(Tensor a, Tensor w, Tensor bias, Tensor? res, str epilogue, "
        "Tensor(a!) out) -> ()",
        kcb._block_gemm_cpu, kcb._block_gemm_cuda, lambda *args: None),
    "block_gemm_s8": (
        "block_gemm_s8(Tensor aq, Tensor sx, Tensor wt, Tensor sw, Tensor bias, "
        "Tensor? res, str epilogue, Tensor(a!) out) -> ()",
        kcb._block_gemm_s8_cpu, kcb._block_gemm_s8_cuda, lambda *args: None),
    "layer_norm_quantize": (
        "layer_norm_quantize(Tensor x, Tensor g, Tensor b, float eps, "
        "int d_model=0) -> (Tensor, Tensor)",
        kcb.layer_norm_quantize_plain, kcb._layer_norm_quantize_cuda,
        kcb._layer_norm_quantize_fake),
    "head_argmax": (
        "head_argmax(Tensor hidden, Tensor w, Tensor b) -> Tensor",
        kha.head_argmax_plain, kha._head_argmax_cuda, kha._head_argmax_fake),
    "fused_attention": (
        "fused_attention(Tensor q, Tensor k, Tensor v, Tensor mask) -> Tensor",
        katt.fused_attention_plain, katt._fused_attention_cuda,
        katt._fused_attention_fake),
}
OP_NAMES = tuple(f"{NAMESPACE}::{name}" for name in _SCHEMAS)

LIB = torch.library.Library(NAMESPACE, "DEF")
for _name, (_schema, _cpu, _cuda, _fake) in _SCHEMAS.items():
    LIB.define(_schema)
    LIB.impl(_name, _cpu, "CPU")
    LIB.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{_name}", _fake, lib=LIB)
