"""Per-exit head + frame argmax kernel (CUDA, `csrc/head_argmax.cu`) and
its plain PyTorch version.

Replaces `early_exit_tpu/ops/pallas/head_argmax.py::head_argmax` (body
`_kernel`): per exit, a bf16 product with float32 accumulation, rounded
to bf16, plus the bf16 bias, then the argmax with the lowest index
winning ties. Only the (E, B, T) int32 ids are written. Its bound and
design notes are in the source. The wrapper calls the op
`eet::head_argmax` (`ops/kernels/library.py`): the plain version on the
CPU, the launch (`_head_argmax_cuda`) on CUDA.
"""

from __future__ import annotations

import ctypes

import torch

from early_exit_tpu_torch.ops.kernels import _build

def head_argmax_plain(hidden: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """hidden (E, B, T, D), w (E, D, V), b (E, V) -> ids (E, B, T) int32."""
    E, B, T, D = hidden.shape
    V = w.shape[-1]
    h = hidden.to(torch.bfloat16).float().reshape(E, B * T, D)
    logits = torch.matmul(h, w.to(torch.bfloat16).float()).to(torch.bfloat16)
    logits = (logits + b.to(torch.bfloat16)[:, None, :]).float()
    m = logits.amax(-1, keepdim=True)
    iota = torch.arange(V, device=hidden.device)
    ids = torch.where(logits == m, iota, V).amin(-1)
    return ids.to(torch.int32).reshape(E, B, T)


def head_argmax(hidden: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """hidden (E, B, T, D), w (E, D, V), b (E, V) -> ids (E, B, T) int32.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (bf16 operands, any V >= 1 and any D: the head stays in shared
    memory where it fits, V <= 256 and D <= 256, streams through it in
    tiles of 256 columns up to D 512, and in tiles of 64 k beside the
    hidden rows' past it) or raises."""
    if hidden.device.type not in ("cpu", "cuda"):
        raise ValueError(f"head_argmax: unsupported device {hidden.device}")
    return torch.ops.eet.head_argmax(hidden, w, b)


def _head_argmax_fake(hidden, w, b):
    return hidden.new_empty(hidden.shape[:3], dtype=torch.int32)


def _head_argmax_cuda(hidden, w, b):
    E, B, T, D = hidden.shape
    V = w.shape[-1] if w.dim() == 3 else 0
    dev = hidden.device
    want = {"hidden": (hidden, (E, B, T, D)), "w": (w, (E, D, V)),
            "b": (b, (E, V))}
    for name, (t, shape) in want.items():
        if (t.device != dev or t.dtype != torch.bfloat16
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"head_argmax kernel: {name} must be a contiguous bf16 tensor "
                f"of shape {shape} on {dev}; got {t.dtype} {tuple(t.shape)} "
                f"on {t.device}")
    if D < 1 or V < 1:
        raise ValueError(f"head_argmax kernel needs D >= 1 and V >= 1, got D={D} V={V}")
    # TMA reads rows of a multiple of 16 bytes: copies with V padded to a
    # multiple of 8 columns, which the kernel masks, and D to a multiple of
    # 8 with zero hidden values and zero head rows, which add nothing
    Vp, Dp = -(-V // 8) * 8, -(-D // 8) * 8
    if Dp != D:
        hidden = torch.nn.functional.pad(hidden, (0, Dp - D))
        w = torch.nn.functional.pad(w, (0, 0, 0, Dp - D))
    if Vp != V:
        w = torch.nn.functional.pad(w, (0, Vp - V))
        b = torch.nn.functional.pad(b, (0, Vp - V))
    out = torch.empty(E, B, T, dtype=torch.int32, device=dev)
    lib = _lib()
    err = lib.eet_head_argmax_bf16(_build.ptr(hidden), _build.ptr(w),
                                   _build.ptr(b), _build.ptr(out), E, B * T,
                                   Dp, V, Vp, _build.stream_ptr(dev))
    _build.check(lib, err, "head_argmax kernel")
    head_argmax.launches += 1
    return out


head_argmax.launches = 0


def _lib():
    lib = _build.load("head_argmax")
    fn = lib.eet_head_argmax_bf16
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, vp]
        fn.restype = i
    return lib
