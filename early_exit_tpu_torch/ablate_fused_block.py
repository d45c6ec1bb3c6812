"""Time the bf16 Conformer block with parts taken out (counterpart of
`tools/ablate_fused_block.py`).

    python -m early_exit_tpu_torch.ablate_fused_block [--device cuda]
        [--batch 128] [--frames 249] [--d_model 256] [--heads 8]
        [--ffn 2048] [--kernel 31] [--layers 12] [--iters 30]

A stack of --layers blocks (random weights in the kernel's layout, bf16
profile with the bf16 softmax) is timed as a whole with CUDA events, once
in full and once with each entry of ABLATIONS taken out
(`kcb.conformer_block_ablate`: on the card the ablation library, which is
`csrc/conformer_block.cu` built with -DEET_ABLATE; on the CPU the plain
version with the same `ablate`); each line gives the time saved against
the full stack. The port's block is a chain of launches (LayerNorm,
GEMMs, attention, conv module), so "attn", "conv" and "ffn" drop whole
launches; the others swap a kernel for its variant. The outputs of an
ablated block are not the block's: the times only.
"""

from __future__ import annotations

import argparse
import json

import torch

from early_exit_tpu_torch import runtime
from early_exit_tpu_torch.ops.kernels import conformer_block as kcb
from early_exit_tpu_torch.ops.kernels import launch_counts
from early_exit_tpu_torch.utils.timing import device_ms

ABLATIONS = [
    (),                                           # the full block
    ("ln",),                                      # LayerNorm: scale and shift only
    ("ln2p",),                                    # LayerNorm: centred two-pass stats
    ("softmax",),                                 # P = the scores
    ("silu",),                                    # FFN and conv SiLU: identity
    ("glu",),                                     # GLU gate: a passes through
    ("dwconv",),                                  # depthwise conv: identity
    ("attn",),                                    # the whole MHSA module
    ("conv",),                                    # the whole conv module
    ("ffn",),                                     # both half-FFNs
    ("ln", "softmax", "silu", "glu", "dwconv"),   # all the elementwise parts
]

# what each ablation does to the port's chain of launches
NOTES = {
    "ln": "5 LayerNorm launches without statistics (one read of x, not two)",
    "ln2p": "5 LayerNorm launches with a third pass over the row; the port's "
            "LayerNorm already reads each row twice (one-pass statistics, then "
            "the normalisation), as the TPU kernel's one-pass form",
    "softmax": "attention: the max and sum passes over the keys not run",
    "silu": "the W1 GEMMs' epilogue without SiLU; the conv module without it",
    "glu": "the conv module without the sigmoid gate",
    "dwconv": "the conv module without its depthwise taps",
    "attn": "4 launches fewer a block (LayerNorm, QKV GEMM, attention, Wo GEMM)",
    "conv": "4 launches fewer a block (LayerNorm, PW1 GEMM, conv module, PW2 GEMM)",
    "ffn": "6 launches fewer a block, one device copy more",
}


def make_folded(gen: torch.Generator, D: int, F: int, K: int, device) -> dict:
    """Random weights in the bf16 kernel layout (`kcb.PARAM_ORDER`): the
    products and their biases bf16, N(0, 0.02); LayerNorm, depthwise
    bias and folded BatchNorm rows float32, N(0, 0.02) (shapes matter, not
    values)."""
    shapes = {"ffn1_w1": (D, F), "ffn1_b1": (F,), "ffn1_w2": (F, D),
              "ffn2_w1": (D, F), "ffn2_b1": (F,), "ffn2_w2": (F, D),
              "wqkv": (D, 3 * D), "bqkv": (3 * D,), "wo": (D, D),
              "pw1_w": (D, 2 * D), "pw1_b": (2 * D,), "pw2_w": (D, D), "dw_w": (K, D)}
    out = {}
    for name in kcb.PARAM_ORDER:
        t = 0.02 * torch.randn(shapes.get(name, (D,)), generator=gen)
        f32 = "_ln_" in name or name in ("dw_b", "bn_scale", "bn_shift")
        out[name] = t.to(torch.float32 if f32 else torch.bfloat16).to(device).contiguous()
    return out


def stack_fn(folded, x, lengths, n_layers, ablate, kw):
    def run():
        y = x
        for _ in range(n_layers):
            y = kcb.conformer_block_ablate(folded, y, lengths, ablate=ablate, **kw)
        return y
    return run


def run(device, B, T, D, H, F, K, n_layers, iters, seed=0, out=print):
    """{ablation tuple: ms of the stack}; prints each line."""
    gen = torch.Generator().manual_seed(seed)
    folded = make_folded(gen, D, F, K, device)
    x = torch.randn(B, T, D, generator=gen).to(torch.bfloat16).to(device)
    lengths = torch.full((B,), T, dtype=torch.int32, device=device)
    kw = dict(n_heads=H, kernel_size=K, attn_softmax_dtype=torch.bfloat16)
    times = {}
    with torch.no_grad():
        for ab in ABLATIONS:
            ms = device_ms(stack_fn(folded, x, lengths, n_layers, ab, kw), device,
                           iters=iters)
            times[ab] = ms
            if not ab:
                out(f"{'FULL':38s} {ms:8.3f} ms")
                continue
            note = "; ".join(NOTES[a] for a in ab) if len(ab) == 1 else "all five at once"
            out(f"-{','.join(ab):37s} {ms:8.3f} ms  (saves {times[()] - ms:7.3f})  [{note}]")
    return times


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--frames", type=int, default=249)
    ap.add_argument("--d_model", type=int, default=256)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--ffn", type=int, default=2048)
    ap.add_argument("--kernel", type=int, default=31)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--iters", type=int, default=30)
    a = ap.parse_args(argv)
    dev = runtime.resolve_device(a.device)
    print(f"{a.layers} bf16 blocks at (B={a.batch}, T'={a.frames}, D={a.d_model}, "
          f"h={a.heads}, ffn {a.ffn}, k={a.kernel}) on {dev}")
    run(dev, a.batch, a.frames, a.d_model, a.heads, a.ffn, a.kernel, a.layers, a.iters)
    print(f"launches: {json.dumps(launch_counts())}")


if __name__ == "__main__":
    main()
