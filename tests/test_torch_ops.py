"""The kernels as `torch.library` ops (`ops/kernels/library.py`).

Each op passes `torch.library.opcheck` on the CPU at small shapes: its
schema (mutation and aliasing as declared), its fake implementation
against the CPU one (the kernel's plain version), and its capture under
AOTAutograd with dynamic shapes. The wrappers call the ops, and the
block op's `params` list round-trips the layout in either order.
"""

import numpy as np
import pytest
import torch

from early_exit_tpu_torch.models.conformer import ConformerBlock, ConformerConfig
from early_exit_tpu_torch.ops.kernels import conformer_block as kcb
from early_exit_tpu_torch.ops.kernels import library

D, H, F, K = 32, 4, 64, 7
B, T = 2, 9


def _layout(quantize=None):
    cfg = ConformerConfig(d_model=D, n_heads=H, d_ff=F, kernel_size=K)
    blk = ConformerBlock(cfg)
    blk.init(torch.Generator().manual_seed(0))
    return kcb.fold_block_params(blk.state_dict(), compute_dtype=torch.bfloat16,
                                 quantize=quantize)


def _rand(*shape, dtype=torch.float32, seed=0):
    r = np.random.RandomState(seed)
    return torch.from_numpy(r.randn(*shape).astype(np.float32)).to(dtype)


def _cases():
    x = _rand(B, T, D, dtype=torch.bfloat16)
    lengths = torch.tensor([T, 5], dtype=torch.int32)
    block = [("conformer_block", (x, lengths, kcb.op_params(_layout()), H, K,
                                  "bfloat16", "bfloat16", "float32", "none")),
             ("conformer_block", (x, lengths, kcb.op_params(_layout("int8"), "int8"),
                                  H, K, "bfloat16", "bfloat16", "bfloat16", "int8"))]
    bf = torch.bfloat16
    a, w = _rand(5, 16, dtype=bf), _rand(16, 24, dtype=bf, seed=1)
    bias, res = _rand(24, dtype=bf, seed=2), _rand(5, 24, dtype=bf, seed=3)
    aq = torch.randint(-127, 128, (5, 16), dtype=torch.int8,
                       generator=torch.Generator().manual_seed(4))
    wt = torch.randint(-127, 128, (24, 16), dtype=torch.int8,
                       generator=torch.Generator().manual_seed(5))
    sx, sw = _rand(5, seed=6).abs() + 0.1, _rand(24, seed=7).abs() + 0.1
    e, v = 3, 16
    return block + [
        ("block_gemm", (a, w, bias, None, "silu", torch.empty(5, 24, dtype=bf))),
        ("block_gemm", (a, w, bias, res, "res_half", torch.empty(5, 24, dtype=bf))),
        ("block_gemm_s8", (aq, sx, wt, sw, bias.float(), res, "res",
                           torch.empty(5, 24, dtype=bf))),
        ("layer_norm_quantize", (_rand(6, 64, dtype=bf), _rand(64, seed=1),
                                 _rand(64, seed=2), 1e-5)),
        ("head_argmax", (_rand(e, B, T, 64, dtype=bf), _rand(e, 64, v, dtype=bf, seed=1),
                         _rand(e, v, dtype=bf, seed=2))),
        ("fused_attention", (_rand(B, H, T, 8), _rand(B, H, T, 8, seed=1),
                             _rand(B, H, T, 8, seed=2),
                             torch.arange(T)[None, :] < lengths[:, None])),
    ]


@pytest.mark.parametrize("i", range(len(_cases())),
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(_cases())])
def test_opcheck(i):
    name, args = _cases()[i]
    torch.library.opcheck(getattr(torch.ops.eet, name).default, args)


def test_every_c_entry_is_an_op_with_cpu_cuda_and_fake_kernels():
    assert set(library.OP_NAMES) == {
        "eet::conformer_block", "eet::block_gemm", "eet::block_gemm_s8",
        "eet::layer_norm_quantize", "eet::head_argmax", "eet::fused_attention"}
    for name in library.OP_NAMES:
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(name, key), (name, key)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_op_params_round_trip(quantize):
    f = _layout(quantize)
    params = kcb.op_params(f, quantize)
    assert len(params) == len(kcb.OP_ORDER_INT8 if quantize else kcb.PARAM_ORDER)
    back = kcb._layout(params, quantize or "none")
    for name in kcb.PARAM_ORDER:
        assert torch.equal(back[name], f[name]), name
    if quantize:
        for name in kcb._MATMULS:
            assert torch.equal(back[name + "_t"], f[name + "_t"])
            assert torch.equal(back[name + "_s"], f[name + "_s"])


def test_the_block_wrapper_is_one_op_node_under_export():
    f = _layout()

    class One(torch.nn.Module):
        def forward(self, x, lengths):
            return kcb.conformer_block(f, x, lengths, n_heads=H, kernel_size=K)

    x = _rand(B, T, D, dtype=torch.bfloat16)
    lengths = torch.tensor([T, 5], dtype=torch.int32)
    ep = torch.export.export(One(), (x, lengths), strict=False)
    targets = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    assert targets.count(torch.ops.eet.conformer_block.default) == 1
    assert torch.equal(ep.module()(x, lengths), One()(x, lengths))
    # the CPU implementation is the plain version, and counts no launch
    before = kcb.conformer_block.launches
    assert torch.equal(One()(x, lengths),
                       kcb.conformer_block_plain(f, x, lengths, n_heads=H,
                                                 kernel_size=K))
    assert kcb.conformer_block.launches == before


def test_the_block_wrapper_copies_into_out():
    f = _layout()
    x = _rand(B, T, D, dtype=torch.bfloat16)
    lengths = torch.tensor([T, 5], dtype=torch.int32)
    out = torch.empty_like(x)
    y = kcb.conformer_block(f, x, lengths, n_heads=H, kernel_size=K, out=out)
    assert y is out
    assert torch.equal(out, kcb.conformer_block_plain(f, x, lengths, n_heads=H,
                                                      kernel_size=K))
