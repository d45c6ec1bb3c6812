"""The Conformer block: the kernel's plain PyTorch version against the
TPU kernel (`fused_block_apply(..., interpret=True)`), and the unfused
module against `conformer.block_apply`, on the same numpy weights and
inputs. Small width (d=32, 4 heads, ff 64, k=7), ragged lengths with an
empty item.

Tolerance: float32 at atol 2e-5, rtol 1e-5, as
tests/test_fused_conformer_block.py holds the TPU kernel to the XLA
block. In the bf16 profile (bf16 compute, residual and softmax) the
outputs are LayerNormed (unit scale): the plain version repeats the TPU
kernel op for op and stays within 2^-5 of it, 2^-8 on average: XLA's
CPU backend keeps bf16 elementwise chains in float32 where it fuses
them. With --xla_allow_excess_precision=false the two agree bit for
bit (tests/test_torch_conformer_block_exact.py). The unfused module stays within the bound the JAX test gives
its own fused-vs-XLA pair (0.06, mean 0.01).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from early_exit_tpu.models import conformer as jconf
from early_exit_tpu.ops.pallas import conformer_block as fcb
from early_exit_tpu_torch import interop
from early_exit_tpu_torch.models.conformer import ConformerConfig, ConformerStack
from early_exit_tpu_torch.ops.kernels import conformer_block as kcb

D, H, FF, K = 32, 4, 64, 7


def _cfgs(compute="float32", softmax="float32", fused=False):
    kw = dict(d_model=D, n_heads=H, d_ff=FF, kernel_size=K,
              compute_dtype=compute, residual_dtype=compute,
              attn_softmax_dtype=softmax)
    return (jconf.ConformerConfig(dropout=0.0, **kw),
            ConformerConfig(fused_block=fused, **kw))


def _weights(n_layers, seed=0):
    """Stacked JAX trees with every leaf moved off its init value."""
    jcfg, _ = _cfgs()
    params, _ = jconf.stack_init(jax.random.PRNGKey(seed), jcfg, n_layers)
    r = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * r.randn(*a.shape)).astype(np.float32),
        params)
    state = {"conv_bn": {
        "mean": (0.1 * r.randn(n_layers, D)).astype(np.float32),
        "var": (1 + 0.5 * r.rand(n_layers, D)).astype(np.float32)}}
    return params, state


def _data(B=4, T=50, seed=0):
    r = np.random.RandomState(seed + 100)
    x = r.randn(B, T, D).astype(np.float32)
    lengths = np.array([T, T - 13, T // 4, 0][:B], np.int32)
    mask = np.arange(T)[None, :] < lengths[:, None]
    return x, lengths, mask


def _port_stack(params, state, pcfg, n_layers):
    return interop.load_stack(ConformerStack(pcfg, n_layers), params, state)


def _layer(tree, i):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


def _plain_and_kernel_ref(compute, softmax, quantize=None):
    jcfg, pcfg = _cfgs(compute, softmax)
    params, state = _weights(1)
    x, lengths, _ = _data()
    folded = fcb.fold_block_params(_layer(params, 0), _layer(state, 0),
                                   compute_dtype=jcfg.dtype, quantize=quantize)
    ref = fcb.fused_block_apply(
        folded, jnp.asarray(x), jnp.asarray(lengths), n_heads=H,
        kernel_size=K, compute_dtype=jcfg.dtype, residual_dtype=jcfg.rdtype,
        attn_softmax_dtype=jcfg.sm_dtype, interpret=True, quantize=quantize)
    block = _port_stack(params, state, pcfg, 1).blocks[0]
    f = kcb.fold_block_params(block.state_dict(), compute_dtype=pcfg.dtype,
                              quantize=quantize)
    got = kcb.conformer_block_plain(
        f, torch.from_numpy(x), torch.from_numpy(lengths), n_heads=H,
        kernel_size=K, compute_dtype=pcfg.dtype, residual_dtype=pcfg.rdtype,
        attn_softmax_dtype=pcfg.sm_dtype, quantize=quantize)
    return got.float().numpy(), np.asarray(ref, np.float32)


def test_plain_version_matches_tpu_kernel_fp32():
    got, ref = _plain_and_kernel_ref("float32", "float32")
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
    assert not got[3].any()            # the empty item is all zeros


@pytest.mark.parametrize("softmax", ["bfloat16", "float32"])
def test_plain_version_matches_tpu_kernel_bf16_profile(softmax):
    got, ref = _plain_and_kernel_ref("bfloat16", softmax)
    d = np.abs(got - ref)
    assert np.isfinite(got).all() and not got[3].any()
    assert d.max() <= 2 ** -5 and d.mean() <= 2 ** -8, (d.max(), d.mean())


def test_plain_version_matches_tpu_kernel_int8_fp32():
    """W8A8 in the float32 profile, at the 2e-4 the JAX package holds its
    W8A8 kernel to (a last-place difference before a quantization can
    move one int8 level)."""
    got, ref = _plain_and_kernel_ref("float32", "float32", "int8")
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-4)
    assert not got[3].any()
    unq, _ = _plain_and_kernel_ref("float32", "float32")
    assert np.abs(unq - got).max() > 2e-3       # it is the quantized block


@pytest.mark.parametrize("softmax", ["bfloat16", "float32"])
def test_plain_version_matches_tpu_kernel_int8_bf16_profile(softmax):
    """W8A8 in the bf16 profile, the mix the CUDA kernel takes. The mean
    bound is the unquantized bf16 profile's above; the largest difference
    may be twice that one's, 2^-4: where XLA's float32 elementwise chains
    move a value across a rounding boundary, one int8 level (1/127 of the
    row's range) moves with it."""
    got, ref = _plain_and_kernel_ref("bfloat16", softmax, "int8")
    d = np.abs(got - ref)
    assert np.isfinite(got).all() and not got[3].any()
    assert d.max() <= 2 ** -4 and d.mean() <= 2 ** -8, (d.max(), d.mean())


def test_fused_stack_int8_matches_jax_fused_stack():
    """3 layers through the fused dispatch with quantize="int8". One
    block alone agrees to 2e-4 (above). Over three, a last-place
    difference that moves one int8 level in an early layer (1/127 of a
    row's range) is quantized again by every later product, so the stack
    is held to: 90% of values within 5e-4, none beyond 0.05."""
    import dataclasses
    jcfg, pcfg = _cfgs(fused=True)
    jcfg = dataclasses.replace(jcfg, quantize="int8", fused_block=True)
    pcfg = dataclasses.replace(pcfg, quantize="int8")
    params, state = _weights(3, seed=4)
    x, lengths, mask = _data(seed=4)
    want, _ = fcb.fused_stack_apply(params, state, jnp.asarray(x),
                                    jnp.asarray(lengths), jcfg, interpret=True)
    stack = _port_stack(params, state, pcfg, 3)
    got = stack(torch.from_numpy(x), torch.from_numpy(mask))
    d = np.abs(got.numpy() - np.asarray(want))
    assert (d <= 5e-4).mean() >= 0.9 and d.max() <= 0.05, ((d <= 5e-4).mean(), d.max())
    assert stack.folded()[0]["ffn1_w1"].dtype == torch.int8


@pytest.mark.parametrize("fused", [False, True])
def test_stack_layer_range_resumes_the_trunk(fused):
    """Layers 0..1 then 2..3 from the cached hidden equal one run of 0..3,
    and the range's collected outputs are those of the full run."""
    _, pcfg = _cfgs(fused=fused)
    params, state = _weights(4, seed=5)
    x, _, mask = _data(seed=5)
    stack = _port_stack(params, state, pcfg, 4)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    y, outs = stack(xt, mt, collect_outputs=True)
    h2 = stack(xt, mt, n_layers=2)
    y2, outs2 = stack(h2, mt, first_layer=2, n_layers=4, collect_outputs=True)
    assert torch.equal(h2, outs[1]) and torch.equal(y2, y)
    assert torch.equal(outs2, outs[2:])
    with pytest.raises(ValueError, match="layers"):
        stack(xt, mt, first_layer=3, n_layers=2)


def test_folded_layout_follows_the_configuration():
    import dataclasses
    _, pcfg = _cfgs(fused=True)
    params, state = _weights(1)
    stack = _port_stack(params, state, pcfg, 1)
    f = stack.folded()
    assert stack.folded() is f and f[0]["ffn1_w1"].dtype == torch.float32
    stack.cfg = dataclasses.replace(pcfg, quantize="int8")
    assert stack.folded()[0]["ffn1_w1"].dtype == torch.int8
    stack.cfg = dataclasses.replace(pcfg, compute_dtype="bfloat16")
    assert stack.folded()[0]["ffn1_w1"].dtype == torch.bfloat16


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_unfused_module_matches_block_apply(compute):
    jcfg, pcfg = _cfgs(compute, compute)
    params, state = _weights(1, seed=1)
    x, lengths, mask = _data(seed=1)
    ref, _ = jax.jit(lambda p, s, x, m: jconf.block_apply(
        p, s, x, m, jcfg, train=False))(_layer(params, 0), _layer(state, 0),
                                        jnp.asarray(x), jnp.asarray(mask))
    block = _port_stack(params, state, pcfg, 1).blocks[0]
    got = block(torch.from_numpy(x), torch.from_numpy(mask)).float().numpy()
    ref = np.asarray(ref, np.float32)
    if compute == "float32":
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
    else:
        d = np.abs(got - ref)
        assert d.max() < 0.06 and d.mean() < 0.01, (d.max(), d.mean())


@pytest.mark.parametrize("fused", [False, True])
def test_stack_collect_every_two(fused):
    """4 layers, collect_every=2: the port's stack (unfused, or the fused
    dispatch, which takes the plain version on the CPU) against the JAX
    XLA stack and the JAX fused stack in interpret mode."""
    jcfg, pcfg = _cfgs(fused=fused)
    params, state = _weights(4, seed=2)
    x, lengths, mask = _data(seed=2)
    if fused:
        _, _, want = fcb.fused_stack_apply(params, state, jnp.asarray(x),
                                           jnp.asarray(lengths), jcfg,
                                           collect_outputs=True,
                                           collect_every=2, interpret=True)
    else:
        _, _, want = jax.jit(lambda p, s, x, m: jconf.stack_apply(
            p, s, x, m, jcfg, train=False, collect_outputs=True,
            collect_every=2))(params, state, jnp.asarray(x), jnp.asarray(mask))
    stack = _port_stack(params, state, pcfg, 4)
    y, outs = stack(torch.from_numpy(x), torch.from_numpy(mask),
                    collect_outputs=True, collect_every=2)
    assert tuple(outs.shape) == (2, 4, 50, D)
    assert torch.equal(outs[-1], y)
    np.testing.assert_allclose(outs.numpy(), np.asarray(want), atol=5e-5,
                               rtol=1e-4)


def test_cpu_wrapper_is_the_plain_version_and_counts_nothing():
    _, pcfg = _cfgs()
    params, state = _weights(1)
    x, lengths, _ = _data()
    f = kcb.fold_block_params(
        _port_stack(params, state, pcfg, 1).blocks[0].state_dict(),
        compute_dtype=torch.float32)
    kw = dict(n_heads=H, kernel_size=K, compute_dtype=torch.float32,
              residual_dtype=torch.float32)
    before = kcb.conformer_block.launches
    a = kcb.conformer_block(f, torch.from_numpy(x), torch.from_numpy(lengths), **kw)
    b = kcb.conformer_block_plain(f, torch.from_numpy(x),
                                  torch.from_numpy(lengths), **kw)
    assert torch.equal(a, b)
    assert kcb.conformer_block.launches == before


def test_fold_layout():
    _, pcfg = _cfgs()
    params, state = _weights(1)
    block = _port_stack(params, state, pcfg, 1).blocks[0]
    f = kcb.fold_block_params(block.state_dict())
    assert set(f) == set(kcb.PARAM_ORDER)
    assert f["wqkv"].shape == (D, 3 * D) and f["wqkv"].dtype == torch.bfloat16
    assert f["dw_w"].shape == (K, D)
    assert f["bn_scale"].dtype == torch.float32
    jf = dict(zip(fcb.PARAM_ORDER, fcb.fold_block_params(
        _layer(params, 0), _layer(state, 0), compute_dtype=jnp.float32)))
    f32 = kcb.fold_block_params(block.state_dict(), compute_dtype=torch.float32)
    for name in ("bn_scale", "bn_shift"):
        np.testing.assert_allclose(f32[name].numpy(), np.asarray(jf[name])[0],
                                   rtol=1e-6)
    np.testing.assert_array_equal(
        f32["wqkv"].numpy(),
        np.concatenate([np.asarray(jf[n]) for n in ("wq", "wk", "wv")], 1))


@pytest.mark.parametrize("T", [50, 600])
def test_fused_dispatch_off_the_cpu_always_calls_the_kernel(T, monkeypatch):
    """Off the CPU the fused stack hands every block to the kernel's
    wrapper at any T', past the TPU kernel's 512 too (meta tensors stand
    in for the card: the wrapper is recorded, not run)."""
    _, pcfg = _cfgs(fused=True)
    params, state = _weights(2)
    stack = _port_stack(params, state, pcfg, 2)
    calls = []

    def wrapper(f, h, lengths, **kw):
        calls.append((h.device.type, tuple(h.shape)))
        return torch.empty_like(h)

    monkeypatch.setattr(kcb, "conformer_block", wrapper)
    x = torch.empty(2, T, D, device="meta")
    mask = torch.ones(2, T, dtype=torch.bool, device="meta")
    stack(x, mask)
    assert calls == [("meta", (2, T, D))] * 2


def test_fused_dispatch_on_the_cpu_past_512_is_the_unfused_stack():
    """On the CPU, T' > 512 takes the unfused blocks, as the JAX
    dispatch does."""
    _, pcfg = _cfgs(fused=True)
    _, ucfg = _cfgs(fused=False)
    params, state = _weights(1, seed=3)
    x = torch.from_numpy(np.random.RandomState(3).randn(1, 520, D)
                         .astype(np.float32))
    mask = torch.arange(520)[None, :] < 500
    got = _port_stack(params, state, pcfg, 1)(x, mask)
    want = _port_stack(params, state, ucfg, 1)(x, mask)
    assert torch.equal(got, want)
