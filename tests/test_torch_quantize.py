"""W8A8 quantization: the port's primitives (`nn/core.py`), the W8A8
layout of `fold_block_params` and the unfused block with
`quantize="int8"` against the JAX package, on the same numpy inputs.

Tolerance: the int8 tensors are equal value for value and the scales
within 1e-7 relative (one float32 product each). A W8A8 linear from equal
int8 operands differs only in the float32 rescale (1e-6 relative to the
output's size). Through a whole block a last-place difference in a
LayerNorm output can move one int8 level, about 1/127 of a row's range,
so the block is held to 2e-4 as tests/test_fused_conformer_block.py
holds the W8A8 TPU kernel to the quantized XLA block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from early_exit_tpu.models import conformer as jconf
from early_exit_tpu.nn import core as jnn
from early_exit_tpu.ops.pallas import conformer_block as fcb
from early_exit_tpu_torch import interop
from early_exit_tpu_torch.models.conformer import ConformerConfig, ConformerStack
from early_exit_tpu_torch.nn import core
from early_exit_tpu_torch.ops.kernels import conformer_block as kcb

D, H, FF, K = 32, 4, 64, 7


def _x(seed, shape=(3, 20, D)):
    r = np.random.RandomState(seed)
    x = (r.randn(*shape) * r.uniform(0.1, 4.0, shape[:-1] + (1,))).astype(np.float32)
    rows = x.reshape(-1, shape[-1])
    rows[-1] = 0.0                      # an all-zero row: amax = 0
    rows[0] = 0.0
    rows[0, :5] = [0.5, 1.5, 2.5, -0.5, 127.0]   # exact ties at scale 1
    return x


@pytest.mark.parametrize("axis", [-1, 0])
def test_quantize_int8_matches_jax(axis):
    x = _x(0, (24, D))
    jq, js = jnn.quantize_int8(jnp.asarray(x), axis=axis)
    q, s = core.quantize_int8(torch.from_numpy(x), axis=axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7, atol=0)
    assert int(q.abs().max()) == 127


def test_quantize_int8_rounds_half_to_even_and_survives_zero_rows():
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -1.5, 127.0], [0.0] * 6])
    q, s = core.quantize_int8(x)
    assert q[0].tolist() == [0, 2, 2, 0, -2, 127]
    assert q[1].tolist() == [0] * 6 and float(s[1]) == pytest.approx(1e-8 / 127)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_linear_int8_matches_jax(compute):
    r = np.random.RandomState(1)
    x = _x(1)
    p = {"w": r.randn(D, FF).astype(np.float32) * 0.2,
         "b": r.randn(FF).astype(np.float32)}
    jdt = jnp.bfloat16 if compute == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if compute == "bfloat16" else torch.float32
    ref = jnn.linear(p, jnp.asarray(x), compute_dtype=jdt, quantize="int8")
    got = core.linear(torch.from_numpy(x), torch.from_numpy(p["w"]),
                      torch.from_numpy(p["b"]), compute_dtype=tdt,
                      quantize="int8")
    assert got.dtype == tdt
    ref = np.asarray(ref, np.float32)
    if compute == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    else:                                 # one bf16 rounding of ~equal values
        d = np.abs(got.float().numpy() - ref)
        assert (d <= 2 ** -7 * np.maximum(np.abs(ref), 1.0)).all()
        assert (d > 0).mean() < 0.01
    # and it is the quantized product, not the float one
    plain = core.linear(torch.from_numpy(x), torch.from_numpy(p["w"]),
                        torch.from_numpy(p["b"]), compute_dtype=torch.float32)
    assert float((got.float() - plain).abs().max()) > 1e-3


def _weights(seed=0):
    jcfg = jconf.ConformerConfig(d_model=D, n_heads=H, d_ff=FF, kernel_size=K,
                                 dropout=0.0)
    params, _ = jconf.stack_init(jax.random.PRNGKey(seed), jcfg, 1)
    r = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * r.randn(*a.shape)).astype(np.float32),
        params)
    state = {"conv_bn": {"mean": (0.1 * r.randn(1, D)).astype(np.float32),
                         "var": (1 + 0.5 * r.rand(1, D)).astype(np.float32)}}
    return params, state


def _layer0(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


def test_fold_int8_layout_matches_jax_fold():
    params, state = _weights()
    block = interop.load_stack(
        ConformerStack(ConformerConfig(D, H, FF, K), 1), params, state).blocks[0]
    f = kcb.fold_block_params(block.state_dict(), compute_dtype=torch.float32,
                              quantize="int8")
    jf = dict(zip(fcb.PARAM_ORDER_INT8, fcb.fold_block_params(
        _layer0(params), _layer0(state), compute_dtype=jnp.float32,
        quantize="int8")))
    assert set(kcb.PARAM_ORDER_INT8) <= set(f)
    # q/k/v are one product in the port: per-column scales keep them apart
    jf["wqkv"] = np.concatenate([np.asarray(jf[n]) for n in ("wq", "wk", "wv")], 1)
    jf["wqkv_s"] = np.concatenate(
        [np.asarray(jf[n + "_s"]) for n in ("wq", "wk", "wv")], 1)
    jf["bqkv"] = np.concatenate([np.asarray(jf[n]) for n in ("bq", "bk", "bv")], 1)
    for name, bias in kcb._MATMULS.items():
        assert f[name].dtype == torch.int8
        np.testing.assert_array_equal(f[name].numpy(), np.asarray(jf[name]))
        np.testing.assert_allclose(f[name + "_s"].numpy(),
                                   np.asarray(jf[name + "_s"])[0], rtol=1e-7, atol=0)
        assert torch.equal(f[name + "_t"], f[name].t())
        assert f[name + "_t"].is_contiguous()
        assert f[bias].dtype == torch.float32       # biases stay float32
        np.testing.assert_array_equal(f[bias].numpy(), np.asarray(jf[bias])[0])
    assert f["dw_w"].dtype == torch.float32 and f["dw_w"].shape == (K, D)
    bf = kcb.fold_block_params(block.state_dict(), quantize="int8")
    assert bf["dw_w"].dtype == torch.bfloat16 and bf["ffn1_b1"].dtype == torch.float32
    with pytest.raises(ValueError, match="quantize"):
        kcb.fold_block_params(block.state_dict(), quantize="int4")


@pytest.mark.parametrize("softmax", ["float32", "bfloat16"])
def test_unfused_block_int8_matches_block_apply(softmax):
    kw = dict(d_model=D, n_heads=H, d_ff=FF, kernel_size=K, quantize="int8",
              attn_softmax_dtype=softmax)
    jcfg = jconf.ConformerConfig(dropout=0.0, **kw)
    params, state = _weights(2)
    r = np.random.RandomState(2)
    x = r.randn(4, 50, D).astype(np.float32)
    mask = np.arange(50)[None, :] < np.array([50, 37, 12, 0])[:, None]
    ref, _ = jax.jit(lambda p, s, x, m: jconf.block_apply(
        p, s, x, m, jcfg, train=False))(_layer0(params), _layer0(state),
                                        jnp.asarray(x), jnp.asarray(mask))
    block = interop.load_stack(ConformerStack(ConformerConfig(**kw), 1),
                               params, state).blocks[0]
    got = block(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    ref = np.asarray(ref)
    if softmax == "float32":
        np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-4)
    else:       # bf16 scores: a bf16 ulp of a probability, then LayerNormed
        d = np.abs(got - ref)
        assert d.max() < 0.06 and d.mean() < 0.01, (d.max(), d.mean())
    unq = interop.load_stack(ConformerStack(ConformerConfig(
        **{**kw, "quantize": "none"}), 1), params, state).blocks[0]
    d = np.abs(unq(torch.from_numpy(x), torch.from_numpy(mask)).numpy() - got)
    assert d.max() > 2e-3          # the quantization is really there


def test_kernel_entries_and_the_mixes_that_raise():
    bf, f32 = torch.bfloat16, torch.float32
    assert kcb._entry(bf, bf, bf, None) == "bf16"
    assert kcb._entry(bf, bf, f32, "none") == "bf16"
    assert kcb._entry(bf, bf, bf, "int8") == "w8a8"
    assert kcb._entry(bf, bf, f32, "int8") == "w8a8"
    assert kcb._entry(f32, f32, f32, None) == "f32"
    assert kcb._entry(f32, f32, bf, None) == "f32_sm_bf16"
    assert kcb._entry(bf, f32, f32, None) == "bf16_res_f32"
    assert kcb._entry(bf, f32, bf, "none") == "bf16_res_f32"
    for mix in ((f32, f32, f32, "int8"), (bf, f32, bf, "int8"),
                (f32, bf, f32, None), (f32, bf, bf, None)):
        with pytest.raises(NotImplementedError, match="not ported"):
            kcb._entry(*mix)
    with pytest.raises(ValueError, match="quantize"):
        kcb._entry(bf, bf, bf, "int4")
