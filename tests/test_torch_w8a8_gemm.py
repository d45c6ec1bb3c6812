"""The W8A8 block's int8 product (`block_gemm_s8`) and its LayerNorm +
quantize (`layer_norm_quantize`), their plain versions against the JAX
package's int8 arithmetic, on the same numpy inputs: small widths, a
ragged row count, rows with exact .5 ties and an all-zero row.

Tolerances: the product is held equal after the bf16 rounding. Its int32
sums are exact on both sides, the rescale and the bias are one float32
product and one sum each, and the epilogue runs op by op in bf16 (JAX
eagerly, so that XLA keeps no float32 excess between the ops). The
LayerNorm + quantize is held to int8 values equal value for value and
scales within 1e-6 relative. The JAX side is `layer_norm`, with two-pass
statistics; the plain version repeats the kernel's one-pass statistics,
as the TPU kernel takes them. Their float32 outputs differ in the last
places (up to 3.6e-7 relative in a row's absmax, hence the scales' 1e-6
where `quantize_int8` alone is held to 1e-7), which moves an int8 value
only where it lies that close to a rounding tie: none does at these
seeds, the nearest at 6.1e-5 of a level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from early_exit_tpu.nn import core as jnn
from early_exit_tpu_torch.nn import core
from early_exit_tpu_torch.ops.kernels import conformer_block as kcb

M, K, N = 37, 64, 48


def _x(seed, shape):
    r = np.random.RandomState(seed)
    x = (r.randn(*shape) * r.uniform(0.1, 4.0, shape[:-1] + (1,))).astype(np.float32)
    x[-1] = 0.0                         # an all-zero row: amax = 0
    x[0] = 0.0
    x[0, :5] = [0.5, 1.5, 2.5, -0.5, 127.0]   # exact ties at scale 1
    return x


def _jax_epilogue(y, res, epilogue):
    """bf16 y (and res) -> the epilogue op by op in bf16, eagerly."""
    if epilogue == "silu":
        return y / (jnp.asarray(1, jnp.bfloat16) + jnp.exp(-y))
    if epilogue == "res":
        return (res.astype(jnp.float32) + y.astype(jnp.float32)).astype(jnp.bfloat16)
    if epilogue == "res_half":
        return (res.astype(jnp.float32) + 0.5 * y.astype(jnp.float32)).astype(jnp.bfloat16)
    return y


@pytest.mark.parametrize("epilogue", kcb.GEMM_EPILOGUES)
def test_block_gemm_s8_plain_matches_jax_int8_product(epilogue):
    r = np.random.RandomState(4)
    x = _x(4, (M, K))
    w = (r.randn(K, N) * 0.2).astype(np.float32)
    w[:, 0] = 0.0                       # an all-zero weight column
    bias = r.randn(N).astype(np.float32)
    res = np.array(jnp.asarray(r.randn(M, N), jnp.bfloat16).astype(jnp.float32))
    with jax.disable_jit():
        xq, _ = jnn.quantize_int8(jnp.asarray(x))
        y = jnn._linear_int8({"w": jnp.asarray(w), "b": jnp.asarray(bias)},
                             jnp.asarray(x), compute_dtype=jnp.bfloat16)
        ref = _jax_epilogue(y, jnp.asarray(res, jnp.bfloat16), epilogue)
    ref = np.asarray(ref.astype(jnp.float32))

    tq, tsx = core.quantize_int8(torch.from_numpy(x))
    tw, tsw = core.quantize_int8(torch.from_numpy(w), axis=0)
    assert torch.equal(tq, torch.from_numpy(np.array(xq)))
    t_res = torch.from_numpy(res).to(torch.bfloat16) if epilogue.startswith("res") else None
    got = kcb.block_gemm_s8_plain(tq, tsx[:, 0], tw.t().contiguous(), tsw[0],
                                  torch.from_numpy(bias), t_res, epilogue)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    np.testing.assert_array_equal(got.float().numpy(), ref)
    # and it is the quantized product, not the float one
    plain = kcb.block_gemm_plain(torch.from_numpy(x).to(torch.bfloat16),
                                 torch.from_numpy(w).to(torch.bfloat16),
                                 torch.from_numpy(bias).to(torch.bfloat16), t_res, epilogue)
    assert not torch.equal(got, plain)


@pytest.mark.parametrize("D", [32, 256, 512])    # lanes past D / 8 idle; every lane, the flagship's D; two chunks a lane
def test_layer_norm_quantize_plain_matches_jax(D):
    r = np.random.RandomState(D)
    x = np.array(jnp.asarray(_x(D, (M, D)), jnp.bfloat16).astype(jnp.float32))
    g = (1 + 0.3 * r.randn(D)).astype(np.float32)
    b = (0.2 * r.randn(D)).astype(np.float32)
    ln = jnn.layer_norm({"g": jnp.asarray(g), "b": jnp.asarray(b)}, jnp.asarray(x))
    jq, js = jnn.quantize_int8(ln)
    q, sx = kcb.layer_norm_quantize_plain(torch.from_numpy(x).to(torch.bfloat16),
                                          torch.from_numpy(g), torch.from_numpy(b))
    assert q.dtype == torch.int8 and sx.dtype == torch.float32 and sx.shape == (M,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(sx.numpy(), np.asarray(js)[:, 0], rtol=1e-6, atol=0)
    # the all-zero row: LayerNorm gives b, quantized
    np.testing.assert_array_equal(q[-1].numpy(), np.asarray(jq)[-1])


def test_cpu_wrappers_are_the_plain_versions_and_launch_nothing():
    r = np.random.RandomState(9)
    aq = torch.from_numpy(r.randint(-127, 128, (M, K)).astype(np.int8))
    wt = torch.from_numpy(r.randint(-127, 128, (N, K)).astype(np.int8))
    sx = torch.from_numpy(r.uniform(1e-3, 1e-1, M).astype(np.float32))
    sw = torch.from_numpy(r.uniform(1e-3, 1e-1, N).astype(np.float32))
    bias = torch.from_numpy(r.randn(N).astype(np.float32))
    res = torch.from_numpy(r.randn(M, N).astype(np.float32)).to(torch.bfloat16)
    x = torch.from_numpy(_x(9, (M, K))).to(torch.bfloat16)
    g, b = torch.ones(K), torch.zeros(K)
    n_gemm, n_ln = kcb.block_gemm_s8.launches, kcb.layer_norm_quantize.launches
    for epilogue in kcb.GEMM_EPILOGUES:
        rr = res.clone() if epilogue.startswith("res") else None
        want = kcb.block_gemm_s8_plain(aq, sx, wt, sw, bias, rr, epilogue)
        got = kcb.block_gemm_s8(aq, sx, wt, sw, bias, rr, epilogue, out=rr)
        assert torch.equal(got, want)
        if rr is not None:
            assert got is rr               # in place, as the block runs it
    q, s = kcb.layer_norm_quantize(x, g, b)
    q_p, s_p = kcb.layer_norm_quantize_plain(x, g, b)
    assert torch.equal(q, q_p) and torch.equal(s, s_p)
    assert kcb.block_gemm_s8.launches == n_gemm
    assert kcb.layer_norm_quantize.launches == n_ln
    with pytest.raises(ValueError, match="epilogue"):
        kcb.block_gemm_s8(aq, sx, wt, sw, bias, None, "gelu")
    with pytest.raises(ValueError, match="res"):
        kcb.block_gemm_s8(aq, sx, wt, sw, bias, None, "res")
