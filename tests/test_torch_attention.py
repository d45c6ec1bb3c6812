"""The attention kernel's plain PyTorch version and the block around it
against the TPU kernel in interpret mode (`fused_attention`,
`mha_pallas`), and the unfused block with `attention_impl="pallas"`
against `conformer.block_apply`, on the same numpy inputs. Small width
(4 heads of 8, T=40), ragged lengths with an empty item.

Tolerance 1e-5 absolute: float32 throughout on both sides (bf16 inputs
are upcast first), the sums of 8 and of 40 terms run in another order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from early_exit_tpu.models import conformer as jconf
from early_exit_tpu.nn import core as jnn
from early_exit_tpu.ops.pallas import attention as pattn
from early_exit_tpu_torch import interop
from early_exit_tpu_torch.models.conformer import ConformerConfig, ConformerStack
from early_exit_tpu_torch.ops.kernels import attention as katt

B, H, T, DH = 4, 4, 40, 8
D = H * DH
LENGTHS = np.array([T, T - 11, 5, 0])
MASK = np.arange(T)[None, :] < LENGTHS[:, None]
ATOL = 1e-5


def _qkv(seed, dtype):
    r = np.random.RandomState(seed)
    q, k, v = (r.randn(B, H, T, DH).astype(np.float32) for _ in range(3))
    if dtype == "bfloat16":      # the same bf16 values on both sides
        q, k, v = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                   for a in (q, k, v))
    return q, k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_tpu_kernel(dtype):
    q, k, v = _qkv(0, dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = pattn.fused_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                jnp.asarray(MASK), interpret=True)
    got = katt.fused_attention_plain(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), torch.from_numpy(MASK))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, T, DH)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_fully_masked_item_gives_the_mean_of_v():
    q, k, v = _qkv(1, "float32")
    got = katt.fused_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                     torch.from_numpy(MASK)).numpy()
    assert np.isfinite(got).all()
    want = np.broadcast_to(v[3].mean(axis=1, keepdims=True), got[3].shape)
    np.testing.assert_allclose(got[3], want, atol=1e-6, rtol=0)


def test_cpu_wrapper_is_the_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, "float32"))
    before = katt.fused_attention.launches
    a = katt.fused_attention(q, k, v, torch.from_numpy(MASK))
    assert torch.equal(a, katt.fused_attention_plain(q, k, v, torch.from_numpy(MASK)))
    assert katt.fused_attention.launches == before


def _mha_params(seed):
    p = jnn.mha_init(jax.random.PRNGKey(seed), D)
    r = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * r.randn(*a.shape)).astype(np.float32), p)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_mha_fused_matches_mha_pallas(compute):
    """bf16 projections round at the same points on both sides; the o
    projection's bf16 output is held to one bf16 ulp at its size."""
    p = _mha_params(3)
    x = np.random.RandomState(3).randn(B, T, D).astype(np.float32)
    jdt = jnp.bfloat16 if compute == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if compute == "bfloat16" else torch.float32
    ref = pattn.mha_pallas(p, jnp.asarray(x), H, key_mask=jnp.asarray(MASK),
                           compute_dtype=jdt, interpret=True)
    tp = {n: (torch.from_numpy(p[n]["w"]), torch.from_numpy(p[n]["b"]))
          for n in ("q", "k", "v", "o")}
    got = katt.mha_fused(tp, torch.from_numpy(x), H,
                         key_mask=torch.from_numpy(MASK), compute_dtype=tdt)
    assert got.dtype == tdt
    atol = ATOL if compute == "float32" else 2 ** -6
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("softmax", ["float32", "bfloat16"])
def test_block_with_attention_kernel_matches_block_apply(softmax, monkeypatch):
    """`attention_impl="pallas"`: float32 softmax whatever the configured
    softmax dtype. The JAX block reaches its kernel in interpret mode."""
    monkeypatch.setattr(pattn, "mha_pallas",
                        functools.partial(pattn.mha_pallas, interpret=True))
    kw = dict(d_model=D, n_heads=H, d_ff=64, kernel_size=7,
              attn_softmax_dtype=softmax, attention_impl="pallas")
    jcfg = jconf.ConformerConfig(dropout=0.0, **kw)
    params, state = jconf.stack_init(jax.random.PRNGKey(4), jcfg, 1)
    r = np.random.RandomState(4)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * r.randn(*a.shape)).astype(np.float32),
        params)
    x = r.randn(B, T, D).astype(np.float32)
    ref, _ = jconf.block_apply(
        jax.tree_util.tree_map(lambda a: a[0], params),
        jax.tree_util.tree_map(lambda a: a[0], state),
        jnp.asarray(x), jnp.asarray(MASK), jcfg, train=False)
    stack = interop.load_stack(ConformerStack(ConformerConfig(**kw), 1),
                               params, state)
    got = stack.blocks[0](torch.from_numpy(x), torch.from_numpy(MASK))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)
    # and it is not the "xla" path with this softmax dtype
    if softmax == "bfloat16":
        other = interop.load_stack(ConformerStack(ConformerConfig(
            **{**kw, "attention_impl": "xla"}), 1), params, state)
        assert not torch.equal(
            other.blocks[0](torch.from_numpy(x), torch.from_numpy(MASK)), got)


def test_config_rejects_unknown_values():
    with pytest.raises(ValueError, match="attention_impl"):
        ConformerConfig(D, H, 64, 7, attention_impl="flash")
    with pytest.raises(ValueError, match="quantize"):
        ConformerConfig(D, H, 64, 7, quantize="int4")


def test_kernel_wrapper_refuses_other_devices():
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        katt.fused_attention(*(torch.empty(1, 1, 4, 32, device=meta)
                               for _ in range(3)),
                             torch.empty(1, 4, dtype=torch.bool, device=meta))
