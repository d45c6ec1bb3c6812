"""The port's pre-norm Transformer decoder (`models/transformer_decoder.py`)
and causal attention against the JAX package's, on the CPU at a small size
(d 32, 4 heads, ffn 64, 2 layers), float32, weights carried across by
`interop.from_jax_params` (exit 1's decoder of a `full_conformer`):
one layer with and without the causal mask, the stack with its final
LayerNorm, `nn.core.mha(causal=True)` with a key mask (float32 and bf16
softmax), and the KV-cached `DecoderStack.step` chained over L steps
against JAX's `step_apply` and against the port's own stack at each
prefix's last position.

Tolerance: float32 rtol 1e-5 (absolute floor 1e-5 x max|ref|); the bf16
softmax 1e-2 of max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from early_exit_tpu.configs import ModelConfig as JModelConfig
from early_exit_tpu.models import full_conformer as jfc
from early_exit_tpu.models import transformer_decoder as jtd
from early_exit_tpu.nn import core as jcore
from early_exit_tpu_torch import interop
from early_exit_tpu_torch.configs import ModelConfig
from early_exit_tpu_torch.models import transformer_decoder as td
from early_exit_tpu_torch.nn import core

KW = dict(model_type="full_conformer", d_model=32, n_heads=4, d_feed_forward=64,
          n_enc_exits=2, n_enc_layers_per_exit=1, n_dec_layers=2,
          depthwise_kernel_size=7, vocab_size=40, n_mels=8, compute_dtype="float32",
          drop_prob=0.0, pad_id=36, bos_id=1, eos_id=2)
B, L, T, D, H = 3, 7, 13, 32, 4


def _close(got, ref, rtol=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1.0))


@pytest.fixture(scope="module")
def setup():
    params, state = jfc.init(jax.random.PRNGKey(7), JModelConfig(**KW))
    params, state = jax.tree_util.tree_map(np.array, (params, state))
    model = interop.from_jax_params(params, state, ModelConfig(**KW))
    r = np.random.RandomState(0)
    x = r.randn(B, L, D).astype(np.float32)
    mem = r.randn(B, T, D).astype(np.float32)
    valid = np.ones((B, L), bool)
    valid[1, 5:] = False
    valid[2, 3:] = False
    dec = jax.tree_util.tree_map(lambda a: a[0], params["decoders"])
    return dict(params=params, model=model, x=x, mem=mem, valid=valid, dec=dec)


@pytest.mark.parametrize("causal", [True, False])
def test_layer_matches_jax(setup, causal):
    s = setup
    p0 = jax.tree_util.tree_map(lambda a: a[0], s["dec"])
    want = jtd.layer_apply(p0, jnp.asarray(s["x"]), jnp.asarray(s["mem"]), H,
                           tgt_pad_mask=jnp.asarray(s["valid"]), causal=causal)
    with torch.no_grad():
        got = s["model"].decoders[0].layers[0](
            torch.from_numpy(s["x"]), torch.from_numpy(s["mem"]), H,
            tgt_valid=torch.from_numpy(s["valid"]), causal=causal)
    _close(got, want)


def test_stack_matches_jax(setup):
    s = setup
    want = jtd.stack_apply(s["dec"], jnp.asarray(s["x"]), jnp.asarray(s["mem"]), H,
                           s["params"]["final_ln"], tgt_pad_mask=jnp.asarray(s["valid"]))
    with torch.no_grad():
        got = s["model"].decoders[0](torch.from_numpy(s["x"]), torch.from_numpy(s["mem"]),
                                     s["model"].final_ln,
                                     tgt_valid=torch.from_numpy(s["valid"]))
    _close(got, want)


@pytest.mark.parametrize("softmax", ["float32", "bfloat16"])
def test_causal_mha_matches_jax(setup, softmax):
    s = setup
    p = jax.tree_util.tree_map(lambda a: a[0], s["dec"]["self_attn"])
    jdt, tdt = ((jnp.float32, torch.float32) if softmax == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    want = jcore.mha(p, jnp.asarray(s["x"]), jnp.asarray(s["x"]), H,
                     key_mask=jnp.asarray(s["valid"]), causal=True, softmax_dtype=jdt)
    pt = s["model"].decoders[0].layers[0].self_attn.params()
    with torch.no_grad():
        got = core.mha(pt, torch.from_numpy(s["x"]), torch.from_numpy(s["x"]), H,
                       key_mask=torch.from_numpy(s["valid"]), causal=True,
                       softmax_dtype=tdt)
    _close(got, want, 1e-5 if softmax == "float32" else 1e-2)
    # the causal mask matters: position 0 sees only itself
    with torch.no_grad():
        free = core.mha(pt, torch.from_numpy(s["x"]), torch.from_numpy(s["x"]), H,
                        key_mask=torch.from_numpy(s["valid"]))
    assert not torch.allclose(free[:, 0], got[:, 0])


def test_step_chain_matches_jax_and_the_stack(setup):
    s = setup
    stack = s["model"].decoders[0]
    fl = s["model"].final_ln
    x, mem = torch.from_numpy(s["x"]), torch.from_numpy(s["mem"])
    jcache = jtd.init_cache(s["dec"], B, L, D)
    cache = td.init_cache(len(stack.layers), B, L, D)
    mem_kv = stack.memory_kv(mem)
    for i in range(L):
        want, jcache = jtd.step_apply(s["dec"], jnp.asarray(s["x"][:, i:i + 1]),
                                      jnp.asarray(s["mem"]), H, s["params"]["final_ln"],
                                      jcache)
        with torch.no_grad():
            got = stack.step(x[:, i:i + 1], fl, cache, mem_kv)
            full = stack(x[:, :i + 1], mem, fl)[:, -1:]
        _close(got, want)
        _close(got, full)
        _close(cache["k"][:, :, :i + 1], np.asarray(jcache["k"])[:, :, :i + 1])
        assert cache["pos"] == int(jcache["pos"]) == i + 1
