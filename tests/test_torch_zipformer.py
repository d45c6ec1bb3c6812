"""The port's early_zipformer (`models/zipformer.py`) against the JAX
package's `zipformer`, on the CPU at a small size (d 32, 4 heads, ffn
64, k 7, 19 x 1 blocks, V 24), the weights carried across by
`interop.from_jax_params`.

- the forward, unfused, float32 log-probs within 2e-5 and the output
  lengths equal: in reference mode at every residue of T' mod 8 (each
  stage pads T' to its factor, 2, 4 and 8: each residue is another set
  of pads), in true mode at an odd and an even T'; the fused path (the
  block kernel's plain version against JAX's TPU kernel in interpret
  mode) at one small T'; the bf16 inference profile at the flagship's
  widths with its trained blocks (`flagship_zoo_trees`), greedy tokens
  <= 1% apart;
- the 19-exit check raises the JAX package's ValueError, and the gate
  has nothing to gate;
- the parameter count and the trees both ways.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from early_exit_tpu.configs import ModelConfig as JModelConfig
from early_exit_tpu.models import zipformer as jzf
from early_exit_tpu.utils import count_parameters as jcount
from early_exit_tpu_torch import interop
from early_exit_tpu_torch.configs import ModelConfig
from early_exit_tpu_torch.models import early_exit_gate as gate
from early_exit_tpu_torch.models.registry import build_model
from early_exit_tpu_torch.models.zipformer import EarlyZipformer
from early_exit_tpu_torch.utils.model_utils import count_parameters

from test_torch_splitformer import bf16_token_disagreement
from torch_one_thread import one_thread  # noqa: F401

KW = dict(model_type="early_zipformer", d_model=32, n_heads=4, d_feed_forward=64,
          n_enc_exits=19, n_enc_layers_per_exit=1, depthwise_kernel_size=7,
          vocab_size=24, n_mels=8, compute_dtype="float32", drop_prob=0.0)
F32_ATOL = 2e-5


@pytest.fixture(scope="module")
def weights():
    params, state = jzf.init(jax.random.PRNGKey(1), JModelConfig(**KW))
    return jax.tree_util.tree_map(np.asarray, (params, state))


def _inputs(t_sub, seed=0):
    """2 T' + 1 mel frames give T' frames after the one convolution; the
    second row is 9 frames shorter."""
    T = 2 * t_sub + 1
    r = np.random.RandomState(seed)
    return (r.randn(2, T, KW["n_mels"]).astype(np.float32), np.array([T, T - 9], np.int32))


def _compare(weights, t_sub, **over):
    cfg = {**KW, **over}
    jcfg = JModelConfig(**cfg)
    feats, lengths = _inputs(t_sub, seed=t_sub)
    want, len_j, _ = jax.jit(lambda p, s, f, l: jzf.apply(p, s, f, l, jcfg))(
        *weights, jnp.asarray(feats), jnp.asarray(lengths))
    model = interop.from_jax_params(*weights, ModelConfig(**cfg))
    with torch.no_grad():
        got, out_len = model.apply(torch.from_numpy(feats), torch.from_numpy(lengths))
    assert got.shape == want.shape == (1, 2, (t_sub + 1) // 2, KW["vocab_size"])
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(len_j))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("t_sub", range(24, 32))
def test_forward_matches_jax_every_pad(weights, t_sub):
    _compare(weights, t_sub)


@pytest.mark.parametrize("t_sub", [26, 29])
def test_forward_matches_jax_true_lengths(weights, t_sub):
    _compare(weights, t_sub, length_mode="true")


def test_fused_forward_matches_jax(weights):
    _compare(weights, 19, fused_block=True)


def test_bf16_tokens_match_jax():
    share, n = bf16_token_disagreement("early_zipformer", n_enc_exits=19,
                                       n_enc_layers_per_exit=1)
    assert n >= 60 and share <= 0.01, (share, n)


def test_requires_19_exits():
    bad = {**KW, "n_enc_exits": 6}
    with pytest.raises(ValueError) as want:
        jzf.init(jax.random.PRNGKey(0), JModelConfig(**bad))
    with pytest.raises(ValueError) as got:
        build_model(ModelConfig(**bad))
    assert str(got.value) == str(want.value)


def test_gate_has_nothing_to_gate(weights):
    model = interop.from_jax_params(*weights, ModelConfig(**KW))
    feats, lengths = _inputs(24)
    with pytest.raises(ValueError, match="nothing to gate"):
        gate.gated_apply(model, torch.from_numpy(feats), torch.from_numpy(lengths),
                         threshold=0.5)


def test_parameter_count_and_trees(weights):
    params, state = weights
    model = build_model(ModelConfig(**KW))
    assert isinstance(model, EarlyZipformer)
    assert count_parameters(model) == jcount(params)
    model = interop.from_jax_params(params, state, ModelConfig(**KW))
    back_p, back_s = interop.to_jax_params(model)
    for a, b in ((params, back_p), (state, back_s)):
        la, ta = jax.tree_util.tree_flatten(a)
        lb, tb = jax.tree_util.tree_flatten(b)
        assert ta == tb
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(x, y)
    # the port's own init draws every weight and every stack
    fresh = EarlyZipformer(dataclasses.replace(ModelConfig(**KW))).init(
        torch.Generator().manual_seed(0))
    assert all(bool(p.abs().sum() > 0) for n, p in fresh.named_parameters()
               if n.endswith(("_w", "w1", "w2", "wq", "wk", "wv", "wo", "_g")))
