"""The port's AED model (`models/full_conformer.py`) against the JAX
package's `full_conformer`, on the CPU at a small size (d 32, 4 heads, 2
exits x 1 block, 2 decoder layers, V 40), weights carried across by
`interop.from_jax_params`: `apply`'s raw decoder logits and encoder
log-probs, with the trunk through the fused branch (the port's block
kernel's plain version against JAX's TPU kernel in interpret mode) and
through the unfused one; `encode_exit` and `decode_exit` at each exit;
`cross_entropy`; the parameter trees both ways; the registry.

Tolerances: float32 rtol 1e-5 (absolute floor 1e-5 x max|ref|); in the
bf16 profile, the decoder's per-position argmax tokens may differ on at
most 2% of the positions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from early_exit_tpu.configs import ModelConfig as JModelConfig
from early_exit_tpu.models import full_conformer as jfc
from early_exit_tpu.ops import ctc as jctc
from early_exit_tpu_torch import interop
from early_exit_tpu_torch.configs import ModelConfig
from early_exit_tpu_torch.models.full_conformer import FullConformer
from early_exit_tpu_torch.models.registry import build_model
from early_exit_tpu_torch.ops import ctc

KW = dict(model_type="full_conformer", d_model=32, n_heads=4, d_feed_forward=64,
          n_enc_exits=2, n_enc_layers_per_exit=1, n_dec_layers=2,
          depthwise_kernel_size=7, vocab_size=40, n_mels=8, compute_dtype="float32",
          drop_prob=0.0, pad_id=36, bos_id=1, eos_id=2)


def _close(got, ref, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1.0))


def _batch(B=3, T=71, L=9, seed=0):
    r = np.random.RandomState(seed)
    labels = np.full((B, L), KW["pad_id"], np.int32)
    labels[:, 0] = KW["bos_id"]
    for b in range(B):
        n = L - 2 - 2 * b
        labels[b, 1:1 + n] = r.randint(3, 30, size=n)
        labels[b, 1 + n] = KW["eos_id"]
    return {"feats": r.randn(B, T, KW["n_mels"]).astype(np.float32),
            "feat_lengths": np.array([T, T - 17, T - 30][:B], np.int32),
            "labels": labels}


@pytest.fixture(scope="module")
def weights():
    params, state = jfc.init(jax.random.PRNGKey(3), JModelConfig(**KW))
    return jax.tree_util.tree_map(np.asarray, (params, state))


def _pair(weights, **over):
    params, state = weights
    jcfg = JModelConfig(**{**KW, **over})
    return jcfg, interop.from_jax_params(params, state, ModelConfig(**{**KW, **over}))


@pytest.mark.parametrize("fused", [False, True])
def test_apply_matches_jax(weights, fused):
    jcfg, model = _pair(weights, fused_block=fused)
    b = _batch()
    trg = b["labels"][:, :-1]
    dec_j, enc_j, sub_j, _ = jfc.apply(*weights, jnp.asarray(b["feats"]),
                                       jnp.asarray(b["feat_lengths"]), jnp.asarray(trg), jcfg)
    with torch.no_grad():
        dec, enc, sub = model.apply(torch.from_numpy(b["feats"]),
                                    torch.from_numpy(b["feat_lengths"]), torch.from_numpy(trg))
    assert dec.shape == dec_j.shape and enc.shape == enc_j.shape
    np.testing.assert_array_equal(sub.numpy(), np.asarray(sub_j))
    _close(dec, dec_j)
    _close(enc, enc_j)


@pytest.mark.parametrize("fused", [False, True])
def test_encode_and_decode_exit_match_jax(weights, fused):
    jcfg, model = _pair(weights, fused_block=fused)
    b = _batch(seed=1)
    trg = b["labels"][:, :-1]
    f, l = jnp.asarray(b["feats"]), jnp.asarray(b["feat_lengths"])
    hid, sub = model.encode(torch.from_numpy(b["feats"]), torch.from_numpy(b["feat_lengths"]))
    for n in (1, 2):
        mem_j, _ = jfc.encode_exit(*weights, f, l, jcfg, n)
        with torch.no_grad():
            mem, sub_n = model.encode_exit(torch.from_numpy(b["feats"]),
                                           torch.from_numpy(b["feat_lengths"]), n)
            lp = model.decode_exit(torch.from_numpy(trg), mem, n)
        _close(mem, mem_j)
        _close(hid[n - 1], mem_j)          # encode's exit n is the trunk cut at n
        np.testing.assert_array_equal(sub_n.numpy(), sub.numpy())
        _close(lp, jfc.decode_exit(weights[0], jnp.asarray(trg), mem_j, jcfg, n))


def test_bf16_decoder_tokens_match_jax(weights):
    over = dict(compute_dtype="bfloat16", attn_softmax_dtype="float32")
    jcfg, model = _pair(weights, **over)
    b = _batch(seed=2)
    trg = b["labels"][:, :-1]
    dec_j, _, _, _ = jfc.apply(*weights, jnp.asarray(b["feats"]),
                               jnp.asarray(b["feat_lengths"]), jnp.asarray(trg), jcfg)
    with torch.no_grad():
        dec, _, _ = model.apply(torch.from_numpy(b["feats"]),
                                torch.from_numpy(b["feat_lengths"]), torch.from_numpy(trg))
    assert dec.dtype == torch.bfloat16
    want = np.asarray(jnp.argmax(dec_j.astype(jnp.float32), -1))
    got = dec.float().argmax(-1).numpy()
    assert (got != want).mean() <= 0.02


@pytest.mark.parametrize("ignore_index", [None, 36])
def test_cross_entropy_matches_jax(ignore_index):
    r = np.random.RandomState(4)
    logits = (3 * r.randn(2, 3, 7, 40)).astype(np.float32)
    targets = r.randint(0, 40, size=(2, 3, 7)).astype(np.int32)
    targets[:, :, -2:] = 36
    got = ctc.cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets),
                            ignore_index=ignore_index)
    want = jctc.cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                              ignore_index=ignore_index)
    _close(got, want)


def test_parameter_trees_both_ways(weights):
    """Every leaf of the JAX tree lands in one parameter and comes back
    equal; the port's own init draws every parameter (none left zero)."""
    _, model = _pair(weights)
    back, state = interop.to_jax_params(model)
    flat_j = jax.tree_util.tree_leaves_with_path(weights[0])
    flat_p = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_p)
    for path, leaf in flat_j:
        key = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        match = [v for p, v in flat_p.items()
                 if tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p) == key]
        assert len(match) == 1, key
        np.testing.assert_array_equal(match[0], leaf)
    n_params = sum(np.asarray(v).size for v in jax.tree_util.tree_leaves(weights[0]))
    assert sum(p.numel() for p in model.parameters()) == n_params
    fresh = FullConformer(ModelConfig(**KW)).init(torch.Generator().manual_seed(0))
    assert all(bool(p.abs().sum() > 0) for n, p in fresh.named_parameters()
               if not n.endswith(("_b", ".b1", ".b2", "bq", "bk", "bv", "bo", "out_b",
                                  "heads_b", "sub_b.0", "sub_b.1")))


def test_registry():
    assert isinstance(build_model(ModelConfig(**KW)), FullConformer)
    assert type(build_model(ModelConfig())).__name__ == "EarlyConformer"
    assert type(build_model(dataclasses.replace(
        ModelConfig(), model_type="splitformer"))).__name__ == "Splitformer"
    assert type(build_model(dataclasses.replace(
        ModelConfig(), model_type="early_zipformer", n_enc_exits=19,
        n_enc_layers_per_exit=1))).__name__ == "EarlyZipformer"
    with pytest.raises(ValueError, match="unknown model_type"):
        build_model(dataclasses.replace(ModelConfig(), model_type="lstm"))
