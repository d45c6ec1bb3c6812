"""The port's legacy Transformer family (`models/legacy_transformer.py`)
against the JAX package's, on the CPU at a small size (d 32, 4 heads,
ffn 64, 2 exits x 2 layers, 2 decoder layers, V 24), the weights carried
across by `interop.legacy_from_jax`, float32: every output within 2e-5
(log-probs) of JAX's. Also: the decoder is causal (a later target token
moves no earlier position's output), the trees come back equal, and the
port's own init draws every weight.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from early_exit_tpu.configs import ModelConfig as JModelConfig
from early_exit_tpu.models import legacy_transformer as jlt
from early_exit_tpu_torch import interop
from early_exit_tpu_torch.configs import ModelConfig
from early_exit_tpu_torch.models import legacy_transformer as lt

KW = dict(d_model=32, n_heads=4, d_feed_forward=64, n_enc_exits=2, n_enc_layers_per_exit=2,
          n_dec_layers=2, depthwise_kernel_size=7, vocab_size=24, n_mels=8,
          compute_dtype="float32", drop_prob=0.0, pad_id=20, bos_id=1, eos_id=2)
ATOL = 2e-5
INIT = {"CTCSelfAttention": jlt.ctc_self_attention_init,
        "EarlyEncoder": jlt.early_encoder_init,
        "EarlyTransformer": jlt.early_transformer_init,
        "LegacyTransformer": jlt.legacy_transformer_init}


def _inputs(seed=0, B=2, T=61, L=7):
    r = np.random.RandomState(seed)
    trg = r.randint(3, 20, size=(B, L)).astype(np.int32)
    trg[:, 0] = KW["bos_id"]
    trg[1, -2:] = KW["pad_id"]
    return r.randn(B, T, KW["n_mels"]).astype(np.float32), trg


@pytest.fixture(scope="module", params=sorted(INIT))
def pair(request):
    params = jax.tree_util.tree_map(np.asarray, INIT[request.param](
        jax.random.PRNGKey(2), JModelConfig(**KW)))
    return request.param, params, interop.legacy_from_jax(request.param, params,
                                                          ModelConfig(**KW))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_forward_matches_jax(pair):
    kind, params, model = pair
    feats, trg = _inputs()
    jcfg, f, t = JModelConfig(**KW), jnp.asarray(feats), jnp.asarray(trg)
    pf, pt = torch.from_numpy(feats), torch.from_numpy(trg)
    with torch.no_grad():
        if kind == "CTCSelfAttention":
            _close(model.apply(pf), jlt.ctc_self_attention_apply(params, f, jcfg))
        elif kind == "EarlyEncoder":
            got, want = model.apply(pf), jlt.early_encoder_apply(params, f, jcfg)
            assert got.shape == want.shape and got.shape[0] == 2
            _close(got, want)
        elif kind == "EarlyTransformer":
            (dec, enc), (dj, ej) = model.apply(pf, pt), jlt.early_transformer_apply(
                params, f, t, jcfg)
            assert dec.shape == dj.shape and enc.shape == ej.shape
            _close(dec, dj)
            _close(enc, ej)
        else:
            (dec, enc), (dj, ej) = model.apply(pf, pt), jlt.legacy_transformer_apply(
                params, f, t, jcfg)
            _close(dec, dj)
            _close(enc, ej)
            mem, mem_j = model.encode(pf), jlt.legacy_transformer_encode(params, f, jcfg)
            _close(mem, mem_j)
            _close(model.ctc_encoder(pf), jlt.legacy_transformer_ctc_encoder(params, f, jcfg))
            _close(model.decode(pt, mem), jlt.legacy_transformer_decode(params, t, mem_j, jcfg))
            # causal: moving the last target token changes no earlier position
            moved = pt.clone()
            moved[:, -1] = 5
            a, b = model.decode(pt, mem), model.decode(moved, mem)
            torch.testing.assert_close(a[:, :-1], b[:, :-1], atol=1e-6, rtol=0)
            assert not torch.allclose(a[:, -1], b[:, -1])


def test_trees_both_ways_and_init(pair):
    kind, params, model = pair
    back = interop.jax_tree(model)
    la, ta = jax.tree_util.tree_flatten(params)
    lb, tb = jax.tree_util.tree_flatten(back)
    assert ta == tb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)
    fresh = getattr(lt, kind)(ModelConfig(**KW)).init(torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in fresh.parameters()) == sum(x.size for x in la)
    for name, p in fresh.named_parameters():
        if p.dim() >= 2 or name.endswith("_g"):       # products, embedding, norm gains
            assert bool(p.abs().sum() > 0), name
