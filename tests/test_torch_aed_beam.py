"""The port's AED beam (`decoding/aed_beam.py`) against the JAX package's,
on the CPU at a small size (d 32, 4 heads, 2 exits x 1 block, 2 decoder
layers, V 40), in float32: tokens, lengths and the best lane equal, and
scores within 1e-5 relative, of `beam_search_exit_batch` at both exits;
the batched search against one utterance at a time; beam 1 against a
greedy rollout of the whole decoder (`decode_exit`); EOS before and after
min_length; forced ties resolved as `lax.top_k` resolves them (the lower
flat index first); `DecoderSuite.aed_beam`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from early_exit_tpu.configs import ModelConfig as JModelConfig
from early_exit_tpu.decoding import aed_beam as jbeam
from early_exit_tpu.models import full_conformer as jfc
from early_exit_tpu_torch import interop
from early_exit_tpu_torch.configs import ModelConfig
from early_exit_tpu_torch.decoding import aed_beam
from early_exit_tpu_torch.decoding.api import DecoderSuite

KW = dict(model_type="full_conformer", d_model=32, n_heads=4, d_feed_forward=64,
          n_enc_exits=2, n_enc_layers_per_exit=1, n_dec_layers=2,
          depthwise_kernel_size=7, vocab_size=40, n_mels=8, compute_dtype="float32",
          drop_prob=0.0, pad_id=36, bos_id=1, eos_id=2)
JCFG = JModelConfig(**KW)


def _weights(seed=3, out_scale=4.0, eos_bias=0.0, tie=False):
    params, state = jfc.init(jax.random.PRNGKey(seed), JCFG)
    params, state = jax.tree_util.tree_map(np.array, (params, state))
    params["out_linear"]["w"] *= out_scale            # peaky, so that paths differ
    params["out_linear"]["b"][:, KW["eos_id"]] += eos_bias
    if tie:
        # the decoder's output ignores its input: every lane, every step,
        # the same log-probs, with values repeated across tokens
        params["out_linear"]["w"][:] = 0.0
        params["out_linear"]["b"][:] = np.tile([0.0, 1.5, 1.5, 0.7, 1.5, 0.7, -1.0, 0.0],
                                               5)[None, :40]
    return params, state


def _memory(params, state, B=3, T=61, seed=0):
    r = np.random.RandomState(seed)
    feats = r.randn(B, T, KW["n_mels"]).astype(np.float32)
    lengths = np.array([T, T - 20, T - 9][:B], np.int32)
    hid, _, _, _ = jfc.encode(params, state, jnp.asarray(feats), jnp.asarray(lengths), JCFG)
    return np.array(hid)


_jax_batch = jax.jit(jbeam.beam_search_exit_batch,
                     static_argnames=("cfg", "n_exit", "beam_size", "max_length",
                                      "pen_alpha"))


def _both(params, state, mem, min_lens, *, n_exit, K=4, max_len=9, alpha=1.0):
    mem = np.array(mem[n_exit - 1])
    want = _jax_batch(params, jnp.asarray(mem), jnp.asarray(min_lens), JCFG,
                      n_exit=n_exit, beam_size=K, max_length=max_len, pen_alpha=alpha)
    model = interop.from_jax_params(params, state, ModelConfig(**KW))
    got = aed_beam.beam_search_exit_batch(model, torch.from_numpy(mem),
                                          torch.tensor(min_lens), n_exit=n_exit,
                                          beam_size=K, max_length=max_len, pen_alpha=alpha)
    return model, [t.numpy() for t in got], [np.asarray(t) for t in want]


def _equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])          # tokens
    np.testing.assert_array_equal(got[1], want[1])          # lengths
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[3], want[3])          # best lane


@pytest.mark.parametrize("n_exit,alpha", [(1, 1.0), (2, 0.6)])
def test_batch_matches_jax(n_exit, alpha):
    params, state = _weights(eos_bias=1.5)
    mem = _memory(params, state)
    model, got, want = _both(params, state, mem, [1, 3, 5], n_exit=n_exit, alpha=alpha)
    _equal(got, want)
    assert got[0].shape == (3, 4, 10)
    assert len({tuple(t) for t in got[0].reshape(-1, 10).tolist()}) > 3   # lanes differ
    assert (got[1] < 10).any(), "no lane retired: EOS never tested"
    # batched against one utterance at a time, through DecoderSuite
    suite = DecoderSuite(ModelConfig(**KW), beam_size=4, pen_alpha=alpha)
    for b, mn in enumerate([1, 3, 5]):
        one = suite.aed_beam(model, torch.from_numpy(mem[n_exit - 1, b:b + 1]), n_exit,
                             max_length=9, min_length=mn)
        _equal([t.numpy() for t in one], [w[b] for w in got])


def test_eos_before_and_after_min_length():
    """With EOS dominant every lane picks it at every step: before
    min_length it is an ordinary token, at the first step i > min_length
    the lane retires, so the best lane is [SOS, EOS x (min_length + 2)]
    and its length freezes at min_length + 3."""
    params, state = _weights(eos_bias=30.0)
    mem = _memory(params, state)
    _, got, want = _both(params, state, mem, [0, 2, 5], n_exit=2, max_len=9)
    _equal(got, want)
    toks, lens, _, best = got
    for b, mn in enumerate([0, 2, 5]):
        assert lens[b, best[b]] == mn + 3
        assert (toks[b, best[b], 1:mn + 3] == KW["eos_id"]).all()
        assert (toks[b, best[b], mn + 3:] == KW["pad_id"]).all()   # frozen


def test_forced_ties_resolved_as_lax_top_k():
    params, state = _weights(tie=True)
    mem = _memory(params, state)
    _, got, want = _both(params, state, mem, [1, 1, 1], n_exit=1, K=5, max_len=6)
    _equal(got, want)
    # every step ties every lane's candidates: the lowest flat indices win,
    # so every lane descends from lane 0 and its first token, id 1 (the
    # highest would give id 10 of lane 4)
    assert got[0][:, :, 1].tolist() == [[1] * 5] * 3
    x = np.random.RandomState(0).randint(0, 4, size=(6, 50)).astype(np.float32)
    v, i = aed_beam.top_k_stable(torch.from_numpy(x), 7)
    vj, ij = jax.lax.top_k(jnp.asarray(x), 7)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(v.numpy(), np.asarray(vj))


def test_beam_one_is_a_greedy_rollout():
    """K = 1: each step the argmax of decoder n's last position over the
    whole prefix (`decode_exit`, no cache), retired at EOS after
    min_length; the score the sum of the chosen log-probs over the
    penalties."""
    params, state = _weights(eos_bias=1.0)
    mem = _memory(params, state)
    model, got, _ = _both(params, state, mem, [2, 2, 2], n_exit=2, K=1, max_len=8)
    for b in range(3):
        seq, score = [KW["bos_id"]], 0.0
        m = torch.from_numpy(mem[1, b:b + 1])
        for i in range(8):
            with torch.no_grad():
                lp = model.decode_exit(torch.tensor([seq]), m, 2)[0, -1]
            t = int(lp.argmax())
            score += float(lp[t]) / float(aed_beam.length_penalty(i + 1.0, 1.0))
            seq.append(t)
            if t == KW["eos_id"] and i > 2:
                break
        assert got[0][b, 0, :len(seq)].tolist() == seq
        assert got[1][b, 0] == len(seq)
        np.testing.assert_allclose(got[2][b, 0], score, rtol=1e-5)
