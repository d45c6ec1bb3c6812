"""The port's joint CTC + attention rescoring (`decoding/rescore.py`)
against the JAX package's, on the CPU: `ctc_lane_scores` on random
emissions with a feasible, an infeasible and a blank-holding hypothesis,
and an utterance whose lanes are all infeasible (finite ~-1e30 scores,
so the mixing stays finite); `joint_rescore` at weights 0, 0.3 and 1 and
at extreme magnitudes; `rescore_batch` on the port's own beam output of
a small `full_conformer` (d 32, 2 exits, V 40) and its CTC heads.

Tolerance: float32 rtol 1e-5 (the infeasible lanes' ~1e30 included); the
chosen lanes equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from early_exit_tpu.configs import ModelConfig as JModelConfig
from early_exit_tpu.decoding import rescore as jrescore
from early_exit_tpu.models import full_conformer as jfc
from early_exit_tpu_torch import interop
from early_exit_tpu_torch.configs import ModelConfig
from early_exit_tpu_torch.decoding import aed_beam, rescore

B, K, T, V, L = 3, 4, 14, 9, 8


def _case(seed=0):
    r = np.random.RandomState(seed)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(3 * r.randn(B, T, V).astype(np.float32))))
    nf = np.array([T, 9, 2], np.int32)
    toks = r.randint(1, V, size=(B, K, L)).astype(np.int32)
    lens = np.array([[8, 5, 3, 1], [8, 6, 2, 4], [8, 7, 5, 6]], np.int32)
    toks[0, 1, 2] = 0                     # a hypothesis holding the blank id
    toks[1, 0, :] = 4                     # 8 repeats need 15 frames: infeasible
    aed = -np.abs(r.randn(B, K)).astype(np.float32) * 3
    return lp, nf, toks, lens, aed         # utterance 2: 2 frames, every lane infeasible


def _jax_lanes(lp, nf, toks, lens):
    return np.array(jax.vmap(jrescore.ctc_lane_scores)(
        jnp.asarray(lp), jnp.asarray(nf), jnp.asarray(toks), jnp.asarray(lens)))


@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_lane_scores_match_jax(seed):
    lp, nf, toks, lens, _ = _case(seed)
    want = _jax_lanes(lp, nf, toks, lens)
    got = rescore.ctc_lane_scores(torch.from_numpy(lp), torch.from_numpy(nf),
                                  torch.from_numpy(toks), torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert want[1, 0] < -1e28 and (want[2] < -1e28).all()     # infeasible, finite
    assert np.isfinite(got).all() and (got[0] > -1e28).all()


@pytest.mark.parametrize("w", [0.0, 0.3, 1.0])
def test_joint_rescore_matches_jax(w):
    lp, nf, toks, lens, aed = _case()
    lanes = _jax_lanes(lp, nf, toks, lens)
    for a, c in ((aed, lanes), (aed - 2000.0, lanes - 1990.0),
                 (np.full_like(aed, -1e30), lanes)):
        bj, sj = jrescore.joint_rescore(jnp.asarray(a), jnp.asarray(c), w)
        bp, sp = rescore.joint_rescore(torch.from_numpy(a), torch.from_numpy(c), w)
        np.testing.assert_allclose(sp.numpy(), np.asarray(sj), rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(bp.numpy(), np.asarray(bj))
        assert np.isfinite(sp.numpy()).all()


def test_rescore_batch_on_beam_output():
    kw = dict(model_type="full_conformer", d_model=32, n_heads=4, d_feed_forward=64,
              n_enc_exits=2, n_enc_layers_per_exit=1, n_dec_layers=2,
              depthwise_kernel_size=7, vocab_size=40, n_mels=8, compute_dtype="float32",
              drop_prob=0.0, pad_id=36, bos_id=1, eos_id=2)
    params, state = jfc.init(jax.random.PRNGKey(11), JModelConfig(**kw))
    params, state = jax.tree_util.tree_map(np.array, (params, state))
    params["out_linear"]["w"] *= 4.0
    params["heads"]["w"] *= 4.0
    model = interop.from_jax_params(params, state, ModelConfig(**kw))
    r = np.random.RandomState(2)
    feats = torch.from_numpy(r.randn(B, 61, 8).astype(np.float32))
    with torch.no_grad():
        hidden, sub_len = model.encode(feats, torch.tensor([61, 40, 52]))
        ctc_lp = model.apply_heads(hidden)
    for n in (1, 2):
        toks, lens, scores, best = aed_beam.beam_search_exit_batch(
            model, hidden[n - 1], [1, 2, 3], n_exit=n, beam_size=K, max_length=7)
        got = rescore.rescore_batch(ctc_lp[n - 1], sub_len, toks, lens, scores,
                                    ctc_weight=0.5)
        want = jrescore.rescore_batch(*(jnp.asarray(t.numpy()) for t in (
            ctc_lp[n - 1], sub_len, toks, lens, scores)), ctc_weight=0.5)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
        assert (toks[:, :, 0] == 1).all()          # BOS kept in what is scored
