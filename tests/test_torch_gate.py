"""The confidence gate (`models/early_exit_gate.py`,
`models/gate_calibration.py`) against the JAX package: the same
numpy-seeded inputs and weights (carried by `interop`), float32 compute.
Small model: d=32, 4 heads, ffn 64, k=7, 4 exits x 1 layer, vocab 16.

Tolerance: confidences 1e-6 on equal log-probs; through the model the
chosen exits are equal and the chosen log-probs within 1e-4 (float32
sums in another order through up to 4 blocks and a head). Thresholds sit
at quantiles of the model's own confidences, between two rows' values,
so the decision does not hang on the last place. With quantize="int8" a
moved int8 level shows in the log-probs, which are held to 0.05 there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from early_exit_tpu.configs import ModelConfig as JaxModelConfig
from early_exit_tpu.models import early_conformer as jec
from early_exit_tpu.models import early_exit_gate as jgate
from early_exit_tpu.models import gate_calibration as jcal
from early_exit_tpu_torch import interop
from early_exit_tpu_torch.configs import ModelConfig
from early_exit_tpu_torch.models import early_exit_gate as gate
from early_exit_tpu_torch.models import gate_calibration as cal

KW = dict(d_model=32, n_enc_exits=4, n_enc_layers_per_exit=1, n_heads=4,
          d_feed_forward=64, depthwise_kernel_size=7, vocab_size=16,
          compute_dtype="float32", residual_dtype="float32",
          attn_softmax_dtype="float32")
TEMPS = [2.0, 1.5, 1.0, 1.0]
B, T = 6, 64


@pytest.fixture(scope="module")
def bundle():
    jcfg = JaxModelConfig(**KW)
    params, state = jec.init(jax.random.PRNGKey(0), jcfg)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    params, state = to_np(params), to_np(state)
    r = np.random.RandomState(1)
    feats = r.randn(B, T, jcfg.n_mels).astype(np.float32)
    lengths = np.array([T, T - 8, T - 16, T, T - 4, T - 30])
    lp, sub_len, _ = jec.apply(params, state, jnp.asarray(feats),
                               jnp.asarray(lengths), jcfg, train=False)
    mask = jnp.arange(lp.shape[2])[None, :] < sub_len[:, None]
    thr = {}
    for score in gate.GATE_SCORES:
        conf = np.stack([np.asarray(jcal.scaled_confidence(
            lp[e], mask, score, TEMPS[e])) for e in range(4)])
        thr[score] = [float(np.quantile(conf[0], 0.5)),
                      float(np.quantile(conf[1], 0.7)),
                      float(np.quantile(conf[2], 0.85)), 0.0]
    return dict(params=params, state=state, feats=feats, lengths=lengths,
                thr=thr, lp=np.array(lp), mask=np.array(mask))


def _both(b, *, over=None, **gate_kw):
    over = over or {}
    jcfg = JaxModelConfig(**{**KW, **over})
    pcfg = ModelConfig(**{**KW, **over})
    ref = jgate.gated_apply(b["params"], b["state"], jnp.asarray(b["feats"]),
                            jnp.asarray(b["lengths"]), jcfg, **{
                                k: (jnp.asarray(v) if k == "item_mask" else v)
                                for k, v in gate_kw.items()})
    model = interop.from_jax_params(b["params"], b["state"], pcfg)
    got = gate.gated_apply(model, torch.from_numpy(b["feats"]),
                           torch.from_numpy(b["lengths"]), **{
                               k: (torch.from_numpy(v) if k == "item_mask" else v)
                               for k, v in gate_kw.items()})
    return got, ref


def _agree(got, ref, atol=1e-4):
    lp, chosen, sub_len, n_run = got
    np.testing.assert_array_equal(chosen.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(sub_len.numpy(), np.asarray(ref[2]))
    assert n_run == int(ref[3])
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref[0]), atol=atol, rtol=0)
    return chosen.numpy()


@pytest.mark.parametrize("score", gate.GATE_SCORES)
def test_exit_confidence_matches_jax(bundle, score):
    lp, mask = bundle["lp"][1], bundle["mask"]
    ref = jgate.exit_confidence(jnp.asarray(lp), jnp.asarray(mask), score)
    got = gate.exit_confidence(torch.from_numpy(lp), torch.from_numpy(mask), score)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    assert ((got >= 0) & (got <= 1)).all()
    # an item with no valid frame: masked mean over max(sum, 1) frames
    none = torch.zeros_like(torch.from_numpy(mask))
    assert not gate.exit_confidence(torch.from_numpy(lp), none, score).any()


def test_exit_confidence_rejects_an_unknown_score(bundle):
    with pytest.raises(ValueError, match="score must be one of"):
        gate.exit_confidence(torch.zeros(1, 2, 4), torch.ones(1, 2), "entropy")


@pytest.mark.parametrize("score", ["maxprob", "negentropy"])
def test_scaled_confidence_matches_jax(bundle, score):
    lp, mask = bundle["lp"][0], bundle["mask"]
    ref = jcal.scaled_confidence(jnp.asarray(lp), jnp.asarray(mask), score, 2.5)
    got = cal.scaled_confidence(torch.from_numpy(lp), torch.from_numpy(mask),
                                score, 2.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("score", gate.GATE_SCORES)
def test_gated_apply_matches_jax(bundle, score):
    chosen = _agree(*_both(bundle, threshold=bundle["thr"][score], score=score,
                           temperatures=TEMPS))
    assert len(set(chosen.tolist())) > 1        # the batch really splits


def test_gated_apply_scalar_threshold_without_temperatures(bundle):
    thr = float(np.median(np.exp(bundle["lp"][0].max(-1)).mean(-1)))
    _agree(*_both(bundle, threshold=thr))


def test_gated_apply_item_mask_rows_start_done(bundle):
    im = np.array([1, 1, 0, 1, 0, 1], np.float32)
    chosen = _agree(*_both(bundle, threshold=bundle["thr"]["maxprob"],
                           temperatures=TEMPS, item_mask=im))
    assert chosen[2] == 0 and chosen[4] == 0


def test_gated_apply_stops_once_every_row_is_done(bundle):
    got, ref = _both(bundle, threshold=0.0)
    _agree(got, ref)
    assert got[3] == 1 and (got[1] == 1).all()


def test_gated_apply_with_a_never_accept_threshold(bundle):
    base = bundle["thr"]["maxprob"]
    chosen = _agree(*_both(bundle, threshold=[2.0, base[1], 2.0, 0.0],
                           temperatures=TEMPS))
    assert set(chosen.tolist()) <= {2, 4}


@pytest.mark.parametrize("over", [dict(fused_block=True),
                                  dict(quantize="int8"),
                                  dict(quantize="int8", fused_block=True)],
                         ids=["fused", "int8", "int8-fused"])
def test_gated_apply_other_configurations(bundle, over):
    atol = 0.05 if "quantize" in over else 1e-4
    _agree(*_both(bundle, over=over, threshold=bundle["thr"]["maxprob"],
                  temperatures=TEMPS), atol=atol)


def test_gated_apply_rejects_what_it_cannot_gate(bundle):
    b = bundle
    model = interop.from_jax_params(b["params"], b["state"], ModelConfig(**KW))
    args = (torch.from_numpy(b["feats"]), torch.from_numpy(b["lengths"]))
    model.cfg = dataclasses.replace(model.cfg, model_type="early_zipformer")
    with pytest.raises(ValueError, match="nothing to gate"):
        gate.gated_apply(model, *args, threshold=0.5)
    with pytest.raises(ValueError, match="per-exit values"):
        gate.per_exit([0.5, 0.5], 4)
