"""Cascade serving (`serving/cascade.py`) against the JAX package's, on
the same numpy-seeded inputs and weights (carried by `interop`), float32
compute, and against the port's own `gated_apply`, whose per-row
decisions it must reproduce. Small model: d=32, 4 heads, ffn 64, k=7,
4 exits x 1 layer, vocab 16. One test runs the flagship's weights.

Tolerance: chosen exits, accept masks and sub-lengths equal; log-probs
and the cached hidden state within 1e-4 (float32 sums in another order
through up to 4 blocks). Thresholds sit at quantiles of the model's own
confidences. With quantize="int8" a moved int8 level shows in the
log-probs, held to 0.05 there. Within the port the cascade and the gate
run the same float32 ops on the same rows, so their log-probs agree to
1e-5 (the batch's size may change a product's blocking).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from early_exit_tpu.configs import ModelConfig as JaxModelConfig
from early_exit_tpu.models import early_conformer as jec
from early_exit_tpu.models import gate_calibration as jcal
from early_exit_tpu.serving import cascade as jcascade
from early_exit_tpu_torch import checkpoint, interop
from early_exit_tpu_torch.configs import ModelConfig
from early_exit_tpu_torch.data.synthetic import synth_batch
from early_exit_tpu_torch.models.early_exit_gate import gated_apply
from early_exit_tpu_torch.serving import cascade
from early_exit_tpu_torch.serving.recognizer import Recognizer
from torch_one_thread import one_thread  # noqa: F401

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
    conf = np.stack([np.asarray(jcal.scaled_confidence(
        lp[e], mask, "maxprob", TEMPS[e])) for e in range(4)])
    thr = [float(np.quantile(conf[0], 0.5)), float(np.quantile(conf[1], 0.7)),
           float(np.quantile(conf[2], 0.85)), 0.0]
    return dict(params=params, state=state, feats=feats, lengths=lengths, thr=thr)


def _port_model(b, **over):
    return interop.from_jax_params(b["params"], b["state"],
                                   ModelConfig(**{**KW, **over}))


def _port_cascade(model, b, k, thr, *, item_mask=None, pack_batch=2):
    """Both phases with the host re-batching between: (chosen, logp,
    phase-A outputs, phase-B outputs or None, idx)."""
    gate = dict(k=k, threshold=thr, temperatures=TEMPS)
    a = cascade.shallow_apply(
        model, torch.from_numpy(b["feats"]), torch.from_numpy(b["lengths"]),
        item_mask=None if item_mask is None else torch.from_numpy(item_mask),
        **gate)
    logp, chosen, accepted, sub_len, h_k = a
    logp, chosen = logp.clone(), chosen.clone()
    idx, real = cascade.pack_escalation_indices(accepted.numpy(), pack_batch)
    bb = None
    if idx.size:
        it = torch.from_numpy(idx).long()
        bb = cascade.continue_apply(model, h_k.index_select(0, it),
                                    sub_len.index_select(0, it), **gate)
        n = int(real.sum())
        logp[it[:n]], chosen[it[:n]] = bb[0][:n], bb[1][:n]
    return chosen, logp, a, bb, idx


@pytest.mark.parametrize("case", [
    dict(k=1), dict(k=2), dict(k=3),
    dict(k=2, item_mask=np.array([1, 1, 0, 1, 0, 1], np.float32)),
    dict(k=2, skip=True),
    dict(k=2, over=dict(quantize="int8")),
    dict(k=2, over=dict(fused_block=True)),
], ids=["k1", "k2", "k3", "item_mask", "never-accept", "int8", "fused"])
def test_cascade_matches_jax_cascade(bundle, case):
    b, k, over = bundle, case["k"], case.get("over", {})
    atol = 0.05 if "quantize" in over else 1e-4
    thr = [2.0, b["thr"][1], 2.0, 0.0] if case.get("skip") else b["thr"]
    im = case.get("item_mask")
    jcfg = JaxModelConfig(**{**KW, **over})
    gate = dict(k=k, threshold=thr, temperatures=TEMPS)
    ja = jcascade.shallow_apply(
        b["params"], b["state"], jnp.asarray(b["feats"]),
        jnp.asarray(b["lengths"]), jcfg,
        item_mask=None if im is None else jnp.asarray(im), **gate)
    _, _, a, bb, idx = _port_cascade(_port_model(b, **over), b, k, thr,
                                     item_mask=im)
    for got, ref, exact in zip(a, ja, (False, True, True, True, False)):
        if exact:
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol, rtol=0)
    jidx, _ = jcascade.pack_escalation_indices(np.asarray(ja[2]), 2)
    np.testing.assert_array_equal(idx, jidx)
    assert idx.size, "the fixture must escalate some rows"
    jb = jcascade.continue_apply(
        b["params"], b["state"], jnp.take(ja[4], jnp.asarray(jidx), axis=0),
        jnp.take(ja[3], jnp.asarray(jidx), axis=0), jcfg, **gate)
    np.testing.assert_array_equal(bb[1].numpy(), np.asarray(jb[1]))
    np.testing.assert_allclose(bb[0].numpy(), np.asarray(jb[0]), atol=atol, rtol=0)
    if im is not None:
        assert a[2][2] and a[2][4] and a[1][2] == 0 and a[1][4] == 0
    if case.get("skip"):          # exit 1 never accepts, its head is skipped
        assert (a[1][a[2]] == 2).all()


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("over", [{}, dict(quantize="int8", fused_block=True)],
                         ids=["float", "int8-fused"])
def test_cascade_matches_gated_apply_rowwise(bundle, k, over):
    b = bundle
    model = _port_model(b, **over)
    g_lp, g_chosen, _, _ = gated_apply(
        model, torch.from_numpy(b["feats"]), torch.from_numpy(b["lengths"]),
        threshold=b["thr"], temperatures=TEMPS)
    chosen, logp, a, _, _ = _port_cascade(model, b, k, b["thr"])
    assert torch.equal(chosen, g_chosen)
    np.testing.assert_allclose(logp.numpy(), g_lp.numpy(), atol=1e-5, rtol=0)
    accepted = a[2].numpy()
    assert accepted.any() and (~accepted).any()     # both phases ran


def test_pack_escalation_indices_matches_jax():
    r = np.random.RandomState(0)
    for n, pack in ((8, 3), (5, 8), (128, 8), (4, 2)):
        acc = r.rand(n) < 0.6
        for a in (acc, np.ones(n, bool), np.zeros(n, bool)):
            got = cascade.pack_escalation_indices(a, pack)
            ref = jcascade.pack_escalation_indices(a, pack)
            for g, w in zip(got, ref):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
    idx, m = cascade.pack_escalation_indices(
        np.array([True, False, True, False, False, True, True, False]), 3)
    np.testing.assert_array_equal(idx, [1, 3, 4, 7, 0, 0])
    np.testing.assert_array_equal(m, [1, 1, 1, 1, 0, 0])


def test_choose_k_matches_jax():
    r = np.random.RandomState(0)
    cases = [[0.7, 0.1, 0.05, 0.05, 0.05, 0.05], [0.0] * 6,
             [0.4, 0.6, 0, 0, 0, 0], [0.25, 0.4, 0.2, 0.1, 0.05, 0.0]]
    cases += [list(r.dirichlet(np.ones(6))) for _ in range(20)]
    for shares in cases:
        assert cascade.choose_k(shares, 6) == jcascade.choose_k(shares, 6)
    assert cascade.choose_k(cases[0], 6) == 1 and cascade.choose_k(cases[3], 6) == 2


def test_reachable_and_the_checks(bundle):
    thr = [2.0, 0.5, 2.0, 0.0]
    assert cascade._reachable(thr, 0, 4) == [False, True, False, True]
    assert cascade._reachable(thr, 2, 2) == jcascade._reachable(thr, 2, 2)
    assert cascade._reachable(0.5, 0, 4) == [True] * 4
    model = _port_model(bundle)
    args = (torch.from_numpy(bundle["feats"]), torch.from_numpy(bundle["lengths"]))
    with pytest.raises(ValueError, match="k must be"):
        cascade.shallow_apply(model, *args, k=4, threshold=0.5)
    with pytest.raises(ValueError, match="k must be"):
        cascade.continue_apply(model, torch.zeros(1, 4, 32), torch.tensor([4]),
                               k=0, threshold=0.5)
    with pytest.raises(ValueError, match="cascade serving supports"):
        cascade._check_model(ModelConfig(model_type="splitformer"))


def test_earliest_ok_picks_the_first_true():
    conf = torch.tensor([[0.1, 0.9, 0.2], [0.8, 0.9, 0.1]])
    thr = torch.tensor([0.5, 0.5])
    rel, acc = cascade._earliest_ok(conf, thr, fallback_last=False)
    assert rel.tolist() == [1, 0, 2] and acc.tolist() == [True, True, False]
    rel, acc = cascade._earliest_ok(conf, thr, fallback_last=True)
    assert rel.tolist() == [1, 0, 1] and acc.all()


def test_flagship_cascade_matches_its_gate_on_the_cpu():
    """Path (A) at full width on the CPU (the kernels' plain versions),
    4 in-distribution requests: under the committed calibration, and with
    exit 2's threshold moved into the batch's own confidences so that both
    phases run. Chosen exits and greedy tokens are those of `gated_apply`."""
    rec = Recognizer.from_flagship("cpu")
    wav, counts, refs = synth_batch(rec.calib["bench_eval"], 4, seed=4242)
    assert rec.gate_settings()["threshold"][1] == pytest.approx(0.688, abs=1e-3)
    out = rec.transcribe_gated(wav, counts)
    ref = rec.transcribe_gated(wav, counts, strategy="whileloop")
    assert torch.equal(out.chosen_exit, ref.chosen_exit)
    assert set(out.chosen_exit.tolist()) <= {2, 6}    # what the thresholds allow
    assert out.texts == ref.texts and len(out.texts) == 4

    feats, lengths = rec._features(wav, counts)
    gate = rec.gate_settings()
    lp, sub_len = rec.model.encode_exit(feats, lengths, 2)
    mask = torch.arange(lp.shape[1])[None, :] < sub_len[:, None]
    from early_exit_tpu_torch.models.gate_calibration import scaled_confidence
    conf = scaled_confidence(lp, mask, gate["score"], gate["temperatures"][1])
    thr = list(gate["threshold"])
    thr[1] = float(conf.sort().values[1:3].mean())     # two rows escalate
    rec.calib = {**rec.calib, "thresholds": thr}
    out = rec.transcribe_gated(wav, counts)
    ref = rec.transcribe_gated(wav, counts, strategy="whileloop")
    assert sorted(out.chosen_exit.tolist()) == [2, 2, 6, 6]
    assert out.escalated_share == 0.5 and out.rows_packed == 8
    assert torch.equal(out.chosen_exit, ref.chosen_exit)
    assert out.texts == ref.texts
