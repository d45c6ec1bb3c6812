"""The gate calibration fits (`models/gate_calibration.py`) against the
JAX package's (`early_exit_tpu/models/gate_calibration.py`), and the
port's `utils/metrics.edit_ops` against `_edit_ops`.

The same seeded numpy inputs go through both: confidences with ties (two
decimals, so that a cut can fall inside a tie), per-utterance error
counts that fall with depth, word counts. Tolerance: temperature
indices, thresholds, chosen exits, mean exit and gated WER equal; `ece`
within 1e-12.
"""

import numpy as np
import pytest
import torch

from early_exit_tpu.models import gate_calibration as jgc
from early_exit_tpu.utils.metrics import _edit_ops
from early_exit_tpu_torch.decoding.lexicon import edit_distance
from early_exit_tpu_torch.models import gate_calibration as gc
from early_exit_tpu_torch.utils.metrics import edit_ops


def _corpus(seed, E=4, N=64, ties=True):
    """(conf (E, N), errors (E, N), words (N,)): deeper exits err less and
    are more confident."""
    r = np.random.RandomState(seed)
    words = r.randint(5, 25, size=N).astype(np.float64)
    conf = np.clip(r.beta(2, 2, size=(E, N)) + np.linspace(0, 0.3, E)[:, None], 0, 1)
    if ties:
        conf = np.round(conf, 2)
    rate = np.linspace(0.5, 0.05, E)[:, None]
    errors = r.binomial(words.astype(int)[None, :].repeat(E, 0), rate).astype(np.float64)
    errors[:, r.rand(N) < 0.3] = 0.0                    # clean utterances
    return conf, errors, words


def test_temp_grid_equals_jax():
    assert gc.DEFAULT_TEMP_GRID == jgc.DEFAULT_TEMP_GRID
    assert 1.0 in gc.DEFAULT_TEMP_GRID


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ece_and_fit_temperature_match_jax(seed):
    r = np.random.RandomState(seed)
    correct = (r.rand(80) < 0.6).astype(np.float64)
    conf_k = np.clip(r.rand(len(jgc.DEFAULT_TEMP_GRID), 80) * 0.8 + 0.1 * correct, 0, 1)
    conf_k[0, :5] = [0.0, 1.0, 0.1, 0.9, 1.0]           # bin edges, both ends
    for k in range(conf_k.shape[0]):
        assert abs(gc.ece(conf_k[k], correct) - jgc.ece(conf_k[k], correct)) <= 1e-12
        assert abs(gc.ece(conf_k[k], correct, 7) - jgc.ece(conf_k[k], correct, 7)) <= 1e-12
    assert (gc.fit_temperature(conf_k, gc.DEFAULT_TEMP_GRID, correct)
            == jgc.fit_temperature(conf_k, jgc.DEFAULT_TEMP_GRID, correct))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("target", [0.0, 0.05, 0.2, 1.0])
def test_pick_threshold_matches_jax(seed, target):
    conf, errors, words = _corpus(seed)
    for e in range(conf.shape[0]):
        got = gc.pick_threshold(conf[e], errors[e], words, target)
        want = jgc.pick_threshold(conf[e], errors[e], words, target)
        assert got[:2] == want[:2]
        assert got[2] == want[2] or (np.isnan(got[2]) and np.isnan(want[2]))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("ties", [True, False])
def test_sequential_thresholds_and_gate_match_jax(seed, ties):
    conf, errors, words = _corpus(seed, ties=ties)
    final = errors[-1].sum() / words.sum()
    for delta in (0.0, 0.005, 0.05):
        thr = gc.fit_sequential_thresholds(conf, errors, words, final + delta)
        assert thr == jgc.fit_sequential_thresholds(conf, errors, words, final + delta)
        mean, wer, chosen = gc.simulate_gate(conf, thr, errors, words)
        j_mean, j_wer, j_chosen = jgc.simulate_gate(conf, thr, errors, words)
        assert (mean, wer) == (j_mean, j_wer)
        np.testing.assert_array_equal(chosen, j_chosen)
        assert wer <= final + delta + 1e-12


@pytest.mark.parametrize("temperature", [0.25, 1.0, 4.0])
def test_scaled_confidence_matches_jax(temperature):
    r = np.random.RandomState(3)
    logits = r.randn(3, 9, 11).astype(np.float32) * 3
    lp = torch.log_softmax(torch.from_numpy(logits), -1)
    mask = torch.arange(9)[None, :] < torch.tensor([9, 5, 1])[:, None]
    for score in ("maxprob", "margin", "negentropy"):
        got = gc.scaled_confidence(lp, mask, score, temperature).numpy()
        want = np.asarray(jgc.scaled_confidence(lp.numpy(), mask.numpy(), score,
                                                temperature))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_edit_ops_matches_jax(seed):
    r = np.random.RandomState(seed)
    vocab = ["a", "b", "c", "d"]
    for _ in range(50):
        ref = list(r.choice(vocab, r.randint(0, 8)))
        hyp = list(r.choice(vocab, r.randint(0, 8)))
        assert edit_ops(ref, hyp) == _edit_ops(ref, hyp) == edit_distance(ref, hyp)
