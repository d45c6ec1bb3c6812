"""`python -m early_exit_tpu_torch.escalation_report` against the JAX
package's tool (`tools/escalation_report.py::main`) on the CPU.

A tiny seeded early_conformer (d 32, 4 heads, ffn 64, k 7, 3 exits x 1
block, BPE-256, float32 compute; the tool's bf16 attention softmax), its
heads sharpened so that it emits tokens, written with the JAX package's
checkpoint writer; a calib JSON with as many exits, exit 1's threshold
at 0.5; both tools over the same 24 synthetic utterances with a sweep of
exit 1's threshold. Tolerance: the two reports equal (every key, every
rounded figure), thresholds within 1e-6. The module's own helpers
(`wer_counts`, `pearson`, `spearman`, `simulate_point`) equal the JAX
tool's on seeded inputs.
"""

import json
import os

import jax
import numpy as np
import pytest

from early_exit_tpu.configs import ModelConfig as JModelConfig
from early_exit_tpu.models import early_conformer as jec
from early_exit_tpu.training import checkpoint as jck
from early_exit_tpu_torch import escalation_report as port

TINY = {"d_model": 32, "n_enc_exits": 3, "n_enc_layers_per_exit": 1, "n_heads": 4,
        "d_feed_forward": 64, "depthwise_kernel_size": 7, "compute_dtype": "float32"}
HEAD_GAIN = 12.0


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    from tools import escalation_report as jtool
    tmp = str(tmp_path_factory.mktemp("esc"))
    cfg = JModelConfig(**TINY)
    params, state = jec.init(jax.random.PRNGKey(0), cfg)
    # sharper heads: a seeded head emits blanks at every exit
    params["heads"]["w"] = params["heads"]["w"] * HEAD_GAIN
    ckpt = os.path.join(tmp, "mod000-transformer")
    jck.save_pytree({"params": params, "model_state": state}, ckpt)
    calib = {"score": "maxprob", "thresholds": [0.5, 2.0, 0.0],
             "temperatures": [2.0, 1.0, 1.0],
             "tokenizer": "assets/spm/synth.bpe-256.model",
             "bench_eval": {"min_words": 2, "max_words": 4, "noise": 0.02,
                            "noise_hi": 0.5}}
    calib_path = os.path.join(tmp, "calib.json")
    with open(calib_path, "w") as f:
        json.dump(calib, f)
    argv = ["--ckpt", ckpt, "--calib", calib_path, "--n_utts", "24", "--batch_size", "8",
            "--n_buckets", "2", "--sweep", "0.0,0.3,0.9", "--model_json", json.dumps(TINY)]
    want = jtool.main(argv + ["--out", os.path.join(tmp, "jax.json")])
    out = os.path.join(tmp, "port.json")
    got = port.main(argv + ["--out", out, "--device", "cpu"])
    with open(out) as f:
        assert json.load(f) == got
    return got, want


def test_report_matches_jax(reports):
    got, want = reports
    assert set(got) == set(want)
    for point_g, point_w in zip(got["operating_points"], want["operating_points"]):
        np.testing.assert_allclose(point_g.pop("thresholds"), point_w.pop("thresholds"),
                                   atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.pop("thresholds"), want.pop("thresholds"), atol=1e-6,
                               rtol=0)
    assert got == want


def test_report_is_not_degenerate(reports):
    """The sweep moves utterances between exits, and some exit emits
    words: the comparison above holds figures, not constants."""
    got, _ = reports
    hists = [tuple(p["accept_histogram"].values()) for p in got["operating_points"]]
    assert len(set(hists)) >= 2
    assert min(got["exit_wer_ladder"].values()) < 100.0 or max(
        got["exit_wer_ladder"].values()) > 100.0


@pytest.mark.parametrize("seed", [0, 1])
def test_helpers_match_jax(seed):
    from tools import escalation_report as jtool
    r = np.random.RandomState(seed)
    vocab = ["a", "b", "c"]
    for _ in range(20):
        ref, hyp = list(r.choice(vocab, r.randint(0, 6))), list(r.choice(vocab, r.randint(0, 6)))
        assert port.wer_counts(ref, hyp) == jtool.wer_counts(ref, hyp)
    a, b = r.rand(40), r.rand(40)
    assert port.pearson(a, b) == jtool.pearson(a, b)
    assert port.spearman(a, b) == jtool.spearman(a, b)
    E, N = 4, 40
    conf, sig = r.rand(E, N), r.rand(N)
    eerr, words = r.randint(0, 5, (E, N)).astype(float), r.randint(1, 9, N).astype(float)
    thr = [0.7, 2.0, 0.5, 0.0]
    assert (port.simulate_point(thr, conf, sig, eerr, words, E, 3)
            == jtool.simulate_point(thr, conf, sig, eerr, words, E, 3))
