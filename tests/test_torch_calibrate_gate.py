"""`python -m early_exit_tpu_torch.calibrate_gate` against the JAX
package's tool (`tools/calibrate_gate.py::main`) on the CPU.

A tiny seeded early_conformer and splitformer (d 32, 4 heads, ffn 64, k
7, 3 exits x 1 block, char vocabulary, float32 with a float32 softmax),
its heads sharpened so that it emits letters, written with the JAX
package's checkpoint writer, calibrated by both
tools over the same `--synthetic_data` utterances. Tolerance: the same
JSON keys, the recommended score, temperatures, exit WERs, accept shares,
mean exit and gated WER equal; thresholds within 1e-6 (each is one
utterance's float32 confidence). The port's inference CLI then reads the
written file and chooses, per utterance, the exit `simulate_gate`
chose (rows whose confidence lies within 1e-6 of a threshold excepted:
there the two paths' last float bits decide). A model with one exit
exits with the JAX tool's message.
"""

import json
import os
import re

import jax
import numpy as np
import pytest

from early_exit_tpu.configs import ModelConfig as JModelConfig
from early_exit_tpu.models.registry import build_model as jbuild
from early_exit_tpu.training import checkpoint as jck
from early_exit_tpu_torch import calibrate_gate
from early_exit_tpu_torch import inference as port_inference
from early_exit_tpu_torch.cli import get_args
from early_exit_tpu_torch.data.librispeech import SyntheticDataset
from early_exit_tpu_torch.data.pipeline import Pipeline
from early_exit_tpu_torch.models import gate_calibration as gc
from torch_one_thread import one_thread  # noqa: F401

DIMS = ["--d_model", "32", "--n_heads", "4", "--d_feed_forward", "64",
        "--n_enc_exits", "3", "--n_enc_layers_per_exit", "1",
        "--depthwise_kernel_size", "7", "--n_mels", "16"]
FLAGS = ["--decoder_mode", "ctc", "--synthetic_data", "true", "--batch_size", "16",
         "--n_workers", "0", "--bpe", "false", "--compute_dtype", "float32",
         "--attn_softmax_dtype", "float32"] + DIMS
THR_ATOL = 1e-6
HEAD_GAIN, SPACE, SPACE_BIAS = 12.0, 28, 5.0


def _checkpoint(tmp, model_type, n_exits=3):
    cfg = JModelConfig(model_type=model_type, d_model=32, n_heads=4, d_feed_forward=64,
                       n_enc_exits=n_exits, n_enc_layers_per_exit=1,
                       depthwise_kernel_size=7, n_mels=16, vocab_size=32)
    params, state = jbuild(cfg).init(jax.random.PRNGKey(5), cfg)
    # sharper heads, so that the seeded model emits letters, and exit 1
    # leaning to the space, so that some of its utterances err more than
    # the final exit's and the fit escalates them (a seeded head emits
    # blanks, every exit at 100% WER)
    params["heads"]["w"] = params["heads"]["w"] * HEAD_GAIN
    params["heads"]["b"] = params["heads"]["b"].at[0, SPACE].add(SPACE_BIAS)
    path = os.path.join(tmp, f"{model_type}.ckpt")
    jck.save_pytree({"params": params, "model_state": state}, path)
    return path


@pytest.fixture(scope="module", params=["early_conformer", "splitformer"])
def calibrated(request, tmp_path_factory):
    import tools.calibrate_gate as jtool
    tmp = str(tmp_path_factory.mktemp("calib"))
    ck = _checkpoint(tmp, request.param)
    argv = ["--target_wer_delta", "0.5", "--load_model_path", ck,
            "--model_type", request.param] + FLAGS
    want = jtool.main(["--out", os.path.join(tmp, "jax.json")] + argv)
    out = os.path.join(tmp, "port.json")
    got = calibrate_gate.main(["--out", out, "--device", "cpu"] + argv)
    with open(out) as f:
        assert json.load(f) == got
    return dict(name=request.param, ck=ck, argv=argv, out=out, got=got, want=want)


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_keys(v) for v in tree]
    return None


def test_report_matches_jax(calibrated):
    got, want = calibrated["got"], calibrated["want"]
    assert _keys(got) == _keys(want)
    for k in ("split", "eval_utts", "final_exit_wer_pct", "score", "temperatures",
              "target_wer_delta_pp"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["thresholds"], want["thresholds"], atol=THR_ATOL, rtol=0)
    for score, entry in want["per_score"].items():
        mine = got["per_score"][score]
        assert mine["temperatures"] == entry["temperatures"], score
        np.testing.assert_allclose(mine["thresholds"], entry["thresholds"],
                                   atol=THR_ATOL, rtol=0)
        assert (mine["mean_exit"], mine["gated_wer_pct"]) == (entry["mean_exit"],
                                                              entry["gated_wer_pct"])
        for a, b in zip(mine["per_exit"], entry["per_exit"]):
            for k in ("exit", "temperature", "exit_wer_pct", "accept_share",
                      "ece_raw", "ece_cal"):
                assert a[k] == b[k], (score, k)
            assert abs(a["threshold"] - b["threshold"]) <= THR_ATOL, score


def test_inference_cli_reads_the_calibration(calibrated, capsys):
    """The CLI's gate chooses simulate_gate's exit for every utterance
    whose calibrated confidence is not within 1e-6 of its threshold."""
    c = calibrated
    calib = c["got"]
    port_inference.main(["--load_model_path", c["ck"], "--model_type", c["name"],
                         "--gate_calibration", c["out"], "--device", "cpu"]
                        + FLAGS)
    out = capsys.readouterr().out
    assert f"gate calibration: score={calib['score']}" in out
    chosen_cli = [int(m) for m in re.findall(r"GATED_OUT \(exit (\d+)\):", out)]
    # the same utterances through the tool's own pass
    args, cfg, tcfg, acfg, tok = get_args(["--load_model_path", c["ck"], "--model_type",
                                           c["name"], "--device", "cpu"] + FLAGS,
                                          mode="infer")
    model = port_inference.load_model(args, cfg, "cpu")
    pipe = Pipeline(SyntheticDataset(n_items=16, seed=args.seed + 7), tok, acfg, tcfg,
                    bpe=False, shuffle=False, infer_mode=True, workers=1, device="cpu")
    temps = list(gc.DEFAULT_TEMP_GRID)
    conf, errors, words = calibrate_gate.calibration_set(model, pipe, tok, [calib["score"]],
                                                         temps, cfg.blank_id)
    cal = np.stack([conf[0, temps.index(t), e] for e, t in enumerate(calib["temperatures"])])
    _, _, chosen = gc.simulate_gate(cal, calib["thresholds"], errors, words)
    assert len(chosen_cli) == len(chosen) == calib["eval_utts"]
    near = (np.abs(cal - np.asarray(calib["thresholds"])[:, None]) <= THR_ATOL).any(0)
    assert near.sum() <= 2
    np.testing.assert_array_equal(np.asarray(chosen_cli)[~near], chosen[~near])


def test_single_exit_model_is_refused_as_in_jax(tmp_path):
    import tools.calibrate_gate as jtool
    argv = ["--model_type", "early_zipformer", "--load_model_path", "unused"] + FLAGS
    argv[argv.index("--n_enc_exits") + 1] = "19"
    with pytest.raises(SystemExit) as want:
        jtool.main(["--out", str(tmp_path / "j.json")] + argv)
    with pytest.raises(SystemExit) as got:
        calibrate_gate.main(["--out", str(tmp_path / "p.json"), "--device", "cpu"] + argv)
    assert str(got.value) == str(want.value)
    assert "multi-exit encoder" in str(got.value)
