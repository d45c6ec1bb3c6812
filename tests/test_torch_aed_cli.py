"""`python -m early_exit_tpu_torch.inference --decoder_mode aed` against
the JAX package's `inference.py`, and `python -m early_exit_tpu_torch.train
--decoder_mode aed`, end to end on the CPU.

Set-up: a tiny full_conformer (d 32, 2 exits x 1 block, 2 decoder layers,
4 heads, ffn 64, k 7, BPE-256), initialised from a seed by the JAX package
(its output products and CTC heads widened, so that the random model's
beams differ from lane to lane and from exit to exit) and saved with its
checkpoint writer. Both CLIs run in process over the synthetic corpus in
the float32 profile; their EXPECTED, BEAM_OUT and WER lines must be equal,
without and with --rescore_ctc_weight. Also: --streaming with AED exits
with the JAX CLI's message, and the training CLI takes its steps in AED
mode and saves a checkpoint the inference CLI decodes.
"""

import os

import jax
import pytest

from early_exit_tpu.configs import ModelConfig as JModelConfig
from early_exit_tpu.models import full_conformer as jfc
from early_exit_tpu.training import checkpoint as jck
from early_exit_tpu_torch import inference as port_inference
from early_exit_tpu_torch import train as port_train

from test_torch_infer_cli import jax_inference  # noqa: F401
from torch_one_thread import one_thread  # noqa: F401

TINY = ["--d_model", "32", "--n_enc_exits", "2", "--n_enc_layers_per_exit", "1",
        "--n_heads", "4", "--d_feed_forward", "64", "--depthwise_kernel_size", "7",
        "--n_dec_layers", "2", "--batch_size", "4", "--n_batch_split", "1",
        "--n_workers", "2", "--beam_size", "4"]
F32 = ["--compute_dtype", "float32", "--attn_softmax_dtype", "float32"]
KEEP = ("EXPECTED:", "BEAM_OUT_", "WER", "trainable parameters")


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("aed_cli")
    cfg = JModelConfig(model_type="full_conformer", d_model=32, n_heads=4,
                       d_feed_forward=64, n_enc_exits=2, n_enc_layers_per_exit=1,
                       n_dec_layers=2, depthwise_kernel_size=7, vocab_size=256)
    params, state = jfc.init(jax.random.PRNGKey(9), cfg)
    params["out_linear"]["w"] = params["out_linear"]["w"] * 6.0
    params["heads"]["w"] = params["heads"]["w"] * 6.0
    jck.save_pytree({"params": params, "model_state": state}, str(d / "model"))
    return str(d / "model")


def _lines(out):
    return [ln for ln in out.splitlines() if any(k in ln for k in KEEP)]


@pytest.mark.parametrize("extra", [[], ["--rescore_ctc_weight", "0.5"]],
                         ids=["beam", "rescored"])
def test_aed_cli_lines_equal_jax(model_path, jax_inference, capsys, extra):
    argv = ["--decoder_mode", "aed", "--synthetic_data", "true",
            "--load_model_path", model_path, *TINY, *F32, *extra]
    jax_inference.main(argv)
    want = _lines(capsys.readouterr().out)
    port_inference.main(argv + ["--device", "cpu"])
    got = _lines(capsys.readouterr().out)
    assert got == want
    hyps = [ln.split(" : ", 1)[-1] for ln in got if "BEAM_OUT_" in ln]
    assert len(hyps) == 16 and sum("EXPECTED:" in ln for ln in got) == 8
    assert len(set(hyps)) > 4, "the beams agree everywhere: the comparison would see little"


def test_aed_streaming_exits_with_the_jax_message(model_path, jax_inference):
    argv = ["--decoder_mode", "aed", "--synthetic_data", "true", "--streaming", "true",
            "--load_model_path", model_path, *TINY]
    with pytest.raises(SystemExit, match="whole-utterance only") as got:
        port_inference.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as want:
        jax_inference.main(argv)
    assert str(got.value) == str(want.value)


def test_aed_train_cli_trains_and_saves(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    port_train.main(["--decoder_mode", "aed", "--synthetic_data", "true", "--device", "cpu",
                     "--n_epochs", "1", *TINY, "--save_model_dir", ck,
                     "--log_dir", str(tmp_path / "runs")])
    out = capsys.readouterr().out
    assert "step 1 loss" in out and "LOSS_TOTAL-0 :=" in out
    assert "CTC_OUT" not in out                  # no sample decode in AED mode
    path = os.path.join(ck, "mod000-transformer")
    assert os.path.exists(path)
    port_inference.main(["--decoder_mode", "aed", "--synthetic_data", "true",
                         "--device", "cpu", "--load_model_path", path, *TINY])
    assert "synthetic WER exit 2:" in capsys.readouterr().out
