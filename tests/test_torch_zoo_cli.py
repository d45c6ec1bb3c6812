"""Both CLIs of the port with --model_type splitformer and early_zipformer
against the JAX package's `train.py` and `inference.py`, end to end on
the CPU at a tiny size (d 32, 4 heads, ffn 64, k 7, BPE-256; the
splitformer 3 exits x 1 block, the zipformer --n_enc_exits 19
--n_enc_layers_per_exit 1), in process, over the synthetic corpus.

- inference, float32 profile, from a checkpoint the JAX package wrote:
  the printed transcript lines (EXPECTED, BEAM_OUT, GATED_OUT) and the
  WER and gate summary lines equal the JAX CLI's, greedy for both
  families and gated for the splitformer; the zipformer's --exit_threshold
  and the splitformer's --cascade_k end with the JAX CLI's refusal;
- training: the parameter-count and set-up lines equal the JAX CLI's,
  one epoch on the CPU writes a pair the JAX package reads, and the
  inference CLI decodes from it (with the block and head kernels' plain
  versions, --fused_block true) one line per utterance and exit.
- the serving modes the JAX package refuses a zoo model (streaming, the
  cascade, the zipformer's gate) refuse it in the port with its text.
"""

import importlib.util
import os

import jax
import pytest
import torch

from early_exit_tpu.configs import ModelConfig as JModelConfig
from early_exit_tpu.models import splitformer as jsf
from early_exit_tpu.models import zipformer as jzf
from early_exit_tpu.training import checkpoint as jck
from early_exit_tpu_torch import export_serving as port_export
from early_exit_tpu_torch import inference as port_inference
from early_exit_tpu_torch import train as port_train
from early_exit_tpu_torch.configs import AudioConfig, ModelConfig
from early_exit_tpu_torch.models.registry import build_model
from early_exit_tpu_torch.serving import export as exp
from early_exit_tpu_torch.serving.recognizer import Recognizer
from early_exit_tpu_torch.serving.streaming import StreamingRecognizer, StreamPool
from early_exit_tpu_torch.tokenizer import load_decoder
from early_exit_tpu_torch import checkpoint
from torch_one_thread import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--d_model", "32", "--n_heads", "4", "--d_feed_forward", "64",
        "--depthwise_kernel_size", "7", "--n_enc_layers_per_exit", "1",
        "--batch_size", "4", "--n_batch_split", "1", "--n_workers", "2",
        "--compute_dtype", "float32", "--attn_softmax_dtype", "float32"]
FAMILIES = {"splitformer": (jsf, 3), "early_zipformer": (jzf, 19)}
KEEP = ("EXPECTED:", "BEAM_OUT_", "GATED_OUT", "WER", "trainable parameters")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flags(name):
    return BASE + ["--model_type", name, "--n_enc_exits", str(FAMILIES[name][1])]


@pytest.fixture(scope="module")
def jax_cli():
    return {"inference": _load("jax_inference_zoo", os.path.join(REPO, "inference.py")),
            "train": _load("jax_train_zoo", os.path.join(REPO, "train.py"))}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """One JAX-initialised checkpoint per family, heads widened x6 so that
    the random models emit tokens, not only blanks."""
    d = tmp_path_factory.mktemp("zoo_cli")
    for name, (mod, E) in FAMILIES.items():
        cfg = JModelConfig(model_type=name, d_model=32, n_heads=4, d_feed_forward=64,
                           n_enc_exits=E, n_enc_layers_per_exit=1,
                           depthwise_kernel_size=7, vocab_size=256)
        params, state = mod.init(jax.random.PRNGKey(5), cfg)
        head = "heads" if name == "splitformer" else "head"
        params[head]["w"] = params[head]["w"] * 6.0
        jck.save_pytree({"params": params, "model_state": state}, str(d / name))
    return d


def _lines(out):
    return [ln for ln in out.splitlines() if any(k in ln for k in KEEP)]


def _infer(name, d, *extra):
    return (["--decoder_mode", "ctc", "--synthetic_data", "true",
             "--load_model_path", str(d / name)] + _flags(name) + list(extra))


@pytest.mark.parametrize("name,extra", [
    ("splitformer", []),
    ("splitformer", ["--exit_threshold", "0.58"]),
    ("early_zipformer", []),
], ids=["splitformer-greedy", "splitformer-gate", "early_zipformer-greedy"])
def test_inference_lines_equal_jax(ckpts, jax_cli, capsys, name, extra):
    argv = _infer(name, ckpts, *extra)
    jax_cli["inference"].main(argv)
    want = _lines(capsys.readouterr().out)
    port_inference.main(argv + ["--device", "cpu"])
    got = _lines(capsys.readouterr().out)
    assert got == want
    E = 1 if extra else FAMILIES[name][1] if name == "splitformer" else 1
    assert sum("EXPECTED:" in ln for ln in got) == 8
    assert sum("_OUT" in ln for ln in got) == 8 * E
    assert any(ln.split(":", 2)[-1].strip() for ln in got if "_OUT" in ln)
    if extra:
        exits = {ln.split("(exit ")[1][0] for ln in got if "GATED_OUT" in ln}
        assert len(exits) >= 2, exits             # the gate chose more than one exit


@pytest.mark.parametrize("name,extra,err", [
    ("early_zipformer", ["--exit_threshold", "0.5"], SystemExit),
    ("splitformer", ["--exit_threshold", "0.5", "--cascade_k", "1"], ValueError),
])
def test_inference_refusals_equal_jax(ckpts, jax_cli, name, extra, err):
    argv = _infer(name, ckpts, *extra)
    with pytest.raises(err) as want:
        jax_cli["inference"].main(argv)
    with pytest.raises(err) as got:
        port_inference.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert name in str(got.value)


def _train(name, d, *extra):
    return (["--decoder_mode", "ctc", "--synthetic_data", "true",
             "--save_model_dir", str(d / "ck"), "--log_dir", str(d / "runs")]
            + _flags(name) + list(extra))


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_train_then_infer(tmp_path, jax_cli, capsys, name):
    jax_cli["train"].main(_train(name, tmp_path / "jax", "--n_epochs", "0"))
    want = capsys.readouterr().out.splitlines()
    port_train.main(_train(name, tmp_path, "--n_epochs", "1", "--device", "cpu"))
    got = capsys.readouterr().out.splitlines()
    count = [ln for ln in want if "trainable parameters" in ln]
    assert len(count) == 1 and count[0] in got
    setup = [ln.split(" devices:")[0] for ln in want if ln.startswith("batch_size:")]
    assert [ln.split(" device:")[0] for ln in got if ln.startswith("batch_size:")] == setup
    assert any(ln.startswith("LOSS_TOTAL-0 :=") for ln in got)
    assert "CTC_OUT :" in "\n".join(got)
    # the JAX package reads the port's pair with its own templates
    mod, E = FAMILIES[name]
    cfg = JModelConfig(model_type=name, d_model=32, n_heads=4, d_feed_forward=64,
                       n_enc_exits=E, n_enc_layers_per_exit=1, depthwise_kernel_size=7,
                       vocab_size=256)
    jck.load_epoch(str(tmp_path / "ck"), 0, *mod.init(jax.random.PRNGKey(0), cfg))
    ck = str(tmp_path / "ck" / "mod000-transformer")
    port_inference.main(["--decoder_mode", "ctc", "--synthetic_data", "true",
                         "--load_model_path", ck, "--device", "cpu", "--fused_block", "true"]
                        + _flags(name))
    out = capsys.readouterr().out
    n_out = E if name == "splitformer" else 1
    assert sum("BEAM_OUT_" in ln for ln in out.splitlines()) == 8 * n_out
    assert sum(" WER exit " in ln for ln in out.splitlines()) == n_out


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_serving_entries_refuse_the_zoo_by_name(tmp_path, ckpts, name):
    """What the JAX package refuses a zoo model, the port refuses with its
    text: streaming (`StreamingRecognizer`, and so `StreamPool`), the
    cascade (`Recognizer.transcribe_gated`, `export_recognizer`, the
    export CLI) and, for the zipformer, the gate. `Recognizer` and the
    all-exit export take both families (`tests/test_torch_zoo_export.py`)."""
    cfg = ModelConfig(model_type=name, d_model=32, n_heads=4, d_feed_forward=64,
                      n_enc_exits=FAMILIES[name][1], n_enc_layers_per_exit=1,
                      depthwise_kernel_size=7)
    model = build_model(cfg)
    tok = load_decoder(checkpoint.bound_tokenizer(checkpoint.load_calib()))
    rec = Recognizer(model, tok, device="cpu")
    wav, n = torch.zeros(1, 16000), torch.tensor([16000])
    streaming = f"{name} checkpoints are batch-only"
    cascade = "cascade serving supports early_conformer"
    cases = [
        (streaming, lambda: StreamingRecognizer(model, AudioConfig(), tok)),
        (streaming, lambda: StreamPool(2, model, AudioConfig(), tok)),
        (cascade, lambda: rec.transcribe_gated(wav, n)),
        (cascade, lambda: exp.export_recognizer(
            model, AudioConfig(), [(1, 16000)], platforms=("cpu",), cascade_k=1)),
        (cascade, lambda: port_export.main(
            _infer(name, ckpts) + ["--export_path", str(tmp_path / "m.eetx"),
                                   "--export_platforms", "cpu", "--export_cascade_k", "1"]))]
    if name == "early_zipformer":
        gate = "has a single output exit"
        cases += [
            (gate, lambda: rec.transcribe_gated(wav, n, strategy="whileloop")),
            (gate, lambda: exp.export_recognizer(
                model, AudioConfig(), [(1, 16000)], platforms=("cpu",), gated=True)),
            (gate, lambda: port_export.main(
                _infer(name, ckpts) + ["--export_path", str(tmp_path / "m.eetx"),
                                       "--export_platforms", "cpu", "--export_gated", "true"]))]
    for match, call in cases:
        with pytest.raises(ValueError, match=match):
            call()
    assert not (tmp_path / "m.eetx").exists()