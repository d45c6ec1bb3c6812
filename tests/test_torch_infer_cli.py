"""`python -m early_exit_tpu_torch.inference` against the JAX package's
`inference.py`, end to end on the CPU.

Set-up: a tiny early_conformer (d 32, 2 exits x 1 layer, 4 heads, ffn
64, k 7, BPE-256), initialised from a seed by the JAX package and saved
with its checkpoint writer, and a LibriSpeech-layout FLAC corpus of 6
utterances. Both CLIs run in process with the float32 profile
(--compute_dtype float32 --attn_softmax_dtype float32); their printed
transcript lines (EXPECTED, BEAM_OUT, GATED_OUT, TIMESTAMPS) and WER and
gate summary lines must be equal, for greedy (with timestamps), the
prefix beam (with timestamps), the lexicon beam with an ARPA LM trained
from the corpus's transcripts, the while-loop gate, the cascade, an
`avg_models` range over two bf16 checkpoint files, --streaming
(STREAM_OUT lines of every exit, and gated per chunk with its exit
histogram), and --fused_block true in the four dtype mixes the block
kernel took last (W8A8 with bf16 compute and a float32 residual, W8A8
with float32 compute and a float32 or bf16 residual, float32 compute
with a bf16 residual).

Also: what the port cannot run raises by name (an early_zipformer of
other than 19 exits, as in the JAX package; --conv_norm group with
--fused_block true),
--streaming's usage errors exit with the JAX CLI's messages, and the CLI
needs a GPU unless told --device cpu.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from early_exit_tpu.configs import ModelConfig as JModelConfig
from early_exit_tpu.models import early_conformer as jec
from early_exit_tpu.training import checkpoint as jck
from early_exit_tpu_torch import inference as port_inference

from test_torch_infer_data import write_corpus
from torch_one_thread import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--d_model", "32", "--n_enc_exits", "2", "--n_enc_layers_per_exit", "1",
        "--n_heads", "4", "--d_feed_forward", "64", "--depthwise_kernel_size", "7",
        "--batch_size", "4", "--n_batch_split", "1", "--n_workers", "2",
        "--compute_dtype", "float32", "--attn_softmax_dtype", "float32"]
KEEP = ("EXPECTED:", "BEAM_OUT_", "GATED_OUT", "STREAM_OUT", "TIMESTAMPS:", "WER",
        "histogram",
        "escalated:", "gate calibration", "shallow fusion", "trainable parameters")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_inference():
    return _load("jax_inference_cli", os.path.join(REPO, "inference.py"))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("infer_cli")
    write_corpus(str(d / "corpus"), speakers=("19", "103", "7"), chapters=("200",),
                 per_chapter=2, seed=21)
    cfg = JModelConfig(d_model=32, n_heads=4, d_feed_forward=64, n_enc_exits=2,
                       n_enc_layers_per_exit=1, depthwise_kernel_size=7, vocab_size=256)
    params, state = jec.init(jax.random.PRNGKey(5), cfg)
    # widen the heads so that the random model emits tokens, not only blanks
    params["heads"]["w"] = params["heads"]["w"] * 6.0
    jck.save_pytree({"params": params, "model_state": state}, str(d / "model"))
    avg = d / "avg"
    avg.mkdir()
    for e, seed in ((0, 6), (1, 7)):
        p, s = jec.init(jax.random.PRNGKey(seed), cfg)
        p["heads"]["w"] = p["heads"]["w"] * 6.0
        p = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), p)
        jck.save_epoch(str(avg), e, p, s)
    tr = _load("train_arpa", os.path.join(REPO, "tools", "train_arpa.py"))
    refs = []
    for root, _, files in os.walk(str(d / "corpus")):
        for f in files:
            if f.endswith(".trans.txt"):
                with open(os.path.join(root, f)) as fh:
                    refs += [ln.split(" ", 1)[1].lower().split() for ln in fh if ln.strip()]
    tr.write_arpa(tr.train(refs, order=2), str(d / "lm.arpa"))
    return d


def _lines(out):
    return [ln for ln in out.splitlines() if any(k in ln for k in KEEP)]


CASES = {
    "greedy": ["--timestamps", "true"],
    "prefix_beam": ["--decode", "prefix_beam", "--beam_size", "4", "--timestamps", "true"],
    "lexicon_beam_lm": ["--decode", "lexicon_beam", "--beam_size", "6",
                        "--lm_path", "{d}/lm.arpa", "--lm_weight", "0.5"],
    "gate": ["--exit_threshold", "0.277"],
    "cascade": ["--exit_threshold", "0.277", "--cascade_k", "1", "--cascade_pack", "2"],
    "gate_calibration": ["--gate_calibration", "{d}/calib.json", "--cascade_k", "1"],
    "avg_models": ["--load_model_dir", "{d}/avg", "--avg_model_start", "0",
                   "--avg_model_end", "1"],
    "streaming": ["--streaming", "true", "--streaming_chunk_s", "0.5",
                  "--streaming_left_s", "1.0", "--streaming_right_s", "0.2"],
    "streaming_gated": ["--streaming", "true", "--streaming_chunk_s", "0.5",
                        "--streaming_left_s", "1.0", "--streaming_right_s", "0.2",
                        "--exit_threshold", "0.277", "--fast_exit", "1"],
    # the block kernel's four last dtype mixes (its plain version here, the
    # Pallas kernel in interpret mode there)
    "fused_w8a8_res_f32": ["--fused_block", "true", "--quantize", "int8",
                           "--compute_dtype", "bfloat16", "--residual_dtype", "float32"],
    "fused_w8a8_f32": ["--fused_block", "true", "--quantize", "int8"],
    "fused_w8a8_f32_res_bf16": ["--fused_block", "true", "--quantize", "int8",
                                "--residual_dtype", "bfloat16"],
    "fused_f32_res_bf16": ["--fused_block", "true", "--residual_dtype", "bfloat16"],
}


# The mixes with bf16 rounding points run both CLIs in a fresh process
# with --xla_allow_excess_precision=false (tests/test_torch_kernel_widths.py
# says why: in process, XLA keeps fused bf16 chains in float32). There the
# two lines equal but in W8A8 with bf16 compute and a float32 residual,
# where one utterance's hypothesis at exit 2 differs by a word (an int8
# level at a rounding tie): that case is held word by word, at most 2% of
# the JAX CLI's hypothesis words edited, its WER lines within 5 points (one
# word of this corpus's 44 reference words is 2.3).
FRESH = ("fused_w8a8_res_f32", "fused_w8a8_f32_res_bf16", "fused_f32_res_bf16")
PER_WORD = ("fused_w8a8_res_f32",)
_FRESH_CLI = """
import io, json, sys, contextlib
sys.path.insert(0, {tests!r})
import jax
jax.config.update("jax_platforms", "cpu")
import test_torch_infer_cli as t
from early_exit_tpu_torch import inference as port_inference
ji = t._load("jax_inference_cli", {jax_cli!r})
argv = {argv!r}
out = []
for main, extra in ((ji.main, []), (port_inference.main, ["--device", "cpu"])):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv + extra)
    out.append(t._lines(buf.getvalue()))
print("LINES " + json.dumps(out))
"""


def _fresh_lines(argv):
    """(the JAX CLI's kept lines, the port CLI's) from one fresh process
    without XLA's excess precision."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    code = _FRESH_CLI.format(tests=os.path.join(REPO, "tests"),
                             jax_cli=os.path.join(REPO, "inference.py"), argv=argv)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("LINES ")][-1]
    return json.loads(line[len("LINES "):])


def _words_held(got, want):
    """Word-level edits of got's hypothesis lines against want's, at most
    2% of want's words; every other line equal but the WER lines, within 5
    points."""
    from early_exit_tpu_torch.decoding.lexicon import edit_distance
    assert len(got) == len(want)
    edits = words = 0
    for g, w in zip(got, want):
        if "_OUT" in w:
            assert g.split(":", 1)[0] == w.split(":", 1)[0]
            gw, ww = g.split(":", 1)[1].split(), w.split(":", 1)[1].split()
            edits += edit_distance(gw, ww)
            words += len(ww)
        elif "WER" in w and "%" in w:
            assert abs(float(g.split()[-3].rstrip("%")) - float(w.split()[-3].rstrip("%"))) <= 5.0
        else:
            assert g == w
    assert edits <= 0.02 * words, (edits, words)


@pytest.mark.parametrize("case", list(CASES))
def test_cli_lines_equal_jax(setup, jax_inference, capsys, case):
    d = setup
    with open(d / "calib.json", "w") as f:
        f.write('{"thresholds": [0.05, 2.0], "temperatures": [1.5, 1.0], '
                '"score": "margin"}')
    extra = [a.format(d=d) for a in CASES[case]]
    load = ([] if case == "avg_models" else ["--load_model_path", str(d / "model")])
    argv = ["--decoder_mode", "ctc", "--data_root", str(d / "corpus"),
            "--eval_splits", "test-clean", *TINY, *load, *extra]
    if case in FRESH:
        want, got = _fresh_lines(argv)
    else:
        jax_inference.main(argv)
        want = _lines(capsys.readouterr().out)
        port_inference.main(argv + ["--device", "cpu"])
        got = _lines(capsys.readouterr().out)
    if case in PER_WORD:
        _words_held(got, want)
    else:
        assert got == want
    n_out = sum(k in ln for ln in got for k in ("BEAM_OUT_", "GATED_OUT", "STREAM_OUT"))
    assert sum("EXPECTED:" in ln for ln in got) == 6
    assert n_out == (6 if case.startswith(("gate", "cascade", "streaming_gated")) else 12)
    hyps = [ln.split(":", 2)[-1].strip() for ln in got if "_OUT" in ln]
    assert any(hyps), "every hypothesis is empty: the comparison would see nothing"
    if "timestamps" in " ".join(extra):
        assert sum("TIMESTAMPS:" in ln for ln in got) >= 1
    if case in ("gate", "cascade", "gate_calibration"):
        exits = {ln.split("(exit ")[1][0] for ln in got if "GATED_OUT" in ln}
        assert exits == {"1", "2"}, exits          # both exits chosen somewhere
    if case == "streaming_gated":                  # chunks at both exits
        hist = [ln for ln in got if "streaming exit histogram" in ln][0]
        assert "{1: 0," not in hist and ", 2: 0}" not in hist, hist


def test_cli_character_vocabulary_equals_jax(setup, jax_inference, capsys, tmp_path):
    """--bpe false (the JAX CLI's character vocabulary, V = 32) with
    --fused_block true: the port's block and head take any vocabulary,
    and its lines equal the JAX CLI's (the block kernel's plain version
    here, the Pallas kernel in interpret mode there)."""
    cfg = JModelConfig(d_model=32, n_heads=4, d_feed_forward=64, n_enc_exits=2,
                       n_enc_layers_per_exit=1, depthwise_kernel_size=7, vocab_size=32)
    params, state = jec.init(jax.random.PRNGKey(9), cfg)
    params["heads"]["w"] = params["heads"]["w"] * 6.0
    jck.save_pytree({"params": params, "model_state": state}, str(tmp_path / "char"))
    argv = ["--decoder_mode", "ctc", "--data_root", str(setup / "corpus"),
            "--eval_splits", "test-clean", *TINY, "--load_model_path", str(tmp_path / "char"),
            "--bpe", "false", "--fused_block", "true"]
    jax_inference.main(argv)
    want = _lines(capsys.readouterr().out)
    port_inference.main(argv + ["--device", "cpu"])
    got = _lines(capsys.readouterr().out)
    assert got == want
    assert sum("BEAM_OUT_" in ln for ln in got) == 12
    assert any(ln.split(":", 2)[-1].strip() for ln in got if "BEAM_OUT_" in ln)


@pytest.mark.parametrize("flags,match", [
    (["--model_type", "early_zipformer"], "early_zipformer"),    # 2 exits, not 19
    (["--conv_norm", "group", "--fused_block", "true"], "conv_norm"),
])
def test_cli_unported_modes_raise_by_name(setup, flags, match):
    argv = ["--decoder_mode", "ctc", "--synthetic_data", "true", "--device", "cpu",
            "--load_model_path", str(setup / "model"), *TINY]
    i = argv.index(flags[0]) if flags[0] in argv else None
    if i is not None:
        argv[i + 1] = flags[1]
    else:
        argv += flags
    with pytest.raises((NotImplementedError, ValueError), match=match):
        port_inference.main(argv)


@pytest.mark.parametrize("flags,match", [
    (["--decode", "prefix_beam"], "decodes greedily per chunk"),
    (["--lm_path", "lm.arpa"], "decodes greedily per chunk"),
    (["--gate_calibration", "calib.json"], "gates per CHUNK"),
    (["--model_type", "splitformer"], "splitformer checkpoints are batch-only"),
])
def test_cli_streaming_usage_errors_equal_jax(setup, jax_inference, flags, match):
    """--streaming with what it does not combine with exits with the JAX
    CLI's message. (The JAX CLI loads the model first, so its splitformer
    message needs a splitformer checkpoint: the port, which checks before
    loading, is held to the message alone there.)"""
    argv = ["--decoder_mode", "ctc", "--synthetic_data", "true", "--streaming", "true",
            "--load_model_path", str(setup / "model"), *TINY, *flags]
    with pytest.raises(SystemExit, match=match) as got:
        port_inference.main(argv + ["--device", "cpu"])
    if "--model_type" not in flags:
        with pytest.raises(SystemExit, match=match) as want:
            jax_inference.main(argv)
        assert str(got.value) == str(want.value)


def test_cli_needs_a_gpu_unless_told_cpu(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_inference.main(["--decoder_mode", "ctc", "--synthetic_data", "true",
                             "--load_model_path", str(setup / "model"), *TINY])


def test_cli_synthetic_split_and_loading_errors(setup, capsys):
    argv = ["--decoder_mode", "ctc", "--synthetic_data", "true", "--device", "cpu", *TINY]
    port_inference.main(argv + ["--load_model_path", str(setup / "model")])
    out = capsys.readouterr().out
    assert "synthetic WER exit 2:" in out and "(8 utts)" in out
    with pytest.raises(ValueError, match="Invalid model loading config"):
        port_inference.main(argv)
    with pytest.raises(SystemExit, match="Invalid data split"):
        port_inference.main(["--decoder_mode", "ctc", "--device", "cpu", "--data_root",
                             str(setup), "--load_model_path", str(setup / "model"), *TINY])
