"""The port's scoring and profiling tools against the JAX package's on
the CPU: `score_wer`, `train_arpa`, `plot_metrics` and
`utils.epoch_timer` / `utils.profiling`.

- score_wer: the printed lines equal to `tools/score_wer.py`'s on the same
  log, which is a port inference CLI log (greedy, and gated) of a tiny
  seeded checkpoint (d 32, 3 exits x 1 block, char vocabulary, float32,
  its heads sharpened so that it emits letters); its per-exit WERs equal
  the CLI's own lines.
- train_arpa: the ARPA file byte for byte equal to `tools/train_arpa.py`'s
  at orders 1-3, the CLI's printed line equal, and the file read back by
  the port's reader (`decoding/ngram_lm.py`, the native library).
- plot_metrics: the ASCII summary equal to `tools/plot_metrics.py`'s for
  every key of a `metrics.jsonl` the port's trainer wrote, and for a key
  it lacks.
- epoch_time and StepTimer: equal figures for the same durations, with
  `time.perf_counter` patched; trace and annotate on the CPU: a Chrome
  trace is written and holds the span.
"""

import contextlib
import io
import json
import os
import sys
import time

import jax
import numpy as np
import pytest
import torch

from early_exit_tpu.configs import ModelConfig as JModelConfig
from early_exit_tpu.models.registry import build_model as jbuild
from early_exit_tpu.training import checkpoint as jck
from early_exit_tpu.utils import epoch_timer as jepoch
from early_exit_tpu.utils import profiling as jprof
from early_exit_tpu_torch import inference, plot_metrics, score_wer, train_arpa
from early_exit_tpu_torch import train as port_train
from early_exit_tpu_torch.utils import epoch_time, profiling

DIMS = ["--d_model", "32", "--n_heads", "4", "--d_feed_forward", "64",
        "--n_enc_exits", "3", "--n_enc_layers_per_exit", "1",
        "--depthwise_kernel_size", "7", "--n_mels", "16"]
FLAGS = ["--decoder_mode", "ctc", "--synthetic_data", "true", "--batch_size", "8",
         "--n_workers", "0", "--bpe", "false", "--compute_dtype", "float32",
         "--attn_softmax_dtype", "float32", "--device", "cpu"] + DIMS
SENTS = ["the cat sat on the mat", "the dog sat on the log", "a cat and a dog",
         "the cat saw the dog", "dogs and cats sat"]


def tiny_checkpoint(path, seed=5, n_exits=3):
    """A seeded early_conformer at the test dims in the JAX package's
    file format, its heads sharpened so that it emits letters."""
    cfg = JModelConfig(d_model=32, n_heads=4, d_feed_forward=64, n_enc_exits=n_exits,
                       n_enc_layers_per_exit=1, depthwise_kernel_size=7, n_mels=16,
                       vocab_size=32)
    params, state = jbuild(cfg).init(jax.random.PRNGKey(seed), cfg)
    params["heads"]["w"] = params["heads"]["w"] * 12.0
    params["heads"]["b"] = params["heads"]["b"].at[0, 28].add(5.0)
    jck.save_pytree({"params": params, "model_state": state}, path)
    return path


def _stdout(fn, *a):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*a)
    return buf.getvalue()


@contextlib.contextmanager
def one_thread():
    """torch on one intra-op thread for the block, as the suite runs six
    workers on the machine's cores: a tiny model's step gains nothing
    from more threads, and contends with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _run_jax_main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module.__file__] + argv)
    return _stdout(module.main)


@pytest.fixture(scope="module")
def cli_logs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("score")
    ck = tiny_checkpoint(str(tmp / "tiny.ckpt"))
    logs = {}
    for mode, extra in (("greedy", []), ("gated", ["--exit_threshold", "0.6"])):
        with one_thread():
            out = _stdout(inference.main, ["--load_model_path", ck] + FLAGS + extra)
        logs[mode] = str(tmp / f"{mode}.log")
        with open(logs[mode], "w") as f:
            f.write(out)
    return logs


@pytest.mark.parametrize("mode", ["greedy", "gated"])
def test_score_wer_prints_the_jax_tools_lines(cli_logs, mode, monkeypatch):
    import tools.score_wer as jtool
    path = cli_logs[mode]
    want = _run_jax_main(jtool, [path], monkeypatch)
    got = _stdout(score_wer.main, [path])
    assert got == want
    with open(path) as f:
        log = f.read()
    if mode == "greedy":
        cli = {int(ln.split("WER exit ")[1].split(":")[0]): ln.split(": ")[1].split("%")[0]
               for ln in log.splitlines() if " WER exit " in ln}
        mine = {int(ln.split()[1].rstrip(":")): ln.split("WER ")[1].split("%")[0]
                for ln in got.splitlines()}
        assert sorted(cli) == [1, 2, 3] and mine == cli
        assert any(v != "100.00" for v in mine.values())
    else:
        assert got.splitlines()[-1].startswith("gated: WER ")
        assert log.split(" gated WER: ")[1].split("%")[0] == \
            got.splitlines()[-1].split("WER ")[1].split("%")[0]


def test_score_wer_without_references_exits_as_jax(tmp_path, monkeypatch):
    import tools.score_wer as jtool
    path = tmp_path / "empty.log"
    path.write_text("nothing here\n")
    with pytest.raises(SystemExit) as want:
        _run_jax_main(jtool, [str(path)], monkeypatch)
    with pytest.raises(SystemExit) as got:
        score_wer.main([str(path)])
    assert str(got.value) == str(want.value) == "no EXPECTED lines found"


@pytest.mark.parametrize("order", [1, 2, 3])
def test_train_arpa_bytes_equal_jax(order, tmp_path, monkeypatch):
    import tools.train_arpa as jtool
    text = tmp_path / "text.txt"
    text.write_text("\n".join(SENTS + ["", "The Cat SAT"]) + "\n")
    want_out = _run_jax_main(jtool, ["--text", str(text), "--out", str(tmp_path / "j.arpa"),
                                     "--order", str(order)], monkeypatch)
    got_out = _stdout(train_arpa.main, ["--text", str(text), "--out",
                                        str(tmp_path / "p.arpa"), "--order", str(order)])
    assert got_out.replace("p.arpa", "j.arpa") == want_out
    got = (tmp_path / "p.arpa").read_bytes()
    assert got == (tmp_path / "j.arpa").read_bytes()

    from early_exit_tpu.decoding.ngram_lm import ArpaLM as JArpaLM
    from early_exit_tpu_torch.decoding.ngram_lm import ArpaLM
    lm, jlm = ArpaLM(str(tmp_path / "p.arpa")), JArpaLM(str(tmp_path / "j.arpa"))
    assert lm.order == order
    for words in (["the", "cat", "sat"], ["sat", "the", "log", "a"], ["zebra"]):
        s = lm.score(words)
        assert np.isfinite(s) and s < 0.0
        assert s == jlm.score(words)
    if order > 1:
        assert lm.score(["the", "cat", "sat"]) > lm.score(["sat", "the", "log", "a"])


@pytest.fixture(scope="module")
def metrics_file(tmp_path_factory):
    """metrics.jsonl of three epochs of the port's trainer."""
    tmp = tmp_path_factory.mktemp("plot")
    argv = ["--decoder_mode", "ctc", "--synthetic_data", "true", "--device", "cpu",
            "--n_epochs", "3", "--batch_size", "16", "--n_batch_split", "1",
            "--n_workers", "0", "--save_model_dir", str(tmp / "ck"),
            "--log_dir", str(tmp / "runs"), "--bpe", "false"] + DIMS
    with one_thread():
        _stdout(port_train.main, argv)
    return str(tmp / "runs" / "metrics.jsonl")


@pytest.mark.parametrize("key", ["loss", "Total loss", "lr", "grad_norm", "absent"])
def test_plot_metrics_summary_equal_jax(metrics_file, key, monkeypatch):
    import tools.plot_metrics as jtool
    with open(metrics_file) as f:
        recs = [json.loads(ln) for ln in f]
    assert sum("loss" in r for r in recs) == 3 and sum("Total loss" in r for r in recs) == 3
    want = _run_jax_main(jtool, [metrics_file, "--key", key], monkeypatch)
    got = _stdout(plot_metrics.main, [metrics_file, "--key", key])
    assert got == want
    assert (f"no '{key}' entries" in got) == (key == "absent")


def test_epoch_time_and_step_timer_equal_jax(monkeypatch):
    for start, end in ((0.0, 0.0), (10.0, 69.999), (3.5, 3725.25), (100.0, 7300.9)):
        assert epoch_time(start, end) == jepoch.epoch_time(start, end)
    # the same clock readings through both timers
    marks = [0.0, 0.5, 1.0, 1.25, 2.0, 2.125, 3.0, 3.5, 4.0, 4.0, 5.0, 5.0625]
    audio = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    figures = []
    for mod in (jprof, profiling):
        clock = iter(marks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        timer = mod.StepTimer(warmup_steps=2)
        steps = []
        for a in audio:
            timer.start()
            steps.append(timer.stop(audio_seconds=a))
        figures.append((steps, timer.n, timer.total, timer.audio_seconds,
                        timer.steps_per_sec, timer.rtf_x))
        empty = mod.StepTimer()
        figures.append((empty.steps_per_sec, empty.rtf_x))
    assert figures[0] == figures[2] and figures[1] == figures[3]
    assert figures[2][4] == 4 / (0.125 + 0.5 + 0.0 + 0.0625)


def test_trace_writes_the_span_on_the_cpu(tmp_path):
    log_dir = str(tmp_path / "profile")
    x = torch.ones(64, 64)
    with profiling.trace(log_dir):
        with profiling.annotate("eet_test_span"):
            (x @ x).sum().item()
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    spans = [ev for ev in events if ev.get("name") == "eet_test_span"]
    assert spans and all(ev.get("dur", 0) > 0 for ev in spans)
    assert any("mm" in ev.get("name", "") for ev in events)
