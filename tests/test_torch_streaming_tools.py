"""`streaming_demo` and `streaming_gate_report` of the port against the
JAX package's tools on the CPU.

- streaming_demo: on one tiny seeded checkpoint both packages read (d 32,
  3 exits x 1 block, char vocabulary, float32 with a float32 softmax, its
  heads sharpened so that it emits letters), over the same 3 utterances
  of a FLAC corpus (the JAX tool compiles each utterance's length: 16
  synthetic ones take a minute), the JSON fields `utts`, `exit`, the
  geometry, `stream_wer_pct`, `full_wer_pct` and
  `exact_transcript_agreement` equal to `tools/streaming_demo.py`'s, and
  every utterance's streamed and full transcript too; at the deepest
  exit, and at exit 2 with causal windows of 0.5 s chunks. The seeded
  model transcribes no word (100% WER): the transcripts carry the test.
- streaming_gate_report: `parse` equal to the JAX tool's on the same text
  (canned lines and a port CLI `--streaming` log, ungated and gated);
  with `subprocess.run` patched, the tool's flags, --device and the
  passthrough reach `python -m early_exit_tpu_torch.inference`, and the
  report equals the JAX tool's on the same leg outputs.
"""

import contextlib
import io
import json
import subprocess
import sys

import pytest

from early_exit_tpu_torch import inference, streaming_demo, streaming_gate_report
from tests.test_torch_eval_tools import DIMS, one_thread, tiny_checkpoint

FLAGS = ["--synthetic_data", "true", "--bpe", "false", "--compute_dtype", "float32",
         "--attn_softmax_dtype", "float32"] + DIMS
# streamed utterances: several chunks of 0.5 s each
CORPUS = dict(n_items=3, seed=11, min_words=4, max_words=6)


def _stdout(fn, *a):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*a)
    return buf.getvalue()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return tiny_checkpoint(str(tmp_path_factory.mktemp("demo") / "tiny.ckpt"))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from early_exit_tpu_torch.reference_scale_run import make_corpus
    root = str(tmp_path_factory.mktemp("demo_corpus"))
    make_corpus(root, "test-clean", CORPUS["n_items"], seed=CORPUS["seed"],
                min_words=CORPUS["min_words"], max_words=CORPUS["max_words"])
    return root


@pytest.mark.parametrize("extra", [[], ["--n_exit", "2", "--causal_attention", "1",
                                        "--chunk_s", "0.5", "--right_s", "0.5"]],
                         ids=["deepest", "exit2_causal"])
def test_streaming_demo_equals_jax(ckpt, corpus, extra):
    import tools.streaming_demo as jtool
    argv = (["--load_model_path", ckpt, "--data_root", corpus, "--eval_splits", "test-clean"]
            + FLAGS[2:] + extra)
    want_out = _stdout(jtool.main, list(argv))
    with one_thread():
        got_out = _stdout(streaming_demo.main, argv + ["--device", "cpu"])
    want, got = json.loads(want_out.splitlines()[-1]), json.loads(got_out.splitlines()[-1])
    for k in ("utts", "exit", "chunk_s", "left_s", "right_s", "causal_attention",
              "stream_wer_pct", "full_wer_pct", "exact_transcript_agreement"):
        assert got[k] == want[k], k
    assert set(got) == set(want) and got["utts"] == CORPUS["n_items"]
    lines = got_out.splitlines()[:-1]
    assert lines == want_out.splitlines()[:-1]
    assert sum("] strm: " in ln for ln in lines) == CORPUS["n_items"]
    assert all(len(ln.split(": ", 1)[1]) for ln in lines if "] strm: " in ln)


UNGATED = """\
test-clean EXPECTED: the cat sat
test-clean STREAM_OUT (exit 1): the cat sat
test-clean WER exit 1: 1.23% (240 utts)
test-clean streaming WER exit 1: 10.50% (240 utts)
test-clean streaming WER exit 2: 8.25% (240 utts)
test-other streaming WER exit 1: 30.00% (240 utts)
test-other streaming WER exit 2: 21.75% (240 utts)
"""

GATED = """\
test-clean streaming exit histogram (chunks per exit): {1: 800, 2: 0, 3: 150, 4: 0, 5: 0, 6: 50}
test-clean streaming WER exit 6: 9.10% (240 utts) (gated: mean exit 1.55/6, 80% of chunks at exit 1)
test-other streaming exit histogram (chunks per exit): {1: 300, 2: 200, 3: 200, 4: 100, 5: 100, 6: 100}
test-other streaming WER exit 6: 22.40% (240 utts) (gated: mean exit 2.60/6, 30% of chunks at exit 1)
"""


@pytest.fixture(scope="module")
def cli_streaming_logs(ckpt):
    base = ["--load_model_path", ckpt, "--decoder_mode", "ctc", "--streaming", "true",
            "--batch_size", "8", "--n_workers", "0", "--device", "cpu"] + FLAGS
    with one_thread():
        return [_stdout(inference.main, base),
                _stdout(inference.main, base + ["--exit_threshold", "0.5", "--fast_exit", "2"])]


def test_parse_equals_jax(cli_streaming_logs):
    from tools.streaming_gate_report import parse as jparse
    ungated, gated = cli_streaming_logs
    for text in (UNGATED, GATED, ungated, gated):
        assert streaming_gate_report.parse(text) == jparse(text)
    u, g = streaming_gate_report.parse(ungated), streaming_gate_report.parse(gated)
    assert set(u["synthetic"]["wer_pct"]) == {"exit1", "exit2", "exit3"}
    assert u["synthetic"]["eval_utts"] == 8
    assert set(g["synthetic"]) == {"exit_histogram", "wer_pct", "eval_utts", "mean_exit",
                                   "pct_chunks_at_exit1"}
    assert set(g["synthetic"]["exit_histogram"]) == {"1", "2", "3"}
    json.dumps(g)


def test_flags_and_passthrough_reach_the_ports_cli(monkeypatch, tmp_path):
    import tools.streaming_gate_report as jtool
    seen = []

    def fake_run(cmd, **kw):
        seen.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, GATED if "--exit_threshold" in cmd
                                           else UNGATED, "")

    monkeypatch.setattr(subprocess, "run", fake_run)
    tail = ["--thresholds", "0.85,0.95", "--d_model", "64", "--n_enc_exits", "2"]
    jtool.main(["--ckpt", "/x/ck", "--data_root", "/x/d", "--out",
                str(tmp_path / "j.json")] + tail)
    got = streaming_gate_report.main(["--ckpt", "/x/ck", "--data_root", "/x/d", "--out",
                                      str(tmp_path / "p.json"), "--device", "cpu"] + tail)
    j_cmds, p_cmds = seen[:3], seen[3:]
    assert len(p_cmds) == 3                      # ungated + two thresholds
    for jc, pc in zip(j_cmds, p_cmds):
        assert pc[:3] == [sys.executable, "-m", "early_exit_tpu_torch.inference"]
        i = pc.index("--device")
        assert pc[i + 1] == "cpu"
        assert pc[3:i] + pc[i + 2:] == jc[2:]
        assert pc[pc.index("--d_model") + 1] == "64" and "--n_enc_exits" in pc
    assert p_cmds[2][-4:] == ["--exit_threshold", "0.95", "--gate_score", "maxprob"]
    assert json.loads((tmp_path / "p.json").read_text()) == got
    wall_s = got.pop("wall_s")                   # the port's one added key
    assert set(wall_s) == {"ungated", "0.85", "0.95"} and min(wall_s.values()) >= 0
    assert got == json.loads((tmp_path / "j.json").read_text())
    assert "0.85" in got["gated"] and "ungated_all_exits" in got
