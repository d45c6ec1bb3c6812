"""The port's streaming server (`python -m early_exit_tpu_torch.serve`)
and pool load test (`python -m early_exit_tpu_torch.serving.load_test`)
on the CPU.

- `--selftest --device cpu` in a subprocess: a tiny model served
  in-process, int16 PCM streamed over a real socket, the final ids equal
  to a local recognizer's;
- the three error replies of the protocol;
- more concurrent connections than cores, each final equal to a local
  recognizer's on its own audio;
- a final, served from a JAX checkpoint, whose ids equal the JAX
  package's `StreamingRecognizer` on the same dequantised PCM (the JAX
  server's own configuration of the same flags), with the partial lines
  adding up to it;
- without --device cpu and without a GPU both entry points raise;
- the load test's smoke run prints a JSON line with churned streams.
"""

import json
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from early_exit_tpu.cli import get_args as jget_args
from early_exit_tpu.models.registry import build_model as jbuild_model
from early_exit_tpu.serving import StreamingRecognizer as JRec
from early_exit_tpu.training import checkpoint as jck
from early_exit_tpu_torch import serve
from early_exit_tpu_torch.serving import load_test
from torch_one_thread import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEO = ["--chunk_s", "0.5", "--left_s", "1.0", "--right_s", "0.2"]


def _run(args, timeout=240):
    return subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, timeout=timeout, cwd=REPO)


def test_serve_selftest_on_the_cpu():
    r = _run(["early_exit_tpu_torch.serve", "--selftest", "--device", "cpu"])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["selftest"] == "ok" and len(out["ids"]) > 0


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A server on a JAX checkpoint of the tiny model, serving in a thread."""
    d = tmp_path_factory.mktemp("serve")
    jargs, jcfg, _, jacfg, _ = jget_args(["--decoder_mode", "ctc"] + serve.TINY)
    params, state = jbuild_model(jcfg).init(jax.random.PRNGKey(3), jcfg)
    jck.save_pytree({"params": params, "model_state": state}, str(d / "model"))
    holder = []
    srv = serve.make_server(serve.TINY + GEO + [
        "--port", "0", "--device", "cpu", "--load_model_path", str(d / "model")],
        port_holder=holder)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield dict(port=holder[0], params=params, state=state, jcfg=jcfg, jacfg=jacfg,
               server=srv)
    srv.shutdown()
    srv.server_close()


@pytest.mark.parametrize("header,error", [
    (b"not json\n", "expected a JSON header line"),
    (b'{"sample_rate": 16000, "format": "f32le"}\n', "only s16le PCM is supported"),
    (b'{"sample_rate": 8000, "format": "s16le"}\n', "server decodes 16000 Hz audio"),
])
def test_error_replies(served, header, error):
    import socket
    with socket.create_connection(("127.0.0.1", served["port"])) as s:
        s.sendall(header)
        s.shutdown(socket.SHUT_WR)
        buf = b""
        while True:
            d = s.recv(65536)
            if not d:
                break
            buf += d
    msgs = [json.loads(line) for line in buf.decode().splitlines()]
    assert len(msgs) == 1 and error in msgs[0]["error"], msgs


def test_served_final_equals_jax_recognizer(served):
    rng = np.random.RandomState(5)
    wav = (0.1 * rng.randn(int(3.1 * 16000))).astype(np.float32)
    pcm = np.clip(wav * 32768.0, -32768, 32767).astype(np.int16)
    msgs = serve.stream_pcm(served["port"], pcm, piece=3331)   # odd-sized pieces
    finals = [m for m in msgs if "final" in m]
    assert len(finals) == 1 and "final" in msgs[-1]
    rec = JRec(served["params"], served["state"], served["jcfg"], served["jacfg"],
               chunk_s=0.5, left_s=1.0, right_s=0.2, causal_attention=False)
    rec.accept_waveform(pcm.astype(np.float32) / 32768.0)
    rec.finish()
    assert finals[0]["ids"] == rec.ids and len(rec.ids) > 0
    assert finals[0]["exits_run"] == []
    partial = "".join(m["partial"] for m in msgs if "partial" in m)
    assert partial.replace(" ", "") in finals[0]["final"].replace(" ", "")
    assert any("partial" in m for m in msgs)


def test_concurrent_connections_each_get_their_own_final(served):
    """More connections than cores at once, the interpreter switching
    threads often: every connection's final equals a local recognizer's
    on its own audio (the model is shared; the state is per connection)."""
    from early_exit_tpu_torch.serving import StreamingRecognizer
    srv = served["server"]
    n = (os.cpu_count() or 4) + 2
    pcms = [np.clip(0.1 * np.random.RandomState(50 + i).randn(int((1.2 + 0.1 * i) * 16000))
                    * 32768.0, -32768, 32767).astype(np.int16) for i in range(n)]
    finals = [None] * n

    def client(i):
        msgs = serve.stream_pcm(served["port"], pcms[i], piece=1000 + 37 * i)
        finals[i] = [m for m in msgs if "final" in m]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for i, pcm in enumerate(pcms):
        local = StreamingRecognizer(srv.model, srv.acfg, srv.tok, **srv.rec_kw)
        local.accept_waveform(pcm.astype(np.float32) / 32768.0)
        local.finish()
        assert len(finals[i]) == 1 and finals[i][0]["ids"] == local.ids, i


def test_entry_points_need_a_gpu_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.make_server(serve.TINY + ["--port", "0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_test.main(["--smoke"])


def test_load_test_smoke_on_the_cpu():
    r = _run(["early_exit_tpu_torch.serving.load_test", "--smoke", "--device", "cpu"])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["churned_streams"] > 0 and out["streams"] == 4 and out["rounds"] == 6
    assert out["round_ms_p99"] >= out["round_ms_p50"] > 0
    assert out["audio_x_realtime"] > 0 and not out["gated"]


def test_load_test_gated_round_loop(capsys):
    load_test.main(["--smoke", "--device", "cpu", "--gated", "--exit_threshold", "0.0"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["gated"] and out["fast_exit_rate"] == 1.0 and out["churned_streams"] > 0
