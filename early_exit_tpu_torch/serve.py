"""Streaming ASR server: TCP, one connection per audio stream (the
counterpart of the JAX package's `tools/serve.py`).

Each connection streams raw PCM and receives transcripts incrementally.
Every connection shares the one model on the device; its state is a
`StreamingRecognizer` of its own, whose batch-1 windows run on the
default stream. The server warms the window programs up (kernels built,
libraries initialised) on a throwaway stream before it listens.

Protocol (newline-delimited JSON + raw audio):
  client -> server: one JSON header line
        {"sample_rate": 16000, "format": "s16le"}
    then raw little-endian int16 PCM until the client half-closes the
    write side (shutdown(SHUT_WR)).
  server -> client: JSON lines
        {"partial": "<newly emitted text>"}     as chunks decode
        {"final": "<full transcript>", "ids": [...], "exits_run": [...]}
    then the server closes. A bad header gets one {"error": ...} line.

Usage:
  python -m early_exit_tpu_torch.serve --port 7070 \\
      --load_model_path assets/flagship_ckpt [model dims...] \\
      [--chunk_s 1.0 --left_s 3.0 --right_s 0.5 --exit_threshold 0.9] \\
      [--device cpu]

Runs on CUDA unless --device cpu, and raises without a GPU otherwise.

Smoke client:
  python -m early_exit_tpu_torch.serve --selftest [--device cpu]
"""

from __future__ import annotations

import json
import socket
import socketserver
import sys
import threading

import numpy as np
import torch

from early_exit_tpu_torch import runtime
from early_exit_tpu_torch.cli import get_args
from early_exit_tpu_torch.models.early_conformer import EarlyConformer
from early_exit_tpu_torch.serving import StreamingRecognizer
from early_exit_tpu_torch.training import checkpoint

TINY = ["--d_model", "32", "--n_enc_exits", "2", "--n_enc_layers_per_exit", "1",
        "--n_heads", "4", "--d_feed_forward", "64", "--depthwise_kernel_size", "7",
        "--compute_dtype", "float32"]


def _pop_extra(argv):
    extra = {"--port": 7070, "--chunk_s": 1.0, "--left_s": 3.0,
             "--right_s": 0.5, "--causal_attention": 0.0, "--n_exit": None}
    for k in list(extra):
        if k in argv:
            i = argv.index(k)
            extra[k] = float(argv[i + 1])
            del argv[i:i + 2]
    return extra


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


def build_model(args, mcfg, device) -> EarlyConformer:
    """Fresh weights from --seed, then --load_model_path if given."""
    model = EarlyConformer(mcfg).to(device)
    model.init(torch.Generator(device=device).manual_seed(args.seed))
    if args.load_model_path:
        checkpoint.load_model_file(model, args.load_model_path)
    return model.eval().requires_grad_(False)


def make_server(argv, port_holder=None):
    """The server, bound to 127.0.0.1 and not yet serving. Its `model`,
    `acfg`, `tok` and `rec_kw` build a recognizer equal to a connection's."""
    argv = list(argv)
    extra = _pop_extra(argv)
    if "--decoder_mode" not in argv:
        argv = ["--decoder_mode", "ctc"] + argv
    args, mcfg, _, acfg, tok = get_args(argv)
    device = runtime.resolve_device(args.device)
    if device.type == "cuda":
        runtime.exact_float32()
    model = build_model(args, mcfg, device)
    rec_kw = dict(chunk_s=extra["--chunk_s"], left_s=extra["--left_s"],
                  right_s=extra["--right_s"],
                  causal_attention=bool(extra["--causal_attention"]),
                  n_exit=int(extra["--n_exit"]) if extra["--n_exit"] else None)
    if args.exit_threshold is not None:
        rec_kw["exit_threshold"] = float(args.exit_threshold)

    # the window programs once on a throwaway stream, so that the first
    # connection's first chunk does not pay for building the kernels
    warm = StreamingRecognizer(model, acfg, tok, **rec_kw)
    warm.accept_waveform(np.zeros(warm.win_samples, np.float32))
    warm.finish()

    class Handler(socketserver.StreamRequestHandler):
        def _reply(self, obj):
            self.wfile.write((json.dumps(obj) + "\n").encode())
            self.wfile.flush()

        def handle(self):
            try:
                header = json.loads(self.rfile.readline() or b"null")
            except json.JSONDecodeError:
                header = None
            if not isinstance(header, dict):
                return self._reply({"error": "expected a JSON header line"})
            if header.get("format", "s16le") != "s16le":
                return self._reply({"error": "only s16le PCM is supported"})
            if int(header.get("sample_rate", acfg.sample_rate)) != acfg.sample_rate:
                return self._reply(
                    {"error": f"server decodes {acfg.sample_rate} Hz "
                              f"audio; resample before streaming"})
            rec = StreamingRecognizer(model, acfg, tok, **rec_kw)
            carry = b""
            while True:
                # read1 from the same buffered reader as the header line:
                # readline() may have buffered the first PCM bytes
                data = self.rfile.read1(65536)
                if not data:
                    break
                carry += data
                usable = len(carry) // 2 * 2
                if not usable:
                    continue
                pcm = np.frombuffer(carry[:usable], np.int16)
                carry = carry[usable:]
                out = rec.accept_waveform(pcm.astype(np.float32) / 32768.0)
                if out:
                    self._reply({"partial": out})
            rec.finish()
            self._reply({"final": rec.transcript, "ids": rec.ids,
                         "exits_run": rec.exits_run})

    srv = _Server(("127.0.0.1", int(extra["--port"])), Handler)
    srv.model, srv.acfg, srv.tok, srv.rec_kw = model, acfg, tok, rec_kw
    if port_holder is not None:
        port_holder.append(srv.server_address[1])
    return srv


def stream_pcm(port: int, pcm: np.ndarray, piece: int = 4000, header=None):
    """A client: send the header and pcm (int16) in pieces of `piece`
    samples, half-close, and return the server's JSON lines."""
    header = {"sample_rate": 16000, "format": "s16le"} if header is None else header
    with socket.create_connection(("127.0.0.1", port)) as s:
        s.sendall(json.dumps(header).encode() + b"\n")
        for i in range(0, len(pcm), piece):
            s.sendall(pcm[i:i + piece].tobytes())
        s.shutdown(socket.SHUT_WR)
        buf = b""
        while True:
            d = s.recv(65536)
            if not d:
                break
            buf += d
    return [json.loads(line) for line in buf.decode().splitlines()]


def selftest(device_argv=()):
    """Serve a tiny model in-process, stream a synthetic waveform through a
    real socket, and require the final ids to equal a local recognizer's
    on the same dequantised audio."""
    holder = []
    srv = make_server(TINY + list(device_argv) + [
        "--port", "0", "--chunk_s", "0.5", "--left_s", "1.0", "--right_s", "0.2"],
        port_holder=holder)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        rng = np.random.RandomState(0)
        wav = (0.1 * rng.randn(int(2.5 * 16000))).astype(np.float32)
        pcm = np.clip(wav * 32768.0, -32768, 32767).astype(np.int16)
        msgs = stream_pcm(holder[0], pcm)
    finally:
        srv.shutdown()
        srv.server_close()
    final = [m for m in msgs if "final" in m]
    assert len(final) == 1, msgs
    rec = StreamingRecognizer(srv.model, srv.acfg, srv.tok, **srv.rec_kw)
    rec.accept_waveform(pcm.astype(np.float32) / 32768.0)
    rec.finish()
    assert final[0]["ids"] == rec.ids, (final[0]["ids"], rec.ids)
    print(json.dumps({"selftest": "ok", "ids": final[0]["ids"],
                      "final": final[0]["final"]}))


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--selftest" in argv:
        argv.remove("--selftest")
        return selftest(argv)
    holder = []
    srv = make_server(argv, port_holder=holder)
    print(f"serving on 127.0.0.1:{holder[0]}", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()


if __name__ == "__main__":
    main()
