"""Streaming-inference evaluation: chunked decode of an eval split (the
counterpart of `tools/streaming_demo.py`).

Feeds each utterance (the first 16 of the split) to
`serving.StreamingRecognizer` in chunk-sized pieces and reports, against
the full-utterance decode of the same checkpoint at the same exit:
streaming WER, full WER, transcript agreement, and chunk compute latency
(the serving-relevant number: added latency on top of the chunk_s +
right_s algorithmic delay).

    python -m early_exit_tpu_torch.streaming_demo \\
        --load_model_path model/mod009-transformer --synthetic_data true \\
        [--chunk_s 1.0 --left_s 2.0 --right_s 0.32 --n_exit 3] \\
        [--fused_block true] [--attention_impl pallas] [--device cpu] [model flags]

The flags, the printed lines and the JSON are the JAX tool's; the model
flags are the training CLI's (`get_args`' train profile, as the JAX tool:
float32 attention softmax, FFT mel, unless given). The full decode is the
model's forward (through the block kernel with --fused_block true on the
card) and greedy CTC (`ops/ctc.py`); the windows run the unfused blocks
(the attention kernel with --attention_impl pallas). A chunk's latency is
`perf_counter` around `accept_waveform`, which reads the chunk's best
path back to the host, so it is the device's time and not the enqueue's;
the first reading (compilation, allocator warm-up) is dropped. Runs on
CUDA unless --device cpu.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch


def main(argv=None):
    from early_exit_tpu_torch import runtime
    from early_exit_tpu_torch.cli import get_args
    from early_exit_tpu_torch.data import text as text_mod
    from early_exit_tpu_torch.data.librispeech import LibriSpeechDataset, SyntheticDataset
    from early_exit_tpu_torch.models.registry import build_model
    from early_exit_tpu_torch.ops import ctc, frontend
    from early_exit_tpu_torch.serving import StreamingRecognizer
    from early_exit_tpu_torch.training import checkpoint
    from early_exit_tpu_torch.utils import WerAccumulator

    extra = {"--chunk_s": 1.0, "--left_s": 2.0, "--right_s": 0.32,
             "--n_exit": None, "--causal_attention": 0.0}
    argv = list(sys.argv[1:] if argv is None else argv)
    for k in list(extra):
        if k in argv:
            i = argv.index(k)
            extra[k] = float(argv[i + 1])
            del argv[i:i + 2]
    if "--decoder_mode" not in argv:
        argv = ["--decoder_mode", "ctc"] + argv

    args, model_cfg, train_cfg, audio_cfg, tokenizer = get_args(argv)
    device = runtime.resolve_device(args.device)
    if device.type == "cuda":
        runtime.exact_float32()
    model = build_model(model_cfg).to(device)
    model.init(torch.Generator(device=device).manual_seed(args.seed))
    if args.load_model_path:
        checkpoint.load_model_file(model, args.load_model_path)
        print(f"loaded {args.load_model_path}")
    model = model.eval().requires_grad_(False)

    if args.synthetic_data:
        ds = SyntheticDataset(n_items=16, seed=args.seed + 7)
    else:
        ds = LibriSpeechDataset(args.data_root, args.eval_splits.split(",")[0])

    n_exit = int(extra["--n_exit"]) if extra["--n_exit"] else model_cfg.n_enc_exits

    stream_wer, full_wer = WerAccumulator(), WerAccumulator()
    agree = 0
    chunk_times = []
    n = min(len(ds), 16)
    for i in range(n):
        utt = ds[i]
        ref = text_mod.clean_infer_label(utt.transcript)
        if ref is None:
            continue

        rec = StreamingRecognizer(model, audio_cfg, tokenizer,
                                  chunk_s=extra["--chunk_s"],
                                  left_s=extra["--left_s"],
                                  right_s=extra["--right_s"],
                                  n_exit=n_exit,
                                  causal_attention=bool(extra["--causal_attention"]))
        # feed in chunk-sized pieces, timing each accept (compute only)
        step = max(int(extra["--chunk_s"] * utt.sample_rate), 1)
        for s0 in range(0, len(utt.waveform), step):
            t0 = time.perf_counter()
            rec.accept_waveform(utt.waveform[s0:s0 + step])
            chunk_times.append(time.perf_counter() - t0)
        rec.finish()
        # score the full id sequence decoded at once (joining per-chunk
        # strings would lose subword word-boundary marks mid-word)
        hyp_stream = rec.transcript.strip().lower()

        with torch.no_grad():
            wav = torch.as_tensor(np.asarray(utt.waveform, np.float32)[None],
                                  device=device)
            lengths = frontend.mel_lengths(
                torch.tensor([len(utt.waveform)], device=device), audio_cfg.hop_length)
            feats = frontend.mel_spectrogram(wav, audio_cfg)
            logp, sub_len = model.apply(feats, lengths)
            toks, cnt = ctc.greedy_decode(logp[n_exit - 1], sub_len,
                                          blank=model_cfg.blank_id)
        ids = [int(t) for t in toks[0, :int(cnt[0])].tolist()]
        hyp_full = tokenizer.decode(ids).strip().lower()

        stream_wer.add(ref.lower(), hyp_stream)
        full_wer.add(ref.lower(), hyp_full)
        agree += hyp_stream == hyp_full
        print(f"[{i}] ref : {ref.lower()}")
        print(f"[{i}] strm: {hyp_stream}")
        print(f"[{i}] full: {hyp_full}")

    # drop the first (compile) measurement from the latency stats
    warm = sorted(chunk_times[1:]) or chunk_times
    if not warm:
        print(json.dumps({"utts": 0, "error": "no decodable utterances"}))
        return {"utts": 0}
    summary = {
        "utts": stream_wer.utterances, "exit": n_exit,
        "chunk_s": extra["--chunk_s"], "left_s": extra["--left_s"],
        "right_s": extra["--right_s"],
        "causal_attention": bool(extra["--causal_attention"]),
        "stream_wer_pct": round(100 * stream_wer.value, 2),
        "full_wer_pct": round(100 * full_wer.value, 2),
        "exact_transcript_agreement": f"{agree}/{stream_wer.utterances}",
        "chunk_compute_ms_p50": round(1e3 * warm[len(warm) // 2], 2),
        "chunk_compute_ms_p95": round(1e3 * warm[int(len(warm) * .95)], 2),
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
