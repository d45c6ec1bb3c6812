"""Streaming at full width: the committed flagship (d=256, 8 heads, ffn
2048, k=31, 6x2 layers) in the bf16 inference profile (bf16 compute,
residual and softmax, DFT mel), through the JAX package's and the port's
`StreamPool` with every exit decoded, at the CLI's geometry (chunk
1.0 s, left 3.0 s, right 0.5 s: windows of 112 sub frames), on one ~6 s
in-distribution utterance fed 1 s a round beside an idle stream.

Tolerance: the token contract of the bf16 profile (ROADMAP's parity
contracts): two bf16 schedules of this trunk diverge at depth, so the
streams' tokens may disagree on <= 1%, pooled over the exits and at
every exit that transcribes (exit 1, ~90% WER, is held pooled only).
"""

import jax
import numpy as np
import pytest

from early_exit_tpu.configs import AudioConfig as JAudioConfig
from early_exit_tpu.configs import ModelConfig as JModelConfig
from early_exit_tpu.serving import StreamPool as JPool
from early_exit_tpu_torch import checkpoint
from early_exit_tpu_torch.data.synthetic import SyntheticDataset
from early_exit_tpu_torch.serving import StreamPool
from early_exit_tpu_torch.serving.recognizer import Recognizer
from test_torch_early_conformer import _edits
from torch_one_thread import one_thread  # noqa: F401

GEO = dict(chunk_s=1.0, left_s=3.0, right_s=0.5, all_exits=True)
TOKEN_DISAGREE = 0.01
TRANSCRIBING_WER = 0.30


def _stream(pool, wav):
    step = 16000
    for s0 in range(0, len(wav), step):
        pool.feed(0, wav[s0:s0 + step])
        pool.poll()
    pool.finish(0)
    return [pool.recs[0].ids_at(e) for e in range(1, 7)]


@pytest.fixture(scope="module")
def utterance():
    knobs = checkpoint.load_calib()["bench_eval"]
    utt = SyntheticDataset(n_items=1, seed=6060, min_words=18, max_words=18,
                           noise=knobs["noise"], speaker_warp=knobs["speaker_warp"],
                           dur_jitter=knobs["dur_jitter"],
                           amp_jitter=knobs["amp_jitter"])[0]
    assert 4.5 * 16000 < len(utt.waveform) < 8 * 16000
    return utt


def test_flagship_stream_pool_tokens_match_jax(utterance):
    rec = Recognizer.from_flagship("cpu", fused=True)
    tree = checkpoint.load_tree(checkpoint.FLAGSHIP_CKPT)
    to_np = lambda t: t.float().numpy()
    params = {"subsample": {"convs": [
                  {k: to_np(v) for k, v in tree["params"]["subsample"]["convs"][i].items()}
                  for i in ("0", "1")]},
              "blocks": jax.tree_util.tree_map(to_np, tree["params"]["blocks"]),
              "heads": jax.tree_util.tree_map(to_np, tree["params"]["heads"])}
    state = jax.tree_util.tree_map(to_np, tree["model_state"])
    jcfg = JModelConfig(attn_softmax_dtype="bfloat16", fused_block=True)
    jpool = JPool(2, params, state, jcfg, JAudioConfig(mel_method="dft"), **GEO)
    pool = StreamPool(2, rec.model, rec.acfg, **GEO)
    assert (pool.recs[0].K, pool.recs[0].win_samples) == (112, 72320)
    want = _stream(jpool, utterance.waveform)
    got = _stream(pool, utterance.waveform)
    assert pool.recs[1].ids == [] and pool.recs[1]._next_chunk == 0

    words = utterance.transcript.lower().split()
    edits = total = 0
    for e in range(6):
        ee, tt = _edits(got[e], want[e]), max(len(want[e]), 1)
        wer = _edits(rec.tokenizer.decode(want[e]).lower().split(), words) / len(words)
        if wer <= TRANSCRIBING_WER:
            assert ee <= TOKEN_DISAGREE * tt, (e + 1, got[e], want[e])
        edits, total = edits + ee, total + tt
    assert edits <= TOKEN_DISAGREE * total
    # the deepest exit transcribes: the comparison is not of empty streams
    assert _edits(rec.tokenizer.decode(got[5]).lower().split(), words) \
        <= TRANSCRIBING_WER * len(words)
