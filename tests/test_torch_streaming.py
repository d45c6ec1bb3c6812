"""Streaming serving (`serving/streaming.py`) against the JAX package's
`early_exit_tpu.serving.streaming`, on the CPU.

Set-up: the JAX streaming tests' model (d=32, 4 heads, ffn 64, 2 exits x
1 layer, k=7, vocab 32, float32, length_mode="true"), initialised by the
JAX package and carried into the port (`interop.from_jax_params`); the
same seeded numpy audio on both sides.

Held:
- `sinusoidal_pe_at` at positions -75..40,000;
- single windows (mid-stream, stream start with pos0 < 0, a tail with
  n_valid < K, an idle row with n_valid = 0, in one batch): plain, causal,
  all exits and with the gate's confidence. Chunk-region float32
  log-probs within 1e-4 (float32 sums in another order through two
  blocks and a head), ids equal, confidences within 1e-5;
- whole streams, pools with churn, the gate, all exits, int8, the
  fused_block=True model and the attention kernel's plain version: ids
  (and each chunk's exit) equal to the JAX package's.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from early_exit_tpu.configs import AudioConfig as JAudioConfig
from early_exit_tpu.configs import ModelConfig as JModelConfig
from early_exit_tpu.models import conformer as jconformer
from early_exit_tpu.models import early_conformer as jec
from early_exit_tpu.nn import core as jcore
from early_exit_tpu.ops.pallas import attention as pattn
from early_exit_tpu.serving import StreamingRecognizer as JRec
from early_exit_tpu.serving import StreamPool as JPool
from early_exit_tpu.serving import streaming as jstreaming
from early_exit_tpu_torch import interop
from early_exit_tpu_torch.configs import AudioConfig, ModelConfig
from early_exit_tpu_torch.nn import core
from early_exit_tpu_torch.serving import StreamingRecognizer, StreamPool
from early_exit_tpu_torch.serving import streaming
from torch_one_thread import one_thread  # noqa: F401

KW = dict(d_model=32, n_heads=4, d_feed_forward=64, n_enc_exits=2,
          n_enc_layers_per_exit=1, depthwise_kernel_size=7, vocab_size=32,
          compute_dtype="float32", length_mode="true")
GEO = dict(chunk_s=0.5, left_s=1.0, right_s=0.2)   # Cs 12, Ls 25, Rs 5: K 42
SR = 16000
LOGP_ATOL = 1e-4
CONF_ATOL = 1e-5


def _pair(**over):
    """(JAX params, state, cfg) and the port's model on the same weights."""
    jcfg = JModelConfig(**{**KW, **over})
    params, state = jec.init(jax.random.PRNGKey(0), jcfg)
    params, state = (jax.tree_util.tree_map(np.asarray, t) for t in (params, state))
    model = interop.from_jax_params(params, state, ModelConfig(**{**KW, **over}))
    return params, state, jcfg, model.eval()


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _wav(seconds, seed=0):
    n = int(seconds * SR)
    return (0.1 * np.random.RandomState(seed).randn(n)).astype(np.float32)


def _run_jax(params, state, jcfg, wav, pieces=1, **kw):
    rec = JRec(params, state, jcfg, JAudioConfig(), **kw)
    for p in np.array_split(wav, pieces):
        rec.accept_waveform(p)
    rec.finish()
    return rec


def _run_port(model, wav, pieces=1, **kw):
    rec = StreamingRecognizer(model, AudioConfig(), **kw)
    out = []
    for p in np.array_split(wav, pieces):
        out += rec.accept_waveform(p)
    out += rec.finish()
    assert out == rec.ids
    return rec


# ---- the positional encodings ------------------------------------------

def test_sinusoidal_pe_at_matches_jax():
    """Both sides form the argument pos x div in float32. XLA's CPU exp
    and torch's round div differently at two of the 16 frequencies of
    d=32 (one float32 ulp; torch's is the correctly rounded value), so
    the encodings part by up to |pos| x that ulp plus the rounding of the
    argument: within 1e-5 to position 2,000 (80 s of audio), and beyond
    within 1e-5 + |pos| x |d div| + one float32 ulp of pos x div, at each
    frequency."""
    pos = np.arange(-75, 40001)
    want = np.asarray(jcore.sinusoidal_pe_at(jnp.asarray(pos), 32))
    got = core.sinusoidal_pe_at(torch.from_numpy(pos), 32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (len(pos), 32)
    got = got.numpy()
    near = np.abs(pos) <= 2000
    np.testing.assert_allclose(got[near], want[near], atol=1e-5, rtol=0)
    c = -math.log(10000.0) / 32
    j_div = np.asarray(jnp.exp(jnp.arange(0, 32, 2, dtype=jnp.float32) * c))
    t_div = torch.exp(torch.arange(0, 32, 2, dtype=torch.float32) * c).numpy()
    ulp = np.spacing(t_div)
    assert (np.abs(j_div - t_div) <= ulp).all()
    arg = np.abs(pos)[:, None] * t_div[None, :]
    bound = 1e-5 + np.abs(pos)[:, None] * np.abs(j_div - t_div) + np.spacing(
        arg.astype(np.float32))
    bound = np.repeat(bound, 2, axis=1)           # sin and cos of each frequency
    assert (np.abs(got - want) <= bound).all()
    np.testing.assert_array_equal(core.sinusoidal_pe(300, 32).numpy(),
                                  got[75:375])


def test_window_geometry_rounds_as_python():
    """The CLI's defaults: round(12.5) = 12, not 13: K = 112 sub frames,
    W = 453 mel frames, 72,320 samples a window."""
    _, _, _, model = _pair()
    rec = StreamingRecognizer(model, chunk_s=1.0, left_s=3.0, right_s=0.5)
    assert (rec.Cs, rec.Ls, rec.Rs, rec.K, rec.W, rec.win_samples) == (
        25, 75, 12, 112, 453, 72320)
    assert streaming._sub_frames_for_mel(453) == 112
    for w in range(5, 600):
        assert streaming._sub_frames_for_mel(w) == jstreaming._sub_frames_for_mel(w)


# ---- single windows ------------------------------------------------------

def _window_batch(rec):
    """Four windows: mid-stream, the stream start (pos0 = -Ls), a tail
    (n_valid < K) and an idle row (n_valid = 0)."""
    r = np.random.RandomState(7)
    wav = (0.1 * r.randn(4, rec.win_samples)).astype(np.float32)
    wav[1, :4 * rec.Ls * 160] = 0.0          # before the stream start
    pos0 = np.array([40, -rec.Ls, 64, 0])
    n_valid = np.array([rec.K, rec.K, 30, 0])
    return wav, pos0, n_valid


def _jax_logp(params, state, jcfg, rec, wav, pos0, n_valid, causal, n_exit):
    sub, blocks, bstate, head = jstreaming._slice_weights(params, state, jcfg, n_exit)
    x, mask, attn_mask, ccfg = jstreaming._embed_window(
        jcfg, JAudioConfig(), rec.Ls, rec.Cs, causal, sub, jnp.asarray(wav),
        jnp.asarray(pos0, jnp.int32), jnp.asarray(n_valid, jnp.int32))
    h, _ = jconformer.stack_apply(blocks, bstate, x, mask, ccfg, train=False,
                                  attn_mask=attn_mask)
    logits = jcore.linear(head, h, compute_dtype=jcfg.dtype)
    return np.asarray(jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1))


def _ids_equal(got, want, logp=None):
    """Ids equal; on a mismatch, JAX's top-2 margin at each differing
    frame goes into the message (a near tie, or a fault)."""
    if np.array_equal(got, want):
        return
    where = np.argwhere(got != want)
    msg = f"{len(where)} ids differ, first at {where[:5].tolist()}"
    if logp is not None:
        top2 = np.sort(logp, axis=-1)[..., -2:]
        margins = [float(top2[tuple(i)][1] - top2[tuple(i)][0]) for i in where[:5]]
        msg += f"; JAX top-2 margins there {margins}"
    raise AssertionError(msg)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n_exit", [1, 2])
def test_single_windows_match_jax(pair, causal, n_exit):
    params, state, jcfg, model = pair
    rec = StreamingRecognizer(model, **GEO)
    wav, pos0, n_valid = _window_batch(rec)
    want_lp = _jax_logp(params, state, jcfg, rec, wav, pos0, n_valid, causal, n_exit)
    t = (torch.from_numpy(wav), torch.from_numpy(pos0), torch.from_numpy(n_valid))
    lp, mask = streaming.window_log_probs(model, AudioConfig(), rec.Ls, rec.Cs,
                                          causal, *t, n_exit=n_exit)
    region = slice(rec.Ls, rec.Ls + rec.Cs)
    np.testing.assert_allclose(lp.numpy()[:, region], want_lp[:, region],
                               atol=LOGP_ATOL, rtol=0)
    np.testing.assert_array_equal(mask.numpy()[1], np.arange(rec.K) >= rec.Ls)
    # ids and confidence through each side's window program
    fn = jstreaming._window_fn(jcfg, JAudioConfig(), rec.Ls, rec.Cs, 0, causal,
                               with_confidence=True)
    j_best, j_conf = fn(*jstreaming._slice_weights(params, state, jcfg, n_exit),
                        jnp.asarray(wav), jnp.asarray(pos0, jnp.int32),
                        jnp.asarray(n_valid, jnp.int32))
    best, conf = streaming.window_forward(model, AudioConfig(), rec.Ls, rec.Cs, 0,
                                          causal, *t, n_exit=n_exit,
                                          with_confidence=True)
    assert tuple(best.shape) == (4, rec.Cs) and tuple(conf.shape) == (4,)
    _ids_equal(best.numpy(), np.asarray(j_best), want_lp[:, region])
    np.testing.assert_allclose(conf.numpy(), np.asarray(j_conf), atol=CONF_ATOL, rtol=0)
    assert float(conf[3]) == 1.0 and (best[3] == 0).all()      # the idle row
    plain = streaming.window_forward(model, AudioConfig(), rec.Ls, rec.Cs, 0,
                                     causal, *t, n_exit=n_exit)
    assert torch.equal(plain, best)


@pytest.mark.parametrize("causal", [False, True])
def test_all_exits_window_matches_jax(pair, causal):
    params, state, jcfg, model = pair
    rec = StreamingRecognizer(model, **GEO)
    wav, pos0, n_valid = _window_batch(rec)
    fn = jstreaming._window_fn_all_exits(jcfg, JAudioConfig(), rec.Ls, rec.Cs, 0, causal)
    want = np.asarray(fn(params["subsample"], params["blocks"], state["blocks"],
                         params["heads"], jnp.asarray(wav),
                         jnp.asarray(pos0, jnp.int32), jnp.asarray(n_valid, jnp.int32)))
    got = streaming.window_forward_all_exits(
        model, AudioConfig(), rec.Ls, rec.Cs, 0, causal, torch.from_numpy(wav),
        torch.from_numpy(pos0), torch.from_numpy(n_valid))
    assert tuple(got.shape) == (2, 4, rec.Cs)
    _ids_equal(got.numpy(), want)


# ---- whole streams -------------------------------------------------------

@pytest.mark.parametrize("case,seconds,pieces,kw", [
    ("defaults", 4.0, 1, {}),
    ("geometry", 3.0, 1, GEO),
    ("exit_1", 1.5, 1, dict(GEO, n_exit=1)),
    ("odd_pieces", 3.0, 37, GEO),
    ("causal", 3.0, 5, dict(GEO, right_s=0.5, causal_attention=True)),
    ("flush_only", 0.3, 1, dict(chunk_s=1.0, left_s=1.0, right_s=0.2)),
])
def test_stream_ids_match_jax(pair, case, seconds, pieces, kw):
    params, state, jcfg, model = pair
    wav = _wav(seconds, seed=len(case))
    want = _run_jax(params, state, jcfg, wav, pieces, **kw)
    got = _run_port(model, wav, pieces, **kw)
    assert got.ids == want.ids
    assert got._next_chunk == want._next_chunk >= 1
    if case != "flush_only":
        assert len(got.ids) > 0


def test_flush_emits_nothing_before_finish(pair):
    _, _, _, model = pair
    rec = StreamingRecognizer(model, chunk_s=1.0, left_s=1.0, right_s=0.2)
    assert rec.accept_waveform(_wav(0.3, seed=2)) == []
    assert rec._next_chunk == 0
    rec.finish()
    assert rec._next_chunk >= 1
    with pytest.raises(AssertionError, match="finished"):
        rec.accept_waveform(_wav(0.1))


def test_reference_length_mode_tail_matches_jax():
    """Under length_mode="reference" (len/4) the stream holds 1-2 more
    frames than under the conv arithmetic; the tail is decoded there."""
    params, state, jcfg, model = _pair(length_mode="reference")
    wav = _wav(3.0, seed=3)
    want = _run_jax(params, state, jcfg, wav, **GEO)
    got = _run_port(model, wav, **GEO)
    assert got.ids == want.ids
    assert got._total_sub_frames() == want._total_sub_frames()
    _, _, _, true_model = _pair()
    other = StreamingRecognizer(true_model, **GEO)
    other._n_samples = got._n_samples
    assert got._total_sub_frames() > other._total_sub_frames()


def _jax_chunk_confidences(params, state, jcfg, wav, **kw):
    """Every chunk's fast-exit confidence, read from the JAX package's
    gated recognizer with every chunk escalated."""
    rec = JRec(params, state, jcfg, JAudioConfig(), exit_threshold=1.01, **kw)
    confs, fast = [], rec._fast_forward

    def recording(*a):
        out = fast(*a)
        confs.append(float(out[1][0]))
        return out
    rec._fast_forward = recording
    rec.accept_waveform(wav)
    rec.finish()
    return np.sort(confs)


def _threshold_between(confs):
    """The middle of the widest gap between the middle half's values."""
    lo, hi = len(confs) // 4, 3 * len(confs) // 4
    j = lo + int(np.argmax(confs[lo + 1:hi + 1] - confs[lo:hi]))
    return float(confs[j:j + 2].mean())


@pytest.mark.parametrize("where", ["zero", "between", "above_one"])
def test_gated_stream_matches_jax(pair, where):
    params, state, jcfg, model = pair
    wav = _wav(3.0, seed=6)
    kw = dict(GEO, fast_exit=1)
    thr = {"zero": 0.0, "above_one": 1.01}.get(where)
    if thr is None:
        thr = _threshold_between(_jax_chunk_confidences(params, state, jcfg, wav, **kw))
    want = _run_jax(params, state, jcfg, wav, exit_threshold=thr, **kw)
    got = _run_port(model, wav, exit_threshold=thr, **kw)
    assert got.ids == want.ids
    assert got.exits_run == want.exits_run
    expect = {"zero": {1}, "above_one": {2}, "between": {1, 2}}[where]
    assert set(got.exits_run) == expect
    if where == "zero":
        assert got.ids == _run_port(model, wav, n_exit=1, **GEO).ids


def test_gate_ignored_when_fast_exit_is_not_shallower(pair, capsys):
    _, _, _, model = pair
    rec = StreamingRecognizer(model, exit_threshold=0.5, fast_exit=2, **GEO)
    assert rec.exit_threshold is None
    assert "exit_threshold ignored" in capsys.readouterr().out
    with pytest.raises(ValueError, match="all_exits"):
        StreamingRecognizer(model, all_exits=True, n_exit=1)


def test_all_exits_stream_matches_jax(pair):
    params, state, jcfg, model = pair
    wav = _wav(2.5, seed=30)
    want = _run_jax(params, state, jcfg, wav, all_exits=True, **GEO)
    got = _run_port(model, wav, all_exits=True, **GEO)
    for e in (1, 2):
        assert got.ids_at(e) == want.ids_at(e), f"exit {e}"
        assert got.ids_at(e) == _run_port(model, wav, n_exit=e, **GEO).ids
    assert got.ids == got.ids_at(2)
    with pytest.raises(ValueError, match="all_exits"):
        _run_port(model, wav, **GEO).ids_at(1)


def test_int8_stream_matches_jax():
    params, state, jcfg, model = _pair(quantize="int8")
    wav = _wav(2.0, seed=8)
    want = _run_jax(params, state, jcfg, wav, **GEO)
    got = _run_port(model, wav, **GEO)
    assert got.ids == want.ids and len(got.ids) > 0


def test_fused_block_model_takes_the_unfused_blocks(pair):
    """A fused_block=True model: the window programs run the unfused
    blocks, whose validity mask is not a prefix; the block kernel's path
    would read the leading invalid frames of the first window as the
    trailing ones."""
    params, state, jcfg, model = pair
    fused = interop.from_jax_params(params, state,
                                    ModelConfig(**{**KW, "fused_block": True})).eval()
    wav = _wav(3.0, seed=9)
    want = _run_jax(params, state, dataclasses.replace(jcfg, fused_block=True), wav, **GEO)
    got = _run_port(fused, wav, **GEO)
    assert got.ids == want.ids == _run_port(model, wav, **GEO).ids
    # the same start window through the kernel's path differs
    rec = StreamingRecognizer(fused, **GEO)
    w, pos0, n_valid = _window_batch(rec)
    x, mask, _ = streaming._embed_window(fused, AudioConfig(), rec.Ls, rec.Cs, False,
                                         torch.from_numpy(w[1:2]),
                                         torch.from_numpy(pos0[1:2]),
                                         torch.from_numpy(n_valid[1:2]))
    with torch.no_grad():
        unfused = fused.stack(x, mask, prefix_mask=False)
        kernel_path = fused.stack(x, mask)
    assert not torch.allclose(unfused, kernel_path, atol=1e-2)


def test_attention_kernel_path_matches_jax_pallas(monkeypatch):
    """attention_impl="pallas": the attention kernel's plain version on
    the CPU, JAX's `mha_pallas` in interpret mode, on the windows' key
    masks (leading invalid keys at the stream start, trailing at the
    tail)."""
    monkeypatch.setattr(pattn, "mha_pallas",
                        functools.partial(pattn.mha_pallas, interpret=True))
    params, state, jcfg, model = _pair(attention_impl="pallas")
    rec = StreamingRecognizer(model, **GEO)
    wav, pos0, n_valid = _window_batch(rec)
    want_lp = _jax_logp(params, state, jcfg, rec, wav, pos0, n_valid, False, 2)
    lp, _ = streaming.window_log_probs(model, AudioConfig(), rec.Ls, rec.Cs, False,
                                       torch.from_numpy(wav), torch.from_numpy(pos0),
                                       torch.from_numpy(n_valid), n_exit=2)
    region = slice(rec.Ls, rec.Ls + rec.Cs)
    np.testing.assert_allclose(lp.numpy()[:, region], want_lp[:, region],
                               atol=LOGP_ATOL, rtol=0)
    s = _wav(2.5, seed=11)
    want = _run_jax(params, state, jcfg, s, **GEO)
    got = _run_port(model, s, **GEO)
    assert got.ids == want.ids and len(got.ids) > 0


# ---- pools ----------------------------------------------------------------

def _drive_pools(pools, first, replacements, n_pieces=4):
    """The same churn schedule on every pool: feed a piece to each live
    stream, poll, and when a stream runs out finish it and recycle the
    slot with the next replacement. Returns, per pool, {tag: (ids,
    exits_run, per-exit ids or None)}."""
    S = len(first)
    results = [dict() for _ in pools]
    pieces = [list(np.array_split(w, n_pieces)) for w in first]
    tags = [f"first{i}" for i in range(S)]
    queue = [(f"repl{i}", w) for i, w in enumerate(replacements)]
    for _ in range(64):
        for i in range(S):
            if pieces[i]:
                for p in pools:
                    p.feed(i, pieces[i][0])
                pieces[i].pop(0)
        for p in pools:
            p.poll()
        for i in range(S):
            if tags[i] is not None and not pieces[i]:
                for p, res in zip(pools, results):
                    p.finish(i)
                    rec = p.recs[i]
                    per_exit = ([rec.ids_at(e) for e in (1, 2)]
                                if rec.all_exits else None)
                    res[tags[i]] = (rec.ids, list(rec.exits_run), per_exit)
                tags[i] = None
                if queue:
                    tag, w = queue.pop(0)
                    for p in pools:
                        p.reset(i)
                    tags[i], pieces[i] = tag, list(np.array_split(w, 3))
        if all(t is None for t in tags) and not queue:
            break
    return results


@pytest.mark.parametrize("mode", ["plain", "gated", "all_exits"])
def test_pool_with_churn_matches_jax_pool(pair, mode):
    params, state, jcfg, model = pair
    kw = dict(GEO)
    first = [_wav(1.2 + 0.9 * i, seed=30 + i) for i in range(3)]
    repl = [_wav(2.1, seed=40), _wav(1.4, seed=41)]
    if mode == "gated":
        confs = np.concatenate([_jax_chunk_confidences(params, state, jcfg, w, **kw)
                                for w in first + repl])
        kw.update(exit_threshold=_threshold_between(np.sort(confs)), fast_exit=1)
    elif mode == "all_exits":
        kw.update(all_exits=True)
    jpool = JPool(3, params, state, jcfg, JAudioConfig(), **kw)
    pool = StreamPool(3, model, AudioConfig(), **kw)
    want, got = _drive_pools([jpool, pool], first, repl)
    assert sorted(got) == ["first0", "first1", "first2", "repl0", "repl1"]
    assert got == want
    assert all(len(v[0]) > 0 for v in got.values())
    if mode == "gated":
        assert {e for v in got.values() for e in v[1]} == {1, 2}


def test_pool_equals_solo_recognizers(pair):
    _, _, _, model = pair
    wavs = [_wav(2.0 + 0.7 * i, seed=10 + i) for i in range(3)]
    solo = [_run_port(model, w, **GEO).ids for w in wavs]
    pool = StreamPool(3, model, **GEO)
    pieces = [np.array_split(w, 5) for w in wavs]
    emitted = {i: [] for i in range(3)}
    for j in range(5):
        for i in range(3):
            pool.feed(i, pieces[i][j])
        for i, ids in pool.poll().items():
            emitted[i] += ids
    for i in range(3):
        emitted[i] += pool.finish(i)
    assert [pool.recs[i].ids for i in range(3)] == solo == [emitted[i] for i in range(3)]


@pytest.mark.parametrize("gated", [False, True])
def test_warmup_leaves_results_unchanged(pair, gated):
    params, state, jcfg, model = pair
    kw = dict(GEO, exit_threshold=0.5, fast_exit=1) if gated else dict(GEO)
    wavs = [_wav(1.5 + 0.5 * i, seed=30 + i) for i in range(2)]

    def run(warm):
        pool = StreamPool(2, model, AudioConfig(), **kw)
        if warm:
            pool.warmup()
        for i in range(2):
            pool.feed(i, wavs[i])
        pool.poll()
        for i in range(2):
            pool.finish(i)
        return [(r.ids, r.exits_run) for r in pool.recs]

    jpool = JPool(2, params, state, jcfg, JAudioConfig(), **kw)
    for i in range(2):
        jpool.feed(i, wavs[i])
    jpool.poll()
    for i in range(2):
        jpool.finish(i)
    assert run(True) == run(False) == [(r.ids, r.exits_run) for r in jpool.recs]


def test_buffer_is_trimmed_on_long_streams(pair):
    _, _, _, model = pair
    rec = StreamingRecognizer(model, chunk_s=0.5, left_s=0.5, right_s=0.2)
    for seed in range(6):
        rec.accept_waveform(_wav(2.0, seed=seed))
    assert sum(len(b) for b in rec._buf) < 3 * rec.win_samples
    assert rec._buf_offset > 0
    assert rec._next_chunk > 20


def test_window_programs_build_no_graph(pair):
    """The window programs run in inference mode, whatever the caller's
    mode (a server thread does not inherit the main thread's)."""
    _, _, _, model = pair
    trainable = interop.from_jax_params(*interop.to_jax_params(model), model.cfg,
                                        trainable=True)
    rec = StreamingRecognizer(trainable, **GEO)
    wav, pos0, n_valid = _window_batch(rec)
    with torch.enable_grad():
        _, conf = streaming.window_forward(trainable, AudioConfig(), rec.Ls, rec.Cs, 0,
                                         False, torch.from_numpy(wav),
                                         torch.from_numpy(pos0),
                                         torch.from_numpy(n_valid), n_exit=2,
                                         with_confidence=True)
    assert conf.grad_fn is None and conf.is_inference()
