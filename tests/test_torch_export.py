"""The serving export (`serving/export.py`, `export_serving.py`) against
the JAX package's (`early_exit_tpu/serving/export.py`) on the CPU.

The same weights (JAX init, carried by `interop.from_jax_params`) and
the same numpy waveforms go through the JAX package's bundle
(platforms=["cpu"]) and the port's (platforms=("cpu",)). Two models: the
tiny float32 configuration of `tests/test_export.py` (unfused), and
`tests/test_torch_cascade.py`'s with `fused_block=True` (the block op in
every graph). Tolerance: tokens, n_tok, chosen exits and escalations
equal; conf within 1e-5, as the JAX package holds its own export.
"""

import dataclasses
import json
import os
import subprocess
import sys
import zipfile

import jax
import numpy as np
import pytest
import torch

from early_exit_tpu.configs import AudioConfig as JaxAudioConfig
from early_exit_tpu.configs import ModelConfig as JaxModelConfig
from early_exit_tpu.models.registry import build_model
from early_exit_tpu.serving import export as jexp
from early_exit_tpu_torch import interop
from early_exit_tpu_torch.configs import AudioConfig, ModelConfig
from early_exit_tpu_torch.models.early_exit_gate import gated_apply
from early_exit_tpu_torch.ops import ctc, frontend
from early_exit_tpu_torch.serving import export as exp
from early_exit_tpu_torch.serving.packing import PACK_BATCH
from early_exit_tpu_torch.serving.recognizer import Recognizer
from torch_one_thread import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNFUSED = dict(d_model=32, n_heads=4, d_feed_forward=64, n_enc_exits=2,
               n_enc_layers_per_exit=1, depthwise_kernel_size=7, vocab_size=40,
               n_mels=16, compute_dtype="float32")
FUSED = dict(d_model=32, n_enc_exits=4, n_enc_layers_per_exit=1, n_heads=4,
             d_feed_forward=64, depthwise_kernel_size=7, vocab_size=16,
             n_mels=16, compute_dtype="float32", residual_dtype="float32",
             attn_softmax_dtype="float32", fused_block=True)
UNFUSED_TEMPS, FUSED_TEMPS = [2.0, 1.0], [2.0, 1.5, 1.0, 1.0]
FUSED_B = 10          # more rows than PACK_BATCH: phase B runs fewer


class Tok:
    def get_piece_size(self):
        return 6

    def id_to_piece(self, i):
        return ["<blank>", "▁he", "llo", "▁yo", "<s>", "</s>"][i]


def _wav(b, s, seed=0):
    rng = np.random.RandomState(seed)
    wav = (rng.randn(b, s) * 0.1).astype(np.float32)
    n = np.asarray([s - 160 * i for i in range(b)], np.int32)
    return wav, n


class Pair:
    """One configuration in both packages, with a bundle of each."""

    def __init__(self, kw, tmp, name, shapes, jax_poly=True, **export_kw):
        self.jcfg = JaxModelConfig(**{k: v for k, v in kw.items()})
        self.jacfg = JaxAudioConfig(n_mels=kw["n_mels"])
        self.jmodel = build_model(self.jcfg)
        params, state = self.jmodel.init(jax.random.PRNGKey(0), self.jcfg)
        self.params, self.state = params, state
        to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        self.model = interop.from_jax_params(to_np(params), to_np(state),
                                             ModelConfig(**kw)).eval()
        self.acfg = AudioConfig(n_mels=kw["n_mels"])
        self.path = str(tmp / f"{name}.eetx")
        self.bundle = exp.export_recognizer(self.model, self.acfg, shapes,
                                            platforms=("cpu",), **export_kw)
        exp.save_bundle(self.path, self.bundle)
        self.rec = exp.ExportedRecognizer(self.path, device="cpu")
        self.jpath = jpath = str(tmp / f"{name}.jax.eetx")
        if not jax_poly:
            export_kw = {k: v for k, v in export_kw.items()
                         if k != "symbolic_max_samples"}
        jexp.save_bundle(jpath, jexp.export_recognizer(
            self.jmodel, self.jcfg, self.jacfg, params, state, shapes,
            platforms=["cpu"], **export_kw))
        self.jrec = jexp.ExportedRecognizer(jpath)

    def jax_direct(self, gated_threshold=None):
        """The JAX package's serve function itself, jitted (where its
        symbolic export cannot be made)."""
        args = (self.jcfg, self.jacfg, self.params, self.state)
        if gated_threshold is None:
            fn = jax.jit(jexp.make_serve_fn(self.jmodel, *args))
            return lambda wav, n: [np.asarray(t) for t in fn(wav, n)]
        fn = jax.jit(jexp.make_gated_serve_fn(*args))
        return lambda wav, n: [np.asarray(t) for t in fn(wav, n, np.float32(
            gated_threshold))]

    def eager(self, wav, n):
        serve = exp.make_serve_fn(self.model, self.acfg)
        with torch.no_grad():
            return [t.numpy() for t in serve(torch.from_numpy(wav), torch.from_numpy(n))]

    def recognizer(self, thresholds, temps, k):
        return Recognizer(self.model, None, acfg=self.acfg, device="cpu", calib={
            "thresholds": list(thresholds), "temperatures": temps,
            "score": "maxprob", "cascade_k": k})

    def conf1(self, wav, n, temperature):
        """Exit 1's calibrated confidence per row (the eager port)."""
        from early_exit_tpu_torch.models.gate_calibration import scaled_confidence
        with torch.no_grad():
            feats = frontend.mel_spectrogram(torch.from_numpy(wav), self.acfg)
            lp, sub_len = self.model.apply(
                feats, frontend.mel_lengths(torch.from_numpy(n), self.acfg.hop_length))
            mask = torch.arange(lp.shape[2])[None, :] < sub_len[:, None]
            return scaled_confidence(lp[0], mask, "maxprob", temperature).numpy()


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    return Pair(UNFUSED, tmp_path_factory.mktemp("plain"), "plain",
                [(2, 4000), (4, 8000)], tokenizer=Tok())


@pytest.fixture(scope="module")
def gc(tmp_path_factory):
    """Gated, cascade and poly programs of the unfused model."""
    return Pair(UNFUSED, tmp_path_factory.mktemp("gc"), "gc", [(3, 4000)],
                symbolic_max_samples=16000, gated=True, cascade_k=1,
                gate_temperatures=UNFUSED_TEMPS)


@pytest.fixture(scope="module")
def fused(tmp_path_factory):
    """The JAX package cannot export its fused stack's poly program (its
    fused dispatch compares the symbolic batch); the port's poly programs
    are held against the JAX functions jitted at the same shape."""
    return Pair(FUSED, tmp_path_factory.mktemp("fused"), "fused", [(FUSED_B, 4000)],
                jax_poly=False, symbolic_max_samples=16000, gated=True,
                cascade_k=2, gate_temperatures=FUSED_TEMPS)


def _split(conf, below):
    """A threshold with `below` rows under it, halfway between two rows'
    confidences (never at one: the packages' float sums may part a tie)."""
    c = np.sort(conf)
    return float((c[below - 1] + c[below]) / 2)


def _same(got, ref, conf_atol=1e-5):
    toks, n_tok, conf = got
    np.testing.assert_array_equal(n_tok, np.asarray(ref[1]))
    np.testing.assert_array_equal(toks, np.asarray(ref[0]))
    np.testing.assert_allclose(conf, np.asarray(ref[2]), atol=conf_atol, rtol=0)


def _same_rows(got, ref):
    """Gated / cascade outputs: n_tok, chosen equal; each row's tokens."""
    np.testing.assert_array_equal(got[2], np.asarray(ref[2]))
    np.testing.assert_array_equal(got[1], np.asarray(ref[1]))
    for i in range(len(got[1])):
        np.testing.assert_array_equal(got[0][i, :got[1][i]],
                                      np.asarray(ref[0])[i, :got[1][i]])


# ---------------------------------------------------------------- JAX's tests

def test_roundtrip_parity(plain):
    wav, n = _wav(2, 4000)
    got = plain.rec(wav, n)
    assert got[0].shape[:2] == (2, 2) and got[0].dtype == np.int32
    _same(got, plain.jrec(wav, n))
    _same(got, plain.eager(wav, n))
    assert np.all((got[2] > 0) & (got[2] <= 1))


def test_padding_to_covering_shape(plain):
    rec = plain.rec
    # B=1, S=3000 -> padded into the (2, 4000) program; trimmed back
    wav, n = _wav(1, 3000, seed=1)
    toks, n_tok, conf = rec(wav, n)
    assert toks.shape[1] == 1 and n_tok.shape == (2, 1)
    _same((toks, n_tok, conf), plain.jrec(wav, n))
    # the same utterance zero-padded by the caller gives the same decode
    toks2, n_tok2, _ = rec(np.pad(wav, ((0, 0), (0, 1000))), n)
    np.testing.assert_array_equal(n_tok, n_tok2)
    for e in range(2):
        np.testing.assert_array_equal(toks[e, 0, :n_tok[e, 0]],
                                      toks2[e, 0, :n_tok2[e, 0]])
    # B=3, S=6000 -> the (4, 8000) program
    _same(rec(*_wav(3, 6000, seed=2)), plain.jrec(*_wav(3, 6000, seed=2)))
    with pytest.raises(ValueError, match="no exported shape"):
        rec(*_wav(8, 4000))


def test_manifest_and_vocab(plain):
    m = plain.rec.manifest
    assert m["format"] == "eet-torch-export-1"
    assert m["platforms"] == ["cpu"]
    assert m["n_exits"] == 2
    assert m["shapes"]["2x4000"]["wav"] == [2, 4000]
    assert m["shapes"]["2x4000"]["tokens"] == list(plain.rec(*_wav(2, 4000))[0].shape)
    assert m["ops"] == []          # unfused: no kernel in the graph
    assert plain.rec.detokenize([1, 2, 4, 3]) == "hello yo"
    assert plain.jrec.detokenize([1, 2, 4, 3]) == "hello yo"


def test_symbolic_program(gc):
    rec = gc.rec
    assert "poly" in rec.manifest["shapes"]
    for b, s, seed in [(3, 6000, 2), (1, 9000, 3), (2, 16000, 4)]:
        wav, n = _wav(b, s, seed=seed)
        got = rec(wav, n)
        _same(got, gc.eager(wav, n))
        _same(got, gc.jrec(wav, n))
    with pytest.raises(ValueError, match="poly"):
        rec(*_wav(1, 32000))


HOP = 160
SHORT = [HOP * h for h in (10, 11, 12, 13)]     # T' = 2: the JAX package's bound up


def _short(b, s, seed):
    """A b-row request s samples wide, rows of s, s - 700 and s // 2
    samples in turn; b above the fixture's bucket batch, so that the poly
    program serves it."""
    rng = np.random.RandomState(seed)
    return ((rng.randn(b, s) * 0.1).astype(np.float32),
            np.asarray([(s, s - 700, s // 2)[i % 3] for i in range(b)], np.int32))


@pytest.mark.parametrize("s", SHORT)
def test_symbolic_program_from_ten_hops(gc, s):
    """From the JAX package's bound (hop * 10 samples) up, the poly
    program takes the request as it is: the same shapes (T' = 2), tokens,
    n_tok and conf as the JAX package's poly program on the unpadded
    request, and the gated poly program's chosen exits and tokens at
    thresholds 0, 1.01 and between two rows' exit-1 confidences."""
    assert gc.rec.manifest["shapes"]["poly"]["min_samples"] == HOP * 10
    assert gc.rec._pick(4, s) == (4, s)
    wav, n = _short(4, s, seed=s)
    got, want = gc.rec(wav, n), gc.jrec(wav, n)
    assert [a.shape for a in got] == [np.shape(w) for w in want]
    assert got[0].shape[2] == 2
    _same(got, want)
    for thr in (0.0, 1.01, _split(got[2][0], 1)):
        g = gc.rec.gated(wav, n, thr)
        w = gc.jrec.gated(wav, n, thr)
        assert [a.shape for a in g] == [np.shape(x) for x in w]
        for a, x in zip(g, w):
            np.testing.assert_array_equal(a, np.asarray(x))


def test_fused_poly_from_ten_hops(fused):
    """The fused model's poly programs at 10 and 13 hops against the JAX
    functions jitted at the request's own shape: all-exit outputs equal,
    the gated program's chosen exits and tokens equal."""
    for s in (SHORT[0], SHORT[-1]):
        wav, n = _short(FUSED_B + 1, s, seed=s + 1)
        got, want = fused.rec(wav, n), fused.jax_direct()(wav, n)
        assert [a.shape for a in got] == [np.shape(w) for w in want]
        _same(got, want)
        thr = _split(got[2][0], 1)
        g = fused.rec.gated(wav, n, thr)
        for a, x in zip(g, fused.jax_direct(thr)(wav, n)):
            np.testing.assert_array_equal(a, np.asarray(x))


def test_symbolic_only_bundle(tmp_path):
    kw = dict(UNFUSED)
    model = interop.from_jax_params(*_jax_weights(kw), ModelConfig(**kw)).eval()
    acfg = AudioConfig(n_mels=16)
    path = str(tmp_path / "poly.eetx")
    exp.save_bundle(path, exp.export_recognizer(model, acfg, [], platforms=("cpu",),
                                                symbolic_max_samples=8000))
    rec = exp.ExportedRecognizer(path, device="cpu")
    wav, n = _wav(2, 4000)
    toks, n_tok, conf = rec(wav, n)
    assert toks.shape[:2] == (2, 2)
    with torch.no_grad():
        ref = exp.make_serve_fn(model, acfg)(torch.from_numpy(wav), torch.from_numpy(n))
    _same((toks, n_tok, conf), [t.numpy() for t in ref])
    with pytest.raises(ValueError):
        exp.export_recognizer(model, acfg, [], platforms=("cpu",))


def _jax_weights(kw):
    jcfg = JaxModelConfig(**kw)
    params, state = build_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return to_np(params), to_np(state)


def test_gated_programs(gc, plain):
    rec = gc.rec
    assert rec.manifest["gated"]
    for b, s, seed in [(3, 4000, 0), (2, 6000, 2)]:       # bucket + poly
        wav, n = _wav(b, s, seed=seed)
        for thr in (0.0, 0.99):
            got = rec.gated(wav, n, thr)
            assert got[0].shape[0] == b and got[2].shape == (b,)
            assert np.all((got[2] >= 1) & (got[2] <= 2))
            _same_rows(got, gc.jrec.gated(wav, n, thr))
            with torch.no_grad():
                feats = frontend.mel_spectrogram(torch.from_numpy(wav), gc.acfg)
                lp, chosen, sub_len, _ = gated_apply(
                    gc.model, feats,
                    frontend.mel_lengths(torch.from_numpy(n), gc.acfg.hop_length),
                    threshold=thr, item_mask=(torch.from_numpy(n) > 0).float())
                t_ref, n_ref = ctc.greedy_decode(lp, sub_len)
            _same_rows(got, (t_ref.numpy(), n_ref.numpy(), chosen.numpy()))
        _, _, c_lo = rec.gated(wav, n, 0.0)
        _, _, c_hi = rec.gated(wav, n, 0.99)
        assert np.all(c_lo == 1) and np.all(c_hi >= c_lo) and np.any(c_hi > 1)
    with pytest.raises(ValueError, match="gated"):
        plain.rec.gated(*_wav(2, 4000), 0.5)


def _cascade_against(pair, wav, n, thr, temps, k):
    """The port's bundle against JAX's bundle and the eager
    `Recognizer.cascade_pass`: chosen, escalation and tokens equal."""
    got = pair.rec.cascade(wav, n, thr)
    ref = pair.jrec.cascade(wav, n, thr)
    _same_rows(got, ref)
    np.testing.assert_array_equal(got[3], np.asarray(ref[3]))
    toks, n_tok, chosen, n_esc, _ = pair.recognizer(thr, temps, k).cascade_pass(
        torch.from_numpy(wav), torch.from_numpy(n))
    _same_rows(got, (toks.numpy(), n_tok.numpy(), chosen.numpy()))
    assert int(got[3].sum()) == n_esc
    np.testing.assert_array_equal(got[3], got[2] > k)
    return got


def test_cascade_programs(gc, plain):
    rec = gc.rec
    assert rec.manifest["cascade_k"] == 1
    assert {"cascade_a/3x4000", "cascade_b/3x4000"} <= set(rec.bundle.programs["cpu"])
    wav, n = _wav(3, 4000, seed=4)
    split = _split(gc.conf1(wav, n, UNFUSED_TEMPS[0]), 1)
    for thr in ([0.0, 0.0], [0.999, 0.0], [split, 0.0]):
        _cascade_against(gc, wav, n, thr, UNFUSED_TEMPS, 1)
    esc = rec.cascade(wav, n, [split, 0.0])[3]
    assert esc.any() and (~esc).any()
    with pytest.raises(ValueError, match="thresholds"):
        rec.cascade(wav, n, [0.5])
    with pytest.raises(ValueError, match="cascade_k"):
        plain.rec.cascade(*_wav(2, 4000), [0.5, 0.0])


def test_rejects_non_bundle(tmp_path, plain):
    path = str(tmp_path / "bad.eetx")
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("manifest.json", json.dumps({"format": "nope"}))
    with pytest.raises(ValueError, match="not an eet export bundle"):
        exp.load_bundle(path)
    # nor is a JAX bundle, nor a zip without a manifest
    with pytest.raises(ValueError, match="not an eet export bundle"):
        exp.load_bundle(plain.jpath)
    empty = str(tmp_path / "empty.eetx")
    with zipfile.ZipFile(empty, "w") as z:
        z.writestr("x.txt", "")
    with pytest.raises(ValueError, match="not an eet export bundle"):
        exp.load_bundle(empty)


# ---------------------------------------------------------------- the fused model

def test_fused_allexit_matches_jax(fused):
    for b, s, seed in [(FUSED_B, 4000, 0), (3, 4000, 1)]:          # bucket, padded
        wav, n = _wav(b, s, seed=seed)
        _same(fused.rec(wav, n), fused.jrec(wav, n))
    wav, n = _wav(2, 7000, seed=2)                                  # poly
    _same(fused.rec(wav, n), fused.jax_direct()(wav, n))


def test_fused_gated_matches_jax(fused):
    for b, s, seed in [(FUSED_B, 4000, 5), (3, 7000, 6)]:
        wav, n = _wav(b, s, seed=seed)
        med = _split(fused.conf1(wav, n, 1.0), b // 2)
        chosen = []
        for thr in (0.0, med):
            got = fused.rec.gated(wav, n, thr)
            ref = (fused.jrec.gated(wav, n, thr) if b == FUSED_B
                   else fused.jax_direct(thr)(wav, n))
            _same_rows(got, ref)
            chosen.append(got[2])
        assert (chosen[0] == 1).all() and (chosen[1] > 1).any()


def test_fused_cascade_matches_jax(fused):
    wav, n = _wav(FUSED_B, 4000, seed=7)
    split = _split(fused.conf1(wav, n, FUSED_TEMPS[0]), FUSED_B // 2)
    for thr in ([0.0] * 4, [0.999, 0.999, 0.0, 0.0], [split, 2.0, 0.5, 0.0]):
        _cascade_against(fused, wav, n, thr, FUSED_TEMPS, 2)


def test_exported_graph_calls_block_op_once_per_layer(fused):
    want = {"10x4000": 4, "gated/10x4000": 4, "cascade_a/10x4000": 2,
            "cascade_b/10x4000": 2, "poly": 4,
            **{f"gated/poly/{e}": 1 for e in range(4)}}
    nodes = fused.rec.manifest["op_nodes"]["cpu"]
    assert {k: c["eet::conformer_block"] for k, c in nodes.items()} == want
    assert fused.rec.manifest["ops"] == ["eet::conformer_block"]
    ep = torch.export.load(
        __import__("io").BytesIO(fused.bundle.programs["cpu"]["10x4000"]))
    assert exp._ops_called(ep) == {"eet::conformer_block": 4}
    # no folding op in the graph: the layout is held as buffers
    assert not any(n.target == torch.ops.aten.cat.default and "wqkv" in str(n.args)
                   for n in ep.graph.nodes)
    assert any("layout" in spec.target for spec in ep.graph_signature.input_specs
               if spec.target)


def test_phase_b_runs_packed_rows(fused):
    """Phase B is captured with a symbolic batch (1..B) and runs the
    escalated rows packed to a multiple of PACK_BATCH, not the bucket."""
    ep = torch.export.load(
        __import__("io").BytesIO(fused.bundle.programs["cpu"]["cascade_b/10x4000"]))
    h_k = next(n for n in ep.graph.nodes if n.op == "placeholder" and n.name == "h_k")
    assert isinstance(h_k.meta["val"].shape[0], torch.SymInt)
    rec = fused.rec
    rows = []
    phase_b = rec._fn("cascade_b/10x4000")

    def recording(h, sl, thr):
        rows.append(h.shape[0])
        return phase_b(h, sl, thr)

    rec._fns["cascade_b/10x4000"] = recording
    try:
        wav, n = _wav(FUSED_B, 4000, seed=7)
        thr = _split(fused.conf1(wav, n, FUSED_TEMPS[0]), 2)   # two rows escalate
        _, _, chosen, esc = rec.cascade(wav, n, [thr, 2.0, 0.5, 0.0])
    finally:
        rec._fns["cascade_b/10x4000"] = phase_b
    assert esc.sum() == 2 and rows == [PACK_BATCH] and PACK_BATCH < FUSED_B


def test_poly_only_cascade_raises(tmp_path):
    kw = dict(FUSED)
    model = interop.from_jax_params(*_jax_weights(kw), ModelConfig(**kw)).eval()
    path = str(tmp_path / "p.eetx")
    exp.save_bundle(path, exp.export_recognizer(
        model, AudioConfig(n_mels=16), [], platforms=("cpu",),
        symbolic_max_samples=8000, cascade_k=1))
    rec = exp.ExportedRecognizer(path, device="cpu")
    assert rec(*_wav(2, 4000))[0].shape[:2] == (4, 2)
    with pytest.raises(ValueError, match=r"cascade is exported for the buckets \[\]"):
        rec.cascade(*_wav(2, 4000), [0.5, 0.5, 0.5, 0.0])


def test_cuda_only_bundle_refuses_the_cpu(tmp_path, plain):
    b = exp.load_bundle(plain.path)
    b = dataclasses.replace(b, manifest={**b.manifest, "platforms": ["cuda"]},
                            programs={"cuda": b.programs["cpu"]})
    path = str(tmp_path / "cuda.eetx")
    exp.save_bundle(path, b)
    with pytest.raises(ValueError, match=r"exported for \['cuda'\]"):
        exp.ExportedRecognizer(path, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            exp.ExportedRecognizer(path)            # the default device is CUDA
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            exp.export_recognizer(plain.model, plain.acfg, [(2, 4000)])


def test_export_serving_cli_roundtrip(tmp_path, capsys):
    from early_exit_tpu_torch import export_serving
    from early_exit_tpu_torch.models.early_conformer import EarlyConformer
    from early_exit_tpu_torch.training import checkpoint
    flags = ["--decoder_mode", "ctc", "--d_model", "32", "--n_enc_exits", "2",
             "--n_enc_layers_per_exit", "1", "--n_heads", "4",
             "--d_feed_forward", "64", "--depthwise_kernel_size", "7",
             "--fused_block", "true", "--seed", "3"]
    from early_exit_tpu_torch.cli import get_args
    _, cfg, _, acfg, _ = get_args(flags, mode="infer")
    model = EarlyConformer(cfg).init(torch.Generator().manual_seed(11)).eval()
    checkpoint.save_epoch(str(tmp_path), 1, model)
    path = str(tmp_path / "cli.eetx")
    export_serving.main(flags + [
        "--load_model_path", checkpoint.model_ckpt_path(str(tmp_path), 1),
        "--export_path", path, "--export_shapes", "2x8000",
        "--export_platforms", "cpu"])
    assert f"exported 1 program(s) x ['cpu'] -> {path}" in capsys.readouterr().out
    rec = exp.ExportedRecognizer(path, device="cpu")
    assert rec.manifest["ops"] == ["eet::conformer_block"]
    assert rec.manifest["has_vocab"]
    wav, n = _wav(2, 8000, seed=9)
    with torch.no_grad():
        ref = exp.make_serve_fn(model, acfg)(torch.from_numpy(wav), torch.from_numpy(n))
    _same(rec(wav, n), [t.numpy() for t in ref], conf_atol=0)
    with pytest.raises(SystemExit, match="AED beam search"):
        export_serving.main(["--decoder_mode", "aed", "--export_path", path])


_CONSUMER = """
import sys
import numpy as np
from early_exit_tpu_torch.serving.export import ExportedRecognizer
rec = ExportedRecognizer(sys.argv[1], device="cpu")
rng = np.random.RandomState(0)
toks, n_tok, conf = rec((rng.randn(2, 4000) * 0.1).astype(np.float32),
                        np.asarray([4000, 3840], np.int32))
bad = sorted(m for m in sys.modules if m.startswith("early_exit_tpu_torch.models")
             or m.split(".")[0] in ("jax", "early_exit_tpu"))
print(bad, toks.shape, float(conf.sum()))
"""


def test_consumer_imports_no_model_code(plain):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _CONSUMER, plain.path], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    bad, shape = out.stdout.split("]", 1)[0] + "]", out.stdout.split("]", 1)[1]
    assert bad == "[]"
    ref = plain.rec(*_wav(2, 4000))
    assert str(ref[0].shape) in shape
    assert abs(float(shape.split(")")[-1]) - float(ref[2].sum())) < 1e-6


def test_aoti_package_matches_its_exported_program(fused, tmp_path):
    """One AOTInductor package compiled on the CPU (the "cuda" platform's
    route: a spawned compile process, here on the CPU's backend) from a
    captured program gives its outputs, the op called through the
    dispatcher: tokens equal, conf within 1e-5 (the compiled code sums in
    its own order)."""
    import io
    saved = {"poly": fused.bundle.programs["cpu"]["poly"]}
    (blob, secs), = exp._compile_all(saved, str(tmp_path)).values()
    assert secs > 0
    path = str(tmp_path / "poly.pt2")
    with open(path, "rb") as f:
        assert f.read() == blob
    run = torch._inductor.aoti_load_package(path)
    ep = torch.export.load(io.BytesIO(saved["poly"]))
    for b, s in ((1, 2240), (3, 7000)):
        wav, n = _wav(b, s, seed=b)
        args = (torch.from_numpy(wav), torch.from_numpy(n))
        _same([t.numpy() for t in run(*args)], [t.numpy() for t in ep.module()(*args)])
    assert torch.ops.eet.conformer_block.default in {
        n.target for gm in ep.graph_module.modules()
        if isinstance(gm, torch.fx.GraphModule) for n in gm.graph.nodes}


def test_attention_op_in_an_unfused_pallas_program(tmp_path):
    """An unfused configuration with attention_impl="pallas" exports the
    attention kernel as one `eet::fused_attention` node a block."""
    kw = dict(UNFUSED, attention_impl="pallas")
    model = interop.from_jax_params(*_jax_weights(UNFUSED), ModelConfig(**kw)).eval()
    acfg = AudioConfig(n_mels=16)
    path = str(tmp_path / "att.eetx")
    bundle = exp.export_recognizer(model, acfg, [(2, 4000)], platforms=("cpu",))
    exp.save_bundle(path, bundle)
    assert bundle.manifest["op_nodes"]["cpu"]["2x4000"] == {"eet::fused_attention": 2}
    wav, n = _wav(2, 4000, seed=5)
    with torch.no_grad():
        ref = exp.make_serve_fn(model, acfg)(torch.from_numpy(wav), torch.from_numpy(n))
    _same(exp.ExportedRecognizer(path, device="cpu")(wav, n), [t.numpy() for t in ref],
          conf_atol=0)
