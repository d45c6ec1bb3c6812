"""The port's CTC decoders against the JAX package's, on the same inputs.

Inputs: `tests/data/rehearsal_emissions.npz` (a trained model's
emissions: 16 utterances, 2 exits, T=74, V=256, ragged lengths) and
seeded random log-softmax with ragged lengths and frames of near-certain
blank (which the prefix beam skips).

- Prefix beam (`decoding/prefix_beam.py`, PyTorch) against
  `early_exit_tpu.decoding.prefix_beam.prefix_beam_search` (JAX) for beam
  1, 4, 10 and nbest 1, 3: tokens and lengths equal, scores within 1e-5
  relative (the log-semiring sums run in another order).
- The rolling hashes: equal to exact integer arithmetic mod 2^32 over the
  whole uint32 range, and the dual key free of collisions where one
  stream collides.
- Forced alignment and word timestamps: frames equal, scores within 1e-5
  relative.
- The lexicon beam with and without an ARPA LM (tools/train_arpa.py), the
  lexicon corrector and apply_lex: equal to the JAX package's wrappers
  (both call the same C++).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from early_exit_tpu.decoding import forced_align as jfa
from early_exit_tpu.decoding import lexicon as jlex
from early_exit_tpu.decoding import prefix_beam as jpb
from early_exit_tpu.decoding import timestamps as jts
from early_exit_tpu.decoding.lexicon_beam import LexiconBeamDecoder as JLexBeam
from early_exit_tpu.decoding.ngram_lm import ArpaLM as JArpaLM
from early_exit_tpu_torch.decoding import forced_align, lexicon, prefix_beam, timestamps
from early_exit_tpu_torch.decoding.api import DecoderSuite
from early_exit_tpu_torch.decoding.lexicon_beam import LexiconBeamDecoder
from early_exit_tpu_torch.decoding.ngram_lm import ArpaLM
from early_exit_tpu_torch.tokenizer import load_tokenizer
from torch_one_thread import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPM = os.path.join(REPO, "assets", "spm")
LEX, TOK = os.path.join(SPM, "synth.bpe-256.lex"), os.path.join(SPM, "synth.bpe-256.tok")


def _rehearsal():
    d = np.load(os.path.join(REPO, "tests", "data", "rehearsal_emissions.npz"))
    lp = d["lp"].astype(np.float32)                      # (B, E, T, V)
    return lp, d["lens"].astype(np.int32), [str(r) for r in d["refs"]]


def _random(B=6, T=40, V=32, seed=0):
    r = np.random.RandomState(seed)
    logits = r.randn(B, T, V).astype(np.float32) * 3.0
    logits[:, ::3, 0] += 12.0                           # near-certain blanks: skipped
    logits[min(1, B - 1), 5:9, 7] += 8.0                # a held token: repeats merge
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    lens = np.array([T, T - 7, 1, 0, T // 2, T - 1][:B], np.int32)
    lens[0] = T
    return lp.astype(np.float32), lens


def _inputs(source):
    if source == "rehearsal":
        lp, lens, _ = _rehearsal()
        return lp[:, -1], lens                          # the last exit
    return _random()


@pytest.mark.parametrize("nbest", [1, 3])
@pytest.mark.parametrize("beam", [1, 4, 10])
@pytest.mark.parametrize("source", ["rehearsal", "random"])
def test_prefix_beam_equals_jax(source, beam, nbest):
    lp, lens = _inputs(source)
    want = jax.device_get(jpb.prefix_beam_search(
        jnp.asarray(lp), jnp.asarray(lens), beam_size=beam, nbest=nbest))
    got = prefix_beam.prefix_beam_search(torch.from_numpy(lp), torch.from_numpy(lens),
                                         beam_size=beam, nbest=nbest)
    (wt, wn, ws), (gt, gn, gs) = want, [g.numpy() for g in got]
    assert gt.shape == wt.shape and gn.shape == wn.shape and gs.shape == ws.shape
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_array_equal(gt, wt)
    np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=0)
    assert gt.dtype == np.int32 and gn.dtype == np.int32


def test_prefix_beam_max_out_and_blank_id():
    """A short output buffer (extensions past it dropped) and a blank other
    than 0."""
    lp, lens = _random(seed=3)
    for kw in (dict(max_out=5), dict(blank=4), dict(topn=3, beam_size=6)):
        want = jax.device_get(jpb.prefix_beam_search(jnp.asarray(lp), jnp.asarray(lens), **kw))
        got = [g.numpy() for g in prefix_beam.prefix_beam_search(
            torch.from_numpy(lp), torch.from_numpy(lens), **kw)]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[2], want[2], rtol=1e-5)


def test_hash_step_is_exact_mod_2_32():
    r = np.random.RandomState(1)
    h = r.randint(0, 2 ** 32, size=100_000, dtype=np.uint64)
    h[:4] = [0, 1, 2 ** 31, 2 ** 32 - 1]
    tok = r.randint(0, 256, size=h.shape, dtype=np.uint64)
    for mult, add in prefix_beam._HASH:
        want = (h * np.uint64(mult) + tok + np.uint64(add)) % np.uint64(2 ** 32)
        got = prefix_beam._hash_step(torch.from_numpy(h.astype(np.int64)),
                                     torch.from_numpy(tok.astype(np.int64)), mult, add)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_dual_hash_collision_resistance():
    """200,000 random prefixes of 10 tokens with the same last token,
    hashed by the port's two streams: single 32-bit collisions occur at
    this scale (the birthday bound gives ~4.6), dual ones must not."""
    r = np.random.RandomState(0)
    prefixes = r.randint(1, 256, size=(200_000, 10))
    prefixes[:, -1] = 7
    uniq = torch.from_numpy(np.unique(prefixes, axis=0))
    hs = []
    for mult, add in prefix_beam._HASH:
        h = torch.zeros(len(uniq), dtype=torch.int64)
        for j in range(uniq.shape[1]):
            h = prefix_beam._hash_step(h, uniq[:, j], mult, add)
        hs.append(h)
    single = len(uniq) - len(torch.unique(hs[0]))
    dual = len(uniq) - len(torch.unique(hs[0] * 2 ** 32 + hs[1]))
    assert single >= 1 and dual == 0, (single, dual)


def _greedy_ids(lp_row, n):
    best = lp_row[:n].argmax(-1)
    out, prev = [], -1
    for b in best:
        if b != prev and b != 0:
            out.append(int(b))
        prev = b
    return out


def test_forced_align_and_timestamps_equal_jax():
    lp, lens, _ = _rehearsal()
    tok = load_tokenizer(os.path.join(SPM, "synth.bpe-256.model"))
    n_checked = 0
    for b in range(lp.shape[0]):
        for e in range(lp.shape[1]):
            em, n = lp[b, e], int(lens[b])
            ids = _greedy_ids(em, n)
            if not ids:
                continue
            ws, we, wsc = jfa.forced_align(jnp.asarray(em[:n]), jnp.asarray(ids, jnp.int32))
            gs, ge, gsc = forced_align.forced_align(torch.from_numpy(em[:n]),
                                                    torch.tensor(ids))
            np.testing.assert_array_equal(gs, ws)
            np.testing.assert_array_equal(ge, we)
            np.testing.assert_allclose(gsc, wsc, rtol=1e-5)
            pieces = timestamps.pieces_of(tok, ids)
            assert pieces == jts.pieces_of(tok, ids)
            want = jts.word_timestamps(em, n, ids, pieces, seconds_per_frame=0.04)
            got = timestamps.word_timestamps(torch.from_numpy(em), n, ids, pieces,
                                             seconds_per_frame=0.04)
            assert [(w.word, w.start, w.end) for w in got] == \
                [(w.word, w.start, w.end) for w in want]
            np.testing.assert_allclose([w.score for w in got], [w.score for w in want],
                                       rtol=1e-5)
            assert timestamps.format_spans(got) == jts.format_spans(want)
            n_checked += 1
    assert n_checked >= 16


def test_trellis_equals_jax_and_infeasible_alignment():
    lp, _ = _random(B=1, T=12, V=8, seed=5)
    toks = np.array([3, 3, 5], np.int32)
    want = np.asarray(jfa.get_trellis(jnp.asarray(lp[0]), jnp.asarray(toks)))
    got = forced_align.get_trellis(torch.from_numpy(lp[0]), torch.from_numpy(toks)).numpy()
    np.testing.assert_array_equal(got, want)
    # more tokens than frames: no alignment, as in the JAX package
    em = lp[0, :2]
    assert timestamps.word_timestamps(em, 2, [3, 4, 5], ["▁a", "b", "c"],
                                      seconds_per_frame=0.04) == []


def _train_arpa(refs, path):
    spec = importlib.util.spec_from_file_location(
        "train_arpa", os.path.join(REPO, "tools", "train_arpa.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.write_arpa(mod.train([r.lower().split() for r in refs], order=2), path)


@pytest.mark.parametrize("with_lm", [False, True])
def test_lexicon_beam_equals_jax(tmp_path, with_lm):
    lp, lens, refs = _rehearsal()
    kw = dict(beam_size=8, word_score=-0.5)
    if with_lm:
        arpa = str(tmp_path / "lm.arpa")
        _train_arpa(refs, arpa)
        lm, jlm = ArpaLM(arpa), JArpaLM(arpa)
        assert lm.order == jlm.order == 2 and lm.vocab_size == jlm.vocab_size
        assert lm.score(["the", "of"]) == jlm.score(["the", "of"])
        kw_p, kw_j = dict(kw, lm=lm, lm_weight=0.7), dict(kw, lm=jlm, lm_weight=0.7)
    else:
        kw_p = kw_j = kw
    dec = LexiconBeamDecoder.from_files(LEX, TOK, **kw_p)
    jdec = JLexBeam.from_files(LEX, TOK, **kw_j)
    for e in range(lp.shape[1]):
        assert dec.decode_batch(lp[:, e], lens) == jdec.decode_batch(lp[:, e], lens)
        for b in range(4):
            row = lp[b, e, :lens[b]]
            assert dec.decode(row) == jdec.decode(row)
            assert dec.decode_nbest(row, 3) == jdec.decode_nbest(row, 3)
    assert any(dec.decode_batch(lp[:, -1], lens))


def test_lexicon_corrector_and_apply_lex_equal_jax():
    words = lexicon.load_dict(os.path.join(SPM, "words.txt"))
    assert words == jlex.load_dict(os.path.join(SPM, "words.txt"))
    r = np.random.RandomState(2)
    letters = "abcdefghijklmnopqrstuvwxyz'"
    texts = []
    for _ in range(40):
        ws = []
        for _ in range(r.randint(1, 8)):
            w = list(words[r.randint(len(words))])
            for _ in range(r.randint(0, 3)):         # substitutions, insertions, deletions
                op, i = r.randint(3), r.randint(len(w) + 1)
                if op == 0 and i < len(w):
                    w[i] = letters[r.randint(len(letters))]
                elif op == 1:
                    w.insert(i, letters[r.randint(len(letters))])
                elif len(w) > 1 and i < len(w):
                    del w[i]
            ws.append("".join(w))
        texts.append(" ".join(ws))
    texts += ["", "the  of", "zzzzzzzzzz"]
    mine, theirs = lexicon.LexiconCorrector(words), jlex.LexiconCorrector(words)
    for t in texts:
        assert mine.apply(t) == theirs.apply(t)
        assert lexicon.apply_lex(t, words[:50]) == jlex.apply_lex(t, words[:50])
    for a, b in (("kitten", "sitting"), ("", "abc"), ("flaw", "lawn")):
        assert lexicon.edit_distance(a, b) == jlex.edit_distance(a, b)


def test_decoder_suite():
    from early_exit_tpu_torch.configs import ModelConfig
    lp, lens = _random(seed=4)
    suite = DecoderSuite(ModelConfig(vocab_size=32), beam_size=4,
                         lexicon_path=None, tokens_path=None)
    toks, n = suite.greedy(torch.from_numpy(lp), torch.from_numpy(lens))
    assert toks.shape == (6, 40) and int(n[3]) == 0
    t, n, s = suite.ctc_prefix(torch.from_numpy(lp), torch.from_numpy(lens))
    want = jax.device_get(jpb.prefix_beam_search(jnp.asarray(lp), jnp.asarray(lens),
                                                 beam_size=4))
    np.testing.assert_array_equal(t.numpy(), want[0])
    starts, ends, score = suite.align(torch.from_numpy(lp[0]), torch.tensor([3, 5]))
    assert len(starts) == 2 and np.isfinite(score)
    with pytest.raises(RuntimeError, match="lexicon"):
        suite.ctc_lexicon(lp, lens)
