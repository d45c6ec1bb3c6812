"""The whole slice at full width on the committed flagship: waveform ->
mel -> subsampling -> 12 Conformer blocks -> 6 heads -> greedy CTC ->
BPE text, the port against the JAX package on the same two short
in-distribution utterances (as tests/test_flagship_bundle.py draws them).

Tolerance:
- float32 compute: every exit's logits within 1e-4 of JAX's (logits
  reach ~50; the sums run in another order and pass through 12
  blocks), and identical greedy tokens;
- bf16 inference profile: tests/test_torch_early_conformer_bf16.py;
- `encode_exit` equals the full forward's exit within 1e-5;
- greedy decoding, the tokenizer's decode and the synthetic requests are
  exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from early_exit_tpu.configs import AudioConfig as JaxAudioConfig
from early_exit_tpu.configs import ModelConfig as JaxModelConfig
from early_exit_tpu.data.librispeech import SyntheticDataset as JaxSynthetic
from early_exit_tpu.models import early_conformer as jec
from early_exit_tpu.ops import ctc as jctc
from early_exit_tpu.ops import frontend as jfe
from early_exit_tpu.tokenizer import proto
from early_exit_tpu.tokenizer.bpe import SentencePieceBPE, load_tokenizer
from early_exit_tpu_torch import checkpoint, interop
from early_exit_tpu_torch.configs import AudioConfig, ModelConfig
from early_exit_tpu_torch.data.synthetic import SyntheticDataset
from early_exit_tpu_torch.ops import ctc, frontend
from early_exit_tpu_torch.tokenizer import load_decoder

FP32_ATOL = 1e-4


@pytest.fixture(scope="module")
def bundle():
    calib = checkpoint.load_calib()
    knobs = calib["bench_eval"]
    kw = dict(n_items=2, seed=4321, min_words=4, max_words=4,
              noise=knobs["noise"], speaker_warp=knobs["speaker_warp"],
              dur_jitter=knobs["dur_jitter"], amp_jitter=knobs["amp_jitter"])
    utts = [SyntheticDataset(**kw)[i] for i in range(2)]
    n = max(len(u.waveform) for u in utts)
    wav = np.zeros((2, n), np.float32)
    for i, u in enumerate(utts):
        wav[i, :len(u.waveform)] = u.waveform
    counts = np.array([len(u.waveform) for u in utts])

    # the same weights for both sides: the checkpoint as the port reads it
    # (bit-exact against flax, tests/test_torch_checkpoint.py), float32
    tree = checkpoint.load_tree(checkpoint.FLAGSHIP_CKPT)
    to_np = lambda t: t.float().numpy()
    params = {"subsample": {"convs": [
                  {k: to_np(v) for k, v in tree["params"]["subsample"]["convs"][i].items()}
                  for i in ("0", "1")]},
              "blocks": jax.tree_util.tree_map(to_np, tree["params"]["blocks"]),
              "heads": jax.tree_util.tree_map(to_np, tree["params"]["heads"])}
    state = jax.tree_util.tree_map(to_np, tree["model_state"])
    return dict(wav=wav, counts=counts, utts=utts, params=params, state=state,
                tree=tree, tok=checkpoint.bound_tokenizer(calib))


def _jax_run(b, cfg, method):
    @jax.jit
    def run(params, state, wav, n):
        feats = jfe.mel_spectrogram(wav, JaxAudioConfig(), method=method)
        lengths = jfe.mel_lengths(n, 160)
        logits, sub_len, _ = jec.apply(params, state, feats, lengths, cfg,
                                       train=False, log_probs=False)
        toks, ntoks = jax.vmap(lambda lg: jctc.greedy_decode(lg, sub_len))(logits)
        return logits, sub_len, toks, ntoks
    out = run(b["params"], b["state"], jnp.asarray(b["wav"]),
              jnp.asarray(b["counts"]))
    return [np.asarray(o.astype(jnp.float32) if o.dtype == jnp.bfloat16 else o)
            for o in out]


def _port_run(b, cfg):
    """float32 path, FFT mel: (model, feats, lengths, logits, sub_len,
    tokens, n_tokens)."""
    model = interop.from_jax_params(b["tree"]["params"],
                                    b["tree"]["model_state"], cfg)
    with torch.no_grad():
        feats = frontend.mel_spectrogram(torch.from_numpy(b["wav"]),
                                         AudioConfig(), method="fft")
        lengths = frontend.mel_lengths(torch.from_numpy(b["counts"]), 160)
        logits, sub_len = model.apply(feats, lengths, log_probs=False)
        E, B, T, V = logits.shape
        toks, ntoks = ctc.greedy_decode(logits.reshape(E * B, T, V),
                                        sub_len.repeat(E))
    return (model, feats, lengths, logits.float(), sub_len.numpy(),
            toks.reshape(E, B, T).numpy(), ntoks.reshape(E, B).numpy())


def _tokens(toks, ntoks):
    return [[toks[e, i, :ntoks[e, i]].tolist() for i in range(toks.shape[1])]
            for e in range(toks.shape[0])]


def _edits(a, b):
    d = list(range(len(b) + 1))
    for i in range(1, len(a) + 1):
        prev, d[0] = d[:], i
        for j in range(1, len(b) + 1):
            d[j] = min(prev[j] + 1, d[j - 1] + 1, prev[j - 1] + (a[i - 1] != b[j - 1]))
    return d[len(b)]


def test_synthetic_requests_match_jax():
    for kw in (dict(n_items=3, seed=4321, min_words=4, max_words=4),
               dict(n_items=3, seed=7, noise=0.02, noise_hi=0.55,
                    speaker_warp=0.15, dur_jitter=0.3, amp_jitter=0.4)):
        ours, theirs = SyntheticDataset(**kw), JaxSynthetic(**kw)
        for i in range(3):
            np.testing.assert_array_equal(ours[i].waveform, theirs[i].waveform)
            assert ours[i].transcript == theirs[i].transcript


def test_fp32_logits_and_tokens_match_jax(bundle):
    jl, jsl, jt, jn = _jax_run(bundle, JaxModelConfig(compute_dtype="float32"), "fft")
    model, feats, lengths, pl, psl, pt, pn = _port_run(
        bundle, ModelConfig(compute_dtype="float32"))
    np.testing.assert_array_equal(psl, jsl)
    assert pl.shape == jl.shape == (6, 2, jl.shape[2], 256)
    np.testing.assert_allclose(pl.numpy(), jl, atol=FP32_ATOL, rtol=0)
    assert _tokens(pt, pn) == _tokens(jt, jn)
    # encode_exit runs only the first exits' blocks: exit 2's log-probs
    with torch.no_grad():
        lp2, sl2 = model.encode_exit(feats, lengths, 2)
    np.testing.assert_array_equal(sl2.numpy(), psl)
    torch.testing.assert_close(lp2, torch.log_softmax(pl[1], -1),
                               atol=1e-5, rtol=0)


def test_greedy_decode_matches_jax():
    r = np.random.RandomState(3)
    for blank in (0, 2):
        logits = r.randn(5, 40, 6).astype(np.float32)
        logits[:, ::3, blank] += 3.0
        lengths = np.array([40, 39, 17, 1, 0])
        jt, jn = jctc.greedy_decode(jnp.asarray(logits), jnp.asarray(lengths),
                                    blank=blank)
        pt, pn = ctc.greedy_decode(torch.from_numpy(logits),
                                   torch.from_numpy(lengths), blank=blank)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))


def test_tokenizer_decode_matches_jax(bundle):
    ours = load_decoder(bundle["tok"])
    theirs = load_tokenizer(bundle["tok"], prefer_native=False)
    assert ours.get_piece_size() == theirs.get_piece_size() == 256
    r = np.random.RandomState(5)
    seqs = [[i] for i in range(256)] + [
        r.randint(-3, 260, size=r.randint(0, 30)).tolist() for _ in range(200)]
    for s in seqs:
        assert ours.decode(s) == theirs.decode(s), s


def test_tokenizer_byte_fallback_matches_jax(tmp_path):
    pieces = [proto.SentencePieceEntry("<unk>", 0.0, proto.UNKNOWN),
              proto.SentencePieceEntry("<s>", 0.0, proto.CONTROL),
              proto.SentencePieceEntry("</s>", 0.0, proto.CONTROL)]
    pieces += [proto.SentencePieceEntry(f"<0x{b:02X}>", 0.0, proto.BYTE)
               for b in range(256)]
    pieces += [proto.SentencePieceEntry(p, -1.0) for p in ("▁a", "b", "▁cd")]
    path = tmp_path / "bf.model"
    path.write_bytes(proto.serialize_model(
        pieces, {"model_type": 2, "vocab_size": len(pieces), "byte_fallback": 1,
                 "unk_id": 0, "bos_id": 1, "eos_id": 2},
        {"name": "identity", "add_dummy_prefix": 1}))
    ours = load_decoder(str(path))
    theirs = SentencePieceBPE(proto.parse_model(str(path)))
    r = np.random.RandomState(6)
    utf8 = [3 + b for b in "é世\U0001f642".encode()]
    seqs = [utf8, [259, *utf8, 260, 3 + 0xC3], [3 + 0xE4, 3 + 0xB8, 261]] + [
        r.randint(0, len(pieces), size=r.randint(0, 20)).tolist()
        for _ in range(300)]
    for s in seqs:
        assert ours.decode(s) == theirs.decode(s), s

