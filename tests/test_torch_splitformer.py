"""The port's splitformer (`models/splitformer.py`) and its gate against
the JAX package's `splitformer` and `early_exit_gate`, on the CPU at a
small size (d 32, 4 heads, ffn 64, k 7, 3 exits x 1 block, V 24), the
weights carried across by `interop.from_jax_params`.

- the all-exit forward, unfused, in both length modes at an odd and an
  even T' (the branch pads T' to even only when it is odd): float32
  log-probs within 2e-5; the fused path (the block kernel's plain
  version against JAX's TPU kernel in interpret mode) at one small T';
  in the bf16 inference profile, at the flagship's widths with its
  trained blocks (`flagship_zoo_trees`), the greedy tokens <= 1% apart;
- the branch: with its blocks zeroed the splitformer is the
  early_conformer of the same trunk; with them, exits 1 and E differ from
  the branch-free trunk, and every other exit is its stack run on the
  exit before it;
- `encode_exit` at each exit equals the all-exit forward's;
- `gated_apply` against JAX's at thresholds 0, 1.01 and the median of
  exit 1's confidences, with and without `item_mask` rows: chosen exits
  and exits run equal, the chosen log-probs within 1e-4;
- the parameter count and the trees both ways.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from early_exit_tpu.configs import ModelConfig as JModelConfig
from early_exit_tpu.models import early_exit_gate as jgate
from early_exit_tpu.models import splitformer as jsf
from early_exit_tpu.models import zipformer as jzf
from early_exit_tpu.utils import count_parameters as jcount
from early_exit_tpu_torch import checkpoint, interop
from early_exit_tpu_torch.configs import AudioConfig, ModelConfig
from early_exit_tpu_torch.data.synthetic import SyntheticDataset
from early_exit_tpu_torch.models import early_exit_gate as gate
from early_exit_tpu_torch.models.early_conformer import EarlyConformer
from early_exit_tpu_torch.models.registry import build_model
from early_exit_tpu_torch.models.splitformer import Splitformer
from early_exit_tpu_torch.ops import frontend
from early_exit_tpu_torch.utils.model_utils import count_parameters
from torch_one_thread import one_thread  # noqa: F401

KW = dict(model_type="splitformer", d_model=32, n_heads=4, d_feed_forward=64,
          n_enc_exits=3, n_enc_layers_per_exit=1, depthwise_kernel_size=7,
          vocab_size=24, n_mels=8, compute_dtype="float32", drop_prob=0.0)
F32_ATOL = 2e-5


@pytest.fixture(scope="module")
def weights():
    params, state = jsf.init(jax.random.PRNGKey(0), JModelConfig(**KW))
    return jax.tree_util.tree_map(np.asarray, (params, state))


def _inputs(T, B=3, seed=0):
    """T = 4 T' + 3 mel frames give T' sub frames; the second row is 24
    frames shorter, the third 40."""
    r = np.random.RandomState(seed)
    return (r.randn(B, T, KW["n_mels"]).astype(np.float32),
            np.array([T, T - 24, T - 40][:B], np.int32))


def _pair(weights, **over):
    cfg = {**KW, **over}
    return JModelConfig(**cfg), interop.from_jax_params(*weights, ModelConfig(**cfg))


def _jax_apply(weights, jcfg, feats, lengths, log_probs=True):
    out, sub, _ = jax.jit(lambda p, s, f, l: jsf.apply(p, s, f, l, jcfg, log_probs=log_probs))(
        *weights, jnp.asarray(feats), jnp.asarray(lengths))
    return np.asarray(out.astype(jnp.float32)), np.asarray(sub)


@pytest.mark.parametrize("length_mode", ["reference", "true"])
@pytest.mark.parametrize("t_sub", [20, 21], ids=["even", "odd"])
def test_forward_matches_jax(weights, length_mode, t_sub):
    jcfg, model = _pair(weights, length_mode=length_mode)
    feats, lengths = _inputs(4 * t_sub + 3)
    want, sub_j = _jax_apply(weights, jcfg, feats, lengths)
    with torch.no_grad():
        got, sub = model.apply(torch.from_numpy(feats), torch.from_numpy(lengths))
    assert got.shape == want.shape == (3, 3, t_sub, KW["vocab_size"])
    np.testing.assert_array_equal(sub.numpy(), sub_j)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


def test_fused_forward_matches_jax(weights):
    jcfg, model = _pair(weights, fused_block=True)
    feats, lengths = _inputs(4 * 13 + 3)
    want, _ = _jax_apply(weights, jcfg, feats, lengths)
    with torch.no_grad():
        got, _ = model.apply(torch.from_numpy(feats), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


def flagship_zoo_trees(model_type: str):
    """JAX (params, state) trees of a zoo model at the flagship's widths
    whose blocks, convolution and heads are the committed flagship's
    (trained) ones: the splitformer's trunk is the flagship's, its
    branches blocks 1 and 12; the zipformer's 19 blocks are blocks 1..12
    in turn, its convolution the flagship's first and its head exit 6's.
    A seeded init gives near-tie logits, where bf16 tokens hang on the last
    rounding; these give decided ones."""
    tree = checkpoint.load_tree(checkpoint.FLAGSHIP_CKPT)
    f32 = lambda t: jax.tree_util.tree_map(lambda a: a.float().numpy(), t)
    fp, fs = f32(tree["params"]), f32(tree["model_state"])
    convs = [fp["subsample"]["convs"][k] for k in ("0", "1")]

    def stacked(tree_, idx):
        return jax.tree_util.tree_map(lambda a: a[np.asarray(idx)], tree_)

    if model_type == "splitformer":
        par = [stacked(fp["blocks"], 0), stacked(fp["blocks"], 11)]
        par_s = [stacked(fs["blocks"], 0), stacked(fs["blocks"], 11)]
        return ({"subsample": {"convs": convs}, "blocks": fp["blocks"],
                 "heads": fp["heads"], "parallel": par},
                {"blocks": fs["blocks"], "parallel": par_s})
    idx = [i % 12 for i in range(19)]
    bounds = np.cumsum([2, 2, 4, 5, 4, 2])
    parts = [idx[a:b] for a, b in zip([0, *bounds[:-1]], bounds)]
    return ({"subsample": {"convs": convs[:1]}, "pre": stacked(fp["blocks"], parts[0]),
             "stages": [stacked(fp["blocks"], p) for p in parts[1:]],
             "head": {"w": fp["heads"]["w"][5], "b": fp["heads"]["b"][5]}},
            {"pre": stacked(fs["blocks"], parts[0]),
             "stages": [stacked(fs["blocks"], p) for p in parts[1:]]})


def bf16_token_disagreement(model_type: str, **over):
    """Greedy tokens of the bf16 inference profile, the port against the
    JAX package, on two short in-distribution utterances at the flagship's
    widths (`flagship_zoo_trees`): the share of valid (exit, row, frame)
    triples that differ, and the number of triples."""
    params, state = flagship_zoo_trees(model_type)
    kw = dict(model_type=model_type, compute_dtype="bfloat16",
              attn_softmax_dtype="bfloat16", drop_prob=0.0, **over)
    utts = [SyntheticDataset(n_items=2, seed=4321, min_words=4, max_words=4)[i]
            for i in range(2)]
    wav = np.zeros((2, max(len(u.waveform) for u in utts)), np.float32)
    for i, u in enumerate(utts):
        wav[i, :len(u.waveform)] = u.waveform
    feats = frontend.mel_spectrogram(torch.from_numpy(wav), AudioConfig(), method="fft")
    lengths = frontend.mel_lengths(torch.tensor([len(u.waveform) for u in utts]), 160)
    jmod = jsf if model_type == "splitformer" else jzf
    jcfg = JModelConfig(**kw)
    want, sub_j, _ = jax.jit(lambda p, s, f, l: jmod.apply(p, s, f, l, jcfg, log_probs=False))(
        params, state, jnp.asarray(feats.numpy()), jnp.asarray(lengths.numpy()))
    model = interop.from_jax_params(params, state, ModelConfig(**kw))
    with torch.no_grad():
        got, sub = model.apply(feats, lengths, log_probs=False)
    np.testing.assert_array_equal(sub.numpy(), np.asarray(sub_j))
    valid = np.arange(want.shape[2])[None, :] < np.asarray(sub_j)[:, None]
    differ = (got.float().argmax(-1).numpy()
              != np.asarray(want.astype(jnp.float32)).argmax(-1))[:, valid]
    return differ.mean(), differ.size


@pytest.mark.parametrize("model_type", ["splitformer", "early_zipformer"])
def test_interop_flagship_zoo_tree_equals_the_helper(model_type):
    """`interop.flagship_zoo_tree`, the numpy version `chip_smoke.py`
    builds its zoo checkpoints from, equals `flagship_zoo_trees` leaf for
    leaf."""
    got, want = interop.flagship_zoo_tree(model_type), flagship_zoo_trees(model_type)
    g = jax.tree_util.tree_flatten_with_path(got)
    w = jax.tree_util.tree_flatten_with_path(want)
    assert g[1] == w[1]
    for (key, a), (_, b) in zip(g[0], w[0]):
        assert a.dtype == b.dtype == np.float32, jax.tree_util.keystr(key)
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(key))


def test_bf16_tokens_match_jax():
    share, n = bf16_token_disagreement("splitformer")
    assert n >= 6 * 60 and share <= 0.01, (share, n)


def test_branch_changes_first_and_last_exits(weights):
    _, model = _pair(weights)
    trunk = EarlyConformer(ModelConfig(**{**KW, "model_type": "early_conformer"}))
    trunk.load_state_dict(model.state_dict(), strict=False)
    feats, lengths = (torch.from_numpy(a) for a in _inputs(4 * 21 + 3))
    with torch.no_grad():
        hidden, sub_len = model.apply_hidden(feats, lengths)
        plain, _ = trunk.apply_hidden(feats, lengths)
        # exits 1 and E carry the branch; exit 2 is the stack on exit 1
        assert not torch.allclose(hidden[0], plain[0], atol=1e-3)
        assert not torch.allclose(hidden[2], plain[2], atol=1e-3)
        _, _, mask = model.frontend_embed(feats, lengths)
        torch.testing.assert_close(hidden[1], model.stack(hidden[0], mask, first_layer=1,
                                                          n_layers=2), atol=1e-6, rtol=0)
        for n in (1, 2, 3):
            lp, sl = model.encode_exit(feats, lengths, n)
            torch.testing.assert_close(lp, model.apply_heads(hidden)[n - 1],
                                       atol=1e-6, rtol=0)
        # zeroed branch blocks add nothing: the trunk's own forward
        for p in model.parallel.parameters():
            p.zero_()
        zeroed, _ = model.apply_hidden(feats, lengths)
    torch.testing.assert_close(zeroed, plain, atol=0, rtol=0)


def test_parameter_count_and_trees(weights):
    params, state = weights
    model = build_model(ModelConfig(**KW))
    assert isinstance(model, Splitformer)
    assert count_parameters(model) == jcount(params)
    _, model = _pair(weights)
    back_p, back_s = interop.to_jax_params(model)
    for a, b in ((params, back_p), (state, back_s)):
        la, ta = jax.tree_util.tree_flatten(a)
        lb, tb = jax.tree_util.tree_flatten(b)
        assert ta == tb
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def gate_bundle(weights):
    jcfg = JModelConfig(**KW)
    feats, lengths = _inputs(4 * 21 + 3, B=3, seed=5)
    feats = np.concatenate([feats, feats[::-1]])          # B = 6
    lengths = np.concatenate([lengths, lengths[::-1]])
    lp, sub = _jax_apply(weights, jcfg, feats, lengths)
    mask = np.arange(lp.shape[2])[None, :] < sub[:, None]
    conf = np.asarray(jgate.exit_confidence(jnp.asarray(lp[0]), jnp.asarray(mask)))
    return dict(feats=feats, lengths=lengths, median=float(np.median(conf)))


@pytest.mark.parametrize("threshold", ["zero", "never", "median"])
@pytest.mark.parametrize("item_mask", [False, True], ids=["all_rows", "item_mask"])
def test_gated_apply_matches_jax(weights, gate_bundle, threshold, item_mask):
    g = gate_bundle
    thr = {"zero": 0.0, "never": 1.01, "median": g["median"]}[threshold]
    im = np.array([1, 1, 0, 1, 0, 1], np.float32) if item_mask else None
    jcfg, model = _pair(weights)
    ref = jgate.gated_apply(*weights, jnp.asarray(g["feats"]), jnp.asarray(g["lengths"]),
                            jcfg, threshold=thr,
                            item_mask=None if im is None else jnp.asarray(im))
    lp, chosen, sub_len, n_run = gate.gated_apply(
        model, torch.from_numpy(g["feats"]), torch.from_numpy(g["lengths"]),
        threshold=thr, item_mask=None if im is None else torch.from_numpy(im))
    np.testing.assert_array_equal(chosen.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(sub_len.numpy(), np.asarray(ref[2]))
    assert int(n_run) == int(ref[3])
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref[0]), atol=1e-4, rtol=0)
    if threshold == "zero":
        assert int(n_run) == 1
    if threshold == "never":
        assert int(n_run) == 3
    if threshold == "median" and not item_mask:
        assert set(chosen.tolist()) > {1}, chosen      # some rows escalate
