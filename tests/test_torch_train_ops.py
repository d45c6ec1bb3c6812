"""The port's training ops against the JAX package's, on the CPU at small
sizes: CTC loss (with infeasible rows, label length 0 and input length 0,
also held against the port's own recursion) and its
gradients, the per-exit and
distillation losses, chunk masks, SpecAugment fed JAX's uniforms, the
Noam schedule and the clipped AdamW against optax, dropout's keep rate
and scale, the initialisers' shapes and limits, BatchNorm in training
mode, the attention pair mask and the depthwise conv's gradients
against the JAX package's hand-written VJP.

Tolerances: float32 values rtol 1e-5 (absolute floor 1e-5 x max|ref|);
the optimizer's parameters 1e-6 relative after each step.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from early_exit_tpu.models import early_conformer as jec
from early_exit_tpu.configs import ModelConfig as JModelConfig
from early_exit_tpu.nn import core as jcore
from early_exit_tpu.ops import ctc as jctc
from early_exit_tpu.ops import specaugment as jsa
from early_exit_tpu.optim import make_optimizer, noam_schedule as jnoam
from early_exit_tpu.training import trainer as jtrainer
from early_exit_tpu_torch import interop
from early_exit_tpu_torch.configs import ModelConfig
from early_exit_tpu_torch.models.early_conformer import EarlyConformer
from early_exit_tpu_torch.nn import core
from early_exit_tpu_torch.ops import ctc, specaugment
from early_exit_tpu_torch.optim.noam import NoamAdamW, noam_schedule
from early_exit_tpu_torch.training import trainer
from torch_one_thread import one_thread  # noqa: F401


def _close(got, ref, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1.0))


def _ctc_case(seed=0):
    r = np.random.RandomState(seed)
    B, T, V, L = 7, 12, 7, 5
    logits = r.randn(B, T, V).astype(np.float32)
    labels = r.randint(1, V, size=(B, L)).astype(np.int32)
    labels[2, :3] = 3                       # repeats need blanks between them
    # full, label length 0, infeasible (3 repeats in 3 frames), input length
    # 0 with a label 0, ragged, infeasible (5 labels in 1 frame), input 0
    # with a label
    il = np.array([12, 12, 3, 0, 7, 1, 0], np.int32)
    ll = np.array([5, 0, 3, 0, 5, 5, 2], np.int32)
    return logits, labels, il, ll


@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_neg_log_likelihood_and_loss_match_jax(seed):
    """The port's recursion (`ops/ctc.py::ctc_neg_log_likelihood`) against
    JAX's, and the port's `ctc_loss` (F.ctc_loss) against both: infeasible rows read ~1e30 in the
    recursions and 0 in the loss."""
    logits, labels, il, ll = _ctc_case(seed)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), -1))
    j = [jnp.asarray(a) for a in (lp, il, labels, ll)]
    t = [torch.from_numpy(a) for a in (lp, il, labels, ll)]
    nll_j = np.asarray(jctc.ctc_neg_log_likelihood(*j))
    nll_r = ctc.ctc_neg_log_likelihood(*t).numpy()
    assert (nll_j[[2, 5]] > 1e29).all() and (nll_r[[2, 5]] > 1e29).all()
    ok = nll_j < 1e29
    _close(nll_r[ok], nll_j[ok])
    _close(ctc.ctc_loss(*t, reduction="none"), np.where(ok, nll_r, 0.0))
    for red in ("none", "mean", "sum"):
        _close(ctc.ctc_loss(*t, reduction=red), jctc.ctc_loss(*j, reduction=red))


@pytest.mark.parametrize("reduction", ["none", "mean"])
def test_ctc_loss_gradient_matches_jax(reduction):
    """Through log_softmax: torch's CTC backward assumes log-softmax
    inputs, so the gradient is held with respect to the logits."""
    logits, labels, il, ll = _ctc_case()
    w = np.linspace(0.5, 1.5, len(il)).astype(np.float32)
    if reduction == "mean":
        w = np.float32(1.0)

    def jloss(x):
        lp = jax.nn.log_softmax(x, -1)
        return jnp.sum(jctc.ctc_loss(lp, jnp.asarray(il), jnp.asarray(labels),
                                     jnp.asarray(ll), reduction=reduction) * w)
    g_j = jax.grad(jloss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    loss = (ctc.ctc_loss(torch.log_softmax(x, -1), torch.from_numpy(il),
                         torch.from_numpy(labels), torch.from_numpy(ll),
                         reduction=reduction) * torch.from_numpy(np.asarray(w))).sum()
    (g_t,) = torch.autograd.grad(loss, x)
    _close(g_t, g_j)
    assert float(g_t[[2, 5]].abs().max()) == 0.0        # infeasible rows: zeroed


@pytest.mark.parametrize("padded,masked", [(False, False), (True, False), (False, True)])
def test_multi_exit_and_distill_losses_match_jax(padded, masked):
    r = np.random.RandomState(2)
    E, B, T, V, L = 3, 4, 20, 9, 4
    lp = np.array(jax.nn.log_softmax(jnp.asarray(r.randn(E, B, T, V).astype(np.float32)), -1))
    sub = np.array([20, 14, 9, 0], np.int32)
    labels = r.randint(1, V, size=(B, L)).astype(np.int32)
    ll = np.array([4, 3, 2, 0], np.int32)
    mask = np.array([1, 1, 1, 0], np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    tot_j, per_j = jtrainer.ctc_multi_exit_loss(
        jnp.asarray(lp), jnp.asarray(sub), jnp.asarray(labels), jnp.asarray(ll),
        blank=0, padded_lengths=padded, item_mask=jm)
    tot_t, per_t = trainer.ctc_multi_exit_loss(
        torch.from_numpy(lp), torch.from_numpy(sub), torch.from_numpy(labels),
        torch.from_numpy(ll), blank=0, padded_lengths=padded, item_mask=tm)
    _close(tot_t, tot_j)
    _close(per_t, per_j)
    _close(trainer.distill_loss(torch.from_numpy(lp), torch.from_numpy(sub),
                                temperature=2.0, item_mask=tm),
           jtrainer.distill_loss(jnp.asarray(lp), jnp.asarray(sub),
                                 temperature=2.0, item_mask=jm))


@pytest.mark.parametrize("t,c,left", [(67, 12, 1000), (40, 5, 1), (9, 25, 0)])
def test_chunk_mask_exact(t, c, left):
    assert np.array_equal(trainer.make_chunk_mask(t, c, left).numpy(),
                          np.asarray(jtrainer.make_chunk_mask(t, c, left)))


def test_subsampled_frames_and_attn_mask_sampling():
    for t in (7, 67, 1001):
        assert trainer.subsampled_frames(t) == ((t - 3) // 2 + 1 - 3) // 2 + 1
    host = torch.Generator().manual_seed(0)
    masks = [trainer.sample_attn_mask(50, host, 1000) for _ in range(400)]
    full = sum(m is None for m in masks)
    assert 150 < full < 250                     # ~50% full attention
    sizes = {int(m[0].sum()) for m in masks if m is not None}
    assert sizes == {min(c, 50) for c in trainer.CHUNK_SIZES}


def test_specaugment_with_injected_uniforms_matches_jax():
    r = np.random.RandomState(3)
    B, T, F = 5, 120, 80
    feats = r.randn(B, T, F).astype(np.float32) + 3.0
    lengths = np.array([120, 100, 57, 8, 0], np.int32)
    key = jax.random.PRNGKey(11)
    kw = dict(n_freq_masks=2, freq_mask_width=27, n_time_masks=3, time_mask_frac=0.2)
    ref = np.asarray(jsa.apply(key, jnp.asarray(feats), jnp.asarray(lengths), **kw))
    # the uniforms jsa.apply draws
    r_fw, r_fs, r_tw, r_ts = jax.random.split(key, 4)
    u = [torch.from_numpy(np.array(jax.random.uniform(k, (B, n))))
         for k, n in ((r_fw, 2), (r_fs, 2), (r_tw, 3), (r_ts, 3))]
    got = specaugment.apply_uniforms(torch.from_numpy(feats), torch.from_numpy(lengths),
                                     *u, freq_mask_width=27, time_mask_frac=0.2)
    assert np.array_equal(got.numpy(), ref)
    assert (ref == 0).any()
    # and with the port's own draws: same shape, masks inside valid frames
    out = specaugment.apply(torch.Generator().manual_seed(0), torch.from_numpy(feats),
                            torch.from_numpy(lengths), **kw)
    assert out.shape == feats.shape and (out.numpy() == 0).any()


def test_noam_schedule_matches_jax_and_formula():
    sched, jsched = noam_schedule(256, 4000), jnoam(256, 4000)
    for step in (1, 100, 4000, 20000):
        expect = 256 ** -0.5 * min(step ** -0.5, step * 4000 ** -1.5)
        np.testing.assert_allclose(sched(step - 1), expect, rtol=1e-12)
        np.testing.assert_allclose(sched(step - 1), float(jsched(step - 1)), rtol=1e-6)


def test_optimizer_matches_optax_over_five_steps():
    """Five gradient trees, the third above the clip; parameters after
    each step within 1e-6 relative of optax's."""
    r = np.random.RandomState(4)
    shapes = [(6, 5), (5,), (3, 4, 2)]
    params = [r.randn(*s).astype(np.float32) for s in shapes]
    opt_j = make_optimizer(64, 3, clip=1.0, adam_eps=1e-9, weight_decay=5e-4)
    pj = [jnp.asarray(p) for p in params]
    st = opt_j.init(pj)
    pt = [torch.from_numpy(p.copy()) for p in params]
    opt_t = NoamAdamW(pt, 64, 3, clip=1.0, adam_eps=1e-9, weight_decay=5e-4)
    for k in range(5):
        scale = 3.0 if k == 2 else 0.05
        g = [(r.randn(*s) * scale).astype(np.float32) for s in shapes]
        norm = math.sqrt(sum(float((x.astype(np.float64) ** 2).sum()) for x in g))
        assert (norm > 1.0) == (k == 2)
        upd, st = opt_j.update([jnp.asarray(x) for x in g], st, pj)
        pj = optax.apply_updates(pj, upd)
        got_norm = opt_t.step([torch.from_numpy(x) for x in g])
        np.testing.assert_allclose(float(got_norm), norm, rtol=1e-6)
        for a, b in zip(pt, pj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6 * float(np.abs(np.asarray(b)).max()))
    assert opt_t.count == 5


def test_dropout_keep_rate_and_scale():
    x = torch.full((400, 500), 2.0, dtype=torch.bfloat16)
    y = core.dropout(x, 0.1, torch.Generator().manual_seed(0))
    assert y.dtype == torch.bfloat16
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.9) < 0.005
    assert torch.equal(y[kept], (x / 0.9)[kept])
    assert core.dropout(x, 0.1, None) is x and core.dropout(x, 0.0, torch.Generator()) is x


def test_init_shapes_and_xavier_limits():
    kw = dict(d_model=32, n_heads=4, d_feed_forward=64, n_enc_exits=2,
              n_enc_layers_per_exit=2, depthwise_kernel_size=7, vocab_size=16, n_mels=8)
    model = EarlyConformer(ModelConfig(**kw)).init(torch.Generator().manual_seed(0))
    params, state = interop.to_jax_params(model)
    jp, js = jec.init(jax.random.PRNGKey(0), JModelConfig(**kw))
    shapes = lambda t: jax.tree_util.tree_map(lambda a: np.shape(a), t)
    assert shapes(params) == shapes(jax.device_get(jp))
    assert shapes(state) == shapes(jax.device_get(js))
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    for path, leaf in flat:
        name = jax.tree_util.keystr(path)
        if name.endswith("['b']"):             # every bias and norm shift
            assert not leaf.any(), name
            continue
        if name.endswith("['g']"):
            assert (leaf == 1).all(), name
            continue
        w = leaf[0] if name.startswith("['blocks']") or name.startswith("['heads']") else leaf
        if "['dw']" in name:
            fan_in = fan_out = w.shape[0]
        elif "convs" in name:
            fan_in, fan_out = w.shape[0] * w.shape[1], w.shape[0] * w.shape[2]
        else:
            fan_in, fan_out = w.shape[-2], w.shape[-1]
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        assert np.abs(leaf).max() <= limit and np.abs(leaf).max() > 0.8 * limit, name
        assert abs(float(leaf.std()) - limit / math.sqrt(3)) < 0.15 * limit, name
    np.testing.assert_array_equal(state["blocks"]["conv_bn"]["mean"], 0)
    np.testing.assert_array_equal(state["blocks"]["conv_bn"]["var"], 1)


@pytest.mark.parametrize("with_mask", [True, False])
def test_masked_batch_norm_train_matches_jax(with_mask):
    r = np.random.RandomState(5)
    x = (r.randn(3, 11, 6) * 2 + 1).astype(np.float32)
    g, b = r.randn(6).astype(np.float32), r.randn(6).astype(np.float32)
    mean, var = r.randn(6).astype(np.float32), r.rand(6).astype(np.float32) + 0.5
    mask = np.arange(11)[None, :] < np.array([11, 6, 1])[:, None]
    y_j, st_j = jcore.masked_batch_norm({"g": jnp.asarray(g), "b": jnp.asarray(b)},
                                        {"mean": jnp.asarray(mean), "var": jnp.asarray(var)},
                                        jnp.asarray(x), jnp.asarray(mask) if with_mask else None,
                                        train=True)
    t = [torch.from_numpy(a) for a in (x, g, b, mean, var)]
    y_t, m_t, v_t = core.masked_batch_norm_train(
        *t, torch.from_numpy(mask) if with_mask else None)
    _close(y_t, y_j)
    _close(m_t, st_j["mean"])
    _close(v_t, st_j["var"])


def test_mha_pair_mask_matches_jax():
    r = np.random.RandomState(6)
    B, T, D, H = 2, 13, 16, 4
    x = r.randn(B, T, D).astype(np.float32)
    jp = {n: {"w": jnp.asarray(r.randn(D, D).astype(np.float32) * 0.3),
              "b": jnp.asarray(r.randn(D).astype(np.float32))} for n in "qkvo"}
    key_mask = np.arange(T)[None, :] < np.array([13, 9])[:, None]
    pm = np.array(jtrainer.make_chunk_mask(T, 4, 1))
    ref = jcore.mha(jp, jnp.asarray(x), jnp.asarray(x), H, key_mask=jnp.asarray(key_mask),
                    pair_mask=jnp.asarray(pm))
    p = {n: (torch.from_numpy(np.array(jp[n]["w"])), torch.from_numpy(np.array(jp[n]["b"])))
         for n in "qkvo"}
    got = core.mha(p, torch.from_numpy(x), torch.from_numpy(x), H,
                   key_mask=torch.from_numpy(key_mask), pair_mask=torch.from_numpy(pm))
    _close(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_depthwise_conv_gradients_match_the_jax_vjp(dtype):
    """dx and dw of the port's autograd through F.conv1d against JAX's
    hand-written `_dwconv_bwd`."""
    r = np.random.RandomState(7)
    B, T, C, k = 2, 19, 8, 7
    x = r.randn(B, T, C).astype(np.float32)
    w = (r.randn(k, 1, C) * 0.3).astype(np.float32)
    g = r.randn(B, T, C).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    _, vjp = jax.vjp(lambda a, b: jcore.depthwise_conv1d({"w": b}, a, compute_dtype=jd),
                     jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = core.depthwise_conv1d(xt, wt, compute_dtype=td)
    dx_t, dw_t = torch.autograd.grad(y, (xt, wt), torch.from_numpy(g))
    rtol = 1e-5 if dtype == "float32" else 2 ** -7
    _close(dx_t, np.asarray(dx_j, np.float32), rtol)
    _close(dw_t, np.asarray(dw_j, np.float32), rtol)
