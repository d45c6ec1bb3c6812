"""The port's CTC train step against the JAX package's, at tiny width.

JAX side: `trainer.make_train_step` with an optimizer that stores the
gradients as its state, so the loss, per-exit losses, grad norm, every
gradient leaf and the new BatchNorm state all come from the JAX
package's own loss function. Port side: `training.trainer.loss_fn`
under autograd, gradients laid out as the JAX tree by `interop.jax_tree`.
Dropout 0 and no SpecAugment, so neither side draws anything.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from early_exit_tpu.configs import ModelConfig as JModelConfig
from early_exit_tpu.configs import TrainConfig as JTrainConfig
from early_exit_tpu.models import early_conformer as jec
from early_exit_tpu.training import trainer as jtrainer
from early_exit_tpu_torch import interop
from early_exit_tpu_torch.configs import ModelConfig, TrainConfig
from early_exit_tpu_torch.optim.noam import global_norm
from early_exit_tpu_torch.training import trainer
from torch_one_thread import one_thread  # noqa: F401

TINY = dict(d_model=32, n_heads=4, d_feed_forward=64, n_enc_exits=2,
            n_enc_layers_per_exit=1, depthwise_kernel_size=7, vocab_size=16,
            n_mels=8, compute_dtype="float32", drop_prob=0.0)


def _grad_store():
    """An optax transformation whose state is the last gradient tree."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _batch(cfg, B=4, T=67, L=6, seed=0, item_mask=False):
    r = np.random.RandomState(seed)
    b = {"feats": r.randn(B, T, cfg["n_mels"]).astype(np.float32),
         "feat_lengths": np.array([T, T, T - 10, T - 20], np.int32),
         "labels": r.randint(3, cfg["vocab_size"], size=(B, L)).astype(np.int32),
         "label_lengths": np.array([L, L - 1, L - 2, 4], np.int32)}
    if item_mask:
        # the last row is bucket padding: no frames, no label, weight 0
        b["feat_lengths"][-1] = 0
        b["label_lengths"][-1] = 0
        b["item_mask"] = np.array([1, 1, 1, 0], np.float32)
    return b


def _jax_step(mkw, tkw, batch, seed=0):
    jcfg = JModelConfig(**mkw)
    params, state = jec.init(jax.random.PRNGKey(seed), jcfg)
    st = {"params": params, "model_state": state,
          "opt_state": _grad_store().init(params), "step": jnp.zeros((), jnp.int32)}
    step = jtrainer.make_train_step(jec, jcfg, JTrainConfig(**tkw), _grad_store())
    new, m = jax.jit(step)(st, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(1))
    return params, state, m, new["opt_state"], new["model_state"]


def _port(params, state, mkw, tkw, batch, attn_mask=None):
    model = interop.from_jax_params(params, state, ModelConfig(**mkw),
                                    trainable=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if attn_mask is None:
        total, per_exit, new_state = trainer.loss_fn(model, TrainConfig(**tkw), tb)
    else:        # a fixed mask: the model's own forward, the trainer's loss
        lp, sub_len, new_state = model.apply_train(tb["feats"], tb["feat_lengths"],
                                                   attn_mask=attn_mask)
        total, per_exit = trainer.ctc_multi_exit_loss(
            lp, sub_len, tb["labels"], tb["label_lengths"], blank=0,
            padded_lengths=False, item_mask=tb.get("item_mask"))
    params_t = list(model.parameters())
    grads = torch.autograd.grad(total, params_t)
    return model, total, per_exit, dict(zip(params_t, grads)), new_state


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# leaves whose gradient is 0 in exact arithmetic: the key bias (a softmax
# does not see a constant added to a query's scores) and the depthwise
# conv's bias (BatchNorm takes the batch mean out). Both sides hold float
# noise there, ~1e-8 of the global norm.
ZERO_GRAD = ("['blocks']['attn']['mha']['k']['b']", "['blocks']['conv']['dw']['b']")


def _check_leaves(jgrads, got, grad_norm, check):
    """Every leaf by `check(port, jax)`; the zero-gradient leaves below
    1e-6 of the global norm on both sides."""
    leaves_j, tree_j = jax.tree_util.tree_flatten_with_path(jax.device_get(jgrads))
    leaves_p, tree_p = jax.tree_util.tree_flatten(got)
    assert jax.tree_util.tree_structure(jax.device_get(jgrads)) == tree_p
    for (path, lj), lp in zip(leaves_j, leaves_p):
        assert lj.shape == lp.shape
        if jax.tree_util.keystr(path) in ZERO_GRAD:
            assert max(np.linalg.norm(lj), np.linalg.norm(lp)) <= 1e-6 * grad_norm
        else:
            assert check(lp, lj), jax.tree_util.keystr(path)


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))


CASES = {
    "float32": ({}, {}, {}),
    "padded_lengths": ({}, {"ctc_compat_padded_lengths": True}, {}),
    "item_mask": ({}, {}, {"item_mask": True}),
    "distill": ({}, {"distill": True}, {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_grads_and_bn_state_match_jax_float32(case):
    mover, tover, bover = CASES[case]
    mkw, tkw = {**TINY, **mover}, tover
    batch = _batch(TINY, **bover)
    params, state, m, jgrads, jstate = _jax_step(mkw, tkw, batch)
    model, total, per_exit, grads, new_state = _port(params, state, mkw, tkw, batch)
    np.testing.assert_allclose(float(total.detach()), float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(per_exit.detach().numpy(),
                               np.asarray(m["loss_per_exit"]), rtol=1e-5)
    np.testing.assert_allclose(float(global_norm(list(grads.values()))),
                               float(m["grad_norm"]), rtol=1e-5)
    _check_leaves(jgrads, interop.jax_tree(model, grads), float(m["grad_norm"]),
                  lambda p, j: _rel_l2(p, j) <= 1e-4)
    for k in ("mean", "var"):
        np.testing.assert_allclose(
            new_state["blocks"]["conv_bn"][k].numpy(),
            np.asarray(jstate["blocks"]["conv_bn"][k]), rtol=1e-5, atol=1e-6)


def test_loss_and_grads_match_jax_bfloat16():
    mkw = {**TINY, "compute_dtype": "bfloat16"}
    batch = _batch(TINY)
    params, state, m, jgrads, _ = _jax_step(mkw, {}, batch)
    model, total, _, grads, _ = _port(params, state, mkw, {}, batch)
    assert abs(float(total.detach()) - float(m["loss"])) <= 2e-2 * abs(float(m["loss"]))
    # bf16 noise in the zero-gradient leaves is larger than float32's
    leaves_j, _ = jax.tree_util.tree_flatten_with_path(jax.device_get(jgrads))
    for (path, lj), lp in zip(leaves_j, jax.tree_util.tree_leaves(
            interop.jax_tree(model, grads))):
        if jax.tree_util.keystr(path) not in ZERO_GRAD:
            assert _cos(lp, lj) >= 0.98, (jax.tree_util.keystr(path), _cos(lp, lj))


def test_fixed_chunk_attention_mask_matches_jax():
    """A fixed chunk mask through both forwards: the JAX package's
    early_conformer.apply(train=True, attn_mask=) and its CTC loss."""
    mkw, batch = dict(TINY), _batch(TINY)
    jcfg = JModelConfig(**mkw)
    params, state = jec.init(jax.random.PRNGKey(0), jcfg)
    t_sub = trainer.subsampled_frames(batch["feats"].shape[1])
    jmask = jtrainer.make_chunk_mask(t_sub, 5, 1)

    def jloss(p):
        lp, sub_len, _ = jec.apply(p, state, jnp.asarray(batch["feats"]),
                                   jnp.asarray(batch["feat_lengths"]), jcfg,
                                   rng=jax.random.PRNGKey(0), train=True,
                                   attn_mask=jmask)
        return jtrainer.ctc_multi_exit_loss(
            lp, sub_len, jnp.asarray(batch["labels"]),
            jnp.asarray(batch["label_lengths"]), blank=0, padded_lengths=False)[0]
    jl, jg = jax.value_and_grad(jloss)(params)
    mask = trainer.make_chunk_mask(t_sub, 5, 1)
    assert np.array_equal(mask.numpy(), np.asarray(jmask))
    model, total, _, grads, _ = _port(params, state, mkw, {}, batch, attn_mask=mask)
    full = _port(params, state, mkw, {}, batch)[1]
    assert abs(float(full.detach()) - float(total.detach())) > 1e-3        # the mask matters
    np.testing.assert_allclose(float(total.detach()), float(jl), rtol=1e-5)
    _check_leaves(jg, interop.jax_tree(model, grads), float(optax.global_norm(jg)),
                  lambda p, j: _rel_l2(p, j) <= 1e-4)


def test_remat_gives_equal_gradients_and_one_bn_update():
    """With dropout on, recomputed blocks must draw the same masks, and the
    running statistics must move once per step."""
    mkw = {**TINY, "drop_prob": 0.1}
    batch = {k: torch.from_numpy(v) for k, v in _batch(TINY).items()}
    out = {}
    for remat in (False, True):
        cfg = ModelConfig(**{**mkw, "remat": remat})
        from early_exit_tpu_torch.models.early_conformer import EarlyConformer
        model = EarlyConformer(cfg).init(torch.Generator().manual_seed(3))
        tr = trainer.Trainer(model, TrainConfig(), warmup=10)
        before = {k: v.clone() for k, v in model.state()["blocks"]["conv_bn"].items()}
        metrics = tr.step(batch)
        out[remat] = (metrics, [p.detach().clone() for p in model.parameters()],
                      model.state()["blocks"]["conv_bn"], before)
    (m0, p0, s0, b0), (m1, p1, s1, b1) = out[False], out[True]
    assert float(m0["loss"]) == float(m1["loss"])
    torch.testing.assert_close(m1["grad_norm"], m0["grad_norm"], rtol=1e-6, atol=0)
    for a, b in zip(p0, p1):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7)
    for k in ("mean", "var"):
        torch.testing.assert_close(s1[k], s0[k], rtol=0, atol=0)
        assert not torch.equal(s0[k], b0[k])


def test_attention_mask_takes_the_unfused_path():
    """With a pair mask the fused configuration runs the unfused blocks
    (the kernels take no mask), as the JAX package's dispatch does."""
    from early_exit_tpu_torch.models.early_conformer import EarlyConformer
    cfg = ModelConfig(**TINY)
    plain = EarlyConformer(cfg).init(torch.Generator().manual_seed(4)).requires_grad_(False)
    fused = EarlyConformer(dataclasses.replace(cfg, fused_block=True)).requires_grad_(False)
    fused.load_state_dict(plain.state_dict())
    b = {k: torch.from_numpy(v) for k, v in _batch(TINY).items()}
    x, _, mask = plain.frontend_embed(b["feats"], b["feat_lengths"])
    pm = trainer.make_chunk_mask(x.shape[1], 5, 1)
    want = plain.stack(x, mask, attn_mask=pm)
    assert torch.equal(fused.stack(x, mask, attn_mask=pm), want)
    assert not torch.equal(fused.stack(x, mask), want)
