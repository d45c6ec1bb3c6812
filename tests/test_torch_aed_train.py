"""AED training in the port against the JAX package, on the CPU at a small
size (d 32, 4 heads, 2 exits x 1 block, 2 decoder layers, V 40).

JAX side: `trainer.make_train_step(full_conformer, ...)` with an
optimizer that stores the gradients as its state, so the joint loss, the
per-exit CTC losses, the grad norm and every gradient leaf come from the
JAX package's own loss function. Port side: `training.trainer.loss_fn`
under autograd, gradients laid out as the JAX tree by `interop.jax_tree`.
Dropout 0 and no SpecAugment; one case with an `item_mask` row of 0.
Also: the loss falls over a few `Trainer` steps (with dropout), a
`full_conformer` checkpoint written by each package reads back equal in
the other, and `avg_models` of two such files equals the JAX package's.

Tolerances: loss, per-exit losses and grad norm rtol 1e-5; each leaf's
relative L2 1e-4 (the zero-gradient leaves below 1e-6 of the norm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from early_exit_tpu.configs import ModelConfig as JModelConfig
from early_exit_tpu.configs import TrainConfig as JTrainConfig
from early_exit_tpu.models import full_conformer as jfc
from early_exit_tpu.training import checkpoint as jck
from early_exit_tpu.training import trainer as jtrainer
from early_exit_tpu_torch import interop
from early_exit_tpu_torch.configs import ModelConfig, TrainConfig
from early_exit_tpu_torch.models.full_conformer import FullConformer
from early_exit_tpu_torch.optim.noam import global_norm
from early_exit_tpu_torch.training import checkpoint as ck
from early_exit_tpu_torch.training import trainer

from test_torch_train_step import ZERO_GRAD, _grad_store, _rel_l2
from torch_one_thread import one_thread  # noqa: F401

KW = dict(model_type="full_conformer", d_model=32, n_heads=4, d_feed_forward=64,
          n_enc_exits=2, n_enc_layers_per_exit=1, n_dec_layers=2,
          depthwise_kernel_size=7, vocab_size=40, n_mels=8, compute_dtype="float32",
          drop_prob=0.0, pad_id=36, bos_id=1, eos_id=2)
TKW = dict(decoder_mode="aed", aed_ce_weight=0.7, aed_ctc_weight=0.3)
# with the trunk's, the decoders' key biases: a softmax does not see a
# constant added to all of a query's scores
ZERO = ZERO_GRAD + tuple(f"['decoders']['{a}']['k']['b']"
                         for a in ("self_attn", "cross_attn"))


def _batch(B=4, T=67, L=9, seed=0, item_mask=False):
    r = np.random.RandomState(seed)
    labels = np.full((B, L), KW["pad_id"], np.int32)
    lens = np.array([L, L - 1, L - 3, 5], np.int32)
    labels[:, 0] = KW["bos_id"]
    for b in range(B):
        labels[b, 1:lens[b] - 1] = r.randint(3, 30, size=lens[b] - 2)
        labels[b, lens[b] - 1] = KW["eos_id"]
    b = {"feats": r.randn(B, T, KW["n_mels"]).astype(np.float32),
         "feat_lengths": np.array([T, T, T - 10, T - 20], np.int32),
         "labels": labels, "label_lengths": lens}
    if item_mask:
        b["feat_lengths"][-1] = 0
        b["label_lengths"][-1] = 0
        b["item_mask"] = np.array([1, 1, 1, 0], np.float32)
    return b


def _jax_step(batch, seed=0):
    jcfg = JModelConfig(**KW)
    params, state = jfc.init(jax.random.PRNGKey(seed), jcfg)
    st = {"params": params, "model_state": state,
          "opt_state": _grad_store().init(params), "step": jnp.zeros((), jnp.int32)}
    step = jtrainer.make_train_step(jfc, jcfg, JTrainConfig(**TKW), _grad_store())
    new, m = jax.jit(step)(st, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(1))
    return params, state, m, new["opt_state"]


@pytest.mark.parametrize("item_mask", [False, True])
def test_aed_loss_and_grads_match_jax(item_mask):
    batch = _batch(item_mask=item_mask)
    params, state, m, jgrads = _jax_step(batch)
    model = interop.from_jax_params(params, state, ModelConfig(**KW), trainable=True)
    assert isinstance(model, FullConformer)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, per_exit, _ = trainer.loss_fn(model, TrainConfig(**TKW), tb)
    ps = list(model.parameters())
    grads = dict(zip(ps, torch.autograd.grad(total, ps)))
    np.testing.assert_allclose(float(total.detach()), float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(per_exit.detach().numpy(), np.asarray(m["loss_per_exit"]),
                               rtol=1e-5)
    norm = float(m["grad_norm"])
    np.testing.assert_allclose(float(global_norm(list(grads.values()))), norm, rtol=1e-5)
    leaves_j = jax.tree_util.tree_flatten_with_path(jax.device_get(jgrads))[0]
    leaves_p, tree_p = jax.tree_util.tree_flatten(interop.jax_tree(model, grads))
    assert jax.tree_util.tree_structure(jax.device_get(jgrads)) == tree_p
    for (path, lj), lp in zip(leaves_j, leaves_p):
        key = jax.tree_util.keystr(path)
        assert lj.shape == lp.shape, key
        if key in ZERO:
            assert max(np.linalg.norm(lj), np.linalg.norm(lp)) <= 1e-6 * norm, key
        else:
            assert _rel_l2(lp, lj) <= 1e-4, key
    # the decoders carry gradient (the CE reaches them)
    dec = interop.jax_tree(model, grads)["decoders"]
    assert np.linalg.norm(dec["w1"]["w"]) > 1e-3 * norm


def test_aed_loss_falls():
    cfg = ModelConfig(**{**KW, "drop_prob": 0.1})
    model = FullConformer(cfg).init(torch.Generator().manual_seed(0))
    tr = trainer.Trainer(model, TrainConfig(**TKW), warmup=3)
    tb = {k: torch.from_numpy(v) for k, v in _batch().items()}
    losses = [float(tr.step(tb)["loss"]) for _ in range(8)]
    assert np.isfinite(losses).all() and losses[-1] < 0.8 * losses[0], losses


def test_checkpoints_both_ways_and_avg_models(tmp_path):
    d = str(tmp_path)
    jcfg = JModelConfig(**KW)
    p0, s0 = jfc.init(jax.random.PRNGKey(2), jcfg)
    jck.save_epoch(d, 0, p0, s0)                        # the JAX package writes
    model = FullConformer(ModelConfig(**KW))
    ck.load_model_file(model, ck.model_ckpt_path(d, 0))  # the port reads
    got, _ = interop.to_jax_params(model)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(p0)):
        np.testing.assert_array_equal(a, np.asarray(b))
    with torch.no_grad():                               # the port writes epoch 1
        for prm in model.parameters():
            prm.mul_(1.5)
    ck.save_epoch(d, 1, model)
    p1, _ = jck.load_epoch(d, 1, p0, s0)                # the JAX package reads
    for a, b in zip(jax.tree_util.tree_leaves(interop.to_jax_params(model)[0]),
                    jax.tree_util.tree_leaves(jax.device_get(p1))):
        np.testing.assert_array_equal(a, b)
    avg = FullConformer(ModelConfig(**KW))
    ck.avg_models(avg, d, 0, 1)
    jp, _ = jck.avg_models(d, 0, 1, p0, s0)
    for a, b in zip(jax.tree_util.tree_leaves(interop.to_jax_params(avg)[0]),
                    jax.tree_util.tree_leaves(jax.device_get(jp))):
        np.testing.assert_array_equal(a, b)
