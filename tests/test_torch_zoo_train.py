"""Training of the splitformer and the early_zipformer in the port against
the JAX package, at a small size on the CPU (d 32, 4 heads, ffn 64, k 7,
V 16; the splitformer 3 exits x 1 block, the zipformer 19 x 1).

For each family, from one seeded JAX init and one batch, dropout 0 and
no SpecAugment:
- the port's `trainer.loss_fn` under autograd against the JAX package's
  `make_train_step` (an optimizer that keeps the gradients as its state):
  the loss within 1e-5 relative, every gradient leaf within 1e-4 relative
  L2 (the two leaves whose gradient is 0 in exact arithmetic, the key
  bias and the depthwise bias, below 1e-6 of the global norm), the new
  BatchNorm statistics (the splitformer's branch blocks' among them)
  within 1e-5;
- --dynamic_chunk changes nothing for the zoo, as in the JAX package;
- checkpoints both ways: the JAX package's pair, one optimizer step from
  the init (optax's own update), resumes in the port, whose next step
  agrees with the JAX package's (the loss within 1e-5 relative, each
  parameter leaf within 1e-4 relative L2); the port's pair loads in the
  JAX package's `load_epoch` and `load_pytree` with its templates,
  values equal; `avg_models` of two port epochs equals the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from early_exit_tpu.configs import ModelConfig as JModelConfig
from early_exit_tpu.configs import TrainConfig as JTrainConfig
from early_exit_tpu.models import splitformer as jsf
from early_exit_tpu.models import zipformer as jzf
from early_exit_tpu.optim import make_optimizer
from early_exit_tpu.training import checkpoint as jck
from early_exit_tpu.training import trainer as jtrainer
from early_exit_tpu_torch import interop
from early_exit_tpu_torch.checkpoint import load_tree
from early_exit_tpu_torch.configs import ModelConfig, TrainConfig
from early_exit_tpu_torch.models.registry import build_model
from early_exit_tpu_torch.optim.noam import global_norm
from early_exit_tpu_torch.training import checkpoint as ck
from early_exit_tpu_torch.training import trainer
from torch_one_thread import one_thread  # noqa: F401

BASE = dict(d_model=32, n_heads=4, d_feed_forward=64, n_enc_layers_per_exit=1,
            depthwise_kernel_size=7, vocab_size=16, n_mels=8, compute_dtype="float32",
            drop_prob=0.0)
FAMILIES = {"splitformer": (jsf, dict(BASE, model_type="splitformer", n_enc_exits=3)),
            "early_zipformer": (jzf, dict(BASE, model_type="early_zipformer",
                                          n_enc_exits=19))}
WARMUP = 10
ZERO_GRAD = ("['attn']['mha']['k']['b']", "['conv']['dw']['b']")


def _batch():
    r = np.random.RandomState(0)
    return {"feats": r.randn(4, 67, 8).astype(np.float32),
            "feat_lengths": np.array([67, 67, 57, 47], np.int32),
            "labels": r.randint(3, 16, size=(4, 6)).astype(np.int32),
            "label_lengths": np.array([6, 5, 4, 4], np.int32)}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _grad_store():
    """An optax transformation whose state is the last gradient tree."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def fam(request):
    """The JAX side of one family: its init, the gradients, metrics and new
    state of one step there, and the state after one optax step (Noam-
    AdamW, as `train.py` builds it) and the gradients of the next."""
    mod, kw = FAMILIES[request.param]
    jcfg = JModelConfig(**kw)
    params, state = mod.init(jax.random.PRNGKey(3), jcfg)
    step = jax.jit(jtrainer.make_train_step(mod, jcfg, JTrainConfig(), _grad_store()))
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}

    def grads_at(p, s):
        st = {"params": p, "model_state": s, "opt_state": _grad_store().init(p),
              "step": jnp.zeros((), jnp.int32)}
        new, m = step(st, batch, jax.random.PRNGKey(1))
        return _host(m), _host(new["opt_state"]), _host(new["model_state"])

    opt = make_optimizer(kw["d_model"], WARMUP)

    @jax.jit
    def update(g, o, p):
        upd, o = opt.update(g, o, p)
        return optax.apply_updates(p, upd), o

    params, state = _host(params), _host(state)
    m0, g0, s1 = grads_at(params, state)
    p1, opt_state = update(g0, opt.init(params), params)
    p1 = _host(p1)
    m1, g1, _ = grads_at(p1, s1)
    p2, _ = update(g1, opt_state, p1)
    return dict(name=request.param, mod=mod, kw=kw, params=params, state=state,
                m0=m0, g0=g0, s1=s1, p1=p1, opt_state=opt_state, m1=m1, p2=_host(p2))


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_loss(f, tcfg=TrainConfig(), seed=None):
    model = interop.from_jax_params(f["params"], f["state"], ModelConfig(**f["kw"]),
                                    trainable=True)
    total, per_exit, new_state = trainer.loss_fn(model, tcfg, _tb(_batch()), seed=seed)
    plist = list(model.parameters())
    grads = torch.autograd.grad(total, plist)
    return model, total, per_exit, dict(zip(plist, grads)), new_state


def test_loss_grads_and_bn_state_match_jax(fam):
    f = fam
    model, total, per_exit, grads, new_state = _port_loss(f)
    np.testing.assert_allclose(float(total.detach()), float(f["m0"]["loss"]), rtol=1e-5)
    assert per_exit.shape == f["m0"]["loss_per_exit"].shape
    norm = float(f["m0"]["grad_norm"])
    np.testing.assert_allclose(float(global_norm(list(grads.values()))), norm, rtol=1e-5)
    want, got = _leaves(f["g0"]), _leaves(interop.jax_tree(model, grads))
    assert [k for k, _ in want] == [k for k, _ in got]
    for (key, j), (_, p) in zip(want, got):
        if key.endswith(ZERO_GRAD):
            assert max(np.linalg.norm(j), np.linalg.norm(p)) <= 1e-6 * norm, key
        else:
            assert np.linalg.norm(p - j) <= 1e-4 * np.linalg.norm(j), key
    want, got = _leaves(f["s1"]), _leaves(interop.numpy_tree(new_state))
    assert [k for k, _ in want] == [k for k, _ in got]
    if f["name"] == "splitformer":
        assert any("['parallel'][1]['conv_bn']['var']" in k for k, _ in got)
    for (key, j), (_, p) in zip(want, got):
        np.testing.assert_allclose(p, j, rtol=1e-5, atol=1e-6, err_msg=key)


def step_gap(name, batch, **over):
    """One float32 step of family `name` (its configuration here, `over`
    replacing fields) on `batch` (numpy: feats, feat_lengths, labels,
    label_lengths), the port's `trainer.loss_fn` under autograd against
    the JAX package's train step from the same seeded init: the loss's and
    the gradients' global norm's relative gaps and the worst gradient
    leaf's relative L2, with its key (the zero-gradient leaves aside).
    At the full width of `chip_smoke.py` phase 13a (d 256, 8 heads, ffn
    2048, k 31, its four requests from `bench_batch`) it tells whether
    the port departs from JAX there, with no card in the comparison."""
    mod, kw = FAMILIES[name]
    kw = dict(kw, **over)
    jcfg = JModelConfig(**kw)
    params, state = _host(mod.init(jax.random.PRNGKey(3), jcfg))
    step = jax.jit(jtrainer.make_train_step(mod, jcfg, JTrainConfig(), _grad_store()))
    st = {"params": params, "model_state": state, "opt_state": _grad_store().init(params),
          "step": jnp.zeros((), jnp.int32)}
    new, m = step(st, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1))
    want = _leaves(_host(new["opt_state"]))
    model = interop.from_jax_params(params, state, ModelConfig(**kw), trainable=True)
    total, _, _ = trainer.loss_fn(model, TrainConfig(), _tb(batch))
    plist = list(model.parameters())
    grads = torch.autograd.grad(total, plist)
    got = _leaves(interop.jax_tree(model, dict(zip(plist, grads))))
    rel = {k: float(np.linalg.norm(p - j) / np.linalg.norm(j))
           for (k, j), (_, p) in zip(want, got) if not k.endswith(ZERO_GRAD)}
    worst = max(rel, key=rel.get)
    norm = float(m["grad_norm"])
    return (abs(float(total.detach()) - float(m["loss"])) / abs(float(m["loss"])),
            abs(float(global_norm(list(grads))) - norm) / norm, rel[worst], worst)


def bench_batch(n=4, seed=1313):
    """`chip_smoke.py` phase 13a's batch: n requests of the flagship calib
    file's `bench_eval` distribution through the training pipeline on the
    CPU (FFT mel, BPE-256), as numpy."""
    from early_exit_tpu_torch import checkpoint
    from early_exit_tpu_torch.configs import AudioConfig
    from early_exit_tpu_torch.data import text
    from early_exit_tpu_torch.data.pipeline import Pipeline
    from early_exit_tpu_torch.data.synthetic import synth_batch
    from early_exit_tpu_torch.tokenizer import load_tokenizer
    calib = checkpoint.load_calib()
    tok = load_tokenizer(checkpoint.bound_tokenizer(calib))
    pipe = Pipeline([], tok, AudioConfig(), TrainConfig(), device="cpu")
    wav, counts, refs = synth_batch(calib.get("bench_eval", {}), n, seed)
    items = [(wav[i, :counts[i]], text.encode_target(text.clean_train_label(refs[i]), tok),
              text.clean_train_label(refs[i])) for i in range(n)]
    host = {k: torch.from_numpy(v) for k, v in pipe.host_subbatch(items).items()}
    batch = pipe.to_device(host)
    return {k: batch[k].numpy() for k in ("feats", "feat_lengths", "labels", "label_lengths")}


def test_step_gap_of_the_zipformer():
    """`step_gap` at this file's size: the gaps the fixture's test holds."""
    d_loss, d_norm, leaf, key = step_gap("early_zipformer", _batch())
    assert d_loss <= 1e-5 and d_norm <= 1e-5 and leaf <= 1e-4, (d_loss, d_norm, leaf, key)


def test_dynamic_chunk_is_ignored_for_the_zoo(fam):
    """JAX samples chunk masks for the early_conformer only: with
    --dynamic_chunk the zoo's loss is the one of full attention."""
    on = _port_loss(fam, TrainConfig(dynamic_chunk=True), seed=7)[1].detach()
    off = _port_loss(fam, TrainConfig(), seed=7)[1].detach()
    assert float(on) == float(off)
    np.testing.assert_allclose(float(on), float(fam["m0"]["loss"]), rtol=1e-5)


def test_jax_pair_resumes_in_the_port(fam, tmp_path):
    f = fam
    jck.save_epoch(str(tmp_path), 0, f["p1"], f["s1"], f["opt_state"],
                   jnp.ones((), jnp.int32))
    model = build_model(ModelConfig(**f["kw"]))
    tr = trainer.Trainer(model, TrainConfig(), warmup=WARMUP)
    ck.load_model_file(model, ck.model_ckpt_path(str(tmp_path), 0))
    ck.load_opt_tree(model, tr.opt, load_tree(ck.opt_ckpt_path(str(tmp_path), 0)))
    assert tr.step_count == 1
    for a, b in ((interop.to_jax_params(model)[0], f["p1"]),
                 (interop.to_jax_params(model)[1], f["s1"])):
        for (key, x), (_, y) in zip(_leaves(a), _leaves(b)):
            np.testing.assert_array_equal(x, y, err_msg=key)
    got = tr.step(_tb(_batch()))
    np.testing.assert_allclose(float(got["loss"]), float(f["m1"]["loss"]), rtol=1e-5)
    # Adam divides each gradient element by its own running scale, so the
    # gradients' 1e-5 of float noise reaches the update of a leaf whose
    # gradient is small (a bias, zero at init) at up to 1e-4 of its norm
    for (key, have), (_, want) in zip(_leaves(interop.to_jax_params(model)[0]),
                                      _leaves(f["p2"])):
        if key.endswith(ZERO_GRAD):
            continue        # float-noise gradients, normalised by Adam
        assert np.linalg.norm(have - want) <= 1e-4 * np.linalg.norm(want), key


def test_port_pair_loads_in_the_jax_package_and_averages(fam, tmp_path):
    f = fam
    d = str(tmp_path)
    model = interop.from_jax_params(f["params"], f["state"], ModelConfig(**f["kw"]),
                                    trainable=True)
    tr = trainer.Trainer(model, TrainConfig(), warmup=WARMUP)
    snapshots = []
    for epoch in range(2):
        tr.step(_tb(_batch()))
        ck.save_epoch(d, epoch, model, tr.opt)
        snapshots.append(interop.to_jax_params(model))
    ptmpl, stmpl = f["mod"].init(jax.random.PRNGKey(0), JModelConfig(**f["kw"]))
    params, state = jck.load_epoch(d, 1, ptmpl, stmpl)
    for a, b in ((params, snapshots[1][0]), (state, snapshots[1][1])):
        assert jax.tree_util.tree_structure(_host(a)) == jax.tree_util.tree_structure(b)
        for (key, x), (_, y) in zip(_leaves(_host(a)), _leaves(b)):
            np.testing.assert_array_equal(x, y, err_msg=key)
    opt = make_optimizer(f["kw"]["d_model"], WARMUP)
    otree = jck.load_pytree({"opt_state": opt.init(ptmpl), "step": jnp.zeros((), jnp.int32)},
                            ck.opt_ckpt_path(d, 1))
    assert int(otree["step"]) == 2
    plist = list(model.parameters())
    for mine, theirs in ((tr.opt.mu, otree["opt_state"][1][0].mu),
                         (tr.opt.nu, otree["opt_state"][1][0].nu)):
        for (key, x), (_, y) in zip(_leaves(interop.jax_tree(model, dict(zip(plist, mine)))),
                                    _leaves(_host(theirs))):
            np.testing.assert_array_equal(x, y, err_msg=key)
    # the average of the two epochs, in each package
    jp, js = jck.avg_models(d, 0, 1, ptmpl, stmpl)
    ck.avg_models(model, d, 0, 1)
    for a, b in ((jp, interop.to_jax_params(model)[0]), (js, interop.to_jax_params(model)[1])):
        for (key, x), (_, y) in zip(_leaves(_host(a)), _leaves(b)):
            np.testing.assert_array_equal(x, y, err_msg=key)
