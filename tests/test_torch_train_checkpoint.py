"""Checkpoints both ways between the port and the JAX package, the epoch
helpers, the training CLI, and two repairs that training needs on the
serving side: the kernel layout cache follows weight updates, and every
serving entry runs without autograd.

- A pair written by the port (`training.checkpoint.save_epoch`) loads in
  `early_exit_tpu.training.checkpoint.load_pytree` with the JAX
  package's templates, values equal; a pair written by the JAX package
  loads in the port, and one more step from it agrees with the JAX
  package's step.
- `avg_models`, `prune_old`, `saved_epochs` and the resume rule.
- `python -m early_exit_tpu_torch.train` (in process): two tiny epochs on
  the CPU write mod000/lr000 and mod001/lr001, a second run resumes.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from early_exit_tpu.configs import ModelConfig as JModelConfig
from early_exit_tpu.configs import TrainConfig as JTrainConfig
from early_exit_tpu.models import early_conformer as jec
from early_exit_tpu.optim import make_optimizer
from early_exit_tpu.training import checkpoint as jck
from early_exit_tpu.training import trainer as jtrainer
from early_exit_tpu_torch import interop, train as port_train
from early_exit_tpu_torch.checkpoint import load_tree, save_tree
from early_exit_tpu_torch.configs import ModelConfig, TrainConfig
from early_exit_tpu_torch.models import conformer
from early_exit_tpu_torch.models.early_conformer import EarlyConformer
from early_exit_tpu_torch.serving.recognizer import Recognizer
from early_exit_tpu_torch.tokenizer import load_decoder
from early_exit_tpu_torch.training import checkpoint as ck
from early_exit_tpu_torch.training.trainer import Trainer
from torch_one_thread import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(d_model=32, n_heads=4, d_feed_forward=64, n_enc_exits=2,
            n_enc_layers_per_exit=1, depthwise_kernel_size=7, vocab_size=16,
            n_mels=8, compute_dtype="float32", drop_prob=0.0)
ZERO_GRAD = ("['blocks']['attn']['mha']['k']['b']", "['blocks']['conv']['dw']['b']")


def _batch(seed=0):
    r = np.random.RandomState(seed)
    return {"feats": r.randn(4, 67, 8).astype(np.float32),
            "feat_lengths": np.array([67, 67, 57, 47], np.int32),
            "labels": r.randint(3, 16, size=(4, 6)).astype(np.int32),
            "label_lengths": np.array([6, 5, 4, 4], np.int32)}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _templates(warmup=10):
    p, s = jec.init(jax.random.PRNGKey(9), JModelConfig(**TINY))
    opt = make_optimizer(TINY["d_model"], warmup)
    return p, s, opt, {"opt_state": opt.init(p), "step": jnp.zeros((), jnp.int32)}


def _assert_tree_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(jax.device_get(a))
    lb, tb = jax.tree_util.tree_flatten(jax.device_get(b))
    assert ta == tb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_port_pair_loads_in_the_jax_package(tmp_path):
    model = EarlyConformer(ModelConfig(**TINY)).init(torch.Generator().manual_seed(0))
    tr = Trainer(model, TrainConfig(), warmup=10)
    for _ in range(2):
        tr.step(_tb(_batch()))
    ck.save_epoch(str(tmp_path), 0, model, tr.opt)
    p, s, opt, otmpl = _templates()
    params, state = jck.load_epoch(str(tmp_path), 0, p, s)
    want_p, want_s = interop.to_jax_params(model)
    _assert_tree_equal(params, want_p)
    _assert_tree_equal(state, want_s)
    tree = jck.load_pytree(otmpl, ck.opt_ckpt_path(str(tmp_path), 0))
    assert int(tree["step"]) == 2
    adam, sched = tree["opt_state"][1][0], tree["opt_state"][1][2]
    assert int(adam.count) == int(sched.count) == 2
    plist = list(model.parameters())
    _assert_tree_equal(adam.mu, interop.jax_tree(model, dict(zip(plist, tr.opt.mu))))
    _assert_tree_equal(adam.nu, interop.jax_tree(model, dict(zip(plist, tr.opt.nu))))


def test_jax_pair_resumes_in_the_port(tmp_path):
    p, s, opt, _ = _templates()
    jcfg, tcfg = JModelConfig(**TINY), JTrainConfig()
    st = {"params": p, "model_state": s, "opt_state": opt.init(p),
          "step": jnp.zeros((), jnp.int32)}
    step = jax.jit(jtrainer.make_train_step(jec, jcfg, tcfg, opt))
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    for _ in range(2):
        st, _ = step(st, jb, jax.random.PRNGKey(1))
    jck.save_epoch(str(tmp_path), 4, st["params"], st["model_state"],
                   st["opt_state"], st["step"])
    model = EarlyConformer(ModelConfig(**TINY))
    tr = Trainer(model, TrainConfig(), warmup=10)
    ck.load_model_file(model, ck.model_ckpt_path(str(tmp_path), 4))
    ck.load_opt_tree(model, tr.opt, load_tree(ck.opt_ckpt_path(str(tmp_path), 4)))
    assert tr.step_count == 2
    _assert_tree_equal(interop.to_jax_params(model)[0], st["params"])
    _assert_tree_equal(interop.to_jax_params(model)[1], st["model_state"])
    plist = list(model.parameters())
    _assert_tree_equal(interop.jax_tree(model, dict(zip(plist, tr.opt.mu))),
                       st["opt_state"][1][0].mu)
    # one more step on each side from the same state
    st, m = step(st, jb, jax.random.PRNGKey(1))
    got = tr.step(_tb(_batch()))
    np.testing.assert_allclose(float(got["loss"]), float(m["loss"]), rtol=1e-5)
    flat_j, _ = jax.tree_util.tree_flatten_with_path(jax.device_get(st["params"]))
    for (path, want), have in zip(flat_j, jax.tree_util.tree_leaves(
            interop.to_jax_params(model)[0])):
        if jax.tree_util.keystr(path) in ZERO_GRAD:
            continue        # float noise gradients, normalised by Adam
        err = np.linalg.norm(have - want) / np.linalg.norm(want)
        assert err <= 1e-5, (jax.tree_util.keystr(path), err)


def test_avg_prune_saved_epochs_and_resume_rule(tmp_path):
    d = str(tmp_path)
    model = EarlyConformer(ModelConfig(**TINY)).init(torch.Generator().manual_seed(1))
    saved = {}
    for e in (0, 2, 3):
        with torch.no_grad():
            for prm in model.parameters():
                prm.add_(0.25 * (e + 1))
        ck.save_epoch(d, e, model)
        saved[e] = interop.to_jax_params(model)[0]
    # [0, 2]: epoch 1 is missing and skipped
    avg = EarlyConformer(ModelConfig(**TINY))
    ck.avg_models(avg, d, 0, 2)
    want = jax.tree_util.tree_map(lambda a, b: (a.astype(np.float64) + b) / 2,
                                  saved[0], saved[2])
    for a, b in zip(jax.tree_util.tree_leaves(interop.to_jax_params(avg)[0]),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    p, s, _, _ = _templates()
    jp, _ = jck.avg_models(d, 0, 2, p, s)
    for a, b in zip(jax.tree_util.tree_leaves(interop.to_jax_params(avg)[0]),
                    jax.tree_util.tree_leaves(jax.device_get(jp))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        ck.avg_models(avg, d, 2, 0)
    # resume: epoch 3 has no optimizer file -> the newest complete pair
    assert ck.resume_epoch(d) == (3, ck.resume_epoch(d)[1])
    assert "params-only" in ck.resume_epoch(d)[1]
    tr = Trainer(model, TrainConfig(), warmup=10)
    ck.save_epoch(d, 2, model, tr.opt)
    epoch, warning = ck.resume_epoch(d)
    assert epoch == 2 and "newest complete pair, epoch 2" in warning
    ck.save_epoch(d, 1000, model, tr.opt)
    assert ck.saved_epochs(d) == [0, 2, 3, 1000] == jck.saved_epochs(d)
    assert ck.resume_epoch(d) == (1000, None) and ck.latest_epoch(d) == 1000
    assert ck.prune_old(d, 0) == []
    assert ck.prune_old(d, 2, protect=(0,)) == [2]
    assert ck.saved_epochs(d) == [0, 3, 1000]
    assert not os.path.exists(ck.opt_ckpt_path(d, 2))


@pytest.mark.parametrize("start,end", [(0, 1), (0, 3), (1, 3)])
def test_avg_models_of_bf16_files_equal_the_jax_package(tmp_path, start, end):
    """Files whose params are bf16 (as assets/flagship_ckpt) and whose BN
    statistics are float32: each mean is rounded to its leaf's file dtype,
    as the JAX package's avg_models does, and equals it bit for bit
    (epoch 2 is missing and skipped)."""
    d = str(tmp_path)
    model = EarlyConformer(ModelConfig(**TINY)).init(torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    for e in (0, 1, 3):
        with torch.no_grad():
            for prm in model.parameters():
                prm.add_(0.1 * torch.randn(prm.shape, generator=g))
            model.set_state({"blocks": {"conv_bn": {
                k: torch.rand(v.shape, generator=g) + 0.5
                for k, v in model.state()["blocks"]["conv_bn"].items()}}})
        params, state = interop.to_jax_params(model)
        params = jax.tree_util.tree_map(
            lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16), params)
        save_tree({"params": params, "model_state": state}, ck.model_ckpt_path(d, e))
    avg = EarlyConformer(ModelConfig(**TINY))
    ck.avg_models(avg, d, start, end)
    mine_p, mine_s = interop.to_jax_params(avg)
    p, s, _, _ = _templates()
    jp, js = jax.device_get(jck.avg_models(d, start, end, p, s))
    rounded = 0
    for a, b in zip(jax.tree_util.tree_leaves(mine_p), jax.tree_util.tree_leaves(jp)):
        assert b.dtype == jnp.bfloat16
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
        rounded += int((a != a.astype(jnp.bfloat16).astype(np.float32)).sum())
    assert rounded == 0
    for a, b in zip(jax.tree_util.tree_leaves(mine_s), jax.tree_util.tree_leaves(js)):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # the float32 mean of the bf16 files is not what the JAX package loads
    files = [load_tree(ck.model_ckpt_path(d, e)) for e in (0, 1, 3) if start <= e <= end]
    w = [f["params"]["heads"]["w"].double() for f in files]
    exact = (sum(w) / len(w)).float().numpy()
    assert (len(files) == 1 or
            (exact != mine_p["heads"]["w"]).any())


def _cli(tmp_path, *extra):
    return ["--decoder_mode", "ctc", "--synthetic_data", "true", "--device", "cpu",
            "--d_model", "32", "--n_enc_exits", "2", "--n_enc_layers_per_exit", "1",
            "--n_heads", "4", "--d_feed_forward", "64", "--depthwise_kernel_size", "7",
            "--batch_size", "4", "--n_batch_split", "1", "--n_workers", "2",
            "--save_model_dir", str(tmp_path / "ck"), "--log_dir", str(tmp_path / "runs"),
            *extra]


def test_train_cli_two_epochs_then_resume(tmp_path, capsys):
    port_train.main(_cli(tmp_path, "--n_epochs", "2"))
    out = capsys.readouterr().out
    for f in ("mod000", "lr000", "mod001", "lr001"):
        assert os.path.exists(tmp_path / "ck" / f"{f}-transformer"), f
    assert "step 1 loss" in out and "RATE:" in out and "LOSS_TOTAL-1 :=" in out
    assert "saving:" in out and "EXPECTED:" in out and "CTC_OUT :" in out
    # the JAX package reads what the CLI wrote (BPE-256 heads)
    jck.load_epoch(str(tmp_path / "ck"), 1,
                   *jec.init(jax.random.PRNGKey(0),
                             JModelConfig(**{**TINY, "vocab_size": 256})))
    port_train.main(_cli(tmp_path, "--n_epochs", "3", "--init_lr", "0.1"))
    out = capsys.readouterr().out
    assert "auto-resume from epoch 1 (step 32)" in out
    assert "warning: --init_lr" in out and "LOSS_TOTAL-2 :=" in out
    assert "LOSS_TOTAL-0" not in out
    assert os.path.exists(tmp_path / "runs" / "metrics.jsonl")


@pytest.mark.parametrize("flags,match", [
    (["--model_type", "early_zipformer"], "early_zipformer"),    # 2 exits, not 19
    (["--model_type", "splitformer", "--attention_impl", "pallas"], "cannot train"),
    (["--tp", "2"], "parallelism"),          # dp x tp = 2 ranks in a world of one
    (["--conv_norm", "group", "--fused_block", "true"], "conv_norm"),
])
def test_train_cli_unported_modes_raise_by_name(tmp_path, flags, match):
    argv = _cli(tmp_path, "--n_epochs", "1")
    for i in range(0, len(flags), 2):
        if flags[i] in argv:
            argv[argv.index(flags[i]) + 1] = flags[i + 1]
        else:
            argv += flags[i:i + 2]
    with pytest.raises((NotImplementedError, ValueError), match=match):
        port_train.main(argv)


def test_train_cli_needs_a_gpu_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _cli(tmp_path, "--n_epochs", "1")
    argv[argv.index("--device") + 1] = "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_train.main(argv)


def test_attention_kernel_cannot_train():
    model = EarlyConformer(ModelConfig(**{**TINY, "attention_impl": "pallas"}))
    model.init(torch.Generator().manual_seed(0))
    b = _tb(_batch())
    with pytest.raises(NotImplementedError, match="no backward"):
        model.apply_train(b["feats"], b["feat_lengths"])


def test_kernel_layout_follows_an_optimizer_step():
    """The fused path (on the CPU, the block kernel's plain version over
    the cached layout) agrees with the unfused path after a train step:
    the cache is rebuilt when the weights move."""
    cfg = ModelConfig(**{**TINY, "fused_block": True})
    model = EarlyConformer(cfg).init(torch.Generator().manual_seed(2))
    unfused = dataclasses.replace(cfg, fused_block=False)
    b = _tb(_batch())

    def outputs():
        twin = EarlyConformer(unfused).requires_grad_(False)
        twin.load_state_dict(model.state_dict())
        with torch.no_grad():
            return (model.apply(b["feats"], b["feat_lengths"])[0],
                    twin.apply(b["feats"], b["feat_lengths"])[0])
    before, _ = outputs()                      # builds the cached layout
    Trainer(model, TrainConfig(), warmup=2).step(b)
    fused, plain = outputs()
    assert float((fused - before).abs().max()) > 1e-2       # the step moved them
    torch.testing.assert_close(fused, plain, rtol=1e-4, atol=1e-4)


def test_serving_entries_build_no_graph(monkeypatch):
    """Recognizer entries on a model whose parameters require grad (as a
    model being trained does) run every trunk forward with grad off."""
    cfg = ModelConfig(**{**TINY, "vocab_size": 256, "n_mels": 80,
                         "compute_dtype": "bfloat16"})
    model = EarlyConformer(cfg).init(torch.Generator().manual_seed(0))
    assert all(p.requires_grad for p in model.parameters())
    seen = []
    forward = conformer.ConformerStack.forward

    def spy(self, *a, **k):
        seen.append(torch.is_grad_enabled())
        return forward(self, *a, **k)
    monkeypatch.setattr(conformer.ConformerStack, "forward", spy)
    rec = Recognizer(model, load_decoder(os.path.join(REPO, "assets", "spm",
                                                      "synth.bpe-256.model")),
                     device="cpu", calib={"cascade_k": 1})
    wav = torch.randn(2, 8000, generator=torch.Generator().manual_seed(0)) * 0.1
    counts = torch.tensor([8000, 5000])
    rec.transcribe(wav, counts)
    rec.transcribe_gated(wav, counts)
    rec.transcribe_gated(wav, counts, strategy="whileloop")
    ids, _ = rec.exit_ids(wav, counts)
    assert seen and not any(seen) and not ids.requires_grad
