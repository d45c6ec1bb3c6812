"""`--conv_norm group` in the port against the JAX package's unfused path,
at a small size on the CPU (d 32, 4 heads, ffn 64, k 7, V 16, float32).

- the conv module and a whole block against `conformer._conv_module` and
  `block_apply` on ragged lengths with one empty item, in eval and in
  train, within 1e-5; the BatchNorm running statistics pass through; the
  empty item stays finite and its block output is zeros;
- a 2-exit early_conformer's forward and one CTC train step (loss, grad
  norm, gradient leaves), and the forwards of the splitformer, the
  zipformer and full_conformer;
- the train CLI trains a group-norm early_conformer (CTC) and a
  full_conformer (AED), and the inference CLI decodes the CTC checkpoint
  with the JAX CLI's lines;
- the records of Queue C: the JAX package's fused path under group norm
  (its Pallas block in interpret mode) folds the BatchNorm running
  statistics and lies away from its unfused path, while the port refuses
  every fused route of a group-norm model by name; and both packages'
  reference converters fail alike on a state_dict without the running
  statistics (a torchaudio `use_group_norm` model).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from early_exit_tpu.configs import ModelConfig as JModelConfig
from early_exit_tpu.models import conformer as jc
from early_exit_tpu.models import early_conformer as jec
from early_exit_tpu.models import full_conformer as jfc
from early_exit_tpu.models import splitformer as jsf
from early_exit_tpu.models import zipformer as jzf
from early_exit_tpu.training import checkpoint as jck
from early_exit_tpu_torch import inference as port_inference
from early_exit_tpu_torch import interop
from early_exit_tpu_torch import train as port_train
from early_exit_tpu_torch.configs import ModelConfig
from early_exit_tpu_torch.models import conformer as pc
from early_exit_tpu_torch.models.registry import build_model
from early_exit_tpu_torch.optim.noam import global_norm

from test_torch_infer_cli import jax_inference  # noqa: F401
from test_torch_train_step import _batch, _jax_step, _port
from torch_one_thread import one_thread  # noqa: F401

D, H, FF, K = 32, 4, 64, 7
TINY = dict(d_model=D, n_heads=H, d_feed_forward=FF, n_enc_exits=2,
            n_enc_layers_per_exit=1, depthwise_kernel_size=K, vocab_size=16,
            n_mels=8, compute_dtype="float32", drop_prob=0.0, conv_norm="group")
TOL = 1e-5


def _jcfg(**kw):
    return jc.ConformerConfig(d_model=D, n_heads=H, d_ff=FF, kernel_size=K, dropout=0.0,
                              conv_norm="group", **kw)


def _pcfg(**kw):
    return pc.ConformerConfig(d_model=D, n_heads=H, d_ff=FF, kernel_size=K, dropout=0.0,
                              conv_norm="group", **kw)


def _affine(params, key=3):
    """The norm's g and b moved off (1, 0), so that the affine counts."""
    norm = params["conv"]["norm"]
    k1, k2 = jax.random.split(jax.random.PRNGKey(key))
    norm["g"] = norm["g"] + 0.3 * jax.random.normal(k1, norm["g"].shape)
    norm["b"] = 0.3 * jax.random.normal(k2, norm["b"].shape)
    return params


@pytest.fixture(scope="module")
def stack():
    """One block's JAX trees (a stack of one, the affine moved, running
    statistics off their init), ragged inputs with an empty item, and the
    port's stack."""
    params, state = jc.stack_init(jax.random.PRNGKey(0), _jcfg(), 1)
    params = _affine(params)
    state = {"conv_bn": {"mean": state["conv_bn"]["mean"] + 0.2,
                         "var": state["conv_bn"]["var"] * 1.5}}
    r = np.random.RandomState(0)
    x = r.randn(3, 11, D).astype(np.float32)
    mask = np.arange(11)[None] < np.array([11, 6, 0])[:, None]
    port = interop.load_stack(pc.ConformerStack(_pcfg(), 1), params, state)
    return params, state, x, mask, port


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_conv_module_and_block_match_jax(stack, train):
    params, state, x, mask, port = stack
    p0 = jax.tree_util.tree_map(lambda a: a[0], params)
    s0 = jax.tree_util.tree_map(lambda a: a[0], state)
    jx, jm = jnp.asarray(x), jnp.asarray(mask)
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    block = port.blocks[0]

    want, new_bn = jc._conv_module(p0["conv"], s0["conv_bn"], jx, jm, _jcfg(),
                                   jax.random.PRNGKey(0), train)
    got = block.conv(tx, tm, block.cfg, train=train)
    if train:
        got, mean, var = got
        assert torch.equal(mean, block.conv.bn_mean) and torch.equal(var, block.conv.bn_var)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(np.asarray(new_bn["mean"]), block.conv.bn_mean.numpy())
    assert np.isfinite(got.detach().numpy()[2]).all()          # the empty item

    want, new_state = jc.block_apply(p0, s0, jx, jm, _jcfg(), train=train)
    got = block(tx, tm, train=train)
    if train:
        got = got[0]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert torch.count_nonzero(got[2]) == 0 and torch.isfinite(got).all()


def test_early_conformer_forward_and_train_step_match_jax():
    batch = _batch(TINY, item_mask=True)
    params, state, m, grads, new_state = _jax_step(TINY, {}, batch)
    model, total, per_exit, pgrads, pstate = _port(params, state, TINY, {}, batch)
    assert float(total.detach()) == pytest.approx(float(m["loss"]), rel=TOL)
    assert float(global_norm(list(pgrads.values()))) == pytest.approx(
        float(m["grad_norm"]), rel=1e-4)
    jg = jax.tree_util.tree_leaves(grads)
    pg = jax.tree_util.tree_leaves(interop.jax_tree(model, pgrads))
    for a, b in zip(jg, pg):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4, atol=1e-5)
    # the running statistics pass through a group-norm step unchanged
    for k in ("mean", "var"):
        np.testing.assert_array_equal(pstate["blocks"]["conv_bn"][k].numpy(),
                                      np.asarray(new_state["blocks"]["conv_bn"][k]))
    with torch.no_grad():
        lp, sub_len = model.apply(torch.from_numpy(batch["feats"]),
                                  torch.from_numpy(batch["feat_lengths"]))
    jlp, jsub = jec.apply(params, state, jnp.asarray(batch["feats"]),
                          jnp.asarray(batch["feat_lengths"]), JModelConfig(**TINY))[:2]
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(sub_len.numpy(), np.asarray(jsub))


ZOO = {"splitformer": (jsf, dict(TINY, model_type="splitformer", n_enc_exits=3)),
       "early_zipformer": (jzf, dict(TINY, model_type="early_zipformer", n_enc_exits=19)),
       "full_conformer": (jfc, dict(TINY, model_type="full_conformer", n_dec_layers=1,
                                    pad_id=14))}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_forwards_match_jax(name):
    jmod, kw = ZOO[name]
    jcfg = JModelConfig(**kw)
    params, state = jmod.init(jax.random.PRNGKey(1), jcfg)
    model = interop.from_jax_params(params, state, ModelConfig(**kw))
    batch = _batch(kw)
    feats, lens = batch["feats"], batch["feat_lengths"]
    tf, tl = torch.from_numpy(feats), torch.from_numpy(lens)
    with torch.no_grad():
        if name == "full_conformer":
            trg = torch.from_numpy(batch["labels"][:, :-1])
            dec, lp, sub = model.apply(tf, tl, trg)
            jdec, jlp, jsub, _ = jfc.apply(params, state, jnp.asarray(feats),
                                           jnp.asarray(lens), jnp.asarray(trg.numpy()), jcfg)
            np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), rtol=TOL, atol=TOL)
        else:
            lp, sub = model.apply(tf, tl)
            jlp, jsub = jmod.apply(params, state, jnp.asarray(feats), jnp.asarray(lens),
                                   jcfg)[:2]
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(sub.numpy(), np.asarray(jsub))


CLI = ["--synthetic_data", "true", "--d_model", "32",
       "--n_enc_exits", "2", "--n_enc_layers_per_exit", "1", "--n_heads", "4",
       "--d_feed_forward", "64", "--depthwise_kernel_size", "7", "--batch_size", "16",
       "--n_batch_split", "1", "--n_workers", "2", "--conv_norm", "group"]
F32 = ["--compute_dtype", "float32", "--attn_softmax_dtype", "float32"]
KEEP = ("EXPECTED:", "BEAM_OUT_", "WER", "trainable parameters")


@pytest.mark.parametrize("mode", ["ctc", "aed"])
def test_train_cli_then_inference_cli(tmp_path, capsys, jax_inference, mode):
    """The train CLI takes an epoch with --conv_norm group and saves; the
    checkpoint holds the BatchNorm tree unchanged (the JAX package reads
    it); in CTC mode the inference CLI decodes it with the JAX CLI's
    lines, and --fused_block true raises by name in both CLIs."""
    extra = ["--n_dec_layers", "1"] if mode == "aed" else []
    port_train.main(["--decoder_mode", mode, *CLI, *extra, "--n_epochs", "1", "--device", "cpu",
                     "--save_model_dir", str(tmp_path / "ck"),
                     "--log_dir", str(tmp_path / "runs")])
    out = capsys.readouterr().out
    assert "LOSS_TOTAL-0 :=" in out and "saving:" in out
    path = str(tmp_path / "ck" / "mod000-transformer")
    cfg = JModelConfig(**{**TINY, "vocab_size": 256, "n_dec_layers": 1,
                          "model_type": "full_conformer" if mode == "aed"
                          else "early_conformer"})
    jmod = jfc if mode == "aed" else jec
    tree = jck.load_pytree(dict(zip(("params", "model_state"),
                                    jmod.init(jax.random.PRNGKey(0), cfg))), path)
    bn = tree["model_state"]["blocks"]["conv_bn"]
    np.testing.assert_array_equal(np.asarray(bn["mean"]), 0.0)
    np.testing.assert_array_equal(np.asarray(bn["var"]), 1.0)
    if mode == "ctc":
        argv = ["--decoder_mode", "ctc", *CLI, *F32, "--load_model_path", path,
                "--batch_size", "4"]
        jax_inference.main(argv)
        want = [ln for ln in capsys.readouterr().out.splitlines()
                if any(k in ln for k in KEEP)]
        port_inference.main(argv + ["--device", "cpu"])
        got = [ln for ln in capsys.readouterr().out.splitlines()
               if any(k in ln for k in KEEP)]
        assert got == want and sum("BEAM_OUT_" in ln for ln in got) > 0
    argv = ["--decoder_mode", mode, *CLI, *extra, "--load_model_path", path,
            "--fused_block", "true", "--device", "cpu"]
    with pytest.raises(ValueError, match="folds the BatchNorm running statistics"):
        port_inference.main(argv)
    with pytest.raises(ValueError, match="conv_norm='group' cannot run the fused block"):
        port_train.main(argv + ["--save_model_dir", str(tmp_path / "ck2")])


def test_jax_fused_path_folds_batchnorm_and_the_port_refuses(stack):
    """Queue C's record. The JAX package's fused branch (conformer.py:237)
    takes the Pallas block for any conv_norm, and `fold_block_params`
    folds the running statistics, which a group-norm model never moves:
    its fused output is the BatchNorm-eval block's, far from its own
    unfused (GroupNorm) path. The port refuses that route by name."""
    params, state, x, mask, port = stack
    jx, jm = jnp.asarray(x), jnp.asarray(mask)
    fused = jc.stack_apply(params, state, jx, jm, _jcfg(fused_block=True))[0]
    unfused = jc.stack_apply(params, state, jx, jm, _jcfg())[0]
    batch_eval = jc.stack_apply(params, state, jx, jm,
                                dataclasses.replace(_jcfg(), conv_norm="batch"))[0]
    valid = np.asarray(mask)
    gap = np.abs(np.asarray(fused) - np.asarray(unfused))[valid].max()
    assert gap > 0.1, gap
    np.testing.assert_allclose(np.asarray(fused)[valid], np.asarray(batch_eval)[valid],
                               rtol=1e-4, atol=1e-4)

    for kw in (dict(fused_block=True), dict(quantize="int8")):
        with pytest.raises(ValueError, match="cannot compute a GroupNorm"):
            _pcfg(**kw)
    with pytest.raises(ValueError, match="cannot compute a GroupNorm"):
        port.folded()
    for name, kw in [("early_conformer", TINY)] + [(n, kw) for n, (_, kw) in ZOO.items()]:
        with pytest.raises(ValueError, match="cannot compute a GroupNorm"):
            build_model(ModelConfig(**{**kw, "fused_block": True}))


def test_reference_converter_fails_on_a_group_norm_state_dict_as_jax():
    """A torchaudio `use_group_norm` conv module has no running statistics;
    both packages' converters read `sequential.3.running_mean` and fail
    there with the same error (Queue C)."""
    from early_exit_tpu import interop as jinterop
    cfg = ModelConfig(**TINY)
    model = build_model(cfg).init(torch.Generator().manual_seed(0))
    sd = interop.to_reference_state_dict(*interop.to_jax_params(model), cfg)
    stats = ("sequential.3.running_mean", "sequential.3.running_var",
             "sequential.3.num_batches_tracked")
    gn = {k: v for k, v in sd.items() if not k.endswith(stats)}
    assert len(gn) < len(sd)
    errors = []
    for convert, c in ((interop.from_reference_state_dict, cfg),
                       (jinterop.from_reference_state_dict, JModelConfig(**TINY))):
        with pytest.raises(KeyError, match="running_mean") as e:
            convert(gn, c)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
