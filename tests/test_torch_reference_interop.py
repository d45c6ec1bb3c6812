"""The port's reference-checkpoint converter (`early_exit_tpu_torch/interop.py`,
`from_reference_state_dict` / `to_reference_state_dict`) against the JAX
package's (`early_exit_tpu/interop.py`), for early_conformer, splitformer,
early_zipformer and full_conformer at a small width:

- a reference state_dict (the JAX package's export of a seeded JAX init)
  imports to the JAX package's trees leaf for leaf, bit for bit, and
  exports back key for key, bit for bit; the round trip is exact;
- unknown, missing and misshapen keys, and models the reference never
  saved, raise the JAX package's exceptions with its texts;
- the port model loaded from the state_dict matches the JAX model's
  forward within 1e-5 (float32, full-length batch), and the torchaudio-
  layout replica's (`tests/test_torch_import.py`) within 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

from early_exit_tpu import interop as jinterop
from early_exit_tpu.configs import ModelConfig as JModelConfig
from early_exit_tpu.models.registry import build_model as jbuild_model
from early_exit_tpu_torch import interop
from early_exit_tpu_torch.configs import ModelConfig

from test_torch_import import (_RefEarlyConformer, _RefFullConformer, _RefZipformer,
                               _torch_model_and_sd)
from torch_one_thread import one_thread  # noqa: F401

BASE = dict(d_model=32, n_heads=4, d_feed_forward=48, n_enc_exits=2,
            n_enc_layers_per_exit=2, depthwise_kernel_size=7, vocab_size=11, n_mels=9,
            max_len=64, compute_dtype="float32", length_mode="reference")
MODELS = {"early_conformer": {}, "splitformer": {},
          "early_zipformer": dict(n_enc_exits=19, n_enc_layers_per_exit=1),
          "full_conformer": dict(n_dec_layers=2, pad_id=9)}
TOL_JAX, TOL_REPLICA = 1e-5, 1e-4


def _cfgs(model_type, **over):
    kw = {**BASE, **MODELS.get(model_type, {}), "model_type": model_type, **over}
    return JModelConfig(**kw), ModelConfig(**kw)


def _leaves(tree, prefix=""):
    """[(path, numpy leaf)] of a tree of dicts and lists, keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{prefix}/{i}")]
    return [(prefix, np.asarray(tree))]


def assert_trees_identical(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert x.tobytes() == y.tobytes(), path


def assert_state_dicts_identical(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.fixture(scope="module", params=list(MODELS))
def case(request):
    """(model type, JAX config, port config, reference state_dict of a
    seeded JAX init, the JAX package's import of it)."""
    jcfg, cfg = _cfgs(request.param)
    params, state = jbuild_model(jcfg).init(jax.random.PRNGKey(7), jcfg)
    # BatchNorm statistics away from (0, 1), so that the state is carried
    params_np = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(3)
    state_np = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.uniform(0.1, 0.5, np.shape(a))).astype(np.float32),
        state)
    sd = jinterop.to_reference_state_dict(params_np, state_np, jcfg)
    return request.param, jcfg, cfg, sd, jinterop.from_reference_state_dict(sd, jcfg)


def test_import_equals_jax_bit_for_bit(case):
    _, _, cfg, sd, want = case
    assert_trees_identical(interop.from_reference_state_dict(sd, cfg), want)


def test_export_equals_jax_and_round_trips(case):
    _, jcfg, cfg, sd, (params, state) = case
    ours = interop.to_reference_state_dict(params, state, cfg)
    assert_state_dicts_identical(ours, jinterop.to_reference_state_dict(params, state, jcfg))
    assert_state_dicts_identical(ours, sd)
    assert_trees_identical(interop.from_reference_state_dict(ours, cfg), (params, state))


def test_model_loaded_from_the_state_dict_round_trips(case):
    """state_dict -> port model -> the JAX layout -> state_dict, exactly."""
    _, _, cfg, sd, _ = case
    model = interop.from_jax_params(*interop.from_reference_state_dict(sd, cfg), cfg)
    back = interop.to_reference_state_dict(*interop.to_jax_params(model), cfg)
    assert_state_dicts_identical(back, sd)


def _raise_alike(ours, theirs):
    with pytest.raises(Exception) as got:
        ours()
    with pytest.raises(Exception) as want:
        theirs()
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)
    return str(got.value)


@pytest.mark.parametrize("fault", ["unknown", "missing", "misshapen"])
def test_bad_state_dicts_raise_as_jax(case, fault):
    name, jcfg, cfg, sd, _ = case
    sd = dict(sd)
    if fault == "unknown":
        sd["decoders.9.weight"] = np.zeros((3, 3), np.float32)
    elif fault == "missing":
        del sd[sorted(k for k in sd if k.endswith(".weight"))[-1]]
    else:
        jcfg, cfg = _cfgs(name, d_feed_forward=64)
    text = _raise_alike(lambda: interop.from_reference_state_dict(sd, cfg),
                        lambda: jinterop.from_reference_state_dict(sd, jcfg))
    assert {"unknown": "unmapped", "missing": "missing",
            "misshapen": "shape"}[fault] in text


@pytest.mark.parametrize("model_type", ["transformer", "early_transformer"])
def test_models_without_a_reference_checkpoint_raise_as_jax(model_type):
    jcfg, cfg = _cfgs(model_type)
    _raise_alike(lambda: interop.from_reference_state_dict({}, cfg),
                 lambda: jinterop.from_reference_state_dict({}, jcfg))
    _raise_alike(lambda: interop.to_reference_state_dict({}, {}, cfg),
                 lambda: jinterop.to_reference_state_dict({}, {}, jcfg))


def _batch(cfg, B=2, T=61, seed=11):
    feats = np.random.RandomState(seed).randn(B, T, cfg.n_mels).astype(np.float32)
    return feats, np.full((B,), T, np.int32)


def test_forward_matches_jax(case):
    name, jcfg, cfg, sd, (params, state) = case
    model = interop.from_jax_params(*interop.from_reference_state_dict(sd, cfg), cfg)
    feats, lengths = _batch(cfg, T=127 if name == "early_zipformer" else 61)
    model_j = jbuild_model(jcfg)
    with torch.no_grad():
        if name == "full_conformer":
            trg = np.asarray([[1, 4, 5, 2], [1, 6, 2, 3]], np.int32)
            dec_j, enc_j, _, _ = model_j.apply(params, state, feats, lengths, trg, jcfg,
                                               train=False)
            dec, enc, _ = model.apply(torch.from_numpy(feats), torch.from_numpy(lengths),
                                      torch.from_numpy(trg))
            np.testing.assert_allclose(dec.numpy(), np.asarray(dec_j), atol=TOL_JAX, rtol=0)
        else:
            enc_j, _, _ = model_j.apply(params, state, feats, lengths, jcfg, train=False)
            enc, _ = model.apply(torch.from_numpy(feats), torch.from_numpy(lengths))
    np.testing.assert_allclose(enc.numpy(), np.asarray(enc_j), atol=TOL_JAX, rtol=0)


def _replica(name, cfg):
    """The torchaudio-layout replica of the reference model, seeded, with
    BatchNorm statistics from three training-mode passes; its state_dict."""
    if name in ("early_conformer", "splitformer"):
        return _torch_model_and_sd(cfg, parallel=name == "splitformer", seed=5)
    torch.manual_seed(5)
    m = (_RefFullConformer(cfg, n_dec_layers=2) if name == "full_conformer"
         else _RefZipformer(cfg))
    T = 127 if name == "early_zipformer" else 61
    with torch.no_grad():
        m.train()
        for _ in range(3):
            args = (torch.randn(2, cfg.n_mels, T), torch.tensor([T, T]))
            if name == "full_conformer":
                args += (torch.tensor([[1, 4, 5, 2], [1, 6, 2, 9]]),)
            m(*args)
        m.eval()
    return m, {k: v.numpy() for k, v in m.state_dict().items()}


@pytest.mark.parametrize("name", ["early_conformer", "early_zipformer", "full_conformer"])
def test_forward_matches_the_torchaudio_replica(name):
    _, cfg = _cfgs(name)
    m, sd = _replica(name, cfg)
    model = interop.from_jax_params(*interop.from_reference_state_dict(sd, cfg), cfg)
    feats, lengths = _batch(cfg, T=127 if name == "early_zipformer" else 61, seed=12)
    ft, lt = torch.from_numpy(feats), torch.from_numpy(lengths)
    with torch.no_grad():
        if name == "full_conformer":
            trg = torch.tensor([[1, 4, 5, 2], [1, 6, 2, 3]])
            want_enc, want_dec = m(ft.transpose(1, 2), lt, trg)
            dec, enc, _ = model.apply(ft, lt, trg)
            np.testing.assert_allclose(torch.log_softmax(dec, -1).numpy(), want_dec.numpy(),
                                       atol=TOL_REPLICA, rtol=0)
        else:
            want_enc = m(ft.transpose(1, 2), lt)
            enc, _ = model.apply(ft, lt)
    np.testing.assert_allclose(enc.numpy(), want_enc.numpy(), atol=TOL_REPLICA, rtol=0)


def test_splitformer_replica_state_dict_round_trips():
    """The splitformer's replica (trunk and two branch blocks): imported and
    exported back as the JAX package does, key for key, bit for bit; the
    export loads strict=True into the replica, every weight and statistic
    as it went in."""
    jcfg, cfg = _cfgs("splitformer")
    _, sd = _replica("splitformer", cfg)
    sd = {k: v.astype(np.float32) if v.dtype.kind == "f" else v for k, v in sd.items()}
    ours = interop.to_reference_state_dict(*interop.from_reference_state_dict(sd, cfg), cfg)
    theirs = jinterop.to_reference_state_dict(*jinterop.from_reference_state_dict(sd, jcfg),
                                              jcfg)
    assert_state_dicts_identical(ours, theirs)
    _RefEarlyConformer(cfg, parallel=True).load_state_dict(
        {k: torch.from_numpy(v) for k, v in ours.items()}, strict=True)
    for k, v in sd.items():
        if k.endswith(".pe"):           # recomputed on export, as the reference's is
            np.testing.assert_allclose(ours[k], v, atol=1e-5, rtol=0)
        elif not k.endswith("num_batches_tracked"):
            assert ours[k].tobytes() == v.tobytes(), k

