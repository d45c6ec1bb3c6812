"""The port's pure-Python msgpack reader against flax, and the weights'
way across to the port's modules.

Tolerance: none. Every leaf of the committed flagship checkpoint must
come out bit-identical to `flax.serialization.from_bytes`, and
`interop.from_jax_params` must carry every value across unchanged.
"""

import hashlib

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from early_exit_tpu.configs import ModelConfig as JaxModelConfig
from early_exit_tpu.models import early_conformer as jec
from early_exit_tpu_torch import checkpoint, interop
from early_exit_tpu_torch.configs import ModelConfig


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _bits(a) -> np.ndarray:
    """Raw bits of a numpy (ml_dtypes bf16 included) or torch leaf."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        a = a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.fixture(scope="module")
def trees():
    with open(checkpoint.FLAGSHIP_CKPT, "rb") as f:
        data = f.read()
    # the flagship's tree structure (lists included) without computing it
    params, state = jax.eval_shape(
        lambda: jec.init(jax.random.PRNGKey(0), JaxModelConfig()))
    ref = serialization.from_bytes({"params": params, "model_state": state},
                                   data)
    return ref, checkpoint.unpackb(data)


def test_reader_matches_flax_leaf_for_leaf(trees):
    ref, got = trees
    r, g = dict(_flatten(ref)), dict(_flatten(got))
    assert r.keys() == g.keys()
    dtypes = [str(t.dtype) for t in g.values()]
    assert dtypes.count("torch.bfloat16") == 40
    assert dtypes.count("torch.float32") == 2
    for k, a in r.items():
        a = np.asarray(a)
        assert tuple(g[k].shape) == a.shape, k
        assert str(g[k].dtype) == "torch." + a.dtype.name, k
        np.testing.assert_array_equal(_bits(g[k]), _bits(a), err_msg=str(k))
    assert tuple(g[("params", "blocks", "ffn1", "w1", "w")].shape) == (12, 256, 2048)
    assert tuple(g[("params", "heads", "w")].shape) == (6, 256, 256)


@pytest.mark.parametrize("tree", [
    {"i8": np.arange(-5, 5, dtype=np.int8), "u32": np.arange(7, dtype=np.uint32),
     "f64": np.linspace(-1, 1, 9), "b": np.array([True, False])},
    {"nested": [{"x": np.float32(3.5)}, np.zeros((0, 3), np.float32)],
     "big": np.arange(70000, dtype=np.int32).reshape(7, 10000),
     "scalars": {"n": -70000, "f": 2.25, "s": "text", "none": None}},
])
def test_reader_matches_flax_on_other_types(tree):
    data = serialization.to_bytes(tree)
    ref = dict(_flatten(serialization.msgpack_restore(data)))
    got = dict(_flatten(checkpoint.unpackb(data)))
    assert ref.keys() == got.keys()
    for k, a in ref.items():
        if isinstance(a, np.ndarray) or isinstance(a, np.generic):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(a))
        else:
            assert got[k] == a, k


def test_tokenizer_binding_is_checked():
    calib = checkpoint.load_calib()
    path = checkpoint.bound_tokenizer(calib)
    with open(path, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == calib["tokenizer_sha256"]
    bad = dict(calib, tokenizer_sha256="0" * 64)
    with pytest.raises(RuntimeError, match="mismatch"):
        checkpoint.bound_tokenizer(bad)
    with pytest.raises(FileNotFoundError):
        checkpoint.bound_tokenizer(dict(calib, tokenizer="assets/spm/none.model"))


def test_from_jax_params_carries_every_value(trees):
    """The port's modules hold exactly the checkpoint's values, whether the
    tree comes from flax (numpy, lists) or from the port's reader."""
    ref, got = trees
    cfg = ModelConfig()
    a = interop.from_jax_params(ref["params"], ref["model_state"], cfg)
    b = interop.from_jax_params(got["params"], got["model_state"], cfg)
    for (ka, ta), (kb, tb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb
        assert torch.equal(ta, tb), ka
    p = ref["params"]["blocks"]
    blk = a.stack.blocks[7]
    np.testing.assert_array_equal(
        blk.ffn2.w1.numpy(), np.asarray(p["ffn2"]["w1"]["w"][7], np.float32))
    np.testing.assert_array_equal(
        blk.conv.bn_var.numpy(),
        np.asarray(ref["model_state"]["blocks"]["conv_bn"]["var"][7]))
    np.testing.assert_array_equal(
        a.sub_w[1].numpy(),
        np.asarray(ref["params"]["subsample"]["convs"][1]["w"], np.float32))
    np.testing.assert_array_equal(
        a.heads_b.numpy(), np.asarray(ref["params"]["heads"]["b"], np.float32))
