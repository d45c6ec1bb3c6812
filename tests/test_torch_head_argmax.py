"""The head+argmax kernel's plain PyTorch version against the TPU kernel
(`head_argmax(..., interpret=True)`), on the same numpy inputs.

Contract, as bench.py:146-163 holds the TPU kernel to the XLA heads: the
ids are equal except where two logits tie exactly in bf16, where the
choice may differ; ties the inputs force by construction go to the
lowest index on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from early_exit_tpu.ops.pallas import head_argmax as jha
from early_exit_tpu_torch.ops.kernels import head_argmax as kha


def _inputs(E, B, T, D, V, seed):
    r = np.random.RandomState(seed)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return (bf(r.randn(E, B, T, D)), bf(r.randn(E, D, V) / np.sqrt(D)),
            bf(0.1 * r.randn(E, V)))


def _jax(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _logits(h, w, b):
    """bf16 logits as both kernels form them (f32 sum -> bf16 -> + bf16 bias)."""
    E, B, T, D = h.shape
    lg = torch.matmul(h.float().reshape(E, B * T, D), w.float()).to(torch.bfloat16)
    return (lg + b[:, None, :]).float().reshape(E, B, T, -1)


@pytest.mark.parametrize("shape,seed", [((3, 2, 37, 32, 64), 0),
                                        ((6, 2, 20, 256, 256), 1)])
def test_plain_matches_tpu_kernel_except_at_ties(shape, seed):
    h, w, b = _inputs(*shape, seed)
    ref = np.asarray(jha.head_argmax(_jax(h), _jax(w), _jax(b), interpret=True))
    got = kha.head_argmax_plain(h, w, b)
    assert got.dtype == torch.int32 and got.shape == shape[:3]
    got = got.numpy()
    lg = _logits(h, w, b).numpy()
    diff = np.argwhere(got != ref)
    for e, bi, t in diff:
        assert lg[e, bi, t, got[e, bi, t]] == lg[e, bi, t, ref[e, bi, t]]
    assert len(diff) <= 0.01 * got.size


def test_forced_ties_go_to_the_lowest_index():
    h, w, b = _inputs(2, 1, 16, 32, 64, 2)
    w[:, :, 40] = w[:, :, 7]          # columns 7 and 40 tie everywhere
    w[:, :, 41] = w[:, :, 7]
    b[:, 40] = b[:, 7]
    b[:, 41] = b[:, 7]
    b[:, 7] += 100.0                   # ... and win everywhere
    b[:, 40] += 100.0
    b[:, 41] += 100.0
    ref = np.asarray(jha.head_argmax(_jax(h), _jax(w), _jax(b), interpret=True))
    got = kha.head_argmax_plain(h, w, b).numpy()
    assert (got == 7).all() and (ref == 7).all()


def test_cpu_wrapper_is_the_plain_version_and_counts_nothing():
    h, w, b = _inputs(2, 2, 9, 32, 64, 3)
    before = kha.head_argmax.launches
    assert torch.equal(kha.head_argmax(h, w, b), kha.head_argmax_plain(h, w, b))
    assert kha.head_argmax.launches == before
