"""The port's `nn/core` ops, subsampling and mel frontend against the JAX
package, on the same numpy inputs.

Tolerance: float32 throughout, rtol 1e-5 with an absolute floor of 1e-5
times the output's scale (sums run in another order on the two sides).
The mel features are raw power with a huge dynamic range, so they are
held at 1e-5 of their largest value. Where an op runs in bf16 the bound
is one bf16 ulp of the output's scale (2^-8 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from early_exit_tpu.configs import AudioConfig as JaxAudioConfig
from early_exit_tpu.models import subsampling as jsub
from early_exit_tpu.nn import core as jcore
from early_exit_tpu.ops import frontend as jfe
from early_exit_tpu_torch.configs import AudioConfig
from early_exit_tpu_torch.models import subsampling
from early_exit_tpu_torch.nn import core
from early_exit_tpu_torch.ops import frontend

RTOL = 1e-5


def _rng(seed=0):
    return np.random.RandomState(seed)


def _close(got, ref, rtol=RTOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1.0))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_linear_float32_and_bf16():
    r = _rng(1)
    x, w, b = (r.randn(2, 5, 24).astype(np.float32),
               r.randn(24, 16).astype(np.float32), r.randn(16).astype(np.float32))
    _close(core.linear(_t(x), _t(w), _t(b)),
           jcore.linear({"w": w, "b": b}, jnp.asarray(x)))
    got = core.linear(_t(x), _t(w), _t(b), compute_dtype=torch.bfloat16)
    ref = jcore.linear({"w": w, "b": b}, jnp.asarray(x),
                       compute_dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    _close(got, ref.astype(jnp.float32), rtol=2 ** -8)


@pytest.mark.parametrize("stride,padding", [(2, "VALID"), (1, "SAME"), (1, 2)])
def test_conv1d(stride, padding):
    r = _rng(2)
    x, w, b = (r.randn(2, 23, 6).astype(np.float32),
               r.randn(3, 6, 5).astype(np.float32), r.randn(5).astype(np.float32))
    _close(core.conv1d(_t(x), _t(w), _t(b), stride=stride, padding=padding),
           jcore.conv1d({"w": w, "b": b}, jnp.asarray(x), stride=stride,
                        padding=padding))


def test_depthwise_conv1d():
    r = _rng(3)
    x, w, b = (r.randn(2, 19, 8).astype(np.float32),
               r.randn(7, 1, 8).astype(np.float32), r.randn(8).astype(np.float32))
    _close(core.depthwise_conv1d(_t(x), _t(w), _t(b)),
           jcore.depthwise_conv1d({"w": w, "b": b}, jnp.asarray(x)))


def test_layer_norm_and_batch_norm():
    r = _rng(4)
    x = (3 + r.randn(3, 7, 16)).astype(np.float32)
    g, b = r.randn(16).astype(np.float32), r.randn(16).astype(np.float32)
    _close(core.layer_norm(_t(x), _t(g), _t(b)),
           jcore.layer_norm({"g": g, "b": b}, jnp.asarray(x)))
    mean, var = r.randn(16).astype(np.float32), (1 + r.rand(16)).astype(np.float32)
    ref, _ = jcore.masked_batch_norm({"g": g, "b": b},
                                     {"mean": mean, "var": var},
                                     jnp.asarray(x), None, train=False)
    _close(core.masked_batch_norm(_t(x), _t(g), _t(b), _t(mean), _t(var)), ref)


@pytest.mark.parametrize("softmax", ["float32", "bfloat16"])
def test_mha_with_key_mask(softmax):
    r = _rng(5)
    D, H = 32, 4
    x = r.randn(3, 11, D).astype(np.float32)
    jp = {n: {"w": (0.3 * r.randn(D, D)).astype(np.float32),
              "b": (0.1 * r.randn(D)).astype(np.float32)} for n in "qkvo"}
    lengths = np.array([11, 6, 1])
    mask = np.arange(11)[None, :] < lengths[:, None]
    sm = jnp.bfloat16 if softmax == "bfloat16" else jnp.float32
    cd = jnp.bfloat16 if softmax == "bfloat16" else None
    ref = jcore.mha(jp, jnp.asarray(x), jnp.asarray(x), H,
                    key_mask=jnp.asarray(mask), compute_dtype=cd,
                    softmax_dtype=sm)
    p = {n: (_t(v["w"]), _t(v["b"])) for n, v in jp.items()}
    got = core.mha(p, _t(x), _t(x), H, key_mask=_t(mask),
                   compute_dtype=torch.bfloat16 if cd else None,
                   softmax_dtype=torch.bfloat16 if cd else torch.float32)
    if cd is None:
        _close(got, ref)
    else:   # bf16 operands, scores and probabilities: a few bf16 ulps
        _close(got, ref.astype(jnp.float32), rtol=2 ** -6)


def test_sinusoidal_pe():
    _close(core.sinusoidal_pe(300, 64), jcore.sinusoidal_pe(300, 64))


def test_conv_subsample_and_lengths():
    r = _rng(6)
    x = r.randn(2, 61, 10).astype(np.float32)
    convs = [(r.randn(3, 10, 12).astype(np.float32), r.randn(12).astype(np.float32)),
             (r.randn(3, 12, 12).astype(np.float32), r.randn(12).astype(np.float32))]
    jp = {"convs": [{"w": w, "b": b} for w, b in convs]}
    _close(subsampling.conv_subsample_apply([(_t(w), _t(b)) for w, b in convs], _t(x)),
           jsub.conv_subsample_apply(jp, jnp.asarray(x)))
    lengths = np.array([0, 3, 4, 5, 61, 1001, 998])
    np.testing.assert_array_equal(
        subsampling.reference_subsampled_length(_t(lengths), 4, 249).numpy(),
        np.asarray(jsub.reference_subsampled_length(jnp.asarray(lengths), 4, 249)))
    np.testing.assert_array_equal(
        subsampling.subsampled_length(_t(lengths)).numpy(),
        np.asarray(jsub.subsampled_length(jnp.asarray(lengths))))


def test_window_filterbank_lengths():
    np.testing.assert_array_equal(frontend.hann_window(320, 1024),
                                  jfe.hann_window(320, 1024))
    np.testing.assert_array_equal(frontend.mel_filterbank(513, 80, 16000),
                                  jfe.mel_filterbank(513, 80, 16000))
    counts = np.array([0, 159, 160, 16000, 160001])
    np.testing.assert_array_equal(frontend.mel_lengths(_t(counts), 160).numpy(),
                                  np.asarray(jfe.mel_lengths(jnp.asarray(counts), 160)))


@pytest.mark.parametrize("method", ["dft", "fft"])
def test_mel_spectrogram(method):
    r = _rng(7)
    wav = (0.1 * r.randn(2, 8000)).astype(np.float32)
    wav[1, 5000:] = 0.0
    got = frontend.mel_spectrogram(_t(wav), AudioConfig(), method=method)
    ref = jfe.mel_spectrogram(jnp.asarray(wav), JaxAudioConfig(), method=method)
    assert tuple(got.shape) == ref.shape == (2, 51, 80)
    _close(got, ref)
