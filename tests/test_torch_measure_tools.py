"""The measuring tools of the port on the CPU, at small sizes:
`ablate_fused_block` (the plain block's `ablate` against the TPU kernel
with the same ablation, `fused_block_apply(..., interpret=True)`, for
every entry of the tool's list), `ablate_decode` (every collapse variant
against the JAX package's `ctc.greedy_decode_ids`), `ablate_head_path`
(the head kernel's ids against torch.matmul heads'), `bench_int8` (the
int8 unfused serving forward against the JAX package's W8A8 XLA path)
and `warm_cache` (each bucket warmed once).

Tolerances: the float32 block at atol 2e-5, rtol 1e-5, as
tests/test_torch_conformer_block.py holds the unablated plain version to
the TPU kernel; "softmax" (P = the scores, masked to -1e9 in float32)
relative to the output's scale, 1e-5. Ids and counts equal. The int8
forward's last-exit tokens equal, its logits within 2e-4 (the bound of
the W8A8 block's float32 test).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from early_exit_tpu.configs import AudioConfig as JAudioConfig
from early_exit_tpu.configs import ModelConfig as JModelConfig
from early_exit_tpu.models import early_conformer as jec
from early_exit_tpu.ops import ctc as jctc
from early_exit_tpu.ops import frontend as jfront
from early_exit_tpu.ops.pallas import conformer_block as fcb
from early_exit_tpu_torch import (ablate_decode, ablate_fused_block, ablate_head_path,
                                  bench_int8, interop, warm_cache)
from early_exit_tpu_torch.configs import AudioConfig, ModelConfig
from early_exit_tpu_torch.ops.kernels import conformer_block as kcb
from tests.test_torch_conformer_block import _cfgs, _data, _layer, _port_stack, _weights

D, H, K = 32, 4, 7


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one intra-op thread, as the suite runs six workers on the
    machine's cores (the head paths run at the flagship's width)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def block():
    jcfg, pcfg = _cfgs("float32", "float32")
    params, state = _weights(1)
    folded = fcb.fold_block_params(_layer(params, 0), _layer(state, 0),
                                   compute_dtype=jcfg.dtype)
    f = kcb.fold_block_params(_port_stack(params, state, pcfg, 1).blocks[0].state_dict(),
                              compute_dtype=pcfg.dtype)
    return folded, f


def _block_pair(block, ablate, x, lengths):
    folded, f = block
    ref = np.asarray(fcb.fused_block_apply(
        folded, jnp.asarray(x), jnp.asarray(lengths), n_heads=H, kernel_size=K,
        compute_dtype=jnp.float32, residual_dtype=jnp.float32,
        attn_softmax_dtype=jnp.float32, interpret=True, ablate=frozenset(ablate)))
    got = kcb.conformer_block_plain(
        f, torch.from_numpy(x), torch.from_numpy(lengths), n_heads=H, kernel_size=K,
        compute_dtype=torch.float32, residual_dtype=torch.float32,
        attn_softmax_dtype=torch.float32, ablate=frozenset(ablate)).numpy()
    return got, ref


@pytest.mark.parametrize("ablate", ablate_fused_block.ABLATIONS,
                         ids=lambda a: ",".join(a) or "full")
def test_plain_ablation_matches_tpu_kernel(block, ablate):
    """Ragged lengths with an empty item, T = 50. With "softmax" the
    masked scores (-1e9) weigh the values themselves, and the TPU kernel
    pads its keys to 128: its output then depends on its padding, so that
    ablation is held on unmasked items at T = 128 (no key masked or
    padded)."""
    x, lengths, _ = _data()
    if "softmax" in ablate:
        x, _, _ = _data(B=2, T=128)
        lengths = np.full(2, 128, np.int32)
    got, ref = _block_pair(block, ablate, x, lengths)
    assert np.isfinite(got).all() and not got[lengths == 0].any()
    if "softmax" in ablate:
        np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
    else:
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
    if ablate and ablate != ("ln2p",):         # ln2p: the same function, rounded apart
        full, _ = _block_pair(block, (), x, lengths)
        assert np.abs(full - got).max() > 1e-3      # the part was taken out


def test_plain_ablation_refuses_unknown_parts(block):
    x, lengths, _ = _data()
    with pytest.raises(ValueError, match="unknown parts"):
        kcb.conformer_block_plain(block[1], torch.from_numpy(x), torch.from_numpy(lengths),
                                  n_heads=H, kernel_size=K, ablate={"mlp"})


def test_ablation_tool_runs_on_the_cpu():
    lines = []
    times = ablate_fused_block.run(torch.device("cpu"), 2, 20, 64, 2, 128, 7, 1, 1,
                                   out=lines.append)
    assert set(times) == set(ablate_fused_block.ABLATIONS)
    assert lines[0].startswith("FULL") and all("saves" in ln for ln in lines[1:])


def test_collapse_variants_equal_jax():
    lines = []
    E, B, T = 2, 4, 31
    _, (toks, n), (ids, lengths) = ablate_decode.run(torch.device("cpu"), E, B, T, 9, 1,
                                                     out=lines.append)
    assert len(lines) == len(ablate_decode.variants())
    jt, jn = jctc.greedy_decode_ids(jnp.asarray(ids.numpy()), jnp.asarray(lengths.numpy()))
    jt, jn = np.asarray(jt), np.asarray(jn)
    np.testing.assert_array_equal(n, jn)
    for r in range(E * B):
        np.testing.assert_array_equal(toks[r, :n[r]], jt[r, :jn[r]])


def test_head_path_ids_agree():
    lines = []
    times, (n_diff, n_nontie) = ablate_head_path.run(torch.device("cpu"), 1, 0.5, 1,
                                                     weights="random", out=lines.append)
    assert set(times) == {"trunk", "last_only", "kernel_all", "matmul_all"}
    assert n_diff == 0 and n_nontie == 0     # the same bf16 arithmetic on the CPU
    assert "audio-s/s" in lines[0]


def _tiny_int8():
    return dict(d_model=32, n_heads=4, d_feed_forward=64, n_enc_exits=2,
                n_enc_layers_per_exit=1, depthwise_kernel_size=7, vocab_size=16,
                n_mels=16, compute_dtype="float32", residual_dtype="float32",
                attn_softmax_dtype="float32", quantize="int8")


def test_int8_unfused_forward_matches_jax():
    jcfg = JModelConfig(**_tiny_int8())
    params, state = jec.init(jax.random.PRNGKey(0), jcfg)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    model = interop.from_jax_params(to_np(params), to_np(state),
                                    ModelConfig(**_tiny_int8())).eval()
    assert not model.cfg.fused_block and model.cfg.quantize == "int8"
    rng = np.random.RandomState(0)
    wav = (0.1 * rng.randn(3, 8000)).astype(np.float32)
    counts = np.asarray([8000, 6000, 3100], np.int32)
    acfg, jacfg = AudioConfig(n_mels=16), JAudioConfig(n_mels=16)
    with torch.no_grad():
        toks, n = bench_int8.infer_fn(model, acfg)(torch.from_numpy(wav),
                                                   torch.from_numpy(counts))
        feats = torch.from_numpy(wav)
        from early_exit_tpu_torch.ops import frontend
        lp, _ = model.apply(frontend.mel_spectrogram(feats, acfg, method=acfg.mel_method),
                            frontend.mel_lengths(torch.from_numpy(counts), acfg.hop_length),
                            log_probs=False)
    jfeats = jfront.mel_spectrogram(jnp.asarray(wav), jacfg, method=jacfg.mel_method)
    jlog, jsub, _ = jec.apply(params, state, jfeats,
                              jfront.mel_lengths(jnp.asarray(counts), jacfg.hop_length),
                              jcfg, train=False, log_probs=False)
    jt, jn = jctc.greedy_decode(jlog[-1], jsub)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlog), atol=2e-4, rtol=0)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    for r in range(3):
        np.testing.assert_array_equal(toks[r, :n[r]].numpy(), np.asarray(jt)[r, :jn[r]])
    assert n.sum() > 0


def test_int8_tool_runs_on_the_cpu():
    lines = []
    times = bench_int8.leg_matmul(torch.device("cpu"), 64, 32, 128, 1, out=lines.append)
    assert len(times) == 4 and all("matmul 64x32x128" in ln for ln in lines)
    a = bench_int8.disagreement((torch.tensor([[1, 2, 0]]), torch.tensor([2])),
                                (torch.tensor([[1, 3, 0]]), torch.tensor([2])))
    assert a == (1, 2)


def test_warm_cache_visits_each_bucket_once(capsys):
    argv = ["--decoder_mode", "ctc", "--device", "cpu", "--max_seconds", "2",
            "--batches", "2,4", "--d_model", "32", "--n_enc_exits", "2",
            "--n_enc_layers_per_exit", "1", "--n_heads", "4", "--d_feed_forward", "64",
            "--depthwise_kernel_size", "7"]
    visited = warm_cache.main(argv)
    want = warm_cache.buckets(2, dataclasses.replace(AudioConfig()), 64, 4, "2,4")
    assert visited == want and len(set(visited)) == len(visited) == 6
    assert {(nb, tf) for nb, tf, _ in visited} == {(b, t) for b in (2, 4)
                                                   for t in (100, 200, 300)}
    out = capsys.readouterr().out
    assert out.count("first call") == 6 and "6 shape combinations warmed" in out
