"""The block kernel in the four dtype mixes that joined the card last
(W8A8 with bf16 compute and a float32 residual, W8A8 with float32 compute
and a float32 or a bf16 residual, float32 compute with a bf16 residual),
each with either softmax dtype, and heads wider than 128 in both
attentions, against the JAX package's Pallas kernels in interpret mode
on the same numpy inputs; the padded layout against the unpadded one; the
plan of every mix.

- The block (`fused_block_apply(..., interpret=True)`) in the 8 new
  profiles at Conformer-S (d 144, 4 heads of 36, ff 576, k 32), the dress
  rehearsal's width (d 64, 4 heads, ff 128, k 7) and d 196 (4 heads of
  49, ff 784, k 31), B=2, T'=37 with one short item, through the port's
  `conformer_block_plain` on the padded layout, in a fresh process
  without XLA's excess precision (tests/test_torch_kernel_widths.py says
  why). Tolerances, test_torch_kernel_widths_any.py's: W8A8 max 2^-4,
  mean 2^-8; float32 compute with a bf16 residual (bf16 rounding points)
  max 2^-5, mean 2^-8.
- A block with heads of 160 (2 of them), 256 and 384 (one each), ff 128,
  k 7: float32 within atol 2e-5 rtol 1e-5 (in this process), the bf16
  profile max 2^-5 mean 2^-8 (in the fresh process).
- The attention (`fused_attention(..., interpret=True)`) at dh 160, 256
  and 384, float32 and bf16 inputs: `fused_attention_plain` within 1e-5
  absolute.
- The plain version on the padded layout against the plain version on
  the unpadded one, in the new profiles and at heads of 160, value for
  value.
- `block_plan` of all 16 mixes and of heads of 160, 256 and 384.
- A 2-block early conformer (d 144) fused, W8A8 with float32 compute and
  float32 compute with a bf16 residual: the port's exit ids against the
  JAX package's.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from early_exit_tpu.configs import ModelConfig as JaxModelConfig
from early_exit_tpu.models import conformer as jconf
from early_exit_tpu.models import early_conformer as jec
from early_exit_tpu.ops.pallas import attention as pattn
from early_exit_tpu.ops.pallas import conformer_block as fcb
from early_exit_tpu_torch import interop
from early_exit_tpu_torch.configs import ModelConfig
from early_exit_tpu_torch.models.conformer import ConformerConfig, ConformerStack
from early_exit_tpu_torch.ops.kernels import attention as katt
from early_exit_tpu_torch.ops.kernels import conformer_block as kcb

from torch_one_thread import one_thread  # noqa: F401  (autouse fixture)

TESTS = os.path.dirname(os.path.abspath(__file__))
# (d_model, n_heads, d_ff, kernel_size)
WIDTHS = {"conformer_s": (144, 4, 576, 32), "rehearsal": (64, 4, 128, 7),
          "d196": (196, 4, 784, 31), "dh160": (320, 2, 128, 7), "dh256": (256, 1, 128, 7),
          "dh384": (384, 1, 128, 7)}
# profile -> (compute, residual, softmax, quantize): the 8 new ones, named
# by their entry and softmax, then the two that the wide heads run in
PROFILES = {f"{entry}-sm_{'bf16' if sm == 'bfloat16' else 'f32'}": (cd, rd, sm, q)
            for entry, cd, rd, q in (("w8a8_res_f32", "bfloat16", "float32", "int8"),
                                     ("w8a8_f32", "float32", "float32", "int8"),
                                     ("w8a8_f32_res_bf16", "float32", "bfloat16", "int8"),
                                     ("f32_res_bf16", "float32", "bfloat16", None))
            for sm in ("bfloat16", "float32")}
NEW = tuple(PROFILES)
PROFILES.update({"bf16": ("bfloat16", "bfloat16", "bfloat16", None),
                 "float32": ("float32", "float32", "float32", None)})
DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _block_weights(jcfg, D, seed):
    params, _ = jconf.stack_init(jax.random.PRNGKey(seed), jcfg, 1)
    r = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * r.randn(*a.shape)).astype(np.float32), params)
    state = {"conv_bn": {"mean": (0.1 * r.randn(1, D)).astype(np.float32),
                         "var": (1 + 0.5 * r.rand(1, D)).astype(np.float32)}}
    return params, state


def _block_pair(width, profile, seed=11):
    """(the plain version's output on the padded layout, cut to d_model;
    the TPU kernel's in interpret mode) of one seeded block, float32."""
    D, H, FF, K = WIDTHS[width]
    compute, residual, softmax, quantize = PROFILES[profile]
    kw = dict(d_model=D, n_heads=H, d_ff=FF, kernel_size=K, compute_dtype=compute,
              residual_dtype=residual, attn_softmax_dtype=softmax)
    jcfg, pcfg = jconf.ConformerConfig(dropout=0.0, **kw), ConformerConfig(**kw)
    params, state = _block_weights(jcfg, D, seed)
    block = interop.load_stack(ConformerStack(pcfg, 1), params, state).blocks[0]
    B, T = 2, 37
    r = np.random.RandomState(12)
    x, lengths = r.randn(B, T, D).astype(np.float32), np.array([T, T - 15], np.int32)
    layer = lambda tree: jax.tree_util.tree_map(lambda a: a[0], tree)
    folded = fcb.fold_block_params(layer(params), layer(state), compute_dtype=jcfg.dtype,
                                   quantize=quantize)
    ref = np.asarray(fcb.fused_block_apply(
        folded, jnp.asarray(x), jnp.asarray(lengths), n_heads=H, kernel_size=K,
        compute_dtype=jcfg.dtype, residual_dtype=jcfg.rdtype,
        attn_softmax_dtype=jcfg.sm_dtype, interpret=True, quantize=quantize), np.float32)
    f = kcb.fold_block_params(block.state_dict(), compute_dtype=pcfg.dtype,
                              quantize=quantize, n_heads=H)
    xp = torch.nn.functional.pad(torch.from_numpy(x), (0, kcb.pitch(D) - D))
    got = kcb.conformer_block_plain(
        f, xp, torch.from_numpy(lengths), n_heads=H, kernel_size=K,
        compute_dtype=pcfg.dtype, residual_dtype=pcfg.rdtype,
        attn_softmax_dtype=pcfg.sm_dtype, quantize=quantize, d_model=D).float().numpy()
    assert np.isfinite(got).all() and not got[..., D:].any()     # the padding stays zero
    return got[..., :D], ref


_EXACT = """
import sys
sys.path.insert(0, {tests!r})
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
import numpy as np
import torch
torch.set_num_threads(1)
import test_torch_kernel_profiles_all as t
for w, profiles in {runs!r}:
    for p in profiles:
        got, ref = t._block_pair(w, p)
        d = np.abs(got - ref)
        print(w, p, float(d.max()), float(d.mean()))
"""
# the fresh process's runs: the 8 new profiles at each width, the bf16
# profile at each wide head
FRESH_RUNS = ([(w, NEW) for w in ("conformer_s", "rehearsal", "d196")]
              + [(w, ("bf16",)) for w in ("dh160", "dh256", "dh384")])


@pytest.fixture(scope="module")
def fresh_rows():
    """{(width, profile): (max, mean) |plain - TPU kernel|} of FRESH_RUNS,
    from fresh processes with --xla_allow_excess_precision=false, three at
    once (the new profiles of a width take ~20 s of interpret mode)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    parts = (FRESH_RUNS[:1], FRESH_RUNS[1:2], FRESH_RUNS[2:])
    procs = [subprocess.Popen([sys.executable, "-c", _EXACT.format(tests=TESTS, runs=runs)],
                              cwd=os.path.dirname(TESTS), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for runs in parts]
    rows = {}
    for p in procs:
        out, err = p.communicate(timeout=900)
        assert p.returncode == 0, err[-3000:]
        rows.update({tuple(ln.split()[:2]): [float(v) for v in ln.split()[2:]]
                     for ln in out.split("\n") if ln})
    return rows


@pytest.mark.parametrize("width", [w for w, _ in FRESH_RUNS])
def test_block_plain_version_matches_tpu_kernel_new_profiles(width, fresh_rows):
    """The 8 new profiles at each width, and the bf16 profile at the three
    wide heads, at W8A8's bounds (max 2^-4) or those of bf16 rounding
    points (max 2^-5); mean 2^-8."""
    profiles = dict(FRESH_RUNS)[width]
    for p in profiles:
        max_abs, mean_abs = fresh_rows[width, p]
        bound = 2 ** -4 if PROFILES[p][3] == "int8" else 2 ** -5
        assert max_abs <= bound and mean_abs <= 2 ** -8, (width, p, max_abs, mean_abs)


@pytest.mark.parametrize("width", ["dh160", "dh256", "dh384"])
def test_block_plain_version_matches_tpu_kernel_fp32_wide_heads(width):
    got, ref = _block_pair(width, "float32")
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [160, 256, 384])
def test_attention_plain_version_matches_tpu_kernel_wide_heads(dh, dtype):
    B, H, T = 3, 2, 40
    lengths = np.array([T, T - 11, 0])
    mask = np.arange(T)[None, :] < lengths[:, None]
    r = np.random.RandomState(dh)
    q, k, v = (r.randn(B, H, T, dh).astype(np.float32) for _ in range(3))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    if dtype == "bfloat16":
        q, k, v = (np.array(jnp.asarray(a, jdt).astype(jnp.float32)) for a in (q, k, v))
    ref = pattn.fused_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                jnp.asarray(mask), interpret=True)
    got = katt.fused_attention_plain(*(torch.from_numpy(a).to(DT[dtype]) for a in (q, k, v)),
                                     torch.from_numpy(mask))
    assert tuple(got.shape) == (B, H, T, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("profile", [*NEW, "bf16", "float32"])
@pytest.mark.parametrize("width", ["d136", "dh160"])
def test_plain_version_on_the_padded_layout_equals_the_unpadded(width, profile):
    """d_ff, head and d_model padding (and the true-width LayerNorm) change
    no value in the new profiles: the padded layout's output, cut to
    d_model, equals the unpadded layout's bit for bit, and its padded
    columns are zeros. d136: d 136 (pitch 144), 2 heads of 68 (to 128), ff
    200 (to 208); dh160: d 328 (pitch 336), 2 heads of 164 (to 256)."""
    D, H, FF, K = {"d136": (136, 2, 200, 5), "dh160": (328, 2, 136, 5)}[width]
    cd, rd, sm, q = ((DT[n] if isinstance(n, str) and n in DT else n)
                     for n in PROFILES[profile])
    stack = ConformerStack(ConformerConfig(d_model=D, n_heads=H, d_ff=FF, kernel_size=K), 1)
    stack.init(torch.Generator().manual_seed(3))
    sd = stack.blocks[0].state_dict()
    x = torch.randn(2, 29, D, generator=torch.Generator().manual_seed(4))
    lengths = torch.tensor([29, 11], dtype=torch.int32)
    kw = dict(n_heads=H, kernel_size=K, compute_dtype=cd, residual_dtype=rd,
              attn_softmax_dtype=sm, quantize=q)
    y0 = kcb.conformer_block(kcb.fold_block_params(sd, compute_dtype=cd, quantize=q),
                             x.to(rd), lengths, **kw)
    fp = kcb.fold_block_params(sd, compute_dtype=cd, quantize=q, n_heads=H)
    plan = kcb.block_plan(D, H, FF, K, compute_dtype=cd, residual_dtype=rd,
                          attn_softmax_dtype=sm, quantize=q)
    assert fp["ffn1_w1"].shape == (plan.pitch, plan.ff_pad)
    assert fp["wqkv"].shape == (plan.pitch, 3 * plan.inner)
    xp = torch.nn.functional.pad(x, (0, plan.pitch - D)).to(rd)
    yp = kcb.conformer_block(fp, xp, lengths, d_model=D, **kw)
    assert yp.dtype == rd
    assert torch.equal(yp[..., :D], y0)
    assert not yp[..., D:].any()


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_launch_plan_of_all_sixteen_mixes_and_wide_heads(quantize):
    bf, f32 = torch.bfloat16, torch.float32
    want = {(bf, bf): "w8a8", (bf, f32): "w8a8_res_f32", (f32, f32): "w8a8_f32",
            (f32, bf): "w8a8_f32_res_bf16"} if quantize else {
        (bf, bf): "bf16", (bf, f32): "bf16_res_f32", (f32, bf): "f32_res_bf16"}
    seen = set()
    for cd in (bf, f32):
        for rd in (bf, f32):
            for sm in (bf, f32):
                for D, H, FF, K, dhp in ((144, 4, 576, 32, 48), (320, 2, 640, 31, 256),
                                         (256, 1, 1024, 31, 256), (768, 2, 3072, 31, 384),
                                         (1024, 4, 4096, 31, 256)):
                    plan = kcb.block_plan(D, H, FF, K, compute_dtype=cd, residual_dtype=rd,
                                          attn_softmax_dtype=sm, quantize=quantize)
                    entry = want.get((cd, rd)) or ("f32" if sm == f32 else "f32_sm_bf16")
                    assert plan.entry == entry and plan.entry in kcb.ENTRIES
                    assert plan.head_pad == dhp == katt.padded_head(D // H)
                    assert plan.conv_channels % 8 == 0 and plan.conv_channels >= 8
                    quant = quantize == "int8"
                    # W8A8's quantized conv rows fit whole in a block to d ~920
                    # (bf16 compute) and ~610 (float32: 4 bytes a value)
                    assert plan.conv_split == (quant and D >= (768 if cd == f32 else 1024))
                    assert plan.lnq_wide == (quant and plan.pitch > kcb.LNQ_MAX_D)
                    seen.add(plan.entry)
    assert len(seen) == (4 if quantize else 5)


@pytest.mark.parametrize("profile", ["w8a8_f32-sm_f32", "f32_res_bf16-sm_bf16"])
def test_early_conformer_exit_ids_match_jax_new_profiles(profile):
    """A 2-block early conformer (d 144, an exit after each block), fused,
    seeded, in float32 compute with W8A8 and with a bf16 residual: the
    port (the block's plain version on the padded layout) against the JAX
    package (the Pallas kernel in interpret mode) on the same random
    features: every exit's argmax ids equal where JAX's top two logits are
    more than 0.05 apart (the rest are ties of rounding), and at least 99%
    of all ids."""
    cd, rd, sm, q = PROFILES[profile]
    kw = dict(d_model=144, n_heads=4, d_feed_forward=576, depthwise_kernel_size=32,
              n_enc_exits=2, n_enc_layers_per_exit=1, compute_dtype=cd, residual_dtype=rd,
              attn_softmax_dtype=sm, quantize=q or "none", fused_block=True)
    jcfg, pcfg = JaxModelConfig(**kw), ModelConfig(**kw)
    params, state = jec.init(jax.random.PRNGKey(7), jcfg)
    r = np.random.RandomState(8)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * r.randn(*a.shape)).astype(np.float32), params)
    state = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), state)
    feats = r.randn(2, 160, jcfg.n_mels).astype(np.float32)
    lengths = np.array([160, 101], np.int32)
    jl, jsl, _ = jec.apply(params, state, jnp.asarray(feats), jnp.asarray(lengths), jcfg,
                           train=False, log_probs=False)
    jl, jsl = np.asarray(jl, np.float32), np.asarray(jsl)
    model = interop.from_jax_params(params, state, pcfg)
    with torch.no_grad():
        pl, psl = model.apply(torch.from_numpy(feats), torch.from_numpy(lengths),
                              log_probs=False)
    np.testing.assert_array_equal(psl.numpy(), jsl)
    assert pl.shape == jl.shape and pl.shape[0] == 2
    valid = np.arange(jl.shape[2])[None, :] < jsl[:, None]
    got, want = pl.float().numpy().argmax(-1)[:, valid], jl.argmax(-1)[:, valid]
    top2 = np.sort(jl, -1)[..., -2:][:, valid]
    clear = top2[..., 1] - top2[..., 0] > 0.05
    np.testing.assert_array_equal(got[clear], want[clear])
    assert (got == want).mean() >= 0.99
