"""The three kernels at every width the JAX package's Pallas kernels take
and in the two profiles the card added (float32 compute with the bf16
softmax; bf16 compute with a float32 residual), on the card's padded
layout, against those kernels in interpret mode on the same numpy
inputs; the padded layout against the unpadded one; the launch plan.

- The block (`fused_block_apply(..., interpret=True)`) at Conformer-S
  (d 144, 4 heads of 36, ff 576, k 32), the dress rehearsal's width (d
  64, 4 heads, ff 128, k 7) and d 196 (4 heads of 49, ff 784, k 31, d
  not a multiple of 8), B=2, T'=37 with one short item, through the
  port's `conformer_block_plain` on the padded layout
  (`fold_block_params(..., n_heads=H)`, the residual padded to its pitch,
  `d_model` the true width). Tolerances: float32 atol 2e-5 rtol 1e-5
  (tests/test_torch_conformer_block.py's); the profiles with bf16
  rounding points, as tests/test_torch_kernel_widths.py holds them
  without XLA's excess precision (in a fresh process): bf16, float32
  compute with the bf16 softmax and bf16 compute with the float32
  residual max 2^-5, mean 2^-8; W8A8 max 2^-4, mean 2^-8.
- The head + argmax (`head_argmax(..., interpret=True)`) at D 144 and 196
  on dyadic inputs: ids equal.
- The attention (`fused_attention(..., interpret=True)`) at dh 36 and 49,
  float32 and bf16 inputs: 1e-5 absolute.
- The plain version on the padded layout against the plain version on
  the unpadded one, in every profile, value for value (the padding is
  exact zeros and the LayerNorms count the true width).
- `block_plan` of each width in each profile, of heads past 128 and of
  the 16 dtype mixes (each was refused by name until the last of them
  was ported).
- A 2-block Conformer-S early conformer, fused, float32: the port's exit
  ids against the JAX package's, equal.
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
from early_exit_tpu.ops.pallas import head_argmax as jha
from early_exit_tpu_torch import interop
from early_exit_tpu_torch.configs import ModelConfig
from early_exit_tpu_torch.models.conformer import ConformerConfig, ConformerStack
from early_exit_tpu_torch.ops.kernels import attention as katt
from early_exit_tpu_torch.ops.kernels import conformer_block as kcb
from early_exit_tpu_torch.ops.kernels import head_argmax as kha

from torch_one_thread import one_thread  # noqa: F401  (autouse fixture)

TESTS = os.path.dirname(os.path.abspath(__file__))
# (d_model, n_heads, d_ff, kernel_size)
WIDTHS = {"conformer_s": (144, 4, 576, 32), "rehearsal": (64, 4, 128, 7),
          "d196": (196, 4, 784, 31)}
# profile -> (compute, residual, softmax, quantize)
PROFILES = {"float32": ("float32", "float32", "float32", None),
            "f32_sm_bf16": ("float32", "float32", "bfloat16", None),
            "bf16": ("bfloat16", "bfloat16", "bfloat16", None),
            "w8a8": ("bfloat16", "bfloat16", "float32", "int8"),
            "bf16_res_f32": ("bfloat16", "float32", "bfloat16", None)}
DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _block_weights(jcfg, D, seed):
    params, _ = jconf.stack_init(jax.random.PRNGKey(seed), jcfg, 1)
    r = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * r.randn(*a.shape)).astype(np.float32), params)
    state = {"conv_bn": {"mean": (0.1 * r.randn(1, D)).astype(np.float32),
                         "var": (1 + 0.5 * r.rand(1, D)).astype(np.float32)}}
    return params, state


def _port_block(width, profile, seed=11):
    D, H, FF, K = WIDTHS[width]
    compute, residual, softmax, quantize = PROFILES[profile]
    kw = dict(d_model=D, n_heads=H, d_ff=FF, kernel_size=K, compute_dtype=compute,
              residual_dtype=residual, attn_softmax_dtype=softmax)
    jcfg, pcfg = jconf.ConformerConfig(dropout=0.0, **kw), ConformerConfig(**kw)
    params, state = _block_weights(jcfg, D, seed)
    block = interop.load_stack(ConformerStack(pcfg, 1), params, state).blocks[0]
    return jcfg, pcfg, params, state, block


def _inputs(D):
    B, T = 2, 37
    r = np.random.RandomState(12)
    return r.randn(B, T, D).astype(np.float32), np.array([T, T - 15], np.int32)


def _block_pair(width, profile):
    """(the plain version's output on the padded layout, cut to d_model;
    the TPU kernel's in interpret mode) of one seeded block, float32."""
    D, H, FF, K = WIDTHS[width]
    quantize = PROFILES[profile][3]
    jcfg, pcfg, params, state, block = _port_block(width, profile)
    x, lengths = _inputs(D)
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


@pytest.mark.parametrize("width", list(WIDTHS))
def test_block_plain_version_matches_tpu_kernel_fp32_any_width(width):
    got, ref = _block_pair(width, "float32")
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)


_EXACT = """
import sys
sys.path.insert(0, {tests!r})
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
import numpy as np
import test_torch_kernel_widths_any as t
for p in ("bf16", "w8a8", "f32_sm_bf16", "bf16_res_f32"):
    got, ref = t._block_pair({width!r}, p)
    d = np.abs(got - ref)
    print(p, float(d.max()), float(d.mean()), float((d > 0).mean()))
"""


@pytest.mark.parametrize("width", list(WIDTHS))
def test_block_plain_version_matches_tpu_kernel_bf16_profiles_any_width(width):
    """The four profiles with bf16 rounding points, in a fresh process with
    --xla_allow_excess_precision=false, at tests/test_torch_kernel_widths.py's
    bounds (that file says why the flag)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    out = subprocess.run([sys.executable, "-c", _EXACT.format(tests=TESTS, width=width)],
                         cwd=os.path.dirname(TESTS), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = {ln.split()[0]: [float(v) for v in ln.split()[1:]]
            for ln in out.stdout.split("\n") if ln}
    assert set(rows) == {"bf16", "w8a8", "f32_sm_bf16", "bf16_res_f32"}, out.stdout
    for p, (max_abs, mean_abs, _) in rows.items():
        bound = 2 ** -4 if p == "w8a8" else 2 ** -5
        assert max_abs <= bound and mean_abs <= 2 ** -8, (width, p, max_abs, mean_abs)


@pytest.mark.parametrize("profile", list(PROFILES))
@pytest.mark.parametrize("width", [*WIDTHS, "tiny", "d136"])
def test_plain_version_on_the_padded_layout_equals_the_unpadded(width, profile):
    """d_ff, head and d_model padding (and the true-width LayerNorm) change
    no value: the padded layout's output, cut to d_model, equals the
    unpadded layout's bit for bit, and its padded columns are zeros. tiny:
    4 heads of 8 (padded to 16); d136: d 136 (pitch 144), 2 heads of 68
    (to 128 in bf16), ff 200 (to 208)."""
    D, H, FF, K = {**WIDTHS, "tiny": (32, 4, 64, 7), "d136": (136, 2, 200, 5)}[width]
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
    plan = kcb.block_plan(D, H, FF, K, **{k: v for k, v in kw.items() if k != "n_heads"
                                          and k != "kernel_size"})
    assert fp["ffn1_w1"].shape == (plan.pitch, plan.ff_pad)
    assert fp["wqkv"].shape == (plan.pitch, 3 * plan.inner)
    xp = torch.nn.functional.pad(x, (0, plan.pitch - D)).to(rd)
    yp = kcb.conformer_block(fp, xp, lengths, d_model=D, **kw)
    assert torch.equal(yp[..., :D], y0)
    assert not yp[..., D:].any()


@pytest.mark.parametrize("D", [144, 196])
def test_head_plain_version_matches_tpu_kernel_any_width(D):
    E, B, T = 2, 3, 21
    r = np.random.RandomState(D)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    for V in (32, 256):
        h = bf(r.randint(-4, 5, (E, B, T, D)) / 4)
        w = bf(r.randint(-4, 5, (E, D, V)) / 16)
        b = bf(r.randint(-8, 9, (E, V)) / 16)
        jx = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        ref = np.asarray(jha.head_argmax(jx(h), jx(w), jx(b), interpret=True))
        got = kha.head_argmax_plain(h, w, b)
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [36, 49])
def test_attention_plain_version_matches_tpu_kernel_any_width(dh, dtype):
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


def test_launch_plan_of_every_width_and_the_refusals_by_name():
    bf, f32 = torch.bfloat16, torch.float32
    for (D, H, FF, K) in [*WIDTHS.values(), (1024, 8, 4096, 31), (256, 8, 2048, 31)]:
        for name, (cd, rd, sm, q) in PROFILES.items():
            plan = kcb.block_plan(D, H, FF, K, compute_dtype=DT[cd], residual_dtype=DT[rd],
                                  attn_softmax_dtype=DT[sm], quantize=q)
            assert plan.pitch % 16 == 0 and plan.pitch - D < 16
            assert plan.head_pad >= plan.head_dim and plan.ff_pad % 16 == 0
            assert plan.head_pad in kcb.HEAD_WIDTHS
            assert plan.head_pad == kcb.padded_head(plan.head_dim)
            assert plan.conv_channels % 8 == 0 and plan.conv_channels >= 8
    s = kcb.block_plan(144, 4, 576, 32)
    assert (s.entry, s.pitch, s.head_pad, s.ff_pad) == ("bf16", 144, 48, 576)
    assert kcb.block_plan(144, 4, 576, 32, compute_dtype=f32, residual_dtype=f32).head_pad == 48
    d196 = kcb.block_plan(196, 4, 784, 31, quantize="int8", attn_softmax_dtype=bf)
    assert (d196.entry, d196.pitch, d196.head_pad) == ("w8a8", 208, 64)
    big = kcb.block_plan(1024, 8, 4096, 31, quantize="int8")
    assert big.conv_split and big.lnq_wide and big.head_pad == 128
    f_big = kcb.block_plan(1024, 8, 4096, 31, compute_dtype=f32, residual_dtype=f32)
    assert f_big.conv_channels < 1024 and not f_big.conv_split
    flagship = kcb.block_plan(256, 8, 2048, 31)
    assert (flagship.pitch, flagship.head_pad, flagship.ff_pad, flagship.conv_channels) == (
        256, 32, 2048, 256)
    # what was queued last (ROADMAP Queue B') is planned: heads past 128
    # pad to a multiple of 128, and every one of the 16 mixes has its entry
    for D, H, dhp in ((640, 4, 256), (1024, 4, 256), (768, 2, 384)):
        wide = kcb.block_plan(D, H, 4 * D, 31)
        assert (wide.entry, wide.head_dim, wide.head_pad, wide.inner) == (
            "bf16", D // H, dhp, H * dhp)
    entries = set()
    for cd in (bf, f32):
        for rd in (bf, f32):
            for sm in (bf, f32):
                for q in (None, "int8"):
                    plan = kcb.block_plan(144, 4, 576, 32, compute_dtype=cd, residual_dtype=rd,
                                          attn_softmax_dtype=sm, quantize=q)
                    assert plan.entry in kcb.ENTRIES and plan.head_pad == 48
                    assert plan.entry.startswith("w8a8") == (q == "int8")
                    entries.add(plan.entry)
    assert entries == set(kcb.ENTRIES)
    for cd, rd, q, entry in ((f32, f32, "int8", "w8a8_f32"), (bf, f32, "int8", "w8a8_res_f32"),
                             (f32, bf, None, "f32_res_bf16")):
        assert kcb.block_plan(144, 4, 576, 32, compute_dtype=cd, residual_dtype=rd,
                              quantize=q).entry == entry


def test_conformer_s_two_blocks_exit_ids_match_jax():
    """A 2-block Conformer-S early conformer (an exit after each block),
    fused block, float32, seeded: the port (the block's plain version on
    the padded layout) against the JAX package (the Pallas kernel in
    interpret mode) on the same random features: every exit's argmax ids
    equal and the logits within 1e-4."""
    kw = dict(d_model=144, n_heads=4, d_feed_forward=576, depthwise_kernel_size=32,
              n_enc_exits=2, n_enc_layers_per_exit=1, compute_dtype="float32",
              attn_softmax_dtype="float32", fused_block=True)
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
    np.testing.assert_allclose(pl.float().numpy(), jl, atol=1e-4, rtol=0)
    valid = np.arange(jl.shape[2])[None, :] < jsl[:, None]
    np.testing.assert_array_equal(pl.float().numpy().argmax(-1)[:, valid],
                                  jl.argmax(-1)[:, valid])


def test_export_of_a_model_off_the_pitch_captures_the_padded_block(tmp_path):
    """A fused model whose d_model (20) is off the pitch of 16 and whose
    heads (4 of 5) pad to 16 exports for the CPU with one
    `eet::conformer_block` node a block (the residual padded once before
    the blocks and cut after them inside the program) and serves from its
    bundle as the eager serving function does: tokens, counts and
    confidences equal."""
    from early_exit_tpu_torch.configs import AudioConfig
    from early_exit_tpu_torch.models.registry import build_model
    from early_exit_tpu_torch.serving import export as exp
    cfg = ModelConfig(d_model=20, n_heads=4, d_feed_forward=40, n_enc_exits=2,
                      n_enc_layers_per_exit=1, depthwise_kernel_size=5, vocab_size=12,
                      n_mels=16, compute_dtype="float32", residual_dtype="float32",
                      attn_softmax_dtype="float32", fused_block=True)
    model = build_model(cfg)
    model.init(torch.Generator().manual_seed(5))
    model = model.eval()
    assert model.stack.folded()[0]["wqkv"].shape == (32, 3 * 4 * 16)
    acfg = AudioConfig(n_mels=16)
    path = str(tmp_path / "d20.eetx")
    bundle = exp.export_recognizer(model, acfg, [(2, 4000)], platforms=("cpu",))
    exp.save_bundle(path, bundle)
    assert bundle.manifest["op_nodes"]["cpu"]["2x4000"] == {"eet::conformer_block": 2}
    r = np.random.RandomState(6)
    wav = (0.1 * r.randn(2, 4000)).astype(np.float32)
    n = np.array([4000, 3200], np.int32)
    with torch.no_grad():
        ref = exp.make_serve_fn(model, acfg)(torch.from_numpy(wav), torch.from_numpy(n))
    got = exp.ExportedRecognizer(path, device="cpu")(wav, n)
    for g, w in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g), w.numpy())
