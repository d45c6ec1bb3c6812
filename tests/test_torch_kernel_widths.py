"""The three kernels' plain PyTorch versions at the widths past the
flagship's that the JAX package's Pallas kernels take, against those
kernels in interpret mode, on the same numpy inputs; and the wrappers'
refusal, by name, of the widths the CUDA kernels still do not take.

- The block (`fused_block_apply(..., interpret=True)`) at d 128 with 2
  heads (dh 64, ff 256) and d 64 with 4 heads (dh 16, ff 128), k 7, in
  the float32, bf16 and W8A8 (bf16 profile) profiles, at the tolerances
  tests/test_torch_conformer_block.py states for d 32: float32 atol 2e-5
  rtol 1e-5; bf16 max 2^-5, mean 2^-8; W8A8 max 2^-4, mean 2^-8 (these
  two without XLA's excess precision, as the test says why).
- The attention (`fused_attention(..., interpret=True)`) at dh 16 and
  64, float32 and bf16 inputs, 1e-5 absolute (tests/test_torch_attention.py).
- The head + argmax (`head_argmax(..., interpret=True)`) at V 32, 128 and
  500 (D 64 and 128), ids equal, with exact ties forced across the
  256-column boundary of the CUDA kernel's V tiles.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from early_exit_tpu.models import conformer as jconf
from early_exit_tpu.ops.pallas import attention as pattn
from early_exit_tpu.ops.pallas import conformer_block as fcb
from early_exit_tpu.ops.pallas import head_argmax as jha
from early_exit_tpu_torch import interop
from early_exit_tpu_torch.models.conformer import ConformerConfig, ConformerStack
from early_exit_tpu_torch.ops.kernels import attention as katt
from early_exit_tpu_torch.ops.kernels import conformer_block as kcb
from early_exit_tpu_torch.ops.kernels import head_argmax as kha

TESTS = os.path.dirname(os.path.abspath(__file__))
K = 7
# (d_model, n_heads, d_ff): dh 64 and dh 16
WIDTHS = {"dh64": (128, 2, 256), "dh16": (64, 4, 128)}
# profile -> (compute, softmax, quantize)
PROFILES = {"float32": ("float32", "float32", None),
            "bf16": ("bfloat16", "bfloat16", None),
            "w8a8": ("bfloat16", "float32", "int8")}


def _block_weights(jcfg, D, seed):
    params, _ = jconf.stack_init(jax.random.PRNGKey(seed), jcfg, 1)
    r = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * r.randn(*a.shape)).astype(np.float32), params)
    state = {"conv_bn": {"mean": (0.1 * r.randn(1, D)).astype(np.float32),
                         "var": (1 + 0.5 * r.rand(1, D)).astype(np.float32)}}
    return params, state


def _block_pair(width, profile):
    """(the plain version's output, the TPU kernel's in interpret mode) of
    one seeded block at `width` in `profile`, as float32 numpy arrays."""
    D, H, FF = WIDTHS[width]
    compute, softmax, quantize = PROFILES[profile]
    kw = dict(d_model=D, n_heads=H, d_ff=FF, kernel_size=K, compute_dtype=compute,
              residual_dtype=compute, attn_softmax_dtype=softmax)
    jcfg, pcfg = jconf.ConformerConfig(dropout=0.0, **kw), ConformerConfig(**kw)
    params, state = _block_weights(jcfg, D, seed=11)
    B, T = 3, 40
    r = np.random.RandomState(12)
    x = r.randn(B, T, D).astype(np.float32)
    lengths = np.array([T, T - 13, 0], np.int32)
    layer = lambda tree: jax.tree_util.tree_map(lambda a: a[0], tree)
    folded = fcb.fold_block_params(layer(params), layer(state), compute_dtype=jcfg.dtype,
                                   quantize=quantize)
    ref = np.asarray(fcb.fused_block_apply(
        folded, jnp.asarray(x), jnp.asarray(lengths), n_heads=H, kernel_size=K,
        compute_dtype=jcfg.dtype, residual_dtype=jcfg.rdtype,
        attn_softmax_dtype=jcfg.sm_dtype, interpret=True, quantize=quantize), np.float32)
    block = interop.load_stack(ConformerStack(pcfg, 1), params, state).blocks[0]
    f = kcb.fold_block_params(block.state_dict(), compute_dtype=pcfg.dtype,
                              quantize=quantize)
    got = kcb.conformer_block_plain(
        f, torch.from_numpy(x), torch.from_numpy(lengths), n_heads=H, kernel_size=K,
        compute_dtype=pcfg.dtype, residual_dtype=pcfg.rdtype,
        attn_softmax_dtype=pcfg.sm_dtype, quantize=quantize).float().numpy()
    assert np.isfinite(got).all() and not got[2].any()    # the empty item
    return got, ref


@pytest.mark.parametrize("width", list(WIDTHS))
def test_block_plain_version_matches_tpu_kernel_fp32(width):
    got, ref = _block_pair(width, "float32")
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)


_EXACT = """
import sys
sys.path.insert(0, {tests!r})
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
import numpy as np
import test_torch_kernel_widths as t
for w in t.WIDTHS:
    for p in ("bf16", "w8a8"):
        got, ref = t._block_pair(w, p)
        d = np.abs(got - ref)
        print(w, p, float(d.max()), float(d.mean()), float((d > 0).mean()))
"""


def test_block_plain_version_matches_tpu_kernel_bf16_profiles():
    """The bf16 and W8A8 profiles, at the d-32 tolerances. In process,
    XLA's CPU backend keeps bf16 elementwise chains in float32 where it
    fuses them, and at d 128 that moves the JAX side past them (max 0.047
    in bf16, 0.094 in W8A8); with --xla_allow_excess_precision=false, set
    in a fresh process as tests/test_torch_conformer_block_exact.py sets
    it, every bf16 op rounds as written. What differs then (10% of the
    values at d 128, by at most 2^-5; none or under 0.4% at d 64) are
    the float32 sums of the products in another order: a sum at a bf16
    rounding boundary moves one value by an ulp, and the residual stream
    and the next LayerNorm carry that to the rest of its row."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    out = subprocess.run([sys.executable, "-c", _EXACT.format(tests=TESTS)],
                         cwd=os.path.dirname(TESTS), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = {tuple(ln.split()[:2]): [float(v) for v in ln.split()[2:]]
            for ln in out.stdout.split("\n") if ln}
    assert set(rows) == {(w, p) for w in WIDTHS for p in ("bf16", "w8a8")}, out.stdout
    for (w, p), (max_abs, mean_abs, _) in rows.items():
        bound = 2 ** -4 if p == "w8a8" else 2 ** -5
        assert max_abs <= bound and mean_abs <= 2 ** -8, (w, p, max_abs, mean_abs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [16, 64])
def test_attention_plain_version_matches_tpu_kernel(dh, dtype):
    B, H, T = 3, 2, 40
    lengths = np.array([T, T - 11, 0])
    mask = np.arange(T)[None, :] < lengths[:, None]
    r = np.random.RandomState(dh)
    q, k, v = (r.randn(B, H, T, dh).astype(np.float32) for _ in range(3))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    if dtype == "bfloat16":          # the same bf16 values on both sides
        q, k, v = (np.array(jnp.asarray(a, jdt).astype(jnp.float32)) for a in (q, k, v))
    ref = pattn.fused_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                jnp.asarray(mask), interpret=True)
    got = katt.fused_attention_plain(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                     torch.from_numpy(mask))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, T, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def _head_inputs(E, B, T, D, V, seed):
    """Small dyadic values: every product and every partial sum is exact in
    float32, so the sums do not depend on their order and both sides round
    the same logits to bf16; the ties that leaves (many, at V 500) are
    exact on both."""
    r = np.random.RandomState(seed)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return (bf(r.randint(-4, 5, (E, B, T, D)) / 4), bf(r.randint(-4, 5, (E, D, V)) / 16),
            bf(r.randint(-8, 9, (E, V)) / 16))


@pytest.mark.parametrize("D,V", [(64, 32), (128, 128), (128, 500)])
def test_head_plain_version_matches_tpu_kernel(D, V):
    E, B, T = 2, 3, 21
    h, w, b = _head_inputs(E, B, T, D, V, seed=V)
    if V > 256:
        # columns 255 and 256 tie exactly on every row of the first exit,
        # on either side of the kernel's V-tile boundary, and win there
        w[0, :, 256] = w[0, :, 255]
        b[0, 256] = b[0, 255] = 50.0
    jx = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    ref = np.asarray(jha.head_argmax(jx(h), jx(w), jx(b), interpret=True))
    got = kha.head_argmax_plain(h, w, b)
    assert got.dtype == torch.int32 and tuple(got.shape) == (E, B, T)
    np.testing.assert_array_equal(got.numpy(), ref)
    if V > 256:
        assert (got[0] == 255).all()                # the lower index of the tie


def test_head_tie_across_tiles_goes_to_the_lower_index():
    """A tie between column 100 and column 356 (the same place in two V
    tiles) and column 499 (the ragged last tile) goes to 100 on both
    sides, whatever the rows."""
    h, w, b = _head_inputs(2, 2, 9, 64, 500, seed=3)
    for c in (356, 499):
        w[:, :, c] = w[:, :, 100]
        b[:, c] = 100.0
    b[:, 100] = 100.0
    jx = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    ref = np.asarray(jha.head_argmax(jx(h), jx(w), jx(b), interpret=True))
    got = kha.head_argmax_plain(h, w, b).numpy()
    assert (got == 100).all() and (ref == 100).all()


def test_cuda_wrappers_refuse_the_widths_still_not_taken_by_name():
    """The launches check widths and types before they touch a library or
    a card, so the refusals run here: float16 in the attention and in the
    block (every width and every mix of bf16 and float32 is taken since
    the heads past 128 and the last four dtype mixes were ported), a block
    of no frames, a layout not padded for the card (the flagship's fold
    without n_heads at d 144), a head of no columns."""
    cpu = torch.device("cpu")
    q = torch.zeros(1, 2, 8, 160, dtype=torch.float16)
    with pytest.raises(ValueError, match="bf16 or float32"):
        katt._fused_attention_cuda(q, q, q, torch.ones(1, 8, dtype=torch.bool))
    hid = torch.zeros(1, 1, 4, 96, dtype=torch.bfloat16)
    w = torch.zeros(1, 96, 0, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="V >= 1"):
        kha._head_argmax_cuda(hid, w, torch.zeros(1, 0, dtype=torch.bfloat16))
    for D, H, FF, quantize, rd, n_heads, match, T in (
            (640, 4, 1280, None, "float16", 4, "unsupported residual dtype", 4),
            (256, 2, 512, "int8", "float32", 2, "T > 0", 0),
            (144, 4, 576, None, "bfloat16", None, "not padded for the card", 4)):
        cfg = ConformerConfig(d_model=D, n_heads=H, d_ff=FF, kernel_size=K)
        block = ConformerStack(cfg, 1).blocks[0]
        f = kcb.fold_block_params(block.state_dict(), quantize=quantize, n_heads=n_heads)
        x = torch.zeros(1, T, D, dtype=getattr(torch, rd), device=cpu)
        args = (x, torch.ones(1, dtype=torch.int32), kcb.op_params(f, quantize), H, K,
                "bfloat16", rd, "float32", quantize or "none")
        with pytest.raises((ValueError, NotImplementedError), match=match):
            kcb._conformer_block_cuda(*args)
