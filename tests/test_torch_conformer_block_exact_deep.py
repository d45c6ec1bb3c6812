"""The block kernel's plain version against the TPU kernel at the
flagship's last block, on the input that block gets in the trained model.

tests/test_torch_conformer_block_exact.py holds the two equal on one
random block at small width. The CUDA kernel meets its plain version
within 1 ulp at the flagship's first block, but in the trained model's
later blocks 0.96-9.74% of values differ by 2-3 ulps. This test asks
whether the plain version keeps the TPU kernel's rounding points there:
one in-distribution utterance of about 4 s (the committed calibration's
bench_eval knobs, 9 words) runs through the flagship's first 11 blocks
on the plain path (the kernel's plain version, bf16 inference profile);
block 12's input and weights then go through
`fused_block_apply(..., interpret=True)` and through
`conformer_block_plain` in a fresh process, with
--xla_allow_excess_precision=false (every bf16 op rounds as written) and
--xla_cpu_max_isa=AVX (XLA's CPU backend contracts a * b + c into a
fused multiply-add where the CPU has one; the TPU kernel and the plain
version round the product first).

As the two run, 28% of block 12's outputs differ, by at most 2^-6. Three
things differ between them that are not rounding points: the order of
every float32 sum (the products, the softmax denominator, the LayerNorm
statistics), and the implementations of exp and rsqrt. The test takes
them out: on both sides every product and sum is taken in float64 and
rounded once to float32, and exp and rsqrt are taken in float64 and
rounded once to their input's type. Every op left is an IEEE
elementwise op or a cast, so the two must then be bit-exact, and are:
no rounding point of the TPU kernel is missing from the plain version.
(With only the products made exact, 3% of the outputs still differ.)

Held: the block as it runs, finite and within 2^-5 (one bf16 ulp of the
largest outputs); the block with the sums, exp and rsqrt made exact,
every value equal.
"""

import os
import subprocess
import sys

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)

_DEEP = """
import sys
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
import torch
from early_exit_tpu.ops.pallas import conformer_block as fcb
from early_exit_tpu_torch import checkpoint, interop
from early_exit_tpu_torch.configs import AudioConfig, inference_profile
from early_exit_tpu_torch.data.synthetic import SyntheticDataset
from early_exit_tpu_torch.ops import frontend
from early_exit_tpu_torch.ops.kernels import conformer_block as kcb

bf = torch.bfloat16
cfg = inference_profile(fused_block=True)
tree = checkpoint.load_tree(checkpoint.FLAGSHIP_CKPT)
model = interop.from_jax_params(tree["params"], tree["model_state"], cfg).eval()
knobs = dict(checkpoint.load_calib()["bench_eval"], min_words=9, max_words=9)
utt = SyntheticDataset(n_items=1, seed=4242, **knobs)[0]
acfg = AudioConfig(mel_method="dft")
wav = torch.from_numpy(utt.waveform)[None]
feats = frontend.mel_spectrogram(wav, acfg, method="dft")
lengths = frontend.mel_lengths(torch.tensor([wav.shape[1]]), acfg.hop_length)
L = len(model.stack.blocks)
with torch.no_grad():
    x, _, mask = model.frontend_embed(feats, lengths)
    x = model.stack(x, mask, n_layers=L - 1).contiguous()
lens = mask.sum(1, dtype=torch.int32)
kw = dict(n_heads=cfg.n_heads, kernel_size=cfg.depthwise_kernel_size,
          compute_dtype=bf, residual_dtype=bf, attn_softmax_dtype=bf)
f = model.stack.folded()[L - 1]

def jx(t):
    a = jnp.asarray(t.float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == bf else a

layer = lambda tr: jax.tree_util.tree_map(lambda a: jx(a[L - 1]), tr)
folded = fcb.fold_block_params(layer(tree["params"]["blocks"]),
                               layer(tree["model_state"]["blocks"]),
                               compute_dtype=jnp.bfloat16)

def tpu_kernel():
    jax.clear_caches()          # trace the kernel anew under the ops in force
    y = fcb.fused_block_apply(
        folded, jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(lens.numpy()), n_heads=cfg.n_heads,
        kernel_size=cfg.depthwise_kernel_size, compute_dtype=jnp.bfloat16,
        residual_dtype=jnp.bfloat16, attn_softmax_dtype=jnp.bfloat16,
        interpret=True)
    return np.asarray(y, np.float32)[:, :x.shape[1]]

def report(tag, got, ref):
    d = np.abs(got - ref)
    print(tag, float(d.max()), float((d > 0).mean()), int((d > 0).sum()), d.size,
          bool(np.isfinite(got).all()))

print("seconds", wav.shape[1] / acfg.sample_rate, "T'", x.shape[1])
report("block", kcb.conformer_block_plain(f, x, lens, **kw).float().numpy(), tpu_kernel())

# every sum in float64, rounded once to float32; exp and rsqrt in float64,
# rounded once to the input's type
f64, f32 = jnp.float64, jnp.float32
dot_general, jsum = jax.lax.dot_general, jnp.sum

def x_dot_general(a, b, dimension_numbers, precision=None,
                  preferred_element_type=None, **_):
    out = preferred_element_type or jnp.result_type(a, b)
    return dot_general(a.astype(f64), b.astype(f64), dimension_numbers,
                       preferred_element_type=f64).astype(f32).astype(out)

jax.lax.dot_general = x_dot_general
jnp.dot = lambda a, b, preferred_element_type=None, **_: x_dot_general(
    a, b, (((a.ndim - 1,), (0,)), ((), ())), preferred_element_type=preferred_element_type)
jnp.sum = lambda v, axis=None, keepdims=False, **_: jsum(
    v.astype(f64), axis=axis, keepdims=keepdims).astype(f32).astype(v.dtype)
jnp.mean = lambda v, axis=None, keepdims=False, **_: (jsum(
    v.astype(f64), axis=axis, keepdims=keepdims).astype(f32) / f32(v.shape[axis])).astype(v.dtype)
jnp.exp = (lambda e: lambda v: e(v.astype(f64)).astype(v.dtype))(jnp.exp)
jax.lax.rsqrt = lambda v: (1.0 / jnp.sqrt(v.astype(f64))).astype(v.dtype)
ref = tpu_kernel()

T = torch.Tensor
matmul, tsum, texp = torch.matmul, T.sum, torch.exp
torch.matmul = lambda a, b: matmul(a.double(), b.double()).float().to(
    torch.promote_types(a.dtype, b.dtype))
T.sum = lambda v, dim, keepdim=False: tsum(v.double(), dim, keepdim=keepdim).float().to(v.dtype)
T.mean = lambda v, dim, keepdim=False: (tsum(v.double(), dim, keepdim=keepdim).float()
                                        / float(v.shape[dim])).to(v.dtype)
torch.exp = lambda v: texp(v.double()).to(v.dtype)
torch.rsqrt = lambda v: (1.0 / torch.sqrt(v.double())).to(v.dtype)
report("exact_sums", kcb.conformer_block_plain(f, x, lens, **kw).float().numpy(), ref)
"""


def test_plain_version_against_the_tpu_kernel_at_block_12():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false --xla_cpu_max_isa=AVX")
    out = subprocess.run([sys.executable, "-c", _DEEP.format(repo=REPO)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    print(out.stdout)
    rows = {ln.split()[0]: ln.split()[1:] for ln in out.stdout.split("\n") if ln}
    secs, tp = float(rows["seconds"][0]), int(rows["seconds"][2])
    assert 3.0 <= secs <= 5.0 and tp > 64, rows["seconds"]
    assert rows["block"][-1] == "True", rows["block"]
    assert float(rows["block"][0]) <= 2 ** -5, rows["block"]
    # the sums, exp and rsqrt made exact on both sides: bit for bit
    assert rows["exact_sums"][-1] == "True", rows["exact_sums"]
    assert int(rows["exact_sums"][2]) == 0, rows["exact_sums"]
