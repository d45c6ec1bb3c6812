"""The Conformer block kernel's plain PyTorch version is the TPU kernel's
arithmetic, op for op.

XLA's CPU backend keeps bf16 elementwise chains in float32 where it
fuses them ("excess precision"), so in-process the two differ by a few
bf16 ulps (tests/test_torch_conformer_block.py bounds that). With
--xla_allow_excess_precision=false every bf16 op rounds as written, and
the plain version must then equal `fused_block_apply(..., interpret=True)`
value for value, in the bf16 profile with either softmax dtype. The flag
must be set before JAX starts, so the comparison runs in a fresh process
on the inputs of tests/test_torch_conformer_block.py.

Tolerance: at most 1% of the output values may differ, by at most 2^-5.
XLA and PyTorch implement exp separately; where the two differ by a
float32 ulp, a rare exponential rounds to the other bf16 neighbour and
moves the outputs of its query row. With excess precision a third of the
values differ, so the bound still tells the two schedules apart.
"""

import os
import subprocess
import sys

TESTS = os.path.dirname(os.path.abspath(__file__))

_EXACT = """
import sys
sys.path.insert(0, {tests!r})
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
import numpy as np
import test_torch_conformer_block as t
for sm in ("bfloat16", "float32"):
    got, ref = t._plain_and_kernel_ref("bfloat16", sm)
    d = np.abs(got - ref)
    print(sm, float(d.max()), float((d > 0).mean()))
"""


def test_plain_version_is_bit_exact_without_excess_precision():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    out = subprocess.run([sys.executable, "-c", _EXACT.format(tests=TESTS)],
                         cwd=os.path.dirname(TESTS), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = {ln.split()[0]: [float(v) for v in ln.split()[1:]]
            for ln in out.stdout.split("\n") if ln}
    assert set(rows) == {"bfloat16", "float32"}, out.stdout
    for sm, (max_abs, frac) in rows.items():
        assert max_abs <= 2 ** -5 and frac <= 0.01, (sm, max_abs, frac)
