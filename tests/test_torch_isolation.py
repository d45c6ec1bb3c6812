"""The port stands alone and never drifts to the CPU.

- Importing every module of `early_exit_tpu_torch` in a fresh process
  leaves `jax` and `early_exit_tpu` out of `sys.modules`.
- No source file of the port names the JAX package as a module.
- Entry points default to CUDA and raise without it; kernel wrappers
  raise on a device that is neither the CPU nor CUDA.
"""

import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "early_exit_tpu_torch")

_PROBE = """
import importlib, pkgutil, sys
import early_exit_tpu_torch
names = [m.name for m in pkgutil.walk_packages(early_exit_tpu_torch.__path__,
                                               "early_exit_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "early_exit_tpu"))
print(len(names), bad)
"""


def test_every_module_imports_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 38
    assert bad.strip() == "[]"


def test_gate_cascade_and_attention_modules_import():
    import importlib
    for name in ("models.early_exit_gate", "models.gate_calibration",
                 "serving.cascade", "ops.kernels.attention"):
        importlib.import_module("early_exit_tpu_torch." + name)


def test_every_cuda_source_is_listed_for_the_build():
    from early_exit_tpu_torch.ops.kernels import KERNEL_SOURCES, _build
    on_disk = {f[:-3] for f in os.listdir(_build.CSRC) if f.endswith(".cu")}
    assert on_disk == set(KERNEL_SOURCES)
    assert "attention" in KERNEL_SOURCES
    assert os.path.exists(os.path.join(_build.CSRC, "attention_f32.cuh"))


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(root, f)


def test_no_source_names_the_jax_package():
    pat = re.compile(r"early_exit_tpu\.|^\s*(import|from)\s+(jax|flax|early_exit_tpu)\b",
                     re.M)
    hits = []
    for path in list(_sources()) + [os.path.join(REPO, "chip_smoke.py"),
                                    os.path.join(REPO, "reproduce_flagship.py")]:
        with open(path) as f:
            hits += [f"{path}: {m.group(0)}" for m in pat.finditer(f.read())]
    assert not hits, hits


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from early_exit_tpu_torch import runtime
    from early_exit_tpu_torch.serving.recognizer import Recognizer
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Recognizer.from_flagship()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runtime.resolve_device()
    assert runtime.resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_other_devices():
    from early_exit_tpu_torch.ops.kernels import attention as katt
    from early_exit_tpu_torch.ops.kernels import conformer_block as kcb
    from early_exit_tpu_torch.ops.kernels import head_argmax as kha
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        katt.fused_attention(*(torch.empty(1, 8, 4, 32, device=meta)
                               for _ in range(3)),
                             torch.empty(1, 4, dtype=torch.bool, device=meta))
    with pytest.raises(ValueError, match="unsupported device"):
        kha.head_argmax(torch.empty(6, 1, 4, 32, device=meta),
                        torch.empty(6, 32, 256, device=meta),
                        torch.empty(6, 256, device=meta))
    with pytest.raises(ValueError, match="unsupported device"):
        kcb.conformer_block({}, torch.empty(1, 4, 32, device=meta),
                            torch.empty(1, dtype=torch.int32, device=meta),
                            n_heads=1, kernel_size=3)


def test_the_walk_reaches_the_inference_slice():
    """The import probe walks the inference CLI's modules, the native
    loader and its ctypes wrappers among them."""
    import pkgutil
    import early_exit_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(early_exit_tpu_torch.__path__,
                                                   "early_exit_tpu_torch.")}
    want = {"_native", "inference", "data.native", "data.flac", "data.librispeech",
            "decoding.native", "decoding.lexicon", "decoding.ngram_lm",
            "decoding.lexicon_beam", "decoding.prefix_beam", "decoding.forced_align",
            "decoding.timestamps", "decoding.api", "utils.model_utils"}
    assert {"early_exit_tpu_torch." + n for n in want} <= names


TOOLS = ("score_wer", "train_arpa", "plot_metrics", "streaming_demo",
         "streaming_gate_report", "dress_rehearsal", "reference_scale_run",
         "promote_flagship", "calibrate_shift_demo", "utils.epoch_timer",
         "utils.profiling")


def test_the_walk_reaches_the_tools():
    """The import probe walks the evaluation and profiling tools."""
    import pkgutil
    import early_exit_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(early_exit_tpu_torch.__path__,
                                                   "early_exit_tpu_torch.")}
    assert {"early_exit_tpu_torch." + n for n in TOOLS} <= names


def test_the_tools_default_to_cuda(tmp_path, monkeypatch):
    """streaming_demo raises without a GPU; the tools that start child
    processes hand them --device cuda unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from early_exit_tpu_torch import dress_rehearsal, streaming_demo, streaming_gate_report
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        streaming_demo.main(["--synthetic_data", "true", "--bpe", "false"])
    seen = []

    def refuse(cmd, **kw):
        seen.append(cmd)
        return subprocess.CompletedProcess(cmd, 1, "", "no GPU")

    monkeypatch.setattr(subprocess, "run", refuse)
    with pytest.raises(SystemExit):
        dress_rehearsal.main(["--fast", "--workdir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="leg failed"):
        streaming_gate_report.main(["--ckpt", "c", "--data_root", "d",
                                    "--out", str(tmp_path / "r.json")])
    assert len(seen) == 2
    for cmd in seen:
        assert cmd[1:3] == ["-m", cmd[2]] and cmd[2].startswith("early_exit_tpu_torch.")
        assert cmd[cmd.index("--device") + 1] == "cuda"
