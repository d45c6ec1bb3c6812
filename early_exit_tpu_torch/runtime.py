"""Device selection, float32 precision settings, and the command line
that runs one of the package's entry points in a child process.

Entry points run on CUDA unless the caller asks for the CPU. Without a
GPU and without an explicit "cpu" they raise: nothing drifts to the CPU.
"""

from __future__ import annotations

import os
import sys

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on "
            "the CPU")
    return dev


def exact_float32() -> None:
    """Float32 products and convolutions in full float32 on the card.

    The mel features are raw power with a huge dynamic range, and TF32
    keeps about three decimal digits; cuBLAS's reduced-precision bf16
    reductions would also change the plain reference's sums. Sets
    process-wide torch flags."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def module_command(name: str) -> list:
    """argv that runs `python -m early_exit_tpu_torch.<name>`."""
    return [sys.executable, "-m", f"early_exit_tpu_torch.{name}"]


def child_env() -> dict:
    """This process's environment with the package's root first on
    PYTHONPATH, so that a child process started from any directory
    imports this checkout."""
    from early_exit_tpu_torch.checkpoint import REPO
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    return env
