"""`python -m early_exit_tpu_torch.multiprocess_smoke --device cpu`: 4 gloo
ranks on the meshes data=2 x model=2 and replica=2 x data=1 x model=2
take the tiny flagship's 2 train steps within the JAX package's
tolerances of the single rank's (its own checks; exit 0). Without
--device it runs on CUDA, and raises here."""

import os
import subprocess
import sys

import pytest
import torch

from early_exit_tpu_torch import multiprocess_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_smoke_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run([sys.executable, "-m", "early_exit_tpu_torch.multiprocess_smoke",
                          "--device", "cpu"], capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=300)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    assert "multiprocess_smoke ok: 4 ranks (gloo, cpu)" in run.stdout
    assert run.stdout.count("step 1:") == 2 and run.stdout.count("step 2:") == 2


def test_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multiprocess_smoke.main([])
