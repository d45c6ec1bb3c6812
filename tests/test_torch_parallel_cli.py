"""`torchrun -m early_exit_tpu_torch.train --dp 2 --tp 2 --device cpu`
against the single-rank CLI, and auto-resume across layouts, on the CPU
(one gloo world of 4 processes, the tiny flagship, float32, dropout 0).

A single-rank run takes three epochs. Beside it: one single-rank epoch,
then the 4-rank run resumes from its pair for the second epoch (the mesh
line printed once, by the first rank), then one rank resumes from the
4-rank run's pair (the gathered whole trees, the single-rank files) for
the third. Each epoch's LOSS_TOTAL equals the three-epoch run's within
rtol 2e-3 (the JAX package's next-step tolerance), and so does the
4-rank run's first logged step loss within 1e-4.
"""

import os
import re
import subprocess
import sys

import pytest

from early_exit_tpu_torch import train as port_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--decoder_mode", "ctc", "--synthetic_data", "true", "--device", "cpu",
        "--d_model", "32", "--n_enc_exits", "2", "--n_enc_layers_per_exit", "1",
        "--n_heads", "4", "--d_feed_forward", "64", "--depthwise_kernel_size", "7",
        "--batch_size", "8", "--n_batch_split", "1", "--n_workers", "1",
        "--drop_prob", "0", "--compute_dtype", "float32"]


def _losses(out):
    return {int(e): float(v) for e, v in re.findall(r"LOSS_TOTAL-(\d+) := ([\d.]+)", out)}


def _steps(out):
    return {int(s): float(v) for s, v in re.findall(r"step (\d+) loss ([\d.]+)", out)}


def _single(capsys, tmp, n):
    port_train.main(ARGS + ["--n_epochs", str(n), "--save_model_dir", str(tmp / "ck"),
                            "--log_dir", str(tmp / "runs")])
    return capsys.readouterr().out


def test_torchrun_dp2_tp2_resumes_across_layouts(tmp_path, capsys):
    whole = tmp_path / "whole"
    ref = _single(capsys, whole, 3)
    mixed = tmp_path / "mixed"
    first = _single(capsys, mixed, 1)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("WORLD_SIZE", None)
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "4", "-m", "early_exit_tpu_torch.train", *ARGS,
         "--dp", "2", "--tp", "2", "--n_epochs", "2",
         "--save_model_dir", str(mixed / "ck"), "--log_dir", str(mixed / "runs")],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=300,
        start_new_session=True)   # no signal torchrun sends its workers reaches pytest
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    four = run.stdout
    assert four.count("mesh: data=2 x model=2") == 1
    assert "auto-resume from epoch 0 (step 8)" in four
    last = _single(capsys, mixed, 3)
    assert "auto-resume from epoch 1 (step 16)" in last

    want = _losses(ref)
    got = {**_losses(first), **_losses(four), **_losses(last)}
    assert sorted(got) == [0, 1, 2] and sorted(want) == [0, 1, 2]
    for e in want:
        assert got[e] == pytest.approx(want[e], rel=2e-3), (e, got, want)
    step = min(_steps(four))
    assert _steps(four)[step] == pytest.approx(_steps(ref)[step], rel=1e-4)
    assert os.path.exists(mixed / "ck" / "lr001-transformer")
