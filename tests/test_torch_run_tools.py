"""The port's run tools against the JAX package's on the CPU:
`promote_flagship`, `reference_scale_run`, `dress_rehearsal` and
`calibrate_shift_demo`.

- promote_flagship: on a tiny float32 checkpoint (`ModelConfig` patched
  to the test dims in both packages), `flagship_ckpt` byte for byte and
  `flagship_calib.json` equal to `tools/promote_flagship.py`'s; --out_dir
  is required.
- reference_scale_run, dress_rehearsal, calibrate_shift_demo: with
  `subprocess.run` patched to answer each child process with canned CLI
  lines (and, for `calibrate_gate`, a calibration file; for the trainer,
  checkpoint files), both tools write the same corpus files, run the
  same command lines (`python -m early_exit_tpu_torch.<tool>` in place of
  the JAX scripts, `--device` in place of EET_PLATFORM), and print the
  same lines and summary; the rehearsal's checks exit with the JAX
  tool's messages.
"""

import contextlib
import functools
import io
import json
import os
import subprocess
import sys

import jax
import pytest

from early_exit_tpu.configs import ModelConfig as JModelConfig
from early_exit_tpu.models import early_conformer as jec
from early_exit_tpu.training import checkpoint as jck
from early_exit_tpu_torch import calibrate_shift_demo, dress_rehearsal, promote_flagship
from early_exit_tpu_torch import reference_scale_run, runtime
from early_exit_tpu_torch import configs as port_configs

TINY = dict(d_model=32, n_heads=4, d_feed_forward=64, n_enc_exits=3,
            n_enc_layers_per_exit=1, depthwise_kernel_size=7)
CALIB = {
    "split": "dev-clean", "eval_utts": 240, "target_wer_delta_pp": 0.5,
    "final_exit_wer_pct": 7.5, "score": "maxprob",
    "thresholds": [0.9, 0.8, 0.7, 0.6, 0.5, 0.0],
    "temperatures": [2.0, 1.5, 1.0, 1.0, 1.0, 1.0],
    "per_score": {"maxprob": {
        "mean_exit": 2.4, "gated_wer_pct": 7.9,
        "per_exit": [{"exit": e, "accept_share": s}
                     for e, s in enumerate([0.2, 0.6, 0.05, 0.05, 0.05, 0.05], 1)]}},
}


def _stdout(fn, *a):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*a)
    return buf.getvalue()


def test_promote_flagship_equals_jax(tmp_path, monkeypatch):
    import early_exit_tpu.configs as jconfigs
    import tools.promote_flagship as jtool
    monkeypatch.setattr(jconfigs, "ModelConfig", functools.partial(JModelConfig, **TINY))
    monkeypatch.setattr(port_configs, "ModelConfig",
                        functools.partial(port_configs.ModelConfig, **TINY))
    cfg = JModelConfig(**TINY)
    params, state = jec.init(jax.random.PRNGKey(0), cfg)
    ckpt = str(tmp_path / "mod007-transformer")
    jck.save_pytree({"params": params, "model_state": state}, ckpt)
    calib = tmp_path / "gate_calib.json"
    calib.write_text(json.dumps(CALIB))
    argv = ["--ckpt", ckpt, "--calib", str(calib), "--knobs", '{"min_words": 18, "noise": 0.05}']
    jtool.main(argv + ["--out_dir", str(tmp_path / "jax")])
    out = _stdout(promote_flagship.main, argv + ["--out_dir", str(tmp_path / "port")])
    assert "wrote" in out
    for name in ("flagship_ckpt", "flagship_calib.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    got = json.loads((tmp_path / "port" / "flagship_calib.json").read_text())
    assert got["cascade_k"] == 2 and got["tokenizer"] == os.path.join(
        "assets", "spm", "synth.bpe-256.model")
    with pytest.raises(SystemExit):
        promote_flagship.main(argv)          # no --out_dir: refused


def _leg(cmd):
    """The tool a child process runs: its JAX script's or module's name."""
    if "-m" in cmd:
        return cmd[cmd.index("-m") + 1].rsplit(".", 1)[1]
    return os.path.splitext(os.path.basename(cmd[1]))[0]


def _fake_cli(seen, losses=(5.0, 4.0)):
    """subprocess.run answering each child process with canned lines."""
    def run(cmd, **kw):
        seen.append(list(cmd))
        leg, out = _leg(cmd), ""
        if leg == "train":
            d = cmd[cmd.index("--save_model_dir") + 1]
            os.makedirs(d, exist_ok=True)
            for e in range(1, len(losses) + 1):
                open(os.path.join(d, f"mod{e:03d}-transformer"), "w").close()
            out = "".join(f"LOSS_TOTAL-{e} := {loss:.4f}  ({10.0 - e:.1f}s, 3 sub-batches)\n"
                          for e, loss in enumerate(losses, 1))
        elif leg == "calibrate_gate":
            with open(cmd[cmd.index("--out") + 1], "w") as f:
                json.dump(CALIB, f)
        elif leg == "inference":
            root = cmd[cmd.index("--data_root") + 1] if "--data_root" in cmd else ""
            E = int(cmd[cmd.index("--n_enc_exits") + 1]) if "--n_enc_exits" in cmd else 6
            extra = sum(f in cmd for f in ("prefix_beam", "lexicon_beam", "--streaming",
                                           "--exit_threshold", "--gate_calibration",
                                           "--cascade_k", "--rescore_ctc_weight"))
            if "--lm_path" in cmd:
                out += "shallow fusion: lm.arpa (order 2, weight 0.5)\n"
            for si, split in enumerate(cmd[cmd.index("--eval_splits") + 1].split(",")):
                n = sum(len(fs) for _, _, fs in os.walk(os.path.join(root, "LibriSpeech",
                                                                       split))) - 1
                out += f"{split} EXPECTED: the cat\n" * max(n, 0)
                for e in range(1, E + 1):
                    out += f"{split} WER exit {e}: {10.0 * si + e + 0.5 * extra:.2f}% ({n} utts)\n"
                if "--exit_threshold" in cmd or "--gate_calibration" in cmd:
                    out += (f"{split} gated WER: {3.0 + si + extra:.2f}% (mean exits run "
                            f"{1.5 + si:.2f}/{E})\n")
                if "--cascade_k" in cmd:
                    out += f"{split} cascade exit histogram (utts per exit): {{1: 0, 2: {n}}}\n"
                if "--streaming" in cmd:
                    out += (f"{split} streaming WER exit {E}: {4.0 + si:.2f}% ({n} utts)"
                            + (f" (gated: mean exit 1.50/{E}, 50% of chunks at exit 1)"
                               if "--exit_threshold" in cmd else "") + "\n")
        else:
            out = "wrote\n"
        return subprocess.CompletedProcess(cmd, 0, out, "")
    return run


def _normal(cmds, work):
    """Command lines with the interpreter and script or module, the
    workdir and the port's --device taken out."""
    out = []
    for cmd in cmds:
        args = cmd[3:] if "-m" in cmd else cmd[2:]
        if "--device" in args:
            i = args.index("--device")
            args = args[:i] + args[i + 2:]
        out.append([_leg(cmd)] + [a.replace(work, "W") for a in args])
    return out


def _printed(out, work):
    """The printed lines but the echoed command lines ("+ ..."), compared
    on their own), the workdir taken out."""
    return [ln.replace(work, "W") for ln in out.splitlines() if not ln.startswith("+ ")]


def _files(root):
    found = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            if not os.path.islink(p):
                with open(p, "rb") as fh:
                    found[os.path.relpath(p, root)] = fh.read()
    return found


def _both(jtool, port_main, argv_j, argv_p, tmp_path, monkeypatch, losses=(5.0, 4.0)):
    """Runs the JAX tool and the port's under the fake CLI, each in its own
    workdir: (outputs, normalized commands, workdirs)."""
    res = {}
    for who, call, argv in (("jax", None, argv_j), ("port", port_main, argv_p)):
        work = str(tmp_path / who)
        seen = []
        monkeypatch.setattr(subprocess, "run", _fake_cli(seen, losses))
        full = [a.replace("{W}", work) for a in argv]
        if call is None:
            monkeypatch.setattr(sys, "argv", [jtool.__file__] + full)
            out = _stdout(jtool.main)
        else:
            out = _stdout(call, full)
        res[who] = (out, _normal(seen, work), work)
    return res


@pytest.mark.parametrize("mode", ["ctc", "aed"])
def test_reference_scale_run_equals_jax(mode, tmp_path, monkeypatch):
    import tools.reference_scale_run as jtool
    argv = ["--workdir", "{W}", "--n_train", "2", "--n_test", "2", "--n_dev", "2",
            "--epochs", "2", "--decoder_mode", mode, "--noise_hi", "0.55",
            "--speaker_warp", "0.15", "--dur_jitter", "0.3", "--amp_jitter", "0.4",
            "--avg_last", "2"]
    res = _both(jtool, reference_scale_run.main, argv, argv + ["--device", "cpu"],
                tmp_path, monkeypatch)
    (jout, jcmds, jwork), (pout, pcmds, pwork) = res["jax"], res["port"]
    assert pcmds == jcmds
    assert _printed(pout, pwork)[:-1] == _printed(jout, jwork)[:-1]
    legs = [c[0] for c in pcmds]
    assert legs[0] == "train" and legs.count("inference") == (3 if mode == "aed" else 6)
    assert ("calibrate_gate" in legs) == (mode == "ctc")
    # the summary: the JAX tool's, plus the evaluation audio and each leg's time
    summary = json.loads(pout.splitlines()[-1])
    timed = summary.pop("legs")
    assert [t["leg"] for t in timed][0] == "train" and len(timed) == len(pcmds)
    assert all(t["wall_s"] >= 0 for t in timed)
    assert set(summary.pop("eval_audio_s")) == {"test-clean", "dev-clean", "test-other"}
    assert json.loads(json.dumps(summary).replace(pwork, "W")) == \
        json.loads(jout.splitlines()[-1].replace(jwork, "W"))
    assert summary["eval_utts"] == 2 and summary["loss_last"] == 4.0
    if mode == "ctc":
        assert summary["cascade_k"] == 2 and summary["gated_cal_other_mean_exits"] == 2.5
        assert set(summary["greedy_wer_pct"]) == {f"exit{e}" for e in range(1, 7)}
    # the corpus: the same FLAC and transcript files, split by split
    jfiles, pfiles = _files(os.path.join(jwork, "corpus")), _files(os.path.join(pwork, "corpus"))
    assert pfiles == jfiles and sum(f.endswith(".flac") for f in pfiles) == 8


def test_reference_scale_run_skip_train_reuses_the_newest(tmp_path):
    moddir = tmp_path / "model_seed1"
    moddir.mkdir()
    for e in (3, 85, 12):
        (moddir / f"mod{e:03d}-transformer").write_bytes(b"")
    seen = []
    real = subprocess.run
    subprocess.run = _fake_cli(seen)
    try:
        summary = json.loads(_stdout(reference_scale_run.main, [
            "--workdir", str(tmp_path), "--skip_train", "--n_train", "1", "--n_test", "1",
            "--n_dev", "1", "--device", "cpu"]).splitlines()[-1])
    finally:
        subprocess.run = real
    assert summary["checkpoint"] == str(moddir / "mod085-transformer")
    assert all(_leg(c) != "train" for c in seen)
    assert all(c[c.index("--device") + 1] == "cpu" for c in seen)


@pytest.mark.parametrize("case", ["all_legs", "loss_rises"])
def test_dress_rehearsal_equals_jax(case, tmp_path, monkeypatch):
    import tools.dress_rehearsal as jtool
    argv = ["--workdir", "{W}", "--fast", "--legs", "ctc,lm,gated,streaming,aed"]
    losses = (5.0, 4.0) if case == "all_legs" else (4.0, 5.0)
    if case == "loss_rises":
        monkeypatch.setattr(subprocess, "run", _fake_cli([], losses))
        full = [a.replace("{W}", str(tmp_path / "jax")) for a in argv]
        monkeypatch.setattr(sys, "argv", [jtool.__file__] + full)
        with pytest.raises(SystemExit) as want:
            _stdout(jtool.main)
        full = [a.replace("{W}", str(tmp_path / "port")) for a in argv]
        with pytest.raises(SystemExit) as got:
            _stdout(dress_rehearsal.main, full + ["--device", "cpu"])
        assert str(got.value) == str(want.value) == "training did not improve: 4.0 -> 5.0"
        return
    res = _both(jtool, dress_rehearsal.main, argv, argv + ["--device", "cpu"], tmp_path,
                monkeypatch)
    (jout, jcmds, jwork), (pout, pcmds, pwork) = res["jax"], res["port"]
    assert pcmds == jcmds
    assert _printed(pout, pwork) == _printed(jout, jwork)
    assert [c[0] for c in pcmds] == ["train", "inference", "train_arpa", "inference",
                                     "inference", "inference", "inference", "train",
                                     "inference"]
    summary = json.loads(pout.splitlines()[-1])
    assert summary["test_utts"] == 6 and summary["lm_wer_pct"] and summary["aed_wer_pct"]
    assert _files(os.path.join(pwork, "corpus")) == _files(os.path.join(jwork, "corpus"))
    with open(os.path.join(pwork, "train_text.txt")) as a, \
            open(os.path.join(jwork, "train_text.txt")) as b:
        assert a.read() == b.read()


def test_calibrate_shift_demo_equals_jax(tmp_path, monkeypatch):
    import tools.calibrate_shift_demo as jtool
    argv = ["--workdir", "{W}", "--ckpt", "{W}/mod017-transformer", "--n_dev", "2"]
    res = _both(jtool, calibrate_shift_demo.main, argv, argv + ["--device", "cpu"],
                tmp_path, monkeypatch)
    (jout, jcmds, jwork), (pout, pcmds, pwork) = res["jax"], res["port"]
    assert pcmds == jcmds
    assert _printed(pout, pwork) == _printed(jout, jwork)
    assert [c[0] for c in pcmds] == ["calibrate_gate", "calibrate_gate", "inference",
                                     "inference", "inference"]
    summary = json.loads(pout.splitlines()[-1])
    assert set(summary) == {"checkpoint", "raw_scalar", "calibrated_dev-other",
                            "calibration_dev-other", "calibrated_dev-mixed",
                            "calibration_dev-mixed"}
    assert _files(os.path.join(pwork, "corpus")) == _files(os.path.join(jwork, "corpus"))


@pytest.mark.slow
def test_dress_rehearsal_end_to_end_on_the_cpu(tmp_path):
    """The whole rehearsal through real child processes on the CPU, every
    leg (~35 s: outside the default selection, as the JAX package's
    `tests/test_e2e_dress_rehearsal.py`)."""
    p = subprocess.run(
        [sys.executable, "-m", "early_exit_tpu_torch.dress_rehearsal", "--fast",
         "--device", "cpu", "--workdir", str(tmp_path), "--legs",
         "ctc,lm,gated,streaming,aed"],
        capture_output=True, text=True, timeout=600,
        env=runtime.child_env())
    assert p.returncode == 0, p.stderr[-3000:]
    summary = json.loads(p.stdout.strip().splitlines()[-1])
    assert summary["test_utts"] == 6 and summary["loss_last"] < summary["loss_first"]
    for key in ("lm_wer_pct", "gated_wer_pct", "streaming_wer_pct", "aed_wer_pct"):
        assert key in summary
