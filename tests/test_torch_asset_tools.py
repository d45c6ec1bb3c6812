"""The asset tools of the port on the CPU: `python -m
early_exit_tpu_torch.make_assets` and `gen_norm_rules` against the
committed files they reproduce (byte for byte: the five files of
`assets/spm/`, made by the JAX package's `tools/make_assets.py`, and
`csrc/tokenizer/data/*.tsv`, made by `tools/gen_norm_rules.py`), and
`_native.build_cli()` raced from two processes into one empty build
directory: both get the same path, which runs, and no partial file is
left beside it.
"""

import filecmp
import os
import subprocess
import sys

from early_exit_tpu_torch import _native, gen_norm_rules, make_assets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = ["synth.bpe-256.model", "synth.bpe-256.vocab", "synth.bpe-256.tok",
          "synth.bpe-256.lex", "words.txt"]


def test_make_assets_reproduces_the_committed_files(tmp_path, capsys):
    make_assets.main(["--out", str(tmp_path)])
    assert "256 pieces" in capsys.readouterr().out
    for name in ASSETS:
        assert filecmp.cmp(tmp_path / name, os.path.join(REPO, "assets", "spm", name),
                           shallow=False), name


def test_gen_norm_rules_reproduces_the_committed_tables(tmp_path):
    gen_norm_rules.main([str(tmp_path)])
    for name in ("nfkc.tsv", "nmt_nfkc.tsv"):
        assert filecmp.cmp(tmp_path / name,
                           os.path.join(REPO, "csrc", "tokenizer", "data", name),
                           shallow=False), name


def test_build_cli_raced_from_two_processes(tmp_path):
    code = ("import sys; from early_exit_tpu_torch import _native; "
            "_native.BUILD_DIR = sys.argv[1]; print(_native.build_cli())")
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate() for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    path = paths.pop()
    assert os.path.dirname(path) == str(tmp_path)
    assert os.path.basename(path) == os.path.basename(_native.cli_path())
    assert sorted(os.listdir(tmp_path)) == [".lock", os.path.basename(path)]
    run = subprocess.run([path], capture_output=True, text=True)
    assert "usage: eet_spm" in run.stderr
