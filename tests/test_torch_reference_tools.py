"""The port's reference-checkpoint tools end to end on the CPU
(`python -m early_exit_tpu_torch.export_reference_checkpoint` and
`python -m early_exit_tpu_torch.import_reference_checkpoint`, with
--device cpu) against the JAX package's (`tools/export_reference_checkpoint.py`,
`tools/import_reference_checkpoint.py`):

- a checkpoint exports to the JAX tool's state_dict, key for key, bit for
  bit, which loads strict=True into the torchaudio-layout replica of the
  reference model (`tests/test_torch_import.py`);
- that state_dict imports to the JAX tool's checkpoint, leaf for leaf,
  and to the original checkpoint's trees;
- the port's inference CLI prints the same transcripts from the imported
  checkpoint as from the original.
"""

import jax
import numpy as np
import pytest
import torch

import tools.export_reference_checkpoint as jax_export
import tools.import_reference_checkpoint as jax_import
from early_exit_tpu.cli import get_args as jax_get_args
from early_exit_tpu.models.registry import build_model as jbuild_model
from early_exit_tpu.training import checkpoint as jck
from early_exit_tpu_torch import checkpoint
from early_exit_tpu_torch import export_reference_checkpoint as port_export
from early_exit_tpu_torch import import_reference_checkpoint as port_import
from early_exit_tpu_torch import inference as port_inference
from early_exit_tpu_torch.cli import get_args

from test_torch_import import _RefEarlyConformer, _RefFullConformer
from test_torch_reference_interop import assert_state_dicts_identical, assert_trees_identical

TINY = ["--d_model", "32", "--n_enc_exits", "2", "--n_enc_layers_per_exit", "1",
        "--n_heads", "4", "--d_feed_forward", "64", "--depthwise_kernel_size", "7",
        "--compute_dtype", "float32", "--attn_softmax_dtype", "float32"]
FLAGS = {"ctc": ["--decoder_mode", "ctc", *TINY],
         "aed": ["--decoder_mode", "aed", "--n_dec_layers", "1", *TINY]}


def _make(mode, d):
    """The original checkpoint: a seeded JAX init at the tiny widths,
    BPE-256 (the committed tokenizer), BatchNorm statistics away from
    (0, 1), heads widened so that the model emits tokens."""
    _, jcfg, _, _, _ = jax_get_args(FLAGS[mode], mode="infer")
    params, state = jbuild_model(jcfg).init(jax.random.PRNGKey(9), jcfg)
    params["heads"]["w"] = params["heads"]["w"] * 6.0
    rng = np.random.RandomState(4)
    state = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.uniform(0.1, 0.5, np.shape(a))).astype(np.float32),
        state)
    jck.save_pytree({"params": params, "model_state": state}, str(d / "original"))
    port_export.main(["--ckpt", str(d / "original"), "--out", str(d / "port.pt"),
                      "--device", "cpu", *FLAGS[mode]])
    return mode, d, str(d / "original")


@pytest.fixture(scope="module", params=list(FLAGS))
def made(request, tmp_path_factory):
    """(mode, directory, original checkpoint); the port tool's export of it
    in the directory's port.pt."""
    return _make(request.param, tmp_path_factory.mktemp(f"ref_tools_{request.param}"))


@pytest.fixture(scope="module")
def made_ctc(tmp_path_factory):
    return _make("ctc", tmp_path_factory.mktemp("ref_tools_cli"))


@pytest.fixture(scope="module")
def exported(made):
    """The port tool's and the JAX tool's state_dicts of the original."""
    mode, d, original = made
    jax_export.main(["--ckpt", original, "--out", str(d / "jax.pt"), *FLAGS[mode]])
    return (torch.load(str(d / "port.pt"), weights_only=True),
            torch.load(str(d / "jax.pt"), weights_only=True))


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def test_export_tool_equals_jax(exported):
    ours, theirs = exported
    assert all(v.device.type == "cpu" for v in ours.values())
    assert_state_dicts_identical(_np(ours), _np(theirs))


def test_exported_state_dict_loads_strict_into_the_replica(made, exported):
    mode = made[0]
    _, cfg, _, _, _ = get_args(FLAGS[mode] + ["--device", "cpu"], mode="infer")
    replica = (_RefEarlyConformer(cfg) if mode == "ctc"
               else _RefFullConformer(cfg, n_dec_layers=cfg.n_dec_layers))
    replica.load_state_dict(exported[0], strict=True)


def test_import_tool_equals_jax_and_the_original(made, exported, capsys):
    mode, d, original = made
    port_import.main(["--torch_ckpt", str(d / "port.pt"), "--out", str(d / "imported"),
                      "--device", "cpu", *FLAGS[mode]])
    assert "forward ok" in capsys.readouterr().out
    jax_import.main(["--torch_ckpt", str(d / "port.pt"), "--out", str(d / "imported_jax"),
                     *FLAGS[mode]])
    ours = checkpoint.load_tree(str(d / "imported"))
    assert_trees_identical(ours, checkpoint.load_tree(str(d / "imported_jax")))
    want = checkpoint.load_tree(original)
    for key in ("params", "model_state"):
        assert_trees_identical(ours[key], want[key])


def test_import_tool_refuses_what_is_not_a_state_dict(made, tmp_path):
    mode = made[0]
    path = str(tmp_path / "not_a_state_dict")
    torch.save([1, 2, 3], path)
    with pytest.raises(SystemExit, match="must hold a state_dict"):
        port_import.main(["--torch_ckpt", path, "--out", str(tmp_path / "x"),
                          "--device", "cpu", *FLAGS[mode]])


def test_inference_cli_on_the_imported_checkpoint(made_ctc, capsys):
    """The port's inference CLI, greedy over the synthetic split, prints the
    same transcripts from the imported checkpoint as from the original."""
    mode, d, original = made_ctc
    imported = str(d / "imported_cli")
    port_import.main(["--torch_ckpt", str(d / "port.pt"), "--out", imported,
                      "--device", "cpu", *FLAGS[mode]])
    capsys.readouterr()
    outs = []
    for path in (original, imported):
        port_inference.main(FLAGS[mode] + ["--synthetic_data", "true", "--device", "cpu",
                                           "--batch_size", "4", "--n_batch_split", "1",
                                           "--load_model_path", path])
        outs.append([ln for ln in capsys.readouterr().out.splitlines()
                     if "BEAM_OUT_" in ln or "EXPECTED:" in ln])
    assert outs[0] and outs[0] == outs[1]
    assert any(ln.split(":", 1)[1].strip() for ln in outs[0] if "BEAM_OUT_" in ln)
