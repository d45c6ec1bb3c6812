"""The zoo in the serving entries on the CPU: the port's bundles of the
splitformer and the early_zipformer (`serving/export.py`) against the JAX
package's bundles of the same weights (`early_exit_tpu/serving/export.py`),
`Recognizer` on both families, the export CLI, and the refusals that stay.

Tiny models (d 32, 4 heads, ffn 64, k 7, V 32, 8 mels, float32; the
splitformer 3 exits x 1 block, the zipformer 19 x 1), JAX inits carried
by `interop.from_jax_params`, the port's stacks fused (the block op in
every graph). Tolerance: tokens and n_tok equal, conf within 1e-5 (as
`tests/test_torch_export.py` holds the flagship's); the gated chosen
exits and tokens equal at thresholds 0, 1.01 and the median of exit 1's
confidences; the manifest's `n_exits` and shapes equal JAX's (1 exit and
the zipformer's own T''); `eet::conformer_block` nodes a graph: one a
trunk block (the splitformer's two branch blocks run unfused), 19 for the
zipformer. The refusals carry the JAX package's text; the zoo's
shape-polymorphic program, refused by name until it was ported, exports.
"""

import jax
import numpy as np
import pytest
import torch

from early_exit_tpu.configs import AudioConfig as JAudioConfig
from early_exit_tpu.configs import ModelConfig as JModelConfig
from early_exit_tpu.models import early_exit_gate as jgate
from early_exit_tpu.models.registry import build_model as jbuild
from early_exit_tpu.serving import cascade as jcascade
from early_exit_tpu.serving import export as jexp
from early_exit_tpu.training import checkpoint as jck
from early_exit_tpu_torch import export_serving as port_export
from early_exit_tpu_torch import interop
from early_exit_tpu_torch.configs import AudioConfig, ModelConfig
from early_exit_tpu_torch.models import registry
from early_exit_tpu_torch.serving import export as exp
from early_exit_tpu_torch.serving.recognizer import Recognizer
from torch_one_thread import one_thread  # noqa: F401

N_EXITS = {"splitformer": 3, "early_zipformer": 19}
SHAPE = (4, 8000)      # an even batch: the median conf lies between two rows


def _kw(name):
    return dict(model_type=name, d_model=32, n_heads=4, d_feed_forward=64,
                n_enc_exits=N_EXITS[name], n_enc_layers_per_exit=1,
                depthwise_kernel_size=7, vocab_size=32, n_mels=8,
                compute_dtype="float32", residual_dtype="float32",
                attn_softmax_dtype="float32", drop_prob=0.0, fused_block=True)


class Tok:
    """A decoder over the tiny vocabulary: one letter a piece."""

    def decode(self, ids):
        return "".join(chr(ord("a") + int(i) % 26) for i in ids)


def _wav(b, s, seed=0):
    rng = np.random.RandomState(seed)
    return ((rng.randn(b, s) * 0.1).astype(np.float32),
            np.asarray([s, s - 1000, s - 3000, s - 500][:b], np.int32))


@pytest.fixture(scope="module", params=sorted(N_EXITS))
def pair(request, tmp_path_factory):
    name = request.param
    tmp = tmp_path_factory.mktemp(name)
    jcfg = JModelConfig(**_kw(name))
    jmodel = jbuild(jcfg)
    params, state = jmodel.init(jax.random.PRNGKey(0), jcfg)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    model = interop.from_jax_params(to_np(params), to_np(state), ModelConfig(**_kw(name)))
    gated = name == "splitformer"
    bundle = exp.export_recognizer(model.eval(), AudioConfig(n_mels=8), [SHAPE],
                                   platforms=("cpu",), gated=gated)
    exp.save_bundle(str(tmp / "port.eetx"), bundle)
    jexp.save_bundle(str(tmp / "jax.eetx"), jexp.export_recognizer(
        jmodel, jcfg, JAudioConfig(n_mels=8), params, state, [SHAPE], platforms=["cpu"],
        gated=gated))
    ck = str(tmp / "ckpt")
    jck.save_pytree({"params": params, "model_state": state}, ck)
    return dict(name=name, model=model, ck=ck, tmp=tmp,
                rec=exp.ExportedRecognizer(str(tmp / "port.eetx"), device="cpu"),
                jrec=jexp.ExportedRecognizer(str(tmp / "jax.eetx")))


def test_allexit_bundle_matches_jax(pair):
    wav, n = _wav(*SHAPE)
    got, want = pair["rec"](wav, n), [np.asarray(t) for t in pair["jrec"](wav, n)]
    E = 1 if pair["name"] == "early_zipformer" else N_EXITS[pair["name"]]
    assert got[0].shape == want[0].shape and got[0].shape[:2] == (E, SHAPE[0])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].sum() > 0
    np.testing.assert_allclose(got[2], want[2], atol=1e-5, rtol=0)
    man, jman = pair["rec"].manifest, pair["jrec"].manifest
    assert man["n_exits"] == jman["n_exits"] == E
    assert man["shapes"] == jman["shapes"]
    blocks = N_EXITS[pair["name"]]
    assert man["op_nodes"]["cpu"]["4x8000"] == {"eet::conformer_block": blocks}


def test_gated_bundle_matches_jax(pair):
    wav, n = _wav(*SHAPE)
    if pair["name"] == "early_zipformer":
        # one exit: exported without a gated program (a gate is refused
        # below), so the consumer has none to run
        with pytest.raises(ValueError, match="without gated=True"):
            pair["rec"].gated(wav, n, 0.5)
        return
    conf1 = pair["rec"](wav, n)[2][0]
    seen = set()
    for thr in (0.0, 1.01, float(np.median(conf1))):
        got = pair["rec"].gated(wav, n, thr)
        want = [np.asarray(t) for t in pair["jrec"].gated(wav, n, thr)]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        seen.update(got[2].tolist())
    assert seen >= {1, 3}
    # one block a trunk exit, in that exit's cond branch
    assert pair["rec"].manifest["op_nodes"]["cpu"]["gated/4x8000"] == {
        "eet::conformer_block": N_EXITS["splitformer"]}


def test_recognizer_serves_the_zoo(pair):
    """`Recognizer.transcribe` decodes every exit of either family as the
    bundle does; the splitformer's while-loop gate chooses its exits."""
    wav, n = _wav(*SHAPE)
    rec = Recognizer(pair["model"], Tok(), acfg=AudioConfig(n_mels=8), device="cpu",
                     calib={"thresholds": 0.0})
    out = rec.transcribe(torch.from_numpy(wav), torch.from_numpy(n))
    toks, n_tok, _ = pair["rec"](wav, n)
    np.testing.assert_array_equal(out.n_tokens.numpy(), n_tok)
    for e in range(toks.shape[0]):
        for b in range(SHAPE[0]):
            np.testing.assert_array_equal(out.tokens[e, b, :n_tok[e, b]].numpy(),
                                          toks[e, b, :n_tok[e, b]])
            assert out.texts[e][b] == Tok().decode(toks[e, b, :n_tok[e, b]])
    if pair["name"] == "splitformer":
        gated = rec.transcribe_gated(torch.from_numpy(wav), torch.from_numpy(n),
                                     strategy="whileloop")
        np.testing.assert_array_equal(gated.chosen_exit.numpy(),
                                      pair["rec"].gated(wav, n, 0.0)[2])


def test_export_cli_takes_the_zoo(pair, capsys):
    path = str(pair["tmp"] / "cli.eetx")
    argv = ["--decoder_mode", "ctc", "--load_model_path", pair["ck"], "--bpe", "false",
            "--model_type", pair["name"], "--d_model", "32", "--n_heads", "4",
            "--d_feed_forward", "64", "--n_enc_exits", str(N_EXITS[pair["name"]]),
            "--n_enc_layers_per_exit", "1", "--depthwise_kernel_size", "7",
            "--n_mels", "8", "--compute_dtype", "float32", "--attn_softmax_dtype",
            "float32", "--fused_block", "true", "--export_path", path,
            "--export_shapes", "2x8000", "--export_platforms", "cpu"]
    port_export.main(argv)
    assert "exported 1 program(s)" in capsys.readouterr().out
    man = exp.load_bundle(path).manifest
    assert man["n_exits"] == (1 if pair["name"] == "early_zipformer" else 3)
    assert man["op_nodes"]["cpu"]["2x8000"] == {"eet::conformer_block":
                                                 N_EXITS[pair["name"]]}


def _jax_error(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


@pytest.mark.parametrize("name", sorted(N_EXITS))
def test_refusals_carry_the_jax_text(name):
    jcfg, cfg = JModelConfig(**_kw(name)), ModelConfig(**_kw(name))
    cascade = _jax_error(lambda: jcascade._check_model(jcfg))
    with pytest.raises(ValueError) as err:
        registry.require_cascade(cfg)
    assert str(err.value) == cascade
    if name == "early_zipformer":
        gate = _jax_error(lambda: jgate.gated_apply(None, None, None, None, jcfg,
                                                    threshold=0.5))
        with pytest.raises(ValueError) as err:
            registry.require_gated(cfg)
        assert str(err.value) == gate
    else:
        registry.require_gated(cfg)
    # no longer refused: the zoo's shape-polymorphic program exports
    # (held against the JAX package's in tests/test_torch_zoo_poly_export.py)
    bundle = exp.export_recognizer(registry.build_model(cfg).eval(), AudioConfig(n_mels=8),
                                   [], platforms=("cpu",), symbolic_max_samples=16000)
    assert sorted(bundle.programs["cpu"]) == ["poly"]
    assert bundle.manifest["shapes"]["poly"]["min_samples"] == 160 * 10
    with pytest.raises(ValueError) as err:
        registry.require_streaming(cfg)
    from early_exit_tpu_torch.inference import check_streaming
    with pytest.raises(SystemExit) as cli:
        check_streaming(type("Args", (), {"model_type": name})())
    assert str(err.value) == str(cli.value)
