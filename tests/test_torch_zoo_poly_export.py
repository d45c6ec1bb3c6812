"""The zoo's shape-polymorphic programs on the CPU: the port's `poly` (and
the splitformer's `gated/poly`) of the splitformer and the early_zipformer
(`serving/export.py`) against the JAX package's poly programs of the same
weights (`early_exit_tpu/serving/export.py`), at lengths off any bucket
and from the JAX package's lower bound (hop * 10 samples, 10 to 13 hops:
T' = 2, the splitformer's branch and the zipformer's deepest stage one
frame), each request as it is, unpadded.

Tiny models (d 32, 4 heads, ffn 64, k 7, V 32, 8 mels, float32; the
splitformer 3 exits x 1 block, the zipformer 19 x 1), JAX inits; the
port's bundles made by `python -m early_exit_tpu_torch.export_serving
--export_symbolic_max` from the JAX package's checkpoint, and its
models by `interop.from_jax_params`. The port's stacks are fused (the block op
in every graph); the JAX package's poly program is exported unfused (its
fused dispatch compares the symbolic batch, so it has none). Tolerance:
tokens and n_tok equal, conf within 1e-5, the gated chosen exits and
tokens equal at thresholds 0, 1.01 and the median of exit 1's
confidences. Each program goes through `save_bundle` / `load_bundle`,
which `torch.export.save` refused while the splitformer's gated capture
held a `sym_sum` node.
"""

import contextlib
import dataclasses
import io

import jax
import numpy as np
import pytest
import sympy
import torch

from early_exit_tpu.configs import AudioConfig as JAudioConfig
from early_exit_tpu.configs import ModelConfig as JModelConfig
from early_exit_tpu.models.registry import build_model as jbuild
from early_exit_tpu.serving import export as jexp
from early_exit_tpu.training import checkpoint as jck
from early_exit_tpu_torch import export_serving as port_export
from early_exit_tpu_torch import interop
from early_exit_tpu_torch.configs import AudioConfig, ModelConfig
from early_exit_tpu_torch.serving import export as exp

N_EXITS = {"splitformer": 3, "early_zipformer": 19}
MAX_S = 8000
HOP = 160
# off the buckets, with a row of every length class; hop * 10 is the
# JAX package's lower bound, and 10 to 13 hops give T' = 2
LENGTHS = [(2, HOP * 10), (3, HOP * 10), (3, HOP * 11), (3, HOP * 12), (3, HOP * 13),
           (3, 3333), (2, 7919)]


def _kw(name, fused):
    return dict(model_type=name, d_model=32, n_heads=4, d_feed_forward=64,
                n_enc_exits=N_EXITS[name], n_enc_layers_per_exit=1,
                depthwise_kernel_size=7, vocab_size=32, n_mels=8,
                compute_dtype="float32", residual_dtype="float32",
                attn_softmax_dtype="float32", drop_prob=0.0, fused_block=fused)


def _wav(b, s, seed):
    rng = np.random.RandomState(seed)
    n = np.asarray([s, s - 700, s // 2][:b], np.int32)
    return (rng.randn(b, s) * 0.1).astype(np.float32), n


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one intra-op thread, as the suite runs six workers on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(N_EXITS))
def pair(request, tmp_path_factory, one_thread):
    """The port's bundle made by the export CLI from the JAX package's
    checkpoint (the splitformer's with --export_gated true), the JAX
    package's of the same weights, and the port's model of them."""
    name = request.param
    tmp = tmp_path_factory.mktemp(name)
    jcfg = JModelConfig(**_kw(name, False))
    jmodel = jbuild(jcfg)
    params, state = jmodel.init(jax.random.PRNGKey(0), jcfg)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    model = interop.from_jax_params(to_np(params), to_np(state),
                                    ModelConfig(**_kw(name, True))).eval()
    gated = name == "splitformer"
    ck = str(tmp / "ckpt")
    jck.save_pytree({"params": params, "model_state": state}, ck)
    path = str(tmp / "port.eetx")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port_export.main([
            "--decoder_mode", "ctc", "--load_model_path", ck, "--bpe", "false",
            "--model_type", name, "--d_model", "32", "--n_heads", "4",
            "--d_feed_forward", "64", "--n_enc_exits", str(N_EXITS[name]),
            "--n_enc_layers_per_exit", "1", "--depthwise_kernel_size", "7", "--n_mels", "8",
            "--compute_dtype", "float32", "--attn_softmax_dtype", "float32",
            "--fused_block", "true", "--export_path", path, "--export_shapes", "",
            "--export_platforms", "cpu", "--export_symbolic_max", str(MAX_S),
            "--export_gated", str(gated).lower()])
    jexp.save_bundle(str(tmp / "jax.eetx"), jexp.export_recognizer(
        jmodel, jcfg, JAudioConfig(n_mels=8), params, state, [], platforms=["cpu"],
        symbolic_max_samples=MAX_S, gated=gated))
    return dict(name=name, model=model, bundle=exp.load_bundle(path), cli=out.getvalue(),
                rec=exp.ExportedRecognizer(path, device="cpu"),
                jrec=jexp.ExportedRecognizer(str(tmp / "jax.eetx")))


def _same(got, want):
    for a, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, np.asarray(w))
    np.testing.assert_allclose(got[2], np.asarray(want[2]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("b,s", LENGTHS)
def test_poly_matches_jax(pair, b, s):
    """The port's poly program against the JAX package's on the same
    request, neither padded: the same output shapes (T' included),
    tokens and n_tok, conf within 1e-5."""
    wav, n = _wav(b, s, seed=s)
    got = pair["rec"](wav, n)
    want = pair["jrec"](wav, n)
    assert [a.shape for a in got] == [np.shape(w) for w in want]
    _same(got, want)
    E = 1 if pair["name"] == "early_zipformer" else N_EXITS[pair["name"]]
    assert got[0].shape[:2] == (E, b) and got[1].sum() > 0


def test_poly_manifest_and_ops(pair):
    man = pair["rec"].manifest
    poly = man["shapes"]["poly"]
    cfg = pair["model"].cfg
    assert poly["min_samples"] == HOP * 10 == pair["jrec"].manifest["shapes"]["poly"][
        "min_samples"]
    assert poly["max_samples"] == MAX_S
    assert man["n_exits"] == pair["jrec"].manifest["n_exits"]
    blocks = N_EXITS[pair["name"]]
    assert man["op_nodes"]["cpu"]["poly"] == {"eet::conformer_block": blocks}
    if pair["name"] == "splitformer":       # the gated program: one program an exit
        assert [man["op_nodes"]["cpu"][f"gated/poly/{e}"] for e in range(blocks)] == [
            {"eet::conformer_block": 1}] * blocks
    # from the bound up the program runs the length as given; only a
    # shorter request is padded up to it, as the JAX package's runner does
    for s in (HOP * 10, HOP * 10 + 1, HOP * 13, MAX_S):
        assert pair["rec"]._pick(2, s) == (2, s) == pair["jrec"]._pick(2, s)
    assert pair["rec"]._pick(2, HOP * 9) == (2, HOP * 10) == pair["jrec"]._pick(2, HOP * 9)
    # the shortest request runs an axis of one frame (the splitformer's
    # branch, the zipformer's deepest stage)
    assert min(exp._stack_frames(cfg, HOP * 10, HOP)) == 1


def test_poly_equals_its_eager_program(pair):
    """At the lower bound itself, the program and its eager module agree."""
    s = pair["rec"].manifest["shapes"]["poly"]["min_samples"]
    wav, n = _wav(3, s, seed=1)
    # the export CLI's inference profile computes the mel features by DFT
    serve = exp.make_serve_fn(pair["model"], AudioConfig(n_mels=8, mel_method="dft"))
    with torch.no_grad():
        want = [t.numpy() for t in serve(torch.from_numpy(wav), torch.from_numpy(n))]
    got = pair["rec"](wav, n)
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a, w)


def test_gated_poly_matches_jax(pair):
    if pair["name"] == "early_zipformer":
        assert "gated/poly" not in pair["rec"]._progs     # no gate, as in JAX
        return
    seen = set()
    for b, s in LENGTHS:
        wav, n = _wav(b, s, seed=s)
        # the middle threshold lies halfway between two rows' exit-1
        # confidences, never at one (the packages' float sums may part a tie)
        c = np.sort(pair["rec"](wav, n)[2][0])
        for thr in (0.0, 1.01, float((c[b // 2 - 1] + c[b // 2]) / 2)):
            toks, n_tok, chosen = pair["rec"].gated(wav, n, thr)
            want = pair["jrec"].gated(wav, n, thr)
            for a, w in zip((toks, n_tok, chosen), want):
                np.testing.assert_array_equal(a, np.asarray(w))
            seen.update(chosen.tolist())
    assert seen >= {1, 3}


def test_programs_round_trip_through_save(pair, tmp_path):
    """Every program saves, loads and holds no `sym_sum` node."""
    path = str(tmp_path / "again.eetx")
    exp.save_bundle(path, pair["bundle"])
    back = exp.load_bundle(path)
    assert back.manifest == pair["bundle"].manifest
    assert back.programs == pair["bundle"].programs
    for key in back.programs["cpu"]:
        # the loaded program the recognizer runs, cond branches included
        for gm in pair["rec"]._fn(key).modules():
            if isinstance(gm, torch.fx.GraphModule):
                assert all(nd.target is not torch.sym_sum for nd in gm.graph.nodes)


def test_bound_and_cpu_limit_follow_the_model():
    """The CPU check uses the model's own largest stack length: the
    zipformer's one-conv T' is about twice the flagship's."""
    from early_exit_tpu_torch.models import registry
    zcfg = ModelConfig(**_kw("early_zipformer", True))
    fcfg = dataclasses.replace(zcfg, model_type="early_conformer", n_enc_exits=2)
    s10 = 10 * 16000
    assert max(exp._stack_frames(zcfg, s10, HOP)) == 500
    assert max(exp._stack_frames(fcfg, s10, HOP)) == 249
    model = registry.build_model(zcfg)
    with pytest.raises(ValueError, match="stay within 164159 samples"):
        exp.export_recognizer(model, AudioConfig(n_mels=8), [], platforms=("cpu",),
                              symbolic_max_samples=s10 + HOP * 100)
    with pytest.raises(ValueError, match=f"must be >= {10 * HOP}"):
        exp.export_recognizer(model, AudioConfig(n_mels=8), [], platforms=("cpu",),
                              symbolic_max_samples=HOP * 9)


def test_export_cli_takes_symbolic_max_for_the_zoo(pair):
    """The fixture's bundle came from `export_serving --export_symbolic_max`
    with --export_shapes "": the poly programs only (the splitformer's
    gated one as one program an exit)."""
    gated = pair["name"] == "splitformer"
    keys = ["poly"] + ([f"gated/poly/{e}" for e in range(N_EXITS["splitformer"])]
                       if gated else [])
    assert f"exported {len(keys)} program(s)" in pair["cli"]
    assert sorted(pair["bundle"].programs["cpu"]) == sorted(keys)
    assert pair["bundle"].manifest["gated"] == gated


def _floor_atoms(sizes):
    """The floor divisions and residues (sympy functions) in sizes."""
    return {a for e in sizes for a in e.atoms(sympy.Function)}


def _node_sizes(node):
    """The symbolic sizes of a node's value: a SymInt, or a tensor's (or
    tensors') symbolic dimensions."""
    val = node.meta.get("val")
    out = []
    for v in (val if isinstance(val, (list, tuple)) else [val]):
        if isinstance(v, torch.SymInt):
            out.append(v.node.expr)
        elif isinstance(v, torch.Tensor):
            out += [d.node.expr for d in v.shape if isinstance(d, torch.SymInt)]
    return out


def test_gated_poly_cond_branches_derive_no_size(pair):
    """The splitformer's gated poly program holds no cond (one program an
    exit, `GatedFirstExit`, stepped on the host), and only its first exit
    computes a divided size (the branch's ceil(T'/2) frames, the pad's
    residue): the later exits take those sizes as operands and make no
    floor division or residue of a symbolic dimension that none of their
    inputs' sizes holds. (AOTInductor, torch 2.11, failed on the sizes
    that the cond program's branches made, `AssertionError: ps5`, and on
    the cond program itself: ROADMAP C8.)"""
    if pair["name"] == "early_zipformer":
        assert not any(k.startswith("gated/") for k in pair["rec"]._progs)
        return
    divided = 0
    for e in range(N_EXITS["splitformer"]):
        ep = torch.export.load(io.BytesIO(pair["bundle"].programs["cpu"][f"gated/poly/{e}"]))
        gm = ep.graph_module
        assert not any(nd.op == "call_function" and nd.target is torch.ops.higher_order.cond
                       for g in gm.modules() if isinstance(g, torch.fx.GraphModule)
                       for nd in g.graph.nodes)
        ops = _floor_atoms(x for p in gm.graph.nodes if p.op == "placeholder"
                           for x in _node_sizes(p))
        made = _floor_atoms(x for nd in gm.graph.nodes if nd.op != "placeholder"
                            for x in _node_sizes(nd))
        if e:
            assert made <= ops, (e, made - ops)
        divided += len(made)
    assert divided > 0          # the branch exits' blocks run at ceil(T'/2)


def test_gated_poly_runs_exits_until_every_row_is_done(pair, monkeypatch):
    """`ExportedRecognizer.gated` steps the splitformer's exit programs on
    the host and stops at the first exit where every row is done, as
    `gated_apply`'s conds skip the rest: at threshold 0 one program runs,
    at 1.01 all of them, and the chosen exits say so."""
    if pair["name"] == "early_zipformer":
        return
    rec, called = pair["rec"], []
    fn = rec._fn
    monkeypatch.setattr(rec, "_fn", lambda key: called.append(key) or fn(key))
    wav, n = _wav(3, HOP * 12, seed=5)
    for thr, runs in ((0.0, 1), (1.01, N_EXITS["splitformer"])):
        called.clear()
        _, _, chosen = rec.gated(wav, n, thr)
        assert called == [f"gated/poly/{e}" for e in range(runs)]
        assert (chosen == runs).all()
