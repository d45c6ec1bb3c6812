"""Data and tensor parallelism in the port's training against its single
rank and the JAX package's single device, in one gloo world of 4 CPU
processes (spawned once for the module by `multiprocess_smoke.run_world`).

Sharding never changes the math (the JAX package's contract,
`tests/test_sharding.py`): a dp x tp step's loss and grad norm lie within
rtol 1e-4 of the single step's, the next step's loss within 2e-3. At a
small size (d 32, 4 heads, ffn 64, k 7, V 16, float32), on a global batch
of 8 with ragged lengths and two bucket-padding rows (item_mask 0):

- the shard table: the port shards exactly the leaves the JAX package's
  `param_pspec` shards, on the same axes, for the four trainable models;
- data=2 x model=2: CTC with distillation against the port's single rank
  and JAX's `make_train_step`; CTC with SpecAugment against the port's
  single rank (the uniforms of the global rows, each rank keeping its
  own); AED (full_conformer, its output heads V-sharded) against both; the
  splitformer and the zipformer (whose single head is V-sharded), in
  group norm, against the port's single rank;
- data=1 x model=4 with dropout 0.1 equals the single rank with dropout:
  every rank of the model group draws the same masks (the FFN's first
  mask drawn at the full d_ff width);
- checkpoints across layouts: a single-rank pair resumes on data=2 x
  model=2, whose gathered pair (the single-rank files) resumes on one
  rank again, each next step within the tolerances;
- bf16 (the train CLI's default dtype): data=2 x model=2 lies no farther
  from the single rank's bf16 step than that step lies from float32;
- the pipeline's shards are the rows of the global sub-batch, at its
  shapes, a rank reads only its rows' audio, and a bucketed B that
  dp x dcn does not divide raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from early_exit_tpu.configs import ModelConfig as JModelConfig
from early_exit_tpu.configs import TrainConfig as JTrainConfig
from early_exit_tpu.models import early_conformer as jec
from early_exit_tpu.models import full_conformer as jfc
from early_exit_tpu.models import splitformer as jsf
from early_exit_tpu.models import zipformer as jzf
from early_exit_tpu.optim import make_optimizer
from early_exit_tpu.parallel.mesh import param_pspec
from early_exit_tpu.training import checkpoint as jck
from early_exit_tpu.training import trainer as jtrainer
from early_exit_tpu_torch import interop, parallel
from early_exit_tpu_torch.configs import AudioConfig, ModelConfig, TrainConfig
from early_exit_tpu_torch.data.pipeline import Pipeline
from early_exit_tpu_torch.data.synthetic import SyntheticDataset
from early_exit_tpu_torch.models.registry import build_model
from early_exit_tpu_torch.multiprocess_smoke import check, run_scenario, run_world
from early_exit_tpu_torch.tokenizer import chars
from early_exit_tpu_torch.training import checkpoint as ck

TINY = dict(d_model=32, n_heads=4, d_feed_forward=64, n_enc_exits=2,
            n_enc_layers_per_exit=1, depthwise_kernel_size=7, vocab_size=16, n_mels=8,
            compute_dtype="float32", drop_prob=0.0)
AED = dict(TINY, model_type="full_conformer", n_dec_layers=1, pad_id=14)
SPLIT = dict(TINY, model_type="splitformer", n_enc_exits=3, conv_norm="group")
ZIP = dict(TINY, model_type="early_zipformer", n_enc_exits=19, conv_norm="group")
BF16 = dict(TINY, compute_dtype="bfloat16")          # the train CLI's default dtype
DP2_TP2 = {"dp": 2, "tp": 2}
WARMUP = 100
CPU = torch.device("cpu")


def _batch(aed=False):
    """8 rows, the last two bucket padding (no frames, no label, weight 0)."""
    r = np.random.RandomState(0)
    B, T, L = 8, 67, 8
    lengths = np.array([67, 60, 55, 67, 40, 51, 0, 0], np.int32)
    if aed:
        labels = np.full((B, L), AED["pad_id"], np.int32)
        labels[:, 0] = 1
        labels[:, 1:5] = r.randint(3, 13, size=(B, 4))
        labels[:, 5] = 2
        label_len = np.full(B, 6, np.int32)
    else:
        labels = r.randint(3, 16, size=(B, L)).astype(np.int32)
        label_len = np.array([8, 7, 6, 5, 4, 6, 0, 0], np.int32)
    label_len[6:] = 0
    return {"feats": r.randn(B, T, 8).astype(np.float32), "feat_lengths": lengths,
            "labels": labels, "label_lengths": label_len,
            "item_mask": (np.arange(B) < 6).astype(np.float32)}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jax_run(jmod, mkw, tkw, batch, path):
    """JAX's init saved at path, and two of its train steps."""
    jcfg = JModelConfig(**mkw)
    opt = make_optimizer(jcfg.d_model, warmup=WARMUP)
    state = jtrainer.create_train_state(jax.random.PRNGKey(0), jmod, jcfg, opt)
    jck.save_pytree({"params": state["params"], "model_state": state["model_state"]}, path)
    step = jax.jit(jtrainer.make_train_step(jmod, jcfg, JTrainConfig(**tkw), opt))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {"loss": [], "grad_norm": []}
    for _ in range(2):
        state, m = step(state, jb, jax.random.PRNGKey(1))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every scenario on 4 ranks, the same on one rank in this process, and
    JAX's two steps of the two scenarios loaded from its init."""
    d = tmp_path_factory.mktemp("parallel")
    batches = {"ctc": _tb(_batch()), "aed": _tb(_batch(aed=True))}
    jax_runs = {"ctc": _jax_run(jec, TINY, {"distill": True}, _batch(), str(d / "jctc")),
                "aed": _jax_run(jfc, AED, {"decoder_mode": "aed"}, _batch(aed=True),
                                str(d / "jaed"))}
    # a single-rank pair one step in, for the resumes
    run_scenario({"model": TINY, "steps": 1, "seed": 3, "save": str(d / "one")},
                 batches["ctc"], CPU)
    one = {"load": str(d / "one" / "mod000-transformer"),
           "load_opt": str(d / "one" / "lr000-transformer")}
    base = {"steps": 2, "warmup": WARMUP, "mesh": DP2_TP2, "batch": "ctc"}
    scenarios = [
        dict(base, name="ctc", model=TINY, train={"distill": True}, load=str(d / "jctc")),
        # masks narrower than the 8 mel bins, so that each row's draw shows
        dict(base, name="ctc_specaugment", model=TINY,
             train={"specaugment": True, "sa_freq_width": 2, "seed": 5}),
        dict(base, name="aed", model=AED, train={"decoder_mode": "aed"}, load=str(d / "jaed"),
             batch="aed"),
        dict(base, name="splitformer", model=SPLIT),
        dict(base, name="zipformer", model=ZIP),
        dict(base, name="dropout_tp4", model=dict(TINY, drop_prob=0.1),
             mesh={"dp": 1, "tp": 4}),
        dict(base, name="bf16", model=BF16),
        dict(base, name="resume", model=TINY, steps=1, save=str(d / "four"), **one),
    ]
    got = run_world(scenarios, batches, world=4, workdir=str(d))
    single = {sc["name"]: run_scenario(dict(sc, save=None, steps=2), batches[sc["batch"]], CPU)
              for sc in scenarios}
    return got, single, jax_runs, d


@pytest.mark.parametrize("name", ["ctc", "ctc_specaugment", "aed", "splitformer",
                                  "zipformer", "dropout_tp4"])
def test_sharded_steps_equal_the_single_rank(world, name):
    got, single, jax_runs, _ = world
    assert not check(name, got[name], single[name])
    if name in jax_runs:
        assert not check(name + " vs JAX", got[name], jax_runs[name])
    # the BatchNorm running statistics after the first step (group norm:
    # unmoved); after the second they also carry Adam's first update, whose
    # sign(g) turns float noise in near-zero gradients into whole steps
    for a, b in zip(jax.tree_util.tree_leaves(got[name]["state"][0]),
                    jax.tree_util.tree_leaves(single[name]["state"][0])):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_bf16_sharded_steps_lie_within_bf16s_own_rounding(world):
    """In bf16 (the train CLI's default), data=2 x model=2 rounds other
    partial sums than one rank does (the FFN's reduced products, each
    rank's part of a bias gradient): its loss, grad norm and next loss lie
    no farther from the single rank's bf16 step than that step lies from
    the same step in float32."""
    got, single, _, _ = world
    f32 = run_scenario({"model": TINY, "steps": 2, "seed": 0}, _tb(_batch()), CPU)
    mesh, one = got["bf16"], single["bf16"]
    for key, i in (("loss", 0), ("grad_norm", 0), ("loss", 1)):
        own = abs(one[key][i] - f32[key][i])
        assert own > 0, (key, i)            # bf16 rounds: the limit is not zero
        assert abs(mesh[key][i] - one[key][i]) <= own, (key, i, mesh[key][i], one[key][i],
                                                         f32[key][i])


def test_checkpoints_resume_across_layouts(world):
    """single -> data=2 x model=2 -> single: the 4-rank resume's step equals
    the single rank's second step, and its gathered pair (the single-rank
    files, whole shapes) resumes on one rank within the next-step
    tolerance of the single rank's third."""
    got, _, _, d = world
    one = run_scenario({"model": TINY, "steps": 3, "seed": 3}, _tb(_batch()), CPU)
    assert got["resume"]["loss"][0] == pytest.approx(one["loss"][1], rel=1e-4)
    assert got["resume"]["grad_norm"][0] == pytest.approx(one["grad_norm"][1], rel=1e-4)
    four = ck.load_tree(str(d / "four" / "mod000-transformer"))
    ref = ck.load_tree(str(d / "one" / "mod000-transformer"))       # a single rank's
    assert jax.tree_util.tree_structure(four) == jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(four), jax.tree_util.tree_leaves(ref)):
        assert np.shape(a) == np.shape(b)
    back = run_scenario({"model": TINY, "steps": 1,
                         "load": str(d / "four" / "mod000-transformer"),
                         "load_opt": str(d / "four" / "lr000-transformer")},
                        _tb(_batch()), CPU)
    assert back["loss"][0] == pytest.approx(one["loss"][2], rel=2e-3)


JAX_MODELS = {"early_conformer": (jec, TINY), "splitformer": (jsf, SPLIT),
              "early_zipformer": (jzf, ZIP), "full_conformer": (jfc, AED)}


@pytest.mark.parametrize("name", sorted(JAX_MODELS))
def test_shard_table_equals_jax_param_pspec(name):
    jmod, kw = JAX_MODELS[name]
    params, _ = jmod.init(jax.random.PRNGKey(0), JModelConfig(**kw))
    model = build_model(ModelConfig(**kw))
    n_sharded = 0
    for path, tensors, lead in interop.param_paths(model):
        leaf = params
        for k in path:
            leaf = leaf[k]
        spec = param_pspec([jax.tree_util.DictKey(k) if isinstance(k, str)
                            else jax.tree_util.SequenceKey(k) for k in path], leaf)
        want = None
        if spec != P():
            i = list(spec).index("model")
            want = tensors[0].ndim - (leaf.ndim - i)       # the same axis from the end
        for t in tensors:
            assert parallel.param_shard_dim(path, t) == want, (path, spec)
        n_sharded += want is not None
    # FFN w1, b1, w2 of both half-FFNs, and the heads' w and b
    assert n_sharded >= 8


def test_pipeline_shards_are_the_global_rows():
    tok = chars.CharTokenizer()
    pipe = Pipeline(SyntheticDataset(n_items=6, seed=1), tok, AudioConfig(), TrainConfig(),
                    bpe=False, device="cpu")
    items = [pipe._load_item(i) for i in range(6)]
    whole = pipe.host_subbatch(items)                  # 6 items -> B = 8
    for index in range(2):
        part = pipe.host_subbatch(items, (index, 2))
        for k, v in whole.items():
            np.testing.assert_array_equal(part[k], v[index * 4:(index + 1) * 4])
    with pytest.raises(ValueError, match="not a multiple of dp x dcn = 3"):
        pipe.host_subbatch(items, (0, 3))


class _CountingSynthetic(SyntheticDataset):
    """SyntheticDataset that records the items whose audio was read."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.read = []

    def __getitem__(self, i):
        self.read.append(i)
        return super().__getitem__(i)


def test_sharded_epoch_reads_only_its_rows_audio():
    """Each rank reads the audio of its own rows only (the split and the
    global T and L come from `meta`), and the ranks' rows are the
    single-rank epoch's."""
    kw = dict(n_items=12, seed=5, dur_jitter=0.3, amp_jitter=0.2, speaker_warp=0.1)
    ds = SyntheticDataset(**kw)
    for i in range(12):
        assert ds.meta(i) == (len(ds[i].waveform), ds[i].transcript)
    tok = chars.CharTokenizer()
    tcfg = TrainConfig(batch_size=6, n_batch_split=2)

    def epoch(shard):
        data = _CountingSynthetic(**kw)
        pipe = Pipeline(data, tok, AudioConfig(), tcfg, bpe=False, device="cpu", seed=3,
                        workers=2, shard=shard)
        return list(pipe.epoch(0)), data.read

    whole, read_all = epoch(None)
    parts = [epoch((index, 2)) for index in range(2)]
    assert sorted(read_all) == list(range(12))
    assert sorted(parts[0][1] + parts[1][1]) == list(range(12))    # each audio read once
    assert len(whole) == len(parts[0][0]) == len(parts[1][0]) == 4
    for b, (p0, p1) in enumerate(zip(parts[0][0], parts[1][0])):
        for k, v in whole[b].items():
            got = torch.cat([p0[k], p1[k]])
            assert got.shape == v.shape, (b, k)
            if k == "feats":
                np.testing.assert_allclose(got.numpy(), v.numpy(), rtol=0, atol=1e-5)
            else:
                np.testing.assert_array_equal(got.numpy(), v.numpy())
