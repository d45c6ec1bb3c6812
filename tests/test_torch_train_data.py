"""The port's training data side against the JAX package's: the BPE
encoder (256 synthetic transcripts and edge strings, against both of the
JAX package's engines), the character tokenizer, label cleaning, the
bucketing helpers, and whole `Pipeline` epochs on SyntheticDataset(16):
ids, lengths and masks exactly, mel features within 1e-4 relative.
"""

import os

import jax
import numpy as np
import pytest
import torch

from early_exit_tpu.configs import AudioConfig as JAudioConfig
from early_exit_tpu.configs import TrainConfig as JTrainConfig
from early_exit_tpu.data import bucketing as jbucketing, text as jtext
from early_exit_tpu.data.librispeech import SyntheticDataset as JSyntheticDataset
from early_exit_tpu.data.pipeline import Pipeline as JPipeline
from early_exit_tpu.tokenizer import CharTokenizer as JCharTokenizer
from early_exit_tpu.tokenizer import load_tokenizer as jload_tokenizer
from early_exit_tpu_torch.configs import AudioConfig, TrainConfig
from early_exit_tpu_torch.data import bucketing, text
from early_exit_tpu_torch.data.pipeline import Pipeline
from early_exit_tpu_torch.data.synthetic import SyntheticDataset
from early_exit_tpu_torch.tokenizer import CharTokenizer, load_tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "assets", "spm", "synth.bpe-256.model")
EDGE = ["", " ", "   leading and trailing   ", "A  B\t\tC\nD", "IT'S THE DOG'S",
        "it's lower case", "ÜNÏCODE ÀND ÉMOJI 🙂", "#^$?:;.![]", "X" * 40,
        "THE OF AND TO A IN THAT IS WAS HE FOR IT WITH AS HIS ON BE AT"]


def _transcripts(n=256):
    ds = SyntheticDataset(n_items=n, seed=5, min_words=1, max_words=25)
    return [ds[i].transcript for i in range(n)]


@pytest.mark.parametrize("native", [True, False])
def test_bpe_encode_matches_jax(native):
    ours = load_tokenizer(MODEL)
    ref = jload_tokenizer(MODEL, prefer_native=native)
    texts = _transcripts() + EDGE + [t.lower() for t in EDGE]
    for t in texts:
        assert ours.encode_as_ids(t) == ref.encode_as_ids(t), repr(t)
    assert ours.encode_as_ids("ü'") == [231, 127, 127]       # unknown -> unk 127
    for name in ("bos_id", "eos_id", "pad_id", "unk_id"):
        assert getattr(ours, name)() == getattr(ref, name)()
    ids = ours.encode_as_ids(texts[0])
    assert ours.decode(ids) == ref.decode(ids) == texts[0]


def test_char_tokenizer_and_label_cleaning_match_jax():
    ours, ref = CharTokenizer(), JCharTokenizer()
    for t in ("hello world", "it's", ""):
        assert ours.encode_as_ids(t) == ref.encode_as_ids(t)
        assert ours.decode(ours.encode_as_ids(t)) == ref.decode(ref.encode_as_ids(t))
    labels = ["HELLO <unk> [ unclear ] WORLD!", "A#B^C$D?E:F;G.H!I[J]K, L",
              "KEEP ignore_time_segment_in_scoring", "PLAIN"]
    tok, jtok = load_tokenizer(MODEL), jload_tokenizer(MODEL)
    for lab in labels:
        assert text.clean_train_label(lab) == jtext.clean_train_label(lab)
        assert text.clean_infer_label(lab) == jtext.clean_infer_label(lab)
        clean = text.clean_train_label(lab)
        assert text.encode_target(clean, tok) == jtext.encode_target(clean, jtok)
    for lab in ("HELLO WORLD", "IT'S"):
        assert (text.encode_target(lab, ours, bpe=False)
                == jtext.encode_target(lab, ref, bpe=False))


def test_bucketing_matches_jax():
    r = np.random.RandomState(0)
    for n_split in (1, 3, 4):
        sizes = list(r.randint(1, 1000, size=23))
        items = list(range(23))
        assert (bucketing.split_equal_total(items, sizes, n_split)
                == jbucketing.split_equal_total(items, sizes, n_split))
    for n in (1, 3, 13, 129, 200):
        assert bucketing.bucket_batch_size(n) == jbucketing.bucket_batch_size(n)
        assert bucketing.bucket_frames(n) == jbucketing.bucket_frames(n)
        assert bucketing.bucket_labels(n) == jbucketing.bucket_labels(n)


def test_pipeline_batches_match_jax():
    tcfg = dict(batch_size=6, n_batch_split=2)
    ours = Pipeline(SyntheticDataset(16), load_tokenizer(MODEL), AudioConfig(),
                    TrainConfig(**tcfg), seed=3, workers=2, device="cpu")
    ref = JPipeline(JSyntheticDataset(16), jload_tokenizer(MODEL), JAudioConfig(),
                    JTrainConfig(**tcfg), seed=3, workers=2)
    assert ours.batches_per_epoch() == ref.batches_per_epoch()
    for epoch in (0, 1):
        got = list(ours.epoch(epoch))
        want = [jax.device_get(b) for b in ref.epoch(epoch)]
        assert len(got) == len(want) == 6       # 6 + 6 + 4 items, 2 sub-batches each
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in ("feat_lengths", "labels", "label_lengths", "item_mask"):
                assert g[k].dtype == torch.from_numpy(np.array(w[k])).dtype, k
                np.testing.assert_array_equal(g[k].numpy(), w[k], err_msg=k)
            f, wf = g["feats"].numpy(), np.asarray(w["feats"])
            assert f.shape == wf.shape
            np.testing.assert_allclose(f, wf, rtol=1e-4, atol=1e-4 * np.abs(wf).max())
    # 3-item sub-batches pad to 4 rows: a bucket row with no frames and no label
    pad = [b for b in got if float(b["item_mask"].min()) == 0]
    assert pad and all(int(b["feat_lengths"][-1]) == 1 and int(b["label_lengths"][-1]) == 0
                       for b in pad)
