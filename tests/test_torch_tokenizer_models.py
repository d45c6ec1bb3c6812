"""The port's SentencePiece tokenizer (`early_exit_tpu_torch/tokenizer/`)
against the JAX package's (`early_exit_tpu/tokenizer/`), on models of all
four types trained into tmp_path by the port's native library
(`eet_spm_train_norm_ex`, `eet_charsmap_compile`): unigram, bpe, word and
char; `identity` and `nmt_nfkc` normalization; byte fallback on and off;
the reference recipe's ids (unk 127, bos 1, eos 2, pad 126, "@"
user-defined).

- Over a fixed text list (fullwidth, compatibility and non-Latin
  characters among them), every model's ids are equal across four
  engines: the port's Python and native engines and the JAX package's;
  decoding gives the same text in all four.
- `Charsmap.normalize` equals the JAX package's on a sample of
  `nmt_nfkc.tsv`'s keys; `serialize_model` writes the same bytes.
- BPE-dropout and unigram sampling give the same pieces under the same
  `random.Random` seed; n-best lists are equal.
- The port's CLI loads an `nmt_nfkc` BPE model.
"""

import os
import random

import pytest

from early_exit_tpu.tokenizer import charsmap as jcharsmap
from early_exit_tpu.tokenizer import proto as jproto
from early_exit_tpu.tokenizer.native import NativeBPE as JNativeBPE
from early_exit_tpu.tokenizer.spm import load_tokenizer as jload_tokenizer
from early_exit_tpu_torch import _native
from early_exit_tpu_torch.cli import get_args
from early_exit_tpu_torch.tokenizer import charsmap, proto
from early_exit_tpu_torch.tokenizer.native import NativeBPE
from early_exit_tpu_torch.tokenizer.spm import load_tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NMT_TSV = os.path.join(REPO, "csrc", "tokenizer", "data", "nmt_nfkc.tsv")
TYPES = {"unigram": 1, "bpe": 2, "word": 3, "char": 4}
RECIPE = (127, 1, 2, 126, b"@")         # unk, bos, eos, pad, user-defined
PLAIN = (0, 1, 2, -1, b"")
# (name, type, normalization, ids, byte fallback, vocabulary)
MODELS = [("bpe_nfkc_recipe", "bpe", "nmt_nfkc", RECIPE, 0, 256),
          ("bpe_identity_bytes", "bpe", "identity", PLAIN, 1, 320),
          ("unigram_nfkc_bytes", "unigram", "nmt_nfkc", PLAIN, 1, 320),
          ("unigram_identity_recipe", "unigram", "identity", RECIPE, 0, 256),
          ("word_nfkc", "word", "nmt_nfkc", PLAIN, 0, 200),
          ("char_identity_bytes", "char", "identity", PLAIN, 1, 300)]
TEXTS = ["", " ", "HELLO WORLD", "the quick brown fox", "  leading   and trailing  ",
         "ＨＥＬＬＯ ｗｏｒｌｄ", "ﬁne ﬂow ① ㎏ Ⅻ ½", "café naïve é", "Ｔｈｅ ＣＡＴ",
         "世界 こんにちは", "Привет мир", "مرحبا", "🙂 ok", "a@b @ c", "x\ty\nz",
         "it's THE dog's", "ｱｲｳｴｵ ｶﾞ", "Ⓐ ⓑ ㈱"]
# whitespace outside ASCII: the Python engines collapse it (str.split), the
# C++ engines keep it; nmt_nfkc maps it to a space before either looks
WIDE_SPACE = ["ＨＥＬＬＯ\u3000ｗｏｒｌｄ", "tab\u00a0nbsp", "a\u2003b"]


def _corpus(path):
    rng = random.Random(11)
    syll = ["ka", "to", "ri", "ne", "su", "mo", "la", "pi", "do", "ve", "ch", "th"]
    words = sorted({"".join(rng.choices(syll, k=rng.randint(1, 3))) for _ in range(400)})
    extra = ["ＨＥＬＬＯ", "ﬁne", "café", "naïve", "①", "Ｔｈｅ", "world", "the", "fox"]
    with open(path, "w") as f:
        for _ in range(600):
            f.write(" ".join(rng.choices(words + extra, k=rng.randint(3, 9))) + "\n")
    return path


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("spm_models")
    corpus = _corpus(str(d / "corpus.txt"))
    lib = _native.get_lib()
    out = {}
    for name, mtype, norm, (unk, bos, eos, pad, ud), bf, vocab in MODELS:
        prefix = str(d / name)
        tsv = NMT_TSV.encode() if norm == "nmt_nfkc" else b""
        rc = lib.eet_spm_train_norm_ex(corpus.encode(), prefix.encode(), vocab, unk, bos,
                                       eos, pad, ud, TYPES[mtype], norm.encode(), tsv, bf)
        assert rc == 0, (name, rc)
        out[name] = prefix + ".model"
    return out


@pytest.fixture(scope="module")
def engines(models):
    """name -> (port Python, JAX Python, port native, JAX native)."""
    return {name: (load_tokenizer(path, prefer_native=False),
                   jload_tokenizer(path, prefer_native=False),
                   load_tokenizer(path), JNativeBPE(path))
            for name, path in models.items()}


def test_the_trained_models_are_what_the_matrix_names(models):
    for name, mtype, norm, (unk, bos, eos, pad, ud), bf, _ in MODELS:
        m = proto.parse_model(models[name])
        assert int(m.trainer["model_type"]) == TYPES[mtype]
        assert bool(m.normalizer.get("precompiled_charsmap")) == (norm == "nmt_nfkc")
        assert int(m.trainer.get("byte_fallback", 0)) == bf
        ids = [int(m.trainer[k]) for k in ("unk_id", "bos_id", "eos_id", "pad_id")]
        assert ids == [unk, bos, eos, pad % 2 ** 64]     # int32 -1: a 64-bit varint
        if ud:
            assert [p.piece for p in m.pieces if p.type == proto.USER_DEFINED] == ["@"]


@pytest.mark.parametrize("name", [m[0] for m in MODELS])
def test_four_engines_encode_and_decode_alike(engines, name):
    port, jax_py, port_native, jax_native = engines[name]
    assert isinstance(port_native, NativeBPE)
    for text in TEXTS:
        ids = port.encode_as_ids(text)
        assert jax_py.encode_as_ids(text) == ids, text
        assert port_native.encode_as_ids(text) == ids, text
        assert jax_native.encode_as_ids(text) == ids, text
        assert port.encode_as_pieces(text) == jax_py.encode_as_pieces(text), text
        decoded = port.decode(ids)
        assert decoded == jax_py.decode(ids) == port_native.decode(ids) == \
            jax_native.decode(ids), text
    for getter in ("get_piece_size", "unk_id", "bos_id", "eos_id", "pad_id"):
        # the Python engines read a negative id (pad -1) as the unsigned
        # varint it is stored as; the C++ engines as int32
        assert getattr(port, getter)() == getattr(jax_py, getter)(), getter
        assert getattr(port_native, getter)() == getattr(jax_native, getter)(), getter
    assert port.get_piece_size() == port_native.get_piece_size()
    assert port.unk_id() == port_native.unk_id() and port.bos_id() == port_native.bos_id()
    n = port.get_piece_size()
    assert [port.id_to_piece(i) for i in range(n)] == [port_native.id_to_piece(i)
                                                        for i in range(n)]


@pytest.mark.parametrize("name", [m[0] for m in MODELS])
def test_wide_spaces_split_the_engines_as_in_jax(engines, name):
    """Each port engine equals the JAX package's engine of its kind; under
    nmt_nfkc all four agree."""
    port, jax_py, port_native, jax_native = engines[name]
    for text in WIDE_SPACE:
        assert port.encode_as_ids(text) == jax_py.encode_as_ids(text), text
        assert port_native.encode_as_ids(text) == jax_native.encode_as_ids(text), text
        if port.charsmap is not None:
            assert port.encode_as_ids(text) == port_native.encode_as_ids(text), text


def test_nmt_nfkc_changes_the_ids(engines):
    """The charsmap is applied: fullwidth and compatibility forms encode as
    their NFKC forms under nmt_nfkc."""
    port = engines["bpe_nfkc_recipe"][0]
    assert port.encode_as_ids("ＨＥＬＬＯ") == port.encode_as_ids("HELLO")
    assert port.encode_as_ids("ﬁne") == port.encode_as_ids("fine")
    assert port.charsmap is not None and engines["bpe_identity_bytes"][0].charsmap is None


def test_byte_fallback_round_trips_unseen_text(engines):
    for name in ("bpe_identity_bytes", "char_identity_bytes", "unigram_nfkc_bytes"):
        port = engines[name][0]
        for text in ("世界 🙂", "Привет"):
            ids = port.encode_as_ids(text)
            assert port.unk_id() not in ids
            want = port.charsmap.normalize(text) if port.charsmap else text
            assert port.decode(ids) == want


def test_charsmap_normalize_equals_jax(tmp_path):
    blob_path = str(tmp_path / "nmt.bin")
    assert _native.get_lib().eet_charsmap_compile(NMT_TSV.encode(), blob_path.encode()) > 0
    with open(blob_path, "rb") as f:
        blob = f.read()
    ours, theirs = charsmap.Charsmap(blob), jcharsmap.Charsmap(blob)
    keys = []
    with open(NMT_TSV) as f:
        for i, line in enumerate(f):
            if line.startswith("#") or "\t" not in line or i % 37:
                continue
            keys.append("".join(chr(int(c, 16)) for c in line.split("\t")[0].split()))
    assert len(keys) > 200
    for k in keys:
        assert ours.normalize(k) == theirs.normalize(k), repr(k)
        assert ours.normalize("a" + k + "b") == theirs.normalize("a" + k + "b"), repr(k)
    assert ours.extract_rules(max_rules=4000) == theirs.extract_rules(max_rules=4000)


def test_serialize_model_bytes_equal_jax(models):
    for path in models.values():
        m, jm = proto.parse_model(path), jproto.parse_model(path)
        ours = proto.serialize_model(m.pieces, m.trainer, m.normalizer)
        assert ours == jproto.serialize_model(jm.pieces, jm.trainer, jm.normalizer)
        with open(path, "rb") as f:
            assert f.read() == ours


@pytest.mark.parametrize("name", ["bpe_nfkc_recipe", "bpe_identity_bytes"])
def test_bpe_dropout_equals_jax_under_a_seed(engines, name):
    port, jax_py = engines[name][:2]
    for seed, alpha in ((0, 0.1), (1, 0.5), (2, 1.0)):
        r1, r2 = random.Random(seed), random.Random(seed)
        for text in TEXTS:
            assert (port.sample_encode_as_pieces(text, alpha, r1)
                    == jax_py.sample_encode_as_pieces(text, alpha, r2)), text
            assert port.encode(text, nbest_size=-1, alpha=alpha, rng=r1) == \
                jax_py.encode(text, nbest_size=-1, alpha=alpha, rng=r2), text
    with pytest.raises(NotImplementedError) as a:
        port.nbest_encode_as_pieces("HELLO", 4)
    with pytest.raises(NotImplementedError) as b:
        jax_py.nbest_encode_as_pieces("HELLO", 4)
    assert str(a.value) == str(b.value)


@pytest.mark.parametrize("name", ["unigram_nfkc_bytes", "unigram_identity_recipe"])
def test_unigram_sampling_and_nbest_equal_jax(engines, name):
    port, jax_py = engines[name][:2]
    for text in TEXTS:
        assert port.nbest_encode_as_pieces(text, 5) == jax_py.nbest_encode_as_pieces(text, 5)
    for seed, nbest, alpha in ((0, -1, 0.1), (1, -1, 1.0), (2, 4, 0.5)):
        r1, r2 = random.Random(seed), random.Random(seed)
        for text in TEXTS:
            assert port.encode(text, nbest_size=nbest, alpha=alpha, rng=r1) == \
                jax_py.encode(text, nbest_size=nbest, alpha=alpha, rng=r2), text


@pytest.mark.parametrize("name", ["word_nfkc", "char_identity_bytes"])
def test_word_and_char_refuse_sampling_as_jax(engines, name):
    port, jax_py = engines[name][:2]
    for call in (lambda e: e.sample_encode_as_pieces("a b"),
                 lambda e: e.nbest_encode_as_pieces("a b", 2),
                 lambda e: e.encode("a b", nbest_size=-1)):
        with pytest.raises(NotImplementedError) as a:
            call(port)
        with pytest.raises(NotImplementedError) as b:
            call(jax_py)
        assert str(a.value) == str(b.value)


def test_cli_loads_an_nmt_nfkc_bpe_model(models):
    path = models["bpe_nfkc_recipe"]
    args, cfg, _, _, tok = get_args(["--decoder_mode", "ctc", "--bpe_model_path", path,
                                     "--device", "cpu"], mode="infer")
    assert args.bpe_model_path == path and isinstance(tok, NativeBPE)
    assert cfg.vocab_size == 256 and (cfg.blank_id, cfg.pad_id, cfg.bos_id, cfg.eos_id) == (
        0, 126, 1, 2)
    assert tok.encode_as_ids("ＨＥＬＬＯ") == tok.encode_as_ids("HELLO")


def test_unsupported_model_type_raises_as_jax(tmp_path):
    m = jproto.parse_model(os.path.join(REPO, "assets", "spm", "synth.bpe-256.model"))
    path = str(tmp_path / "bad.model")
    with open(path, "wb") as f:
        f.write(jproto.serialize_model(m.pieces, {**m.trainer, "model_type": 7},
                                       m.normalizer))
    with pytest.raises(ValueError) as a:
        load_tokenizer(path)
    with pytest.raises(ValueError) as b:
        jload_tokenizer(path)
    assert str(a.value) == str(b.value)
