"""The port's inference data path against the JAX package's.

- `write_flac_verbatim` writes files byte-identical to the JAX writer's,
  float and int16 input, one block and several;
- `decode_flac` / `read_audio` give arrays equal to the JAX package's
  (FLAC and 16-bit WAV, mono and stereo);
- `LibriSpeechDataset` lists the same utterances in the same order on a
  corpus of 3 speakers x 2 chapters (split lists and a file without a
  transcript too), and its items equal the JAX package's;
- `Pipeline(infer_mode=True)`: the same cleaning and dropping of labels,
  batches equal to the JAX pipeline's (labels, lengths and masks equal;
  features within the existing pipeline tests' 1e-4 relative);
- `get_args(mode=...)` resolves "auto" as the JAX `get_args` does, and
  finds the same lexicon and tokens files;
- the native library builds into the port's own directory;
- the training CLI on a FLAC corpus (the LibriSpeech reader lifts its
  former raise).
"""

import os
import wave

import numpy as np
import pytest
import torch

from early_exit_tpu import cli as jcli
from early_exit_tpu.configs import AudioConfig as JAudioConfig
from early_exit_tpu.configs import TrainConfig as JTrainConfig
from early_exit_tpu.data import flac as jflac
from early_exit_tpu.data import librispeech as jls
from early_exit_tpu.data.pipeline import Pipeline as JPipeline
from early_exit_tpu.tokenizer import load_tokenizer as jload_tokenizer
from early_exit_tpu_torch import _native, cli
from early_exit_tpu_torch import train as port_train
from early_exit_tpu_torch.configs import AudioConfig, TrainConfig
from early_exit_tpu_torch.data import flac, librispeech
from early_exit_tpu_torch.data.pipeline import Pipeline
from early_exit_tpu_torch.data.synthetic import SyntheticDataset
from early_exit_tpu_torch.tokenizer import load_tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BPE = os.path.join(REPO, "assets", "spm", "synth.bpe-256.model")


def write_corpus(root, split="test-clean", speakers=("19", "103", "7"),
                 chapters=("200", "31"), per_chapter=1, seed=11, extra=None):
    """A LibriSpeech-layout FLAC corpus of SyntheticDataset utterances;
    extra maps an utterance index to a transcript that replaces its own.
    Returns the transcripts in file order."""
    ds = SyntheticDataset(n_items=len(speakers) * len(chapters) * per_chapter, seed=seed)
    i, texts = 0, []
    for spk in speakers:
        for ch in chapters:
            d = os.path.join(root, "LibriSpeech", split, spk, ch)
            os.makedirs(d, exist_ok=True)
            lines = []
            for u in range(per_chapter):
                utt = ds[i]
                text = (extra or {}).get(i, utt.transcript)
                stem = f"{spk}-{ch}-{u:04d}"
                flac.write_flac_verbatim(os.path.join(d, stem + ".flac"), utt.waveform)
                lines.append(f"{stem} {text}")
                texts.append(text)
                i += 1
            with open(os.path.join(d, f"{spk}-{ch}.trans.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
    return texts


@pytest.mark.parametrize("n", [100, 4096, 4096 * 2 + 17])
@pytest.mark.parametrize("kind", ["float", "int16"])
def test_flac_writer_bytes_and_decoder_equal_jax(tmp_path, n, kind):
    r = np.random.RandomState(n)
    x = (r.randn(n) * 0.3).astype(np.float32)
    x[:3] = [1.5, -1.5, 0.0]                      # clipped in the float writer
    if kind == "int16":
        x = (x.clip(-1, 1) * 32767).astype(np.int16)
    a, b = str(tmp_path / "port.flac"), str(tmp_path / "jax.flac")
    flac.write_flac_verbatim(a, x)
    jflac.write_flac_verbatim(b, x)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    got, sr = flac.read_flac(a)
    want, jsr = jflac.read_flac(b)
    assert sr == jsr == 16000 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    q = x if kind == "int16" else (np.clip(x, -1, 1) * 32767).astype(np.int16)
    np.testing.assert_array_equal(got, q.astype(np.float32) / 32768.0)


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_reader_equals_jax(tmp_path, channels):
    path = str(tmp_path / "a.wav")
    pcm = (np.random.RandomState(3).randn(800 * channels) * 8000).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    got, sr = librispeech.read_audio(path)
    want, jsr = jls.read_audio(path)
    assert sr == jsr
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unsupported"):
        librispeech.read_audio(str(tmp_path / "a.mp3"))


def test_librispeech_dataset_order_and_items_equal_jax(tmp_path):
    root = str(tmp_path)
    write_corpus(root, per_chapter=2)
    write_corpus(root, split="dev-clean", speakers=("5",), chapters=("9",), seed=12)
    # an audio file without a transcript line is not listed
    os.link(os.path.join(root, "LibriSpeech", "test-clean", "7", "31", "7-31-0000.flac"),
            os.path.join(root, "LibriSpeech", "test-clean", "7", "31", "7-31-0099.flac"))
    for url in ("test-clean", "test-clean,dev-clean"):
        mine, theirs = librispeech.LibriSpeechDataset(root, url), jls.LibriSpeechDataset(root, url)
        assert mine.items == theirs.items and mine.bases == theirs.bases
        assert len(mine) == (12 if url == "test-clean" else 13)
        assert [it[2:4] for it in mine.items][:4] == [("103", "200"), ("103", "200"),
                                                      ("103", "31"), ("103", "31")]
        for i in range(len(mine)):
            a, b = mine[i], theirs[i]
            np.testing.assert_array_equal(a.waveform, b.waveform)
            assert (a.sample_rate, a.transcript, a.speaker_id, a.chapter_id,
                    a.utterance_id) == (b.sample_rate, b.transcript, b.speaker_id,
                                        b.chapter_id, b.utterance_id)
    with pytest.raises(FileNotFoundError):
        librispeech.LibriSpeechDataset(root, "test-other")


def test_infer_pipeline_batches_equal_jax(tmp_path):
    root = str(tmp_path)
    texts = write_corpus(root, per_chapter=2, extra={
        1: "HELLO, WORLD! <unk> #THE$",            # punctuation and <unk> cleaned
        4: "ignore_time_segment_in_scoring",        # not scored: dropped
        6: " ".join(["WORD"] * 120)})               # long label: kept at inference
    tok, jtok = load_tokenizer(BPE), jload_tokenizer(BPE)
    acfg, jacfg = AudioConfig(mel_method="dft"), JAudioConfig(mel_method="dft")
    kw = dict(batch_size=4, n_batch_split=1, max_utterance_length=100)
    pipe = Pipeline(librispeech.LibriSpeechDataset(root, "test-clean"), tok, acfg,
                    TrainConfig(**kw), shuffle=False, infer_mode=True, workers=2,
                    device="cpu")
    jpipe = JPipeline(jls.LibriSpeechDataset(root, "test-clean"), jtok, jacfg,
                      JTrainConfig(**kw), shuffle=False, infer_mode=True, workers=2)
    got, want = list(pipe.epoch(0)), list(jpipe.epoch(0))
    assert len(got) == len(want) == 3
    n_items = 0
    for g, w in zip(got, want):
        for k in ("feat_lengths", "labels", "label_lengths", "item_mask"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=k)
        np.testing.assert_allclose(g["feats"].numpy(), np.asarray(w["feats"]),
                                   rtol=1e-4, atol=1e-4 * float(np.abs(w["feats"]).max()))
        n_items += int(g["item_mask"].sum())
    assert n_items == len(texts) - 1
    labels = [tok.decode(l[1:n].tolist()) for g in got
              for l, n, m in zip(g["labels"], g["label_lengths"], g["item_mask"]) if m]
    assert "hello world the" in [s.lower() for s in labels]
    # the training mode drops the long label and keeps the unscored one
    train = Pipeline(librispeech.LibriSpeechDataset(root, "test-clean"), tok, acfg,
                     TrainConfig(**kw), shuffle=False, workers=2, device="cpu")
    assert sum(int(b["item_mask"].sum()) for b in train.epoch(0)) == len(texts) - 1
    ds = pipe.ds
    long = next(i for i in range(len(ds)) if ds.items[i][1].startswith("WORD WORD"))
    unscored = next(i for i in range(len(ds)) if ds.items[i][1].startswith("ignore"))
    assert train._load_item(long) is None and pipe._load_item(unscored) is None
    assert pipe._load_item(long) is not None and train._load_item(unscored) is not None


@pytest.mark.parametrize("mode", ["train", "infer"])
@pytest.mark.parametrize("flags", [[], ["--attn_softmax_dtype", "float32"],
                                   ["--mel_method", "fft"], ["--bpe", "false"]])
def test_get_args_modes_equal_jax(mode, flags):
    argv = ["--decoder_mode", "ctc", *flags]
    args, mcfg, _, acfg, _ = cli.get_args(argv, mode=mode)
    jargs, jmcfg, _, jacfg, _ = jcli.get_args(argv, mode=mode)
    assert args.attn_softmax_dtype == jargs.attn_softmax_dtype
    assert args.mel_method == jargs.mel_method == acfg.mel_method == jacfg.mel_method
    assert mcfg.attn_softmax_dtype == jmcfg.attn_softmax_dtype
    assert (args.lexicon, args.tokens) == (jargs.lexicon, jargs.tokens)
    if mode == "infer" and not flags:
        assert args.attn_softmax_dtype == "bfloat16" and args.mel_method == "dft"
    with pytest.raises(ValueError, match="mode"):
        cli.get_args(argv, mode="serve")


def test_native_library_builds_into_its_own_directory():
    path = _native.build()
    assert os.path.dirname(path) == os.path.join(REPO, "build", "torch_native")
    assert os.path.exists(path) and path == _native.lib_path()
    assert _native.get_lib() is _native.get_lib()
    assert not [s for s in _native.sources() if s.endswith("_cli.cc")]
    assert any(s.endswith(os.path.join("audio", "flac.cc")) for s in _native.sources())


def test_train_cli_on_a_flac_corpus(tmp_path, capsys):
    root = str(tmp_path / "corpus")
    write_corpus(root, split="train-clean-100", per_chapter=2)
    port_train.main([
        "--decoder_mode", "ctc", "--data_root", root, "--device", "cpu",
        "--d_model", "32", "--n_enc_exits", "2", "--n_enc_layers_per_exit", "1",
        "--n_heads", "4", "--d_feed_forward", "64", "--depthwise_kernel_size", "7",
        "--batch_size", "4", "--n_batch_split", "1", "--n_workers", "2", "--n_epochs", "1",
        "--save_model_dir", str(tmp_path / "ck"), "--log_dir", str(tmp_path / "runs")])
    out = capsys.readouterr().out
    assert "LOSS_TOTAL-0 := " in out and " 3 sub-batches)" in out
    assert os.path.exists(tmp_path / "ck" / "mod000-transformer")
    with pytest.raises(SystemExit, match="no LibriSpeech split"):
        port_train.main(["--decoder_mode", "ctc", "--data_root", str(tmp_path / "none"),
                         "--device", "cpu", "--save_model_dir", str(tmp_path / "ck2")])


def test_audio_samples_from_headers_equal_the_decoded_length(tmp_path):
    """`audio_samples` (the sharded pipeline's metadata) reads the count
    that `read_audio` returns from the header, and the dataset's `meta`
    gives it with the transcript."""
    r = np.random.RandomState(0)
    for n in (100, 4096, 4096 * 2 + 17):
        path = str(tmp_path / f"{n}.flac")
        flac.write_flac_verbatim(path, (r.randn(n) * 0.3).astype(np.float32))
        assert librispeech.audio_samples(path) == len(librispeech.read_audio(path)[0]) == n
    for channels in (1, 2):
        path = str(tmp_path / f"{channels}.wav")
        with wave.open(path, "wb") as w:
            w.setnchannels(channels)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(np.zeros(800 * channels, np.int16).tobytes())
        assert librispeech.audio_samples(path) == len(librispeech.read_audio(path)[0]) == 800
    root = str(tmp_path / "corpus")
    write_corpus(root)
    ds = librispeech.LibriSpeechDataset(root, "test-clean")
    for i in range(len(ds)):
        assert ds.meta(i) == (len(ds[i].waveform), ds[i].transcript)
