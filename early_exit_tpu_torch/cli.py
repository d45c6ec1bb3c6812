"""Command-line flags of the port's entry points (`train.py`,
`inference.py`).

The same flags and defaults as `early_exit_tpu/cli.py` (the reference's
util/conf.py surface plus the JAX package's additions), so invocations
carry across unchanged, and `--device` (default cuda). `get_args`
resolves the "auto" profile flags as the JAX package does: for training
(mode "train") float32 attention softmax and FFT mel, for inference
(mode "infer") bf16 softmax and DFT mel. It loads the tokenizer, sets
the special ids and vocabulary size, finds the lexicon beam's
`.lex`/`.tok` pair beside the tokenizer's model file, and builds the
configs. Flags that mean nothing to PyTorch (--fast_rng, --n_threads,
--init_lr) warn when set, as the JAX package's dead flags do; modes the
port has not ported raise by name in the entry points.
"""

from __future__ import annotations

import argparse
import os

from early_exit_tpu_torch import checkpoint
from early_exit_tpu_torch.configs import AudioConfig, ModelConfig, TrainConfig
from early_exit_tpu_torch.tokenizer import CharTokenizer, load_tokenizer


def _bool(v: str) -> bool:
    return str(v).lower() not in ("false", "0", "no", "")


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)

    # model architecture
    p.add_argument("--decoder_mode", type=str.lower, required=True,
                   choices=["ctc", "aed"],
                   help="CTC decoder or attention encoder-decoder (AED).")
    p.add_argument("--model_type", type=str.lower,
                   choices=["early_conformer", "early_zipformer",
                            "splitformer"],
                   default="early_conformer",
                   help="CTC-mode model family.")
    p.add_argument("--bpe", type=_bool, default=True,
                   help="Use SentencePiece BPE tokenization (True) or the "
                        "legacy 32-char map (False).")
    p.add_argument("--distill", type=_bool, default=False,
                   help="Self-distillation: the deepest exit teaches "
                        "earlier exits via temperature-smoothed KL "
                        "(implemented here; reserved in the reference).")
    p.add_argument("--distill_weight", type=float, default=1.0)
    p.add_argument("--distill_temperature", type=float, default=2.0)

    # checkpoints
    p.add_argument("--save_model_dir", type=str, default="/trained_model")
    p.add_argument("--keep_last_ckpts", type=int, default=0,
                   help="keep only the newest N saved epoch checkpoints "
                        "(model+optimizer pairs); 0 = keep all (the "
                        "reference behavior — ~1 GB/epoch at reference "
                        "dims, which fills a disk on multi-hundred-epoch "
                        "runs)")
    p.add_argument("--load_model_path", type=str, default=None)
    p.add_argument("--load_model_dir", type=str, default=None)
    p.add_argument("--avg_model_start", type=int, default=None)
    p.add_argument("--avg_model_end", type=int, default=None)

    # training schedule
    p.add_argument("--shuffle", type=_bool, default=True)
    p.add_argument("--n_epochs", type=int, default=10000)
    p.add_argument("--n_threads", type=int, default=10,
                   help="Parity flag; no effect in the port.")
    p.add_argument("--n_workers", type=int, default=10,
                   help="Host data-loading workers (parity flag).")

    # model dims
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--n_batch_split", type=int, default=4)
    p.add_argument("--max_len", type=int, default=2000)
    p.add_argument("--d_model", type=int, default=256)
    p.add_argument("--n_enc_layers_per_exit", type=int, default=2)
    p.add_argument("--n_enc_exits", type=int, default=6)
    p.add_argument("--n_dec_layers", type=int, default=6)
    p.add_argument("--n_heads", type=int, default=8)
    p.add_argument("--d_feed_forward", type=int, default=2048)
    p.add_argument("--aed_ce_weight", type=float, default=0.7)
    p.add_argument("--aed_ctc_weight", type=float, default=0.3)
    p.add_argument("--drop_prob", type=float, default=0.1)
    p.add_argument("--depthwise_kernel_size", type=int, default=31)
    p.add_argument("--max_utterance_length", type=int, default=360)

    # assets
    p.add_argument("--lexicon_path", type=str, default="lexicon.txt")
    p.add_argument("--tokens_path", type=str, default="tokens.txt")
    p.add_argument("--bpe_model_path", type=str,
                   default="sentencepiece/build/libri.bpe-256.model",
                   help="SentencePiece .model artifact; the committed "
                        "assets/spm/synth.bpe-256.model when absent.")

    # audio frontend
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--n_fft", type=int, default=512)
    p.add_argument("--win_length", type=int, default=320)
    p.add_argument("--hop_length", type=int, default=160)
    p.add_argument("--n_mels", type=int, default=80)

    # optimizer
    p.add_argument("--init_lr", type=float, default=1e-5,
                   help="Parity flag (the reference parses but never uses "
                        "it; Noam sets the LR).")
    p.add_argument("--adam_eps", type=float, default=1e-9)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--warmup", type=int, default=-1)
    p.add_argument("--clip", type=float, default=1.0)

    # inference
    p.add_argument("--beam_size", type=int, default=10)
    p.add_argument("--pen_alpha", type=float, default=1.0)
    p.add_argument("--word_score", type=float, default=0.0,
                   help="Per-word insertion score in the lexicon beam "
                        "(flashlight word_score; the reference uses "
                        "WORD_SCORE=-4 for its LM decoders, "
                        "util/beam_infer.py:63).")
    p.add_argument("--lm_path", type=str, default=None,
                   help="ARPA n-gram LM for shallow fusion in the "
                        "lexicon beam (the reference's KenLM slot, "
                        "util/beam_infer.py:77-78).")
    p.add_argument("--lm_weight", type=float, default=1.0,
                   help="LM fusion weight (reference LM_WEIGHT=1.0, "
                        "util/beam_infer.py:62).")

    # ---- additions of the JAX package (no reference equivalent) ----
    p.add_argument("--data_root", type=str, default=".",
                   help="Directory containing LibriSpeech/ (data.py uses "
                        "the working directory).")
    p.add_argument("--train_split", type=str, default="train-clean-100",
                   help="LibriSpeech training split; a comma-separated "
                        "list concatenates splits (the reference's "
                        "full-960h ConcatDataset recipe, data.py:9-16), "
                        "e.g. train-clean-100,train-clean-360.")
    p.add_argument("--synthetic_data", type=_bool, default=False,
                   help="Use the deterministic synthetic corpus (smoke "
                        "runs without LibriSpeech).")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--conv_norm", type=str, default="batch",
                   choices=["batch", "group"],
                   help="The conv module's norm: masked BatchNorm, or the "
                        "masked GroupNorm(1) of each utterance (unfused path "
                        "only: --fused_block true raises).")
    p.add_argument("--length_mode", type=str, default="reference",
                   choices=["reference", "true"])
    p.add_argument("--ctc_compat_padded_lengths", type=_bool,
                   default=False,
                   help="Reference quirk train.py:57-58: feed the padded "
                        "frame count as CTC input length. Default OFF "
                        "(true per-item lengths): counting padding as "
                        "valid CTC input lets deep exits park tokens in "
                        "padding frames and collapse when batches carry "
                        "real padding (measured: exit-2 WER 200%% -> 0%% "
                        "on the rehearsal corpus, BENCH_NOTES.md); "
                        "enable only for bit-parity debugging against "
                        "the reference.")
    p.add_argument("--dp", type=int, default=None,
                   help="Data-parallel size (default WORLD_SIZE // --tp); "
                        "launch dp x tp ranks with torchrun.")
    p.add_argument("--tp", type=int, default=1,
                   help="Tensor-parallel size: the FFN and the vocab heads "
                        "sharded over tp ranks.")
    p.add_argument("--log_dir", type=str, default="runs")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--decode", type=str, default="greedy",
                   choices=["greedy", "prefix_beam", "lexicon_beam"],
                   help="CTC decoding strategy at inference.")
    p.add_argument("--timestamps", type=_bool, default=False,
                   help="CTC mode (greedy/prefix_beam): print per-word "
                        "start/end seconds + confidence for the final "
                        "exit, via forced alignment of the hypothesis "
                        "(decoding/timestamps.py; the reference computes "
                        "the trellis, util/beam_infer.py:129-191, but "
                        "never surfaces timestamps).")
    p.add_argument("--rescore_ctc_weight", type=float, default=0.0,
                   help="AED mode: re-rank each exit's beam n-best by the "
                        "joint max-normalized CTC+attention score — the "
                        "reference's commented-out rescoring branch "
                        "(util/beam_infer.py:309-383), completed with the "
                        "exact CTC log-marginal (decoding/rescore.py). "
                        "0 (default) keeps the pure attention ranking.")
    p.add_argument("--eval_splits", type=str,
                   default="test-clean,test-other",
                   help="Comma-separated LibriSpeech splits to decode "
                        "(inference.py evaluates test-clean and "
                        "test-other; dev-* also valid).")
    p.add_argument("--exit_threshold", type=float, default=None,
                   help="Confidence-gated dynamic early exit: stop at the "
                        "first exit whose mean max-prob exceeds this "
                        "(beyond-reference feature).")
    p.add_argument("--gate_score", type=str, default="maxprob",
                   choices=["maxprob", "margin", "negentropy"],
                   help="Confidence statistic for the gate "
                        "(models/early_exit_gate.exit_confidence).")
    p.add_argument("--gate_calibration", type=str, default=None,
                   help="JSON from tools/calibrate_gate.py: per-exit "
                        "temperatures + thresholds (and the fitted "
                        "score) override --exit_threshold/--gate_score.")
    p.add_argument("--cascade_k", type=int, default=None,
                   help="Gated inference via the two-phase re-batching "
                        "cascade (serving/cascade.py): a fixed-cost run "
                        "of exits 1..k on every utterance, then only "
                        "unconfident rows continue (re-batched, trunk "
                        "resumed from the cached layer-k hidden) through "
                        "exits k+1..E. Decisions identical to the "
                        "while_loop gate; computed cost is per-utterance "
                        "instead of batch-max. Requires --exit_threshold "
                        "or --gate_calibration.")
    p.add_argument("--fast_exit", type=int, default=1,
                   help="Gated STREAMING only: the shallow stage exit "
                        "each chunk decodes at before the confidence "
                        "gate decides whether to escalate to the deep "
                        "trunk (serving/streaming.py fast_exit). Use "
                        "the flagship's best shallow exit (2) when "
                        "exit 1 is below serving quality.")
    p.add_argument("--cascade_pack", type=int, default=16,
                   help="Phase-B re-batch granularity: escalated rows "
                        "are packed into batches padded to a multiple "
                        "of this.")

    p.add_argument("--profile_trace", type=str, default=None,
                   help="Capture a torch.profiler trace (CPU and CUDA "
                        "activity) of training steps 1..--profile_steps "
                        "of the first epoch into <dir>/trace.json "
                        "(chrome trace format).")
    p.add_argument("--profile_steps", type=int, default=10)

    # performance profile. "auto" resolves by mode: training fp32
    # attention softmax + FFT mel, inference bf16 softmax + DFT mel.
    p.add_argument("--attention_impl", type=str, default="xla",
                   choices=["xla", "pallas"],
                   help="Attention: PyTorch ops, or the CUDA attention "
                        "kernel at inference (it has no backward, so "
                        "training with it raises).")
    p.add_argument("--fused_block", type=_bool, default=False,
                   help="Run inference (the sample decode) through the "
                        "CUDA Conformer block kernel; training always "
                        "runs the PyTorch blocks.")
    p.add_argument("--quantize", type=str, default="none",
                   choices=["none", "int8"],
                   help="W8A8 int8 quantization of the encoder blocks at "
                        "inference; training is always unquantized.")
    p.add_argument("--remat", type=_bool, default=False,
                   help="Recompute each conformer block in backward "
                        "(torch.utils.checkpoint): less activation memory "
                        "for more compute.")
    p.add_argument("--residual_dtype", type=str, default="auto",
                   choices=["auto", "bfloat16", "float32"],
                   help="Residual-stream dtype between sublayers; auto = "
                        "compute_dtype (bf16 halves activation HBM "
                        "traffic).")
    p.add_argument("--attn_softmax_dtype", type=str, default="auto",
                   choices=["auto", "bfloat16", "float32"],
                   help="Dtype of materialised attention scores/probs; "
                        "auto = fp32 in training, bf16 at inference.")
    p.add_argument("--fast_rng", type=_bool, default=True,
                   help="Parity flag (a PRNG choice of the JAX package); "
                        "no effect in the port.")
    p.add_argument("--mel_method", type=str, default="auto",
                   choices=["auto", "fft", "dft"],
                   help="Mel frontend: rFFT or real-DFT products; auto = "
                        "fft in training, dft at inference.")
    p.add_argument("--streaming", type=_bool, default=False,
                   help="Inference only: decode through the streaming "
                        "serving path (chunked windows via StreamPool) "
                        "instead of whole utterances.")
    p.add_argument("--streaming_chunk_s", type=float, default=1.0)
    p.add_argument("--streaming_left_s", type=float, default=3.0)
    p.add_argument("--streaming_right_s", type=float, default=0.5)
    p.add_argument("--streaming_causal", type=str, default="auto",
                   choices=["auto", "true", "false"],
                   help="Use the dynamic-chunk attention pattern inside "
                        "streaming windows. auto (default) follows "
                        "--dynamic_chunk_training, so a vanilla "
                        "full-attention checkpoint is evaluated with "
                        "the mask it was trained with and its WER stays "
                        "comparable to the batch path.")
    p.add_argument("--dynamic_chunk_training", type=_bool, default=False,
                   help="Sample a chunked self-attention mask per step "
                        "(50%% full attention) so one model serves both "
                        "whole-utterance and streaming inference "
                        "(early_conformer CTC mode).")
    p.add_argument("--chunk_left_context", type=int, default=1000,
                   help="Chunks of left context kept in dynamic-chunk "
                        "training (1000 = effectively unlimited).")
    p.add_argument("--specaugment", type=_bool, default=False,
                   help="SpecAugment masking at train time (beyond-"
                        "reference; Park et al. 2019): frequency masks + "
                        "adaptive time masks on the log-mel features.")
    p.add_argument("--sa_freq_masks", type=int, default=2)
    p.add_argument("--sa_freq_width", type=int, default=27,
                   help="Max mel bins per frequency mask (of 80).")
    p.add_argument("--sa_time_masks", type=int, default=2)
    p.add_argument("--sa_time_frac", type=float, default=0.05,
                   help="Max time-mask width as a fraction of each "
                        "item's valid frames (adaptive masking).")

    # ---- the port's own ----
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu.")
    return p


OWN_BPE_MODEL = os.path.join(checkpoint.REPO, "assets", "spm",
                             "synth.bpe-256.model")
DEAD_FLAGS = ("fast_rng", "n_threads", "init_lr")


def resolve_bpe_model(path: str, load_model_path=None) -> str:
    """The tokenizer: the committed flagship's bound tokenizer when
    training from it (checked by sha256), else the requested file, else
    the committed asset."""
    if load_model_path and os.path.exists(load_model_path) and os.path.samefile(
            load_model_path, checkpoint.FLAGSHIP_CKPT) and not os.path.exists(path):
        return checkpoint.bound_tokenizer(checkpoint.load_calib())
    for cand in (path, OWN_BPE_MODEL):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"BPE model not found: {path} (nor {OWN_BPE_MODEL})")


def get_args(argv=None, mode: str = "train"):
    """Returns (args, model_cfg, train_cfg, audio_cfg, tokenizer). mode
    ("train" | "infer") resolves the "auto" profile flags."""
    if mode not in ("train", "infer"):
        raise ValueError(f"mode must be 'train' or 'infer': {mode!r}")
    parser = get_parser()
    args = parser.parse_args(argv)
    for dead in DEAD_FLAGS:
        if getattr(args, dead) != parser.get_default(dead):
            print(f"warning: --{dead} is accepted for reference-CLI "
                  f"parity but has no effect here")
    if args.attn_softmax_dtype == "auto":
        args.attn_softmax_dtype = "float32" if mode == "train" else "bfloat16"
    if args.mel_method == "auto":
        args.mel_method = "fft" if mode == "train" else "dft"
    residual_dtype = None if args.residual_dtype == "auto" else args.residual_dtype

    if args.bpe:
        args.bpe_model_path = resolve_bpe_model(args.bpe_model_path,
                                                args.load_model_path)
        tokenizer = load_tokenizer(args.bpe_model_path)
        vocab = tokenizer.get_piece_size()
        blank_id, pad_id, bos_id, eos_id = 0, 126, 1, 2
        # the lexicon beam's pair beside the tokenizer's model file:
        # "<model stem>.{lex,tok}", else the reference's fixed names
        mdir = os.path.dirname(args.bpe_model_path) or "."
        stem = os.path.splitext(os.path.basename(args.bpe_model_path))[0]
        args.lexicon = os.path.join(mdir, stem + ".lex")
        args.tokens = os.path.join(mdir, stem + ".tok")
        if not (os.path.exists(args.lexicon) and os.path.exists(args.tokens)):
            args.lexicon = os.path.join(mdir, "librispeech-bpe-256.lex")
            args.tokens = os.path.join(mdir, "librispeech-bpe-256.tok")
    else:
        tokenizer = CharTokenizer()
        vocab = 32
        blank_id, pad_id, bos_id, eos_id = 0, 30, 1, 31
        args.lexicon, args.tokens = args.lexicon_path, args.tokens_path

    model_type = args.model_type if args.decoder_mode == "ctc" else "full_conformer"
    model_cfg = ModelConfig(
        model_type=model_type, d_model=args.d_model, n_heads=args.n_heads,
        d_feed_forward=args.d_feed_forward, n_enc_exits=args.n_enc_exits,
        n_enc_layers_per_exit=args.n_enc_layers_per_exit,
        n_dec_layers=args.n_dec_layers,
        depthwise_kernel_size=args.depthwise_kernel_size,
        drop_prob=args.drop_prob, max_len=args.max_len, n_mels=args.n_mels,
        vocab_size=vocab, blank_id=blank_id, pad_id=pad_id, bos_id=bos_id,
        eos_id=eos_id, compute_dtype=args.compute_dtype,
        conv_norm=args.conv_norm, length_mode=args.length_mode,
        attention_impl=args.attention_impl, remat=args.remat,
        residual_dtype=residual_dtype,
        attn_softmax_dtype=args.attn_softmax_dtype,
        fused_block=args.fused_block, quantize=args.quantize)
    train_cfg = TrainConfig(
        batch_size=args.batch_size, n_batch_split=args.n_batch_split,
        n_epochs=args.n_epochs, warmup=args.warmup, adam_eps=args.adam_eps,
        weight_decay=args.weight_decay, clip=args.clip,
        max_utterance_length=args.max_utterance_length,
        decoder_mode=args.decoder_mode, aed_ce_weight=args.aed_ce_weight,
        aed_ctc_weight=args.aed_ctc_weight,
        ctc_compat_padded_lengths=args.ctc_compat_padded_lengths,
        fast_rng=args.fast_rng, distill=args.distill,
        distill_weight=args.distill_weight,
        distill_temperature=args.distill_temperature,
        dynamic_chunk=args.dynamic_chunk_training,
        chunk_left=args.chunk_left_context, specaugment=args.specaugment,
        sa_freq_masks=args.sa_freq_masks, sa_freq_width=args.sa_freq_width,
        sa_time_masks=args.sa_time_masks, sa_time_frac=args.sa_time_frac,
        seed=args.seed)
    audio_cfg = AudioConfig(
        sample_rate=args.sample_rate, n_fft=args.n_fft,
        win_length=args.win_length, hop_length=args.hop_length,
        n_mels=args.n_mels, mel_method=args.mel_method)
    return args, model_cfg, train_cfg, audio_cfg, tokenizer
