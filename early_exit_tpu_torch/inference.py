"""Inference entry point of the port: decoding of every exit of the
early-exit Conformer, CTC or AED, the same surface as the JAX package's
`inference.py`.

    python -m early_exit_tpu_torch.inference --decoder_mode ctc \\
        --load_model_path assets/flagship_ckpt --data_root <dir> \\
        [--eval_splits test-clean,test-other] [--decode greedy] \\
        [--fused_block true] [--device cpu] ...

Per split: every utterance of the LibriSpeech layout under --data_root
(or the synthetic corpus with --synthetic_data true), decoded at every
exit, with `EXPECTED:` / `BEAM_OUT_ n :` pairs (the lexicon corrector
snaps out-of-lexicon words), `TIMESTAMPS:` of the last exit with
--timestamps, and the WER of each exit. One batched forward gives every
exit; then greedy CTC, the prefix beam (on the device) or the lexicon
beam (C++ on the host, optionally with an ARPA LM through --lm_path).
With --fused_block true the trunk runs through the Conformer block kernel
and greedy decoding through the head + argmax kernel. --exit_threshold or
--gate_calibration decodes each utterance at one exit instead: the
batch-conservative gate, or with --cascade_k the two-phase cascade.
--streaming true decodes each split through `StreamPool` instead: audio
fed --streaming_chunk_s a round to --batch_size streams, every exit
decoded from one trunk pass per window, or with --exit_threshold each
chunk gated at --fast_exit (`serving/streaming.py`).

--decoder_mode aed decodes a `full_conformer`: per batch the trunk once
for all exits (through the block kernel with --fused_block true), then
per exit the KV-cached beam over the whole batch (--beam_size,
--pen_alpha, the reference's max-length heuristic), with
--rescore_ctc_weight > 0 the n-best re-ranked by the joint CTC +
attention score of that exit's CTC head.

--model_type splitformer or early_zipformer (with --n_enc_exits 19
--n_enc_layers_per_exit 1) decodes those models as the flagship: every
exit from one forward (the zipformer has one), with --fused_block true
their stacks through the block kernel and greedy decoding through the
head + argmax kernel; --exit_threshold gates the splitformer. As in the
JAX CLI, the zipformer has nothing to gate, and --cascade_k and
--streaming run the early_conformer only.

The model comes from --load_model_path or the average of the epoch
checkpoints --avg_model_start..--avg_model_end in --load_model_dir. Runs
on CUDA unless --device cpu; raises without a GPU otherwise.

--conv_norm group decodes a group-norm model on the unfused path (the JAX
package's unfused path); with --fused_block true it raises by name: the
block kernel folds BatchNorm running statistics and cannot compute a
GroupNorm.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from early_exit_tpu_torch import runtime
from early_exit_tpu_torch.cli import get_args
from early_exit_tpu_torch.data.librispeech import LibriSpeechDataset, SyntheticDataset
from early_exit_tpu_torch.data.pipeline import Pipeline
from early_exit_tpu_torch.decoding.lexicon import LexiconCorrector, load_dict
from early_exit_tpu_torch.models.registry import build_model
from early_exit_tpu_torch.ops import ctc
from early_exit_tpu_torch.ops.kernels.head_argmax import head_argmax
from early_exit_tpu_torch.training import checkpoint
from early_exit_tpu_torch.utils.metrics import WerAccumulator
from early_exit_tpu_torch.utils.model_utils import count_parameters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPM = os.path.join(REPO, "assets", "spm")


def check_ported(args) -> None:
    """The JAX CLI's usage errors, before any model is built."""
    if args.streaming and args.decoder_mode != "ctc":
        sys.exit("--streaming is a CTC serving path; AED decoding "
                 "is whole-utterance only")
    if args.streaming:
        check_streaming(args)


def check_streaming(args) -> None:
    """The JAX CLI's usage errors of --streaming."""
    if args.model_type != "early_conformer":
        sys.exit("--streaming: the chunked-window recognizer runs the "
                 "early_conformer trunk (serving/streaming.py); "
                 f"{args.model_type} checkpoints are batch-only")
    if args.decode != "greedy" or args.lm_path:
        sys.exit("--streaming decodes greedily per chunk; it does not "
                 "combine with --decode beams or --lm_path (run without "
                 "--streaming for those)")
    if args.gate_calibration is not None:
        sys.exit("--streaming gates per CHUNK at one fast exit "
                 "(--exit_threshold [--gate_score]); the per-exit "
                 "calibrated thresholds of --gate_calibration are fitted "
                 "on whole-utterance confidence and do not apply — run "
                 "without --streaming to use them")


def _load_lexicon(args):
    for cand in ("librispeech.lex", os.path.join(SPM, "words.txt")):
        if os.path.exists(cand):
            return LexiconCorrector(load_dict(cand))
    print("warning: librispeech.lex not found; lexicon correction off")
    return None


def _gate_operating_point(model_cfg, args):
    """(threshold, score, temperatures) from --gate_calibration (the
    fitted per-exit operating point) or the raw --exit_threshold."""
    score, temps = args.gate_score, None
    if args.gate_calibration is not None:
        with open(args.gate_calibration) as f:
            calib = json.load(f)
        thr = [float(t) for t in calib["thresholds"]]
        if len(thr) != model_cfg.n_enc_exits:
            sys.exit(f"--gate_calibration: {len(thr)} thresholds for a "
                     f"{model_cfg.n_enc_exits}-exit model")
        score = calib.get("score", score)
        temps = calib.get("temperatures")
        if temps is not None and len(temps) != model_cfg.n_enc_exits:
            sys.exit(f"--gate_calibration: {len(temps)} temperatures for "
                     f"a {model_cfg.n_enc_exits}-exit model")
        print(f"gate calibration: score={score} thresholds="
              f"{[round(t, 3) for t in thr]} (from {args.gate_calibration})")
    else:
        thr = float(args.exit_threshold)
    return thr, score, temps


def _references(batch, tokenizer):
    """Each real row's reference text (None for padding) and the item
    mask, on the host."""
    mask = batch["item_mask"].cpu().numpy().astype(bool)
    labels = batch["labels"].cpu().numpy()
    lab_len = batch["label_lengths"].cpu().numpy()
    refs = []
    for b in range(labels.shape[0]):
        if not mask[b]:
            refs.append(None)
            continue
        refs.append(tokenizer.decode([int(t) for t in labels[b][1:lab_len[b]]]).lower())
    return refs, mask


def _hyp(tokenizer, lex, ids) -> str:
    hyp = tokenizer.decode([int(t) for t in ids]).lower()
    return lex.apply(hyp) if lex is not None else hyp


def run_ctc_gated_cascade(model, model_cfg, pipe, split, tokenizer, lex, args):
    """Gated inference through the two-phase cascade (--cascade_k,
    serving/cascade.py): exits 1..k for every utterance, the unconfident
    rows re-batched and resumed through exits k+1..E. Decisions are
    those of the batch-conservative gate; the exits computed are counted
    per utterance."""
    from early_exit_tpu_torch.serving import cascade
    E, k = model_cfg.n_enc_exits, int(args.cascade_k)
    thr, score, temps = _gate_operating_point(model_cfg, args)
    gate = dict(k=k, threshold=thr, score=score, temperatures=temps)
    blank = model_cfg.blank_id
    acc = WerAccumulator()
    chosen_all, n_utts, exits_computed = [], 0, 0
    for batch in pipe.epoch(0):
        lp, chosen, accepted, sub_len, h_k = cascade.shallow_apply(
            model, batch["feats"], batch["feat_lengths"],
            item_mask=batch["item_mask"], **gate)
        toks, n = ctc.greedy_decode(lp, sub_len, blank=blank)
        toks, n, chosen = toks.cpu().numpy(), n.cpu().numpy(), chosen.cpu().numpy()
        idx, pmask = cascade.pack_escalation_indices(accepted.cpu().numpy(),
                                                     pack_batch=args.cascade_pack)
        refs, mask = _references(batch, tokenizer)
        exits_computed += k * int(mask.sum()) + (E - k) * len(idx)
        if idx.size:
            rows = torch.as_tensor(idx, dtype=torch.long, device=sub_len.device)
            sl = sub_len.index_select(0, rows)
            b_lp, b_chosen = cascade.continue_apply(model, h_k.index_select(0, rows),
                                                    sl, **gate)
            b_toks, b_n = ctc.greedy_decode(b_lp, sl, blank=blank)
            b_toks, b_n, b_chosen = (b_toks.cpu().numpy(), b_n.cpu().numpy(),
                                     b_chosen.cpu().numpy())
            for j, (i, real) in enumerate(zip(idx, pmask)):
                if real:
                    toks[i], n[i], chosen[i] = b_toks[j], b_n[j], b_chosen[j]
        for b, ref in enumerate(refs):
            if ref is None:
                continue
            hyp = _hyp(tokenizer, lex, toks[b][:n[b]])
            print(split, "EXPECTED:", ref)
            print(split, f"GATED_OUT (exit {int(chosen[b])}):", hyp)
            acc.add(ref, hyp)
            chosen_all.append(int(chosen[b]))
            n_utts += 1
    hist = {e: chosen_all.count(e) for e in range(1, E + 1)}
    print(f"{split} cascade exit histogram (utts per exit): {hist}")
    print(f"{split} cascade escalated: "
          f"{sum(v for e, v in hist.items() if e > k)}/{n_utts} "
          f"(k={k}, mean chosen exit "
          f"{np.mean(chosen_all) if chosen_all else 0:.2f})")
    print(f"{split} gated WER: {100 * acc.value:.2f}% "
          f"(mean exits run {exits_computed / max(n_utts, 1):.2f}/{E})")


def run_ctc_gated(model, model_cfg, pipe, split, tokenizer, lex, args):
    """Confidence-gated early exit: each batch stops at the first exit
    where every row's confidence has cleared its threshold."""
    from early_exit_tpu_torch.models import early_exit_gate
    if model_cfg.model_type not in early_exit_gate.GATED_MODEL_TYPES:
        sys.exit(f"--exit_threshold: gating needs a multi-exit encoder "
                 f"({', '.join(early_exit_gate.GATED_MODEL_TYPES)}); "
                 f"{model_cfg.model_type} emits a single exit "
                 "(reference README.md:61)")
    thr, score, temps = _gate_operating_point(model_cfg, args)
    acc = WerAccumulator()
    exits_run = []
    for batch in pipe.epoch(0):
        lp, chosen, sub_len, n_run = early_exit_gate.gated_apply(
            model, batch["feats"], batch["feat_lengths"], threshold=thr,
            item_mask=batch["item_mask"], score=score, temperatures=temps)
        exits_run.append(int(n_run))
        toks, n = ctc.greedy_decode(lp, sub_len, blank=model_cfg.blank_id)
        toks, n, chosen = toks.cpu().numpy(), n.cpu().numpy(), chosen.cpu().numpy()
        refs, _ = _references(batch, tokenizer)
        for b, ref in enumerate(refs):
            if ref is None:
                continue
            hyp = _hyp(tokenizer, lex, toks[b][:n[b]])
            print(split, "EXPECTED:", ref)
            print(split, f"GATED_OUT (exit {int(chosen[b])}):", hyp)
            acc.add(ref, hyp)
    print(f"{split} gated WER: {100 * acc.value:.2f}% "
          f"(mean exits run {np.mean(exits_run):.2f}/{model_cfg.n_enc_exits})")


def run_ctc_streaming(model, model_cfg, dataset, split, tokenizer, lex, args,
                      audio_cfg):
    """Decode the split through `StreamPool`: --batch_size streams at a
    time, fed --streaming_chunk_s of audio a round round-robin and polled
    each round (one batched dispatch a round), each tail flushed at the
    end. Ungated every exit is decoded from one trunk pass; with
    --exit_threshold each chunk is gated at --fast_exit and decoded at
    the deepest exit when it escalates."""
    from early_exit_tpu_torch.data import text
    from early_exit_tpu_torch.serving import StreamPool
    S = max(int(args.batch_size), 1)
    n_exit = model_cfg.n_enc_exits
    gated = args.exit_threshold is not None
    n_out = 1 if gated else n_exit
    accs = [WerAccumulator() for _ in range(n_out)]
    exits_run = []
    kw = dict(chunk_s=args.streaming_chunk_s, left_s=args.streaming_left_s,
              right_s=args.streaming_right_s,
              causal_attention=(args.dynamic_chunk_training
                                if args.streaming_causal == "auto"
                                else args.streaming_causal == "true"))
    if gated:
        kw.update(exit_threshold=float(args.exit_threshold),
                  gate_score=args.gate_score, fast_exit=args.fast_exit)
    else:
        kw["all_exits"] = True

    def groups():
        """Audio read one group of S utterances at a time."""
        group = []
        for i in range(len(dataset)):
            utt = dataset[i]
            ref = text.clean_infer_label(utt.transcript)
            if ref is None:
                continue
            group.append((ref, utt.waveform))
            if len(group) == S:
                yield group
                group = []
        if group:
            yield group

    step = int(audio_cfg.sample_rate * max(args.streaming_chunk_s, 0.1))
    for group in groups():
        pool = StreamPool(len(group), model, audio_cfg, tokenizer, **kw)
        longest = max(len(w) for _, w in group)
        for s0 in range(0, longest, step):
            for i, (_, w) in enumerate(group):
                if s0 < len(w):
                    pool.feed(i, w[s0:s0 + step])
            pool.poll()
        for i, (ref, _) in enumerate(group):
            pool.finish(i)
            rec = pool.recs[i]
            print(split, "EXPECTED:", ref.lower())
            for e in range(n_out):
                hyp = (rec.transcript if gated else rec.transcript_at(e + 1))
                hyp = hyp.strip().lower()
                if lex is not None:
                    hyp = lex.apply(hyp)
                label = n_exit if gated else e + 1
                print(split, f"STREAM_OUT (exit {label}):", hyp)
                accs[e].add(ref.lower(), hyp)
            exits_run.extend(rec.exits_run)
    gate = ""
    if exits_run:
        er = np.asarray(exits_run)
        hist = {e: int(np.sum(er == e)) for e in range(1, n_exit + 1)}
        gate = (f" (gated: mean exit {np.mean(er):.2f}/{n_exit}, "
                f"{100 * np.mean(er == 1):.0f}% of chunks at exit 1)")
        print(f"{split} streaming exit histogram (chunks per exit): {hist}")
    for e, acc in enumerate(accs):
        label = n_exit if gated else e + 1
        print(f"{split} streaming WER exit {label}: "
              f"{100 * acc.value:.2f}% ({acc.utterances} utts){gate}")


def _lexicon_beam(args):
    from early_exit_tpu_torch.decoding.lexicon_beam import LexiconBeamDecoder
    lm = None
    if args.lm_path:
        from early_exit_tpu_torch.decoding.ngram_lm import ArpaLM
        lm = ArpaLM(args.lm_path)
        print(f"shallow fusion: {args.lm_path} (order {lm.order}, weight "
              f"{args.lm_weight})")
    for tok, lex in ((args.tokens, args.lexicon),
                     (os.path.join(SPM, "synth.bpe-256.tok"),
                      os.path.join(SPM, "synth.bpe-256.lex"))):
        if os.path.exists(tok) and os.path.exists(lex):
            return LexiconBeamDecoder.from_files(
                lex, tok, beam_size=args.beam_size, word_score=args.word_score,
                lm=lm, lm_weight=args.lm_weight)
    sys.exit(f"lexicon_beam: tokens/lexicon not found ({args.tokens}, {args.lexicon})")


@torch.no_grad()
def exit_outputs(model, feats, lengths, *, greedy: bool, timestamps: bool):
    """One batched forward of every exit. greedy: per-frame argmax ids
    (E, B, T') int32 -- with fused bf16 blocks from the head + argmax
    kernel, else the argmax of the raw logits, which is what the JAX
    package decodes -- and, with timestamps, the last exit's raw logits
    (B, T', V). Otherwise float32 log-probs (E, B, T', V) for the beams.
    Returns (ids or log-probs, last exit's emission or None, sub_len)."""
    hidden, sub_len = model.apply_hidden(feats, lengths)
    if not greedy:
        return model.apply_heads(hidden, log_probs=True), None, sub_len
    cfg = model.cfg
    if cfg.fused_block and cfg.dtype == torch.bfloat16:
        ids = head_argmax(hidden.to(torch.bfloat16).contiguous(),
                          model.heads_w.to(torch.bfloat16),
                          model.heads_b.to(torch.bfloat16))
        last = (model.apply_heads(hidden[-1:], log_probs=False)[0]
                if timestamps else None)
        return ids, last, sub_len
    logits = model.apply_heads(hidden, log_probs=False)
    return torch.argmax(logits, dim=-1).to(torch.int32), logits[-1], sub_len


def run_ctc(model, model_cfg, pipe, split, tokenizer, lex, args):
    from early_exit_tpu_torch.decoding import prefix_beam
    from early_exit_tpu_torch.decoding import timestamps as ts
    greedy = args.decode == "greedy"
    trie_dec = _lexicon_beam(args) if args.decode == "lexicon_beam" else None
    blank = model_cfg.blank_id
    wers = None
    for batch in pipe.epoch(0):
        out, last_em, sub_len = exit_outputs(model, batch["feats"], batch["feat_lengths"],
                                             greedy=greedy, timestamps=args.timestamps)
        E = out.shape[0]
        if wers is None:
            wers = [WerAccumulator() for _ in range(E)]
        refs, mask = _references(batch, tokenizer)
        for ref in refs:
            if ref is not None:
                print(split, "EXPECTED:", ref)
        sub_h = sub_len.cpu().numpy()
        feat_len = batch["feat_lengths"].cpu().numpy()
        host_lp = out.cpu().numpy() if trie_dec is not None else None
        for e in range(E):
            if trie_dec is not None:
                # lexicon beam: the output is lexicon words already
                for b, hyp in enumerate(trie_dec.decode_batch(host_lp[e], sub_h)):
                    if mask[b]:
                        print(split, "BEAM_OUT_", e + 1, ":", hyp)
                        wers[e].add(refs[b], hyp)
                continue
            if greedy:
                toks, n = ctc.greedy_decode_ids(out[e], sub_len, blank=blank)
            else:
                toks, n, _ = prefix_beam.prefix_beam_search(
                    out[e], sub_len, beam_size=args.beam_size, blank=blank,
                    blank_skip_threshold=0.95)
            toks, n = toks.cpu().numpy(), n.cpu().numpy()
            last_exit = e == E - 1
            for b in range(toks.shape[0]):
                if not mask[b]:
                    continue
                ids = [int(t) for t in toks[b][:n[b]]]
                hyp = _hyp(tokenizer, lex, ids)
                print(split, "BEAM_OUT_", e + 1, ":", hyp)
                if args.timestamps and last_exit and ids:
                    audio_s = float(feat_len[b]) * args.hop_length / args.sample_rate
                    em = last_em[b] if greedy else out[e][b]
                    spans = ts.word_timestamps(
                        em, int(sub_h[b]), ids, ts.pieces_of(tokenizer, ids),
                        blank=blank, seconds_per_frame=audio_s / max(int(sub_h[b]), 1))
                    print(split, "TIMESTAMPS:", ts.format_spans(spans))
                wers[e].add(refs[b], hyp)
    for e, acc in enumerate(wers or []):
        print(f"{split} WER exit {e + 1}: {100 * acc.value:.2f}% "
              f"({acc.utterances} utts)")


def _aed_max_lengths(n_frames: int):
    """The reference's heuristic (inference.py:20-41): (max_len, min_len)
    of an utterance of n_frames mel frames."""
    if n_frames < 200:
        max_len = int(30 - n_frames * (5 / 200.0))
    else:
        max_len = int(n_frames / 12)
    max_len = max(max_len, 4)
    return max_len, int(max_len * 0.6)


def _bucket(n: int, g: int = 8) -> int:
    return ((n + g - 1) // g) * g


def run_aed(model, model_cfg, pipe, split, tokenizer, lex, args):
    """Per batch: the trunk once for all exits, then per exit the batched
    KV-cached beam (max_length the batch's longest heuristic length,
    bucketed to 8; min_length per utterance); with --rescore_ctc_weight
    > 0 the best lane chosen by the joint rescoring instead."""
    from early_exit_tpu_torch.decoding import aed_beam, rescore
    rescore_w = float(args.rescore_ctc_weight)
    wers = [WerAccumulator() for _ in range(model_cfg.n_enc_exits)]
    for batch in pipe.epoch(0):
        with torch.no_grad():
            exit_hidden, sub_len = model.encode(batch["feats"], batch["feat_lengths"])
        refs, mask = _references(batch, tokenizer)
        lengths = [_aed_max_lengths(int(n)) for n in batch["feat_lengths"].cpu().tolist()]
        for ref in refs:
            if ref is not None:
                print(split, "EXPECTED:", ref)
        max_len = _bucket(max(ml for ml, _ in lengths))
        min_lens = torch.tensor([mn for _, mn in lengths])
        ctc_logp = model.apply_heads(exit_hidden) if rescore_w > 0.0 else None
        for n in range(1, model_cfg.n_enc_exits + 1):
            toks, lens, scores, best = aed_beam.beam_search_exit_batch(
                model, exit_hidden[n - 1], min_lens, n_exit=n,
                beam_size=args.beam_size, max_length=max_len, pen_alpha=args.pen_alpha)
            if rescore_w > 0.0:
                best = rescore.rescore_batch(ctc_logp[n - 1], sub_len, toks, lens, scores,
                                             ctc_weight=rescore_w,
                                             blank=model_cfg.blank_id)[0]
            toks, lens, best = toks.cpu().numpy(), lens.cpu().numpy(), best.cpu().numpy()
            for b, ref in enumerate(refs):
                if ref is None:
                    continue
                ids = aed_beam.trim_hypothesis(toks[b][best[b]], lens[b][best[b]],
                                               eos_id=model_cfg.eos_id,
                                               bos_id=model_cfg.bos_id)
                hyp = _hyp(tokenizer, lex, ids)
                print(split, "BEAM_OUT_", n, ":", hyp)
                wers[n - 1].add(ref, hyp)
    for e, acc in enumerate(wers):
        print(f"{split} WER exit {e + 1}: {100 * acc.value:.2f}% "
              f"({acc.utterances} utts)")


def load_model(args, model_cfg, device) -> torch.nn.Module:
    """The model of model_cfg.model_type (`registry.build_model`), from
    the checkpoint file or the average the arguments name."""
    model = build_model(model_cfg).to(device)
    model.init(torch.Generator(device=device).manual_seed(args.seed))
    if args.load_model_path is not None:
        checkpoint.load_model_file(model, args.load_model_path)
    elif None not in (args.load_model_dir, args.avg_model_start, args.avg_model_end):
        checkpoint.avg_models(model, args.load_model_dir, args.avg_model_start,
                              args.avg_model_end)
    else:
        raise ValueError(
            "Invalid model loading config. Use either --load_model_path "
            "for a single model or --load_model_dir/--avg_model_start/"
            "--avg_model_end for an average of models.")
    return model.eval().requires_grad_(False)


def main(argv=None) -> None:
    # mode="infer": the auto profile resolves to bf16 attention softmax and
    # the DFT mel
    args, model_cfg, train_cfg, audio_cfg, tokenizer = get_args(argv, mode="infer")
    check_ported(args)
    device = runtime.resolve_device(args.device)
    if device.type == "cuda":
        runtime.exact_float32()
    model = load_model(args, model_cfg, device)
    print(f"The model has {count_parameters(model):,} trainable parameters")
    lex = _load_lexicon(args)

    splits = (["synthetic"] if args.synthetic_data
              else [s for s in args.eval_splits.split(",") if s])
    for split in splits:
        print(split)
        if args.synthetic_data:
            ds = SyntheticDataset(n_items=max(args.batch_size, 8), seed=args.seed + 7)
        else:
            try:
                ds = LibriSpeechDataset(args.data_root, split)
            except FileNotFoundError:
                sys.exit("Invalid data split")
        pipe = Pipeline(ds, tokenizer, audio_cfg, train_cfg, bpe=args.bpe,
                        shuffle=False, infer_mode=True, workers=args.n_workers,
                        device=device)
        if args.decoder_mode == "aed":
            run_aed(model, model_cfg, pipe, split, tokenizer, lex, args)
        elif args.streaming:
            run_ctc_streaming(model, model_cfg, ds, split, tokenizer, lex, args,
                              audio_cfg)
        elif args.exit_threshold is not None or args.gate_calibration is not None:
            if args.cascade_k is not None:
                run_ctc_gated_cascade(model, model_cfg, pipe, split, tokenizer, lex, args)
            else:
                run_ctc_gated(model, model_cfg, pipe, split, tokenizer, lex, args)
        else:
            run_ctc(model, model_cfg, pipe, split, tokenizer, lex, args)


if __name__ == "__main__":
    main()
