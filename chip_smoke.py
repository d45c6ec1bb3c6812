"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --row_times [CHECKOUT]   # rows 1-3s' times only

Phases (any failure exits non-zero, with no result line; they run in
the order 1-10, 12, 13, 15-17, 18b-d, 19, 20, 11, 14, 18a: the serving programs
of phases 11, 14c and 18a are captured and compiled by AOTInductor in a
child process at nice 10 (`export_child`, EXPORT_WORKERS compiles at a
time) beside phases 8-18d, and served once they all are):
  1. build the CUDA kernels from `early_exit_tpu_torch/csrc` with nvcc
     (sm_90a, one nvcc per source, in parallel);
  2. hold each kernel against its plain PyTorch version on the card, at
     the flagship's weights and main-path shapes (B=8, T'=249, ragged
     lengths with one short and one empty item), and the block kernel
     again past the TPU kernel's T' <= 512 (B=2, 60 s and 45 s, T'=1499)
     and, bf16 and W8A8 entries, at 80.02 s or 79.98 s beside 55 s
     (T'=2000 and 1999), with the plain version's drift from its own
     softmax denominator's sum order printed beside each long reading;
     the block kernel with the other softmax dtype must fall outside the
     tolerance, which shows the tolerance sees a moved rounding point.
     Likewise the attention kernel (bf16 and float32 inputs, 1e-5 of
     max|v|), the float32 block entry (5e-5 absolute) and the W8A8 block
     entry (the bf16 block's tolerance; held against the unquantized
     plain version it must fall outside); a row's result must not depend
     on its batch. The bf16 block's product on its own (`block_gemm`) at a
     ragged M, at each (K, N) of the block's products and each of the four
     epilogues, with the residual in place, and the W8A8 block's int8
     product (`block_gemm_s8`) at the same shapes, held equal bit for bit;
     the W8A8 LayerNorm + quantize (`layer_norm_quantize`) equal to its
     plain version value for value, and against the plain LayerNorm
     followed by `quantize_int8` differing only next to rounding ties; the
     heads at ragged row counts with forced exact ties; the attention
     kernel at T = 1,
     65, 249 and 785 in both layouts ((B, H, T, dh) through
     `fused_attention`, packed q|k|v rows through the float32 block);
  3. the main path end to end: `Recognizer.from_flagship("cuda")` on 128
     in-distribution ~10 s requests, launch counts read around that run;
     its greedy tokens against the same path built from the kernels'
     plain versions and against the unfused PyTorch path, each held to
     <= 1% token disagreement pooled over the exits (bench.py's
     contract) and <= 1% at every exit that transcribes (in-distribution
     WER within bench.py's 30% sanity bound); and the final-exit WER
     against that bound. Against the plain versions every exit is held
     to 1%. Exit 1 of the flagship decodes at ~90% WER on near-tie
     logits, where the plain-version path and the unfused path, neither
     of which runs a kernel, already disagree by about 1%; so against the
     unfused path exit 1 is held to the pooled contract only, and the
     no-kernel pair's rates are printed beside it;
  4. at B=128 x 10 s (T'=249), where the persistent kernels' rings wrap,
     the heads' ids, the six int8 products and the LayerNorm + quantize
     held to their plain versions as in phase 2, the W8A8 block to the
     block tolerance; then times: each kernel, its plain version, a
     library yardstick (the block composed of torch ops with cuBLAS,
     SDPA and cuDNN, in bf16 and in float32, and in W8A8 with
     `torch._int_mm` products; the heads as torch.matmul + argmax;
     attention as SDPA on float32 inputs) and its bound; each product of
     the bf16 and of the W8A8 block on its own in ms and TFLOP/s (TOP/s),
     beside torch.matmul (torch._int_mm), and the host time of one block
     launch; the end-to-end forward in audio-seconds per second;
  5. torch.profiler over a few end-to-end forwards of phase 4: device
     time per kernel and the device-busy share; the same over W8A8 block
     launches at that shape, and over the cascade pass of phase 6;
  6. gated cascade serving, `Recognizer.transcribe_gated`, on the same 128
     requests under the committed calibration, with bf16 blocks (path A)
     and with W8A8 blocks (path B): launch counts (4 block launches in
     phase A, 8 for the packed phase-B batch), chosen exits equal to the
     while-loop gate's on every row and within 1% of rows of the same
     cascade built from the plain versions, gated WER beside the dense
     final-exit WER, and the time of one cascade pass with the mask fetch
     and the host packing in it. Each is run again with exit 2's threshold
     moved to the batch's median confidence, so that phase B runs at width
     (there the plain-version cascade may differ on 5% of rows: the
     threshold sits where the confidences are densest);
  7. the all-exit path on 16 requests in float32 through the float32 block
     entry (path C) and unfused with `attention_impl="pallas"` through the
     attention kernel (path D), 12 launches each, tokens held to phase 3's
     contract against the unfused path of the same configuration;
  8. training (plain PyTorch with autograd: no TPU kernel lies on the
     training path): (a) one CTC train step of the flagship on 4 requests
     of bench_eval's distribution on the card and on the CPU, dropout 0, no
     SpecAugment: in float32 with TF32 off the loss and the gradients'
     global norm within 1e-4 relative, each gradient leaf within 1e-3
     relative L2, the BatchNorm running statistics within 1e-5; in the train
     profile (bf16) the loss within 2e-2 and each leaf's cosine >= 0.98;
     (b) a fresh model at the flagship's width in the train profile
     (dropout 0.1, SpecAugment, warmup 10) takes 40 steps on one sub-batch
     of 16 requests: every loss finite and the last < 0.6x the first; then
     the trained model transcribes through the block and head kernels (12
     and 1 launches, the kernel layout rebuilt after the weights moved)
     within phase 3's token contract of its unfused path; its cached
     kernel layout equals one folded anew from the trained weights bit for
     bit, and each block kernel, fed the kernel path's own input, stays
     within phase 2's ulps of the plain version of that layout (the first
     block within phase 2's whole tolerance, which the layout folded
     before training must miss); (c) the training loop over the `Pipeline` at the CLI's
     --batch_size 64 --n_batch_split 4 on a corpus made beforehand: ms per
     step by CUDA events, trained audio-seconds per second, peak memory,
     the host's share of the wall time; then 12 steps over the
     `SyntheticDataset` itself (the CLI's path, which synthesises in the
     loader threads) and the host's wait there; a torch.profiler top-15 of
     one step's device time, and a checkpoint pair written and read back
     equal;
  9. the inference CLI, `early_exit_tpu_torch.inference.main`, on the card
     over a LibriSpeech-layout FLAC corpus of N_CORPUS utterances of
     bench_eval's distribution (split test-clean), written with the port's
     FLAC writer and read back equal to the int16 sources: greedy, the
     prefix beam (beam 10), the lexicon beam with an ARPA LM trained from
     the corpus's transcripts by `train_arpa`, and the gated
     cascade under the committed calibration (k=2), all with
     --fused_block true. Launch counts around each run: 12 block launches
     a sub-batch and one head launch for greedy, 12 block launches for
     the beams, 4 a sub-batch plus 8 a phase-B batch for the cascade.
     Held: every exit but exit 1 (the flagship's ~90%-WER exit, which does
     not transcribe) within the 30% sanity bound; the prefix beam's exit-6
     WER within 0.5 points of greedy's; greedy on the card against the same
     CLI on the CPU over 8 utterances within phase 3's token contract; the
     prefix beam on the card and on the CPU, fed the same log-probs, equal
     tokens and scores within 1e-4 relative; the cascade's chosen exits
     equal to `Recognizer.transcribe_gated`'s on the same requests. Times:
     audio-s/s of each whole CLI pass, the share of its wall spent in the
     decoders, and the device's busy share of a second, profiled pass.

 10. streaming serving of the flagship at the CLI's geometry (chunk 1.0 s,
     left 3.0 s, right 0.5 s: windows of 112 sub frames) over phase 9's
     corpus: (1) the attention kernel against its plain version at
     (32, 8, 112, 32), bf16 and float32, on the windows' key masks (75
     leading invalid keys, trailing invalid keys, both, wholly masked rows
     that must give the mean of v), with its time, bound and SDPA's; (2)
     `StreamPool` with every exit decoded, fed 1 s a round, with the XLA
     path's attention and with the kernel (12 launches a dispatch, no
     block or head kernel), each against the same code on the CPU over 8
     streams and against each other within phase 3's token contract,
     exit 6 within 30% WER, the per-exit streaming WER beside phase 9's;
     (3) the pool against solo `StreamingRecognizer`s, and one utterance
     as one chunk with no context against `Recognizer`'s unfused batch
     path; (4) the gated pool at fast exit 2, its threshold in the widest
     gap of the corpus's chunk confidences: part of the chunks escalated,
     each stream's chunk exits equal to a solo gated recognizer's; (5)
     causal windows, card against CPU over 16 streams (the card against
     itself at two pool widths printed beside it); (6) the load test's
     round loop (`serving.load_test.run_rounds`) at 16 and 64 streams,
     ungated and gated, each with one profiled round; (7) the server
     (`python -m early_exit_tpu_torch.serve` in a thread) with 4
     concurrent loopback connections, each final's ids equal to a local
     recognizer's; (8) `python -m early_exit_tpu_torch.inference
     --streaming true` over the corpus, ungated and gated.

 11. the serving export (`serving/export.py`): the flagship exported for
     "cuda" at the bucket 8 x 160000 with the gated, cascade (the
     committed calibration's k and temperatures) and poly (up to 320000
     samples) programs and the features' program, captured and compiled
     by AOTInductor in `export_child` (capture and compile seconds and
     bundle size printed, the bundles under a temp dir); the graphs hold
     `eet::conformer_block` once per block run (12 all-exit, 2 in each
     exit's cond of the gated bucket program and in each of the gated
     poly program's six programs, 2k and 12-2k in the cascade phases); the compiled program's mel features full float32 (and
     TF32's outside the tolerance); then, from the bundle alone
     (`ExportedRecognizer`, AOTInductor packages) over phase 3's 128
     requests in 16 batches of 8: the all-exit program (12 block launches
     a call) within phase 3's token contract of `Recognizer.transcribe`,
     max|dconf| against the eager serve module printed; the gated program
     at threshold 0 and at each batch's median exit-1 confidence, chosen
     exits equal to eager `gated_apply`'s on every row; the cascade under
     the committed calibration and with exit k's threshold at the median,
     chosen exits equal to `Recognizer.transcribe_gated`'s on every row,
     tokens within the contract, 2k launches in phase A and 12-2k per
     packed phase-B batch; the poly program at 0.10, 0.12, 0.13 and 0.14
     s (10, 12, 13 and 14 hops: from the JAX package's bound, served as
     given) and at 12.3 s and 17.9 s within the contract of
     `Recognizer.transcribe`; the gated poly program (one program an
     exit, stepped on the host) at those lengths and 10 s, thresholds 0,
     1.01 and the median gap, chosen exits equal to eager `gated_apply`'s,
     2 launches an exit run, and its time at 8 x 10 s against the same
     gate as one cond program (a yardstick compiled beside it); times
     (CUDA events) of the
     exported all-exit program and cascade against the eager ones, and
     each path's device-busy share (torch.profiler).

 12. the AED mode (`--decoder_mode aed`) at the flagship's widths, a
     seeded `full_conformer` (AED_DEC_LAYERS decoder layers an exit, the
     recipe's 6 cut to 2 to keep the whole run inside its 1,200 s budget):
     (a) one joint-loss train step on the card against the CPU in float32
     with TF32 off, dropout 0, no SpecAugment (phase 8a's tolerances, the
     decoders' key biases among the zero-gradient leaves); (b) LEARN_STEPS
     steps of a fresh model in the train profile on one sub-batch of 16:
     every loss finite, the last < LEARN_RATIO x the first; (c) that model
     served through `inference.main --decoder_mode aed --fused_block true`
     over phase 9's corpus, without and with --rescore_ctc_weight 0.5: 12
     block launches a batch and no other launch, a BEAM_OUT line per
     utterance and exit; the float32 beam (--compute_dtype float32) card
     against CPU on the card's memory at exits 2 and 6 (best hypotheses
     equal on every row, best scores within AED_RTOL) and the rescoring's
     CTC lane scores within AED_RTOL with the chosen lanes equal; the
     bf16 beam on the kernel-encoded memory against the plain-encoded
     memory (agreement and per-exit AED WER printed, not held: the model
     does not transcribe); times (encode, beam per exit, the rescoring,
     the CLI's audio-s/s) and a profiled beam's launches a step and
     device-busy share.

 13. the model zoo at the flagship's widths: the splitformer (6 x 2
     blocks and its two branch blocks) and the early_zipformer (19 x 1
     blocks, one exit), seeded: (a) one float32 train step of each on the
     card against the CPU (phase 8a's conditions and tolerances, the
     branch blocks' BatchNorm statistics among those held; the
     zipformer's grad norm to ZIP_F32_NORM), and the zipformer's float32
     steps on the card (with cuDNN's default and its deterministic
     algorithms) and on the CPU each against the same step in float64 on
     the CPU (`float64_math`): the norm's gap and the 10 worst leaves; (b)
     ZOO_STEPS steps of `python -m early_exit_tpu_torch.train` each on the
     synthetic corpus, 16 requests a step: the last loss < LEARN_RATIO x
     the first, ms a step (CUDA events and wall), peak memory; (c)
     checkpoints of the flagship's trained blocks in the zoo's layouts
     (`interop.flagship_zoo_tree`: 13b's models emit ~2 tokens an
     utterance) through `python -m early_exit_tpu_torch.inference
     --fused_block true` over phase 9's corpus: 12 (19) block launches and
     1 head launch a sub-batch and nothing else, no launch from the
     splitformer's branch blocks (they run unfused, as in the JAX
     package), each exit's WER (no bound: no trained checkpoint), the bf16
     kernel path against the plain-version path (reported), the float32
     CLI (row 1c, 12 (19) launches a sub-batch) card against CPU on 8
     utterances within 1% of tokens at every exit; (d) at B=128 x 10 s
     the block kernel on each of 13b's zipformer's six stacks' inputs (as
     its plain path gives them, T' = 500, 250, 125, 63; and on 13c's model)
     against its plain version, every stack held by ROADMAP Queue C's C6
     readings (`c6_readings`; C3 for the five stages): the kernel within
     phase 2's tolerance of its plain version run with the kernel's own
     products and LayerNorms, every other sum exact, and each of the
     block's products, rounded to bf16, within 1 ulp of the float64 product
     on at most twice the share cuBLAS's bf16 product moves; 13b's pre
     stack (fed the embedding, as phase 2's block) also within phase 2's
     tolerance of the plain version itself; the head kernel at E=1 equal
     to its plain version; (e) the
     splitformer's gate in float32 on 32 of those requests: threshold 0
     runs 1 exit, 1.01 all 6, and at the
     median of exit 1's confidences the chosen exits equal those the
     all-exit forward's confidences give on every row, the chosen
     log-probs within 1e-4 of its; (f) the four legacy Transformer models
     (no kernel) in float32, card against CPU within 1e-4; times: the
     all-exit forward of each family beside the flagship's at B=128 x
     10 s, a profile of the zipformer's, each CLI's audio-s/s.

 14. the calibrate -> export -> serve path on the flagship and the zoo
     models of its trained blocks: (a) `python -m
     early_exit_tpu_torch.calibrate_gate --fused_block true` over phase
     9's corpus for the flagship and the splitformer (12 block launches a
     batch): every score's simulated gated WER within its target
     (GATE_DELTA_PP over the final exit's); the inference CLI under the
     written --gate_calibration choosing simulate_gate's exit for every
     utterance (those within GATE_NEAR of a threshold counted, not held);
     in float32 on 8 utterances the tool on the card and on the CPU with
     equal exit WERs, temperatures, mean exit and gated WER, thresholds
     within GATE_THR_ATOL; (b) `python -m
     early_exit_tpu_torch.escalation_report --fused_block` at the settings
     of `reports/escalation_v3_seed1.json` (the flagship, its calibration,
     seed 9999, 256 utterances): the record's utterances (its noise-sigma
     buckets), exits 2-6 and the gated WER within ESC_WER_PP points of the
     record, the accept histogram within ESC_HIST, the sweep printed; (c)
     the splitformer's all-exit and gated programs and the zipformer's
     all-exit program exported at EXPORT_BUCKET (captured and compiled
     by AOTInductor in `export_child`): 12, 12 (2 in each exit's
     cond) and 19 `eet::conformer_block` nodes, the manifests' n_exits 6
     and 1; phase 3's first ZOO_EXPORT_ROWS requests served from each
     bundle in batches of 8, 12 (19) launches a call, within phase 3's
     token contract of the eager `Recognizer.transcribe` (12 (19) block
     launches and one head launch); the gated program's chosen exits equal
     to `gated_apply`'s on every row at thresholds 0, 1.01 and each
     batch's median exit-1 confidence, 2 launches an exit run; compile
     seconds and MB per program, ms a call and audio-s/s against the eager
     `Recognizer`.

 15. reference checkpoints and the whole tokenizer (`reference_phase`):
     (a) the flagship through `interop.to_reference_state_dict` and
     `torch.save` into `python -m
     early_exit_tpu_torch.import_reference_checkpoint --fused_block true`
     on the card, the imported tree equal to the flagship's leaf for leaf,
     and its `Recognizer.transcribe` over 32 of phase 3's requests giving
     the flagship's tokens at every exit, 0 apart, in 12 block launches
     and one head launch; (b) seeded splitformer, early_zipformer and
     full_conformer at the flagship's widths: exact reference round trips
     and the forwards of the models read back bit-equal on the card; (c)
     nmt_nfkc BPE-256 and unigram-256 tokenizers with the reference
     recipe's ids trained over phase 9's transcripts, their native and
     Python engines' ids equal (sentences a second printed), and 5 steps
     of `python -m early_exit_tpu_torch.train` with the BPE model, the
     loss finite and falling. Its seconds are printed.

 16. `--conv_norm group` and data + tensor parallelism (`parallel_phase`).
 17. the evaluation and profiling tools (`tools_phase`): `utils/profiling`'s
     trace, annotate and StepTimer around phase 3's flagship forward,
     `score_wer` over phase 9's greedy log, `streaming_demo` (block and
     attention kernels), `streaming_gate_report` and `dress_rehearsal` on
     the card. Its seconds are printed.
 18. the zoo's poly programs and the measuring tools: (a) `poly_phase`:
     the splitformer's and the zipformer's all-exit poly programs,
     captured and compiled by AOTInductor in `export_child`, served from
     their bundles at 3.7, 7.9, 11.3 s, at 10, 12 and 13 hops (0.10-0.13
     s, the JAX package's bound up, unpadded) and at each model's former
     bound (14 and 18 hops), 12 (19) `eet::conformer_block` launches a
     call, within the token contract of the eager `Recognizer.transcribe`
     pooled and at each exit; the splitformer's gated poly program (one
     program an exit, stepped on the host by `ExportedRecognizer.gated`)
     at the same lengths and thresholds 0, 1.01 and the median gap, 2
     launches an exit run, chosen exits equal to eager `gated_apply`'s;
     compile seconds, MB and ms a call beside the bucket programs' (14c). (b-d) `measure_phase`: the
     ablation library (`conformer_block.cu` with -DEET_ABLATE) bit-equal
     to the bf16 entry and within ABLATE_TIME_RTOL of its time, each
     ablation within the bf16 rule of the plain version with the same
     `ablate`, `ablate_fused_block`'s savings; `ablate_head_path`,
     `bench_int8` and `ablate_decode` in child processes (head ids equal
     but at bf16 ties, the int8 legs within the token contract, the
     collapse variants equal); `warm_cache` at WARM_ARGS.

 19. the widths past the flagship's that the JAX package's Pallas kernels
     take: (a) `widths_kernels`: each new kernel instantiation against
     its plain version on seeded inputs: the block's three entries at d
     512 (8 heads of 64, ff 2048) and at 16 heads of 16 (d 256), B=8,
     T'=249, a short and an empty item (the bf16 and W8A8 entries by
     phase 2's rule against a reference that rounds where the kernel
     rounds, with two controls outside it, `held_block`; float32 within
     F32_BLOCK_ATOL); the attention at dh 16 and 64, T = 1, 65, 249, 785,
     bf16 and float32 inputs (ATT_RTOL of max|v|); the head at V 32, 128,
     500, 5000 beside D 256 and 512 (the resident and the streamed
     design) on dyadic inputs with exact ties across its 256-column
     tiles, at 3 x 3 x 83 rows and at the main path's 6 x 128 x 249, ids
     equal (`heads_held`); the W8A8 LayerNorm + quantize at d 512, value
     for value; (b-e) `widths_phase`: the d-512 early conformer
     (`d512_config`, the port's init at seed 0, BPE-256) served on phase
     3's 128 requests through `Recognizer.transcribe` (12 block and 1 head
     launches; each block launch, fed the kernel path's own input, held
     by `held_block`, and so each W8A8 block and, within F32_BLOCK_ATOL,
     each float32 block of the same model at the same size; each exit's
     head ids equal to the plain head's on the same hidden states but at
     near-ties, `heads_held`; the per-exit token disagreement against the
     plain-version path printed, not held: random weights transcribe
     nothing), through the cascade with bf16 and W8A8 blocks under the
     committed calibration and with exit k's threshold at the median
     (chosen exits equal to the while-loop gate's), through `python -m
     early_exit_tpu_torch.inference --fused_block true` with its flags
     over phase 9's corpus, and the same CLI with `--bpe false` at the
     flagship's widths (the head at V = 32); a seeded 5000-piece head at
     d 512 through `Recognizer.exit_ids`, the model unfused with the
     attention kernel (dh 64) and in float32 on 16 requests; the heads at
     V 32 and V 5000 held by `heads_held` on the hidden states they are
     timed on; the new rows' times (1@d512, 1b@d512, 1c@d512, 2@V32,
     2@V5000·D512, 3@dh64) beside their plain versions, library calls and
     bounds (`block_rows`, `head_row`, `attention_row`, as phase 4's).
     19a then takes every width the JAX package's Pallas kernels take, on
     the card's padded layout (`widths_kernels_any`): the block at
     WIDTH_BLOCKS_ANY (Conformer-S, d 64, d 196, d 1024) in every entry
     and in the two profiles added in PR 18 (float32 compute with the
     bf16 softmax, bf16 compute with a float32 residual), held by
     `held_block`, whose bf16-compute references take the kernel's own
     products, LayerNorms and attention, that attention launch held in
     its turn on the block's own q, k, v against exact sums
     (`attention_figures`), as `attention_held` holds it on seeded q, k,
     v; the attention kernel at
     dh 36, 49, 128; the head at D 144, 196, 1024 (resident, streamed,
     k-tiled); the LayerNorm + quantize at d 144, 196, 1024.

 20. Conformer-S served (`conformer_s_phase`): a seeded Conformer-S (d 144,
     4 heads of 36, ff 576, k 32, 16 blocks, 8 exits, BPE-256) through
     `Recognizer.transcribe` at B=128 x 10 s (16 block and 1 head
     launches; blocks 1 and 16 held by `held_block`, the head against the
     plain head, tokens against the plain path printed), the forward's
     audio-s/s and profile; the bf16 and W8A8 cascades at thresholds 0,
     1.01 and exit 2's median, chosen exits equal to the while-loop gate's;
     the inference CLI over N_CLI_S utterances in four fused profiles
     (bf16, --compute_dtype float32, --residual_dtype float32, --quantize
     int8) and unfused with --attention_impl pallas, launches and
     audio-s/s each; a d-1024 model in every profile on 16 requests; the
     new rows' times (1, 1b, 1c, (i), (ii) at d 144 and d 1024, 2 at D 144
     and D 1024, 3 at dh 36 and dh 128).

`--row_times [CHECKOUT]` times rows 1-3s alone at the flagship's shapes
for the package of another checkout (`row_times`): parent and change are
compared in one call to the card as p, c, c, p.

The line before the last is the `kernels` JSON (every time in it is this
run's; PERF.md keeps the times of the designs a kernel replaced); the
last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import contextlib
import faulthandler
import io
import json
import math
import multiprocessing
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16 = 989e12      # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
PEAK_INT8 = 1979e12     # H100 SXM dense int8 OP/s, tensor cores
PEAK_F32 = 67e12        # H100 SXM float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes/s
SANE_DENSE_WER = 30.0   # bench.py's in-distribution sanity bound
N_CORPUS = 32          # phase 9's FLAC corpus, utterances
LOAD_STREAMS, LOAD_ROUNDS = (16, 64), 30   # phase 10.6's pools
# phase 11: the bucket (the JAX export tool's default), the poly program's
# bound, and lengths no bucket covers: 10, 12, 13 and 14 hops (from the
# JAX package's bound, hop * 10, where T' = 2; 14 hops was the port's
# former bound) and 12.3 s and 17.9 s
EXPORT_BUCKET, EXPORT_POLY_MAX = (8, 160000), 320000
EXPORT_WORKERS = 4       # AOTInductor compiles at once beside phases 8-19
SHORT_POLY_LENGTHS = (1600, 1920, 2080)
EXPORT_POLY_LENGTHS = (*SHORT_POLY_LENGTHS, 2240, 196800, 286400)
# the exported program's mel features against eager ones: both full
# float32 (cuBLAS products in another blocking at most move the last
# places); TF32 keeps about three decimal digits
FEATURE_RTOL = 1e-5
# bf16 tolerance of the block kernel against its plain version, in bf16
# ulps of the plain value (2^-7 below |y| = 1) and in the share of values
# that differ at all. The two sum the softmax denominator over T' keys in
# different float32 orders, so a rare row's bf16 denominator moves by an
# ulp, and more rows as T' grows. On an H100 the sound kernel gave 1 ulp
# and 0.07% of values at T'=249, 3 ulps and 2.2% at T'=1499; the kernel
# with the float32 softmax against the bf16 plain version gave 5 ulps and
# 7.8%, and 6.25 ulps and 21%.
BLOCK_MAX_ULPS = 4
BLOCK_DIFFERING = 0.05
TOKEN_DISAGREE = 0.01
# The block kernel at the widths past the flagship's (phase 19), on seeded
# weights: a block's branches are as large as its residual stream there,
# so one sum that rounds the other way reaches more of its row than on
# trained weights, and the share grows with the width. Held against a
# reference that rounds where the kernel rounds (`held_block`), the share
# lies between the sound kernel's readings and the controls' (a skipped
# bf16 rounding of P or of the SiLU). On an H100: bf16 up to 6.2%, its
# controls 28-41%; W8A8 up to 10.4%, its controls 47-58% (and a third of
# the nearer control where the block barely moves its input, the first
# block on the frontend's output: sound 0.02%, controls 1.3-4.9%).
SEEDED_DIFFERING = {"bf16": 0.12, "w8a8": 0.2}
# head_argmax on real-valued hidden states (phase 19): two float32 sums in
# another order round to bf16 at most one ulp apart, so where the two
# sides choose different columns, those columns' logits lie within two
# ulps of each other (one on each side)
HEAD_NEAR_TIE_ULPS = 2
# float32 kernels against their plain versions: both sides are float32
# throughout and differ in the order of their sums (32 and 249 terms in
# attention, whose outputs have the scale of v, so its tolerance is
# relative to max|v|; 256 and 2048 in the block's products, whose outputs
# are LayerNormed to unit scale, so its tolerance is absolute). The JAX
# package holds its float32 kernels to 1e-5 and 2e-5 on the CPU at small
# width and unit-scale inputs.
ATT_RTOL = 1e-5
F32_BLOCK_ATOL = 5e-5
# a float32 block output of a profile with bf16 rounding points (float32
# compute with the bf16 softmax; bf16 compute with a float32 residual)
# "differs" from its reference (`held_block`) where the two are more than
# this share of a bf16 ulp of max(|y|, 1) apart. On the CPU, where kernel
# and plain version are one arithmetic, the plain version against the
# reference that takes the kernel's products and float64 LayerNorm sums
# differed on 0-0.3% of the values at d 64, 144 and 196 by this measure,
# the controls (P's or the SiLU's bf16 rounding skipped) on 13-34%
F32_OUT_ULPS = 0.25
# the bf16 block's product against its plain arithmetic: the float32 sums
# over k run in another order, so a sum that lies at a rounding boundary of
# bf16 moves by one ulp. SiLU just above a power of two maps that ulp onto
# two of the next binade down, and its own rounding may add a third; ulps
# of max(|plain|, 1) as for the block. On an H100 2e-5 to 3e-4 of values
# differed, more at K=2048
GEMM_MAX_ULPS = 3
GEMM_DIFFERING = 0.002
# the W8A8 LayerNorm + quantize against the plain LayerNorm followed by
# quantize_int8: the LayerNorms' float32 values differ from the kernel's in
# the last places (a few 1e-7 relative), which moves an int8 value by one
# level only where v / sx lies within ~1e-4 of a rounding tie, and a scale
# by a float32 ulp or two
LNQ_TIE = 1e-3
LNQ_SCALE_RTOL = 1e-6
ROWS_DIFFER = 0.01      # chosen exits, kernel cascade vs plain-version cascade
# the same with exit 2's threshold at the batch's median confidence, where
# the confidences lie closest together: the two rows next to the threshold
# are ~1e-4 apart, within what two bf16 schedules move a confidence by
ROWS_DIFFER_AT_MEDIAN = 0.05
# phase 8, one train step of the flagship on the card against the CPU. In
# float32 with TF32 off the two sum in other orders (and the CUDA CTC
# backward with atomics); in bf16 their products round differently
TRAIN_F32_LOSS = 1e-4       # relative
TRAIN_F32_NORM = 1e-4       # relative, the global norm of the gradients
# the zipformer's (phase 13a): its seeded model's CTC loss is ~1,000 a row
# on phase 13a's batch, where the float32 CTC gradient lies 3.8e-4
# (relative L2) from the float64 one on either device, and so does each
# run's gradient norm from the float64 step's at most: twice that bounds
# the card against the CPU (phase 13a's float64 yardstick prints each)
ZIP_F32_NORM = 8e-4
TRAIN_F32_LEAF = 1e-3       # relative L2 of each gradient leaf
TRAIN_F32_BN = 1e-5         # BN running statistics, of max(1, max|ref|)
TRAIN_BF16_LOSS = 2e-2
# cosine of each gradient leaf, held at a fresh seeded init: the flagship's
# bf16 gradient is chaotic, its norm and leaf directions moving between
# runs of the card whose features differ by 1e-5 relative noise (far below
# bf16's rounding) about as far as between the card and the CPU; the
# script prints that envelope, in float32 and bf16, beside the comparison.
# In float32 the flagship's gradient is stable, and a fresh init is stable
# in bf16
TRAIN_BF16_COS = 0.98
CHAOS_NOISE, CHAOS_DRAWS = 1e-5, 4
# the two leaves whose gradient is 0 in exact arithmetic -- the key bias (a
# softmax does not see a constant added to a query's scores) and the
# depthwise conv's bias (BatchNorm takes the batch mean out) -- hold float
# noise on both sides, held below this share of the global norm
ZERO_GRAD_LEAVES = ("['blocks']['attn']['mha']['k']['b']", "['blocks']['conv']['dw']['b']")
ZERO_GRAD_SHARE = 1e-5
LEARN_STEPS, LEARN_RATIO = 40, 0.6   # the JAX package's criterion, tests/test_trainer.py
# phase 12 (AED): the decoders' key biases have zero gradient as the
# trunk's does; the float32 beam and the rescoring's CTC lane scores on the
# card against the CPU, relative (both sum in other orders); the beam's
# width (the CLI's default), the utterances and exits compared
AED_ZERO_GRAD_LEAVES = ZERO_GRAD_LEAVES + (
    "['decoders']['self_attn']['k']['b']", "['decoders']['cross_attn']['k']['b']")
AED_RTOL = 1e-4
AED_BEAM, AED_CMP_UTTS, AED_CMP_EXITS = 10, 4, (2, 6)
# phase 12's decoder depth, cut from the recipe's 6 layers an exit to keep
# the whole run inside its 1,200 s budget (widths stay the flagship's)
AED_DEC_LAYERS = 2
# phase 13 (the zoo): the zero-gradient leaves wherever their blocks sit
# (the stack, the splitformer's branches, the zipformer's stacks); the
# training CLI's steps and requests a step (64 synthetic utterances an
# epoch); the rows of the gate's batch
ZOO_ZERO_GRAD = ("['attn']['mha']['k']['b']", "['conv']['dw']['b']")
ZOO_STEPS, ZOO_BATCH, ZOO_GATE_ROWS = 40, 16, 32
# phase 14: calibrate_gate's quality slack (the committed calibration's
# provenance); the rows whose calibrated confidence lies this close to a
# threshold, where the gate's own pass and the tool's may round apart;
# thresholds in float32, card against CPU; escalation_report against the
# committed record (its WERs in percentage points, its accept shares); the
# requests served from the zoo's bundles
GATE_DELTA_PP, GATE_NEAR, GATE_THR_ATOL = 0.5, 1e-3, 1e-5
ESC_WER_PP, ESC_HIST = 0.5, 0.01
ZOO_EXPORT_ROWS = 32
# phase 17a: StepTimer's rtf_x (host clock, synchronized before stop)
# against CUDA events over the same forwards; the host clock adds the
# launch of the first kernel and the synchronize's return
TIMER_STEPS, TIMER_RTOL = 10, 0.05
# phase 18a: the zoo's poly programs served at lengths no bucket covers
# (3.7 s, 7.9 s, 11.3 s; SHORT_POLY_LENGTHS and each model's former bound,
# 14 and 18 hops), 8 rows a call;
# 18b: the ablation library's full block against the production entry's
# time; 18d: warm_cache's buckets (3 frame buckets up to 2 s x 2 batches)
ZOO_POLY_LENGTHS = (59200, 126400, 180800)
ZOO_FORMER_BOUND = {"splitformer": 2240, "early_zipformer": 2880}
ABLATE_TIME_RTOL = 0.03
WARM_ARGS = ("--max_seconds", "2", "--batches", "8,16")
# phase 19: the widths past the flagship's. The block at d 512 (8 heads of
# 64, ff 2048) and at 16 heads of 16 (d 256, ff 1024); the attention at
# dh 16 and 64; the head at V 32, 128, 500 and 5000 beside D 256 and 512
WIDTH_BLOCKS = {"d512": (512, 8, 2048), "dh16": (256, 16, 1024)}
WIDTH_ATT_DH = (16, 64)
WIDTH_ATT_T = (1, 65, 249, 785)
WIDTH_HEADS = tuple((V, D) for D in (256, 512) for V in (32, 128, 500, 5000))
D512 = dict(d_model=512, n_heads=8, d_feed_forward=2048, depthwise_kernel_size=31,
            n_enc_exits=6, n_enc_layers_per_exit=2)
# phase 19a, every width the JAX package's Pallas kernels take: the block
# (d, heads, ff, k) at Conformer-S, the dress rehearsal's width, d 196 (dh
# 49, d not a multiple of 8) and d 1024 (dh 128, W8A8 past d 512, the
# conv module's channel split), in every entry and both new profiles; the
# attention at dh 36, 49 and 128; the head at D 144, 196 and 1024 beside V
# 32, 256 and 5000; the W8A8 LayerNorm + quantize at d 144, 196 and 1024
WIDTH_BLOCKS_ANY = {"conformer_s": (144, 4, 576, 32), "rehearsal": (64, 4, 128, 7),
                    "d196": (196, 4, 784, 31), "d1024": (1024, 8, 4096, 31)}
WIDTH_ATT_DH_ANY = (36, 49, 128)
WIDTH_HEADS_ANY = tuple((V, D) for D in (144, 196, 1024) for V in (32, 256, 5000))
WIDTH_LNQ_ANY = (144, 196, 1024)
# phase 20: Conformer-S (Gulati et al. 2020, arXiv:2005.08100, Table 1:
# 16 layers, encoder dim 144, 4 heads, conv kernel 32, FFN 4 x 144), an
# exit every 2 blocks, BPE-256; and a d-1024 model (8 heads of 128, ff
# 4096) of one block an exit, 2 exits, whose paths carry 19a's d-1024 rows
CONFORMER_S = dict(d_model=144, n_heads=4, d_feed_forward=576, depthwise_kernel_size=32,
                   n_enc_exits=8, n_enc_layers_per_exit=2)
D1024 = dict(d_model=1024, n_heads=8, d_feed_forward=4096, depthwise_kernel_size=31,
             n_enc_exits=2, n_enc_layers_per_exit=1)
N_CLI_S = 8              # phase 20's CLI runs: the first utterances of phase 9's corpus


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3, behind=None) -> float:
    """Device ms per call of fn between CUDA events. A kernel shorter than
    the host's time to launch it is timed behind `behind`, a long device
    operation enqueued first, so that every launch is waiting in the
    stream when its turn comes."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if behind is not None:
        behind()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def disagreement(tok_a, n_a, tok_b, n_b):
    """Per exit (edits, reference tokens) of a's greedy tokens against b's."""
    from early_exit_tpu_torch.decoding.lexicon import edit_distance
    out = []
    for e in range(tok_a.shape[0]):
        edits = total = 0
        for i in range(tok_a.shape[1]):
            x = tok_a[e, i, :n_a[e, i]].tolist()
            y = tok_b[e, i, :n_b[e, i]].tolist()
            edits += edit_distance(x, y)
            total += max(len(y), 1)
        out.append((edits, total))
    return out


def bf16_figures(y, ref):
    """(max|d|, mean|d|, max bf16 ulps of max(|ref|, 1), share of values
    differing) of y against ref."""
    import torch
    d = (y.float() - ref.float()).abs()
    # bf16 ulp of each reference value (8 significant bits), 2^-7 at |y| < 1
    ulp = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp_min(1.0))) - 7)
    return (float(d.max()), float(d.mean()), float((d / ulp).max()),
            float((d > 0).float().mean()))


def f32_differing(y, ref) -> float:
    """The share of the values of a float32 output y that differ from ref
    by more than F32_OUT_ULPS of a bf16 ulp of max(|ref|, 1)."""
    import torch
    r = ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(1.0))) - 7)
    return float(((y.float() - r).abs() > F32_OUT_ULPS * ulp).float().mean())


@contextlib.contextmanager
def plain_versions(kcb, katt):
    """Within the block, the port's wrappers run the kernels' plain
    versions on the card: the same path with no kernel in it."""
    def block(f, x, lengths, *, out=None, **kw):
        y = kcb.conformer_block_plain(f, x, lengths, **kw)
        if out is None:
            return y
        out.copy_(y)
        return out
    saved = kcb.conformer_block, katt.fused_attention
    kcb.conformer_block, katt.fused_attention = block, katt.fused_attention_plain
    try:
        yield
    finally:
        kcb.conformer_block, katt.fused_attention = saved


@contextlib.contextmanager
def exact_product_sums():
    """Within the block's plain version, every product's sum (the ten
    matrix products and the attention's two) is taken in float64 and
    rounded once to float32: the products' sum order taken out."""
    import torch
    matmul = torch.matmul
    torch.matmul = lambda a, b: matmul(a.double(), b.double()).to(a.dtype)
    try:
        yield
    finally:
        torch.matmul = matmul


@contextlib.contextmanager
def exact_key_sums():
    """Within the block's plain version, its one sum over the keys (the
    bf16 softmax's denominator) is taken in float64 and rounded once to
    float32: that sum's order taken out of the comparison."""
    import torch
    tsum = torch.Tensor.sum
    torch.Tensor.sum = lambda v, *a, **k: tsum(v.double(), *a, **k).to(v.dtype)
    try:
        yield
    finally:
        torch.Tensor.sum = tsum


@contextlib.contextmanager
def exact_sums():
    """Within the block's plain version, every sum in float64, rounded once
    to float32: the products' and the softmax denominator's (as in
    `exact_product_sums` and `exact_key_sums`) and the LayerNorms'
    statistics. The conv's 31 taps keep their float32 order."""
    from early_exit_tpu_torch.ops.kernels import conformer_block as kcb
    one_pass = kcb._ln_one_pass

    def ln(v, g, b, eps, d=None):
        v64 = v.double()[..., :d]
        mu = v64.mean(-1, keepdim=True)
        var = (v64.square().mean(-1, keepdim=True) - mu.square()).clamp_min(0.0)
        return (v.float() - mu.float()) * (var.float() + eps).rsqrt() * g + b
    kcb._ln_one_pass = ln
    try:
        with exact_product_sums(), exact_key_sums():
            yield
    finally:
        kcb._ln_one_pass = one_pass


@contextlib.contextmanager
def kernel_products_and_norms(f=None):
    """Within the block's plain version, its ten products run through the
    bf16 block's own product (`block_gemm`, bias added after, as the plain
    version adds it) and its LayerNorms through the block's own LayerNorm
    (`block_layer_norm`, of a bf16 or, bf16 compute with a float32
    residual, a float32 row); every other sum (the attention's, the
    softmax denominator's) in float64, as `exact_sums` takes them.
    f (the block's layout): its final LayerNorm of a float32
    residual stays the plain version's, float32 as the kernel writes it
    (the LayerNorm op writes bf16)."""
    import torch
    from early_exit_tpu_torch.ops.kernels import conformer_block as kcb
    one_pass, matmul = kcb._ln_one_pass, torch.matmul

    def ln(v, g, b, eps, d=None):
        if v.dtype == torch.float32 and f is not None and g is f["final_ln_g"]:
            return one_pass(v, g, b, eps, d)
        # a float32 residual (bf16 compute) is read as it is, a bf16 one too
        rows = v if v.dtype == torch.float32 else v.to(torch.bfloat16)
        kcb._ln_one_pass = one_pass      # the CPU's block_layer_norm is plain
        try:
            y = kcb.block_layer_norm(rows.reshape(-1, v.shape[-1]).contiguous(), g, b,
                                     eps, d or 0)
        finally:
            kcb._ln_one_pass = ln
        return y.reshape(v.shape).float()

    def mm(a, b):
        if b.dim() != 2:                 # the attention's products
            return matmul(a.double(), b.double()).to(a.dtype)
        a2 = a.reshape(-1, a.shape[-1]).to(torch.bfloat16).contiguous()
        zero = torch.zeros(b.shape[1], dtype=torch.bfloat16, device=a.device)
        torch.matmul = matmul            # the CPU's block_gemm is plain
        try:
            y = kcb.block_gemm(a2, b.to(torch.bfloat16).contiguous(), zero)
        finally:
            torch.matmul = mm
        return y.float().reshape(*a.shape[:-1], b.shape[1])
    kcb._ln_one_pass = ln
    try:
        with exact_key_sums():
            torch.matmul = mm
            yield
    finally:
        torch.matmul = matmul
        kcb._ln_one_pass = one_pass


@contextlib.contextmanager
def kernel_quantized_norms(f):
    """Within the W8A8 block's plain version (folded params f), each
    LayerNorm that feeds a product is the block's own LayerNorm + quantize
    (`layer_norm_quantize`): the product's row quantize takes its int8
    values and scales as they are. The final LayerNorm is the block's own
    (`block_layer_norm`). The products themselves are exact on both sides;
    the attention is the kernel's (`held_block` adds `kernel_attention`)."""
    import torch
    from early_exit_tpu_torch.ops.kernels import conformer_block as kcb
    one_pass, quantize = kcb._ln_one_pass, kcb.quantize_int8
    made = {}

    def ln(v, g, b, eps, d=None):
        rows = v.to(torch.bfloat16).reshape(-1, v.shape[-1]).contiguous()
        kcb._ln_one_pass = one_pass      # the CPU's kernels are plain
        try:
            if g is f["final_ln_g"]:
                return kcb.block_layer_norm(rows, g, b, eps, d or 0).reshape(
                    v.shape).float()
            q, sx = kcb.layer_norm_quantize(rows, g, b, eps, d or 0)
        finally:
            kcb._ln_one_pass = ln
        q, sx = q.reshape(v.shape), sx.reshape(*v.shape[:-1], 1)
        y = q.float() * sx
        made[id(y)] = (y, q, sx)
        return y

    def quantize_int8(v, axis=-1):
        hit = made.pop(id(v), None)
        return hit[1:] if hit is not None and hit[0] is v else quantize(v, axis)
    kcb._ln_one_pass, kcb.quantize_int8 = ln, quantize_int8
    try:
        yield
    finally:
        kcb._ln_one_pass, kcb.quantize_int8 = one_pass, quantize


@contextlib.contextmanager
def kernel_attention(held=None):
    """Within the block's plain version, the attention of q, k and v (its
    scores, softmax and P V) is the bf16 entries' own attention kernel
    (`block_attention`), so that a block held with the kernel's products
    and LayerNorms differs from its reference only where the rest of it
    rounds another way. held (a list): each launch is held too, on the
    block's own q, k and v, against the plain attention with every sum
    exact (`attention_figures`), its (softmax dtype, figures) appended."""
    from early_exit_tpu_torch.ops.kernels import conformer_block as kcb
    plain = kcb._attention

    def att(q, k, v, valid, dh, cd, sm, no_softmax):
        if q.device.type == "cpu":       # the CPU's kernel is the plain version
            return plain(q, k, v, valid, dh, cd, sm, no_softmax)
        y = kcb.block_attention(q.contiguous(), k.contiguous(), v.contiguous(), valid, dh, sm)
        if held is not None:
            held.append((sm, attention_figures(y, q, k, v, valid, dh, sm, plain)))
        return y
    kcb._attention = att
    try:
        yield
    finally:
        kcb._attention = plain


def attention_figures(y, q, k, v, valid, dh, sm, plain):
    """The bf16 entries' attention kernel's output y (`block_attention`) on
    q, k, v (B, H, T, heads padded past dh with zero columns) and the key
    mask valid (B, T), against the plain attention `plain` (the block's
    `_attention`) with every sum exact (`exact_sums`), by phase 2's rule:
    within BLOCK_MAX_ULPS bf16 ulps of max(|y|, 1) and at most a share of
    the values differing. The bf16 softmax's output is bf16, its share at
    most min(BLOCK_DIFFERING, a third of the control's), the control being
    the same reference with P's bf16 rounding skipped; the float32
    softmax's output is float32 with P rounded to bf16, so a value differs
    where it lies more than F32_OUT_ULPS of a bf16 ulp away
    (`f32_differing`), at most BLOCK_DIFFERING of them. The rows of an
    item with no valid key are not compared (the kernel spreads them over
    the keys of its 16-key tiles, the plain version over T, and the block
    zeroes them); every item's padded columns must be zero. Returns
    (max|d|, max ulps, share differing, its limit, the control's share or
    None, held)."""
    import torch
    keep = valid.any(-1)
    with exact_sums():
        y_p = plain(q, k, v, valid, dh, torch.bfloat16, sm, False)[keep]
        y_c = None
        if sm == torch.bfloat16:
            with skipped_rounding(None):
                y_c = plain(q, k, v, valid, dh, torch.bfloat16, sm, False)[keep]
    y_in = y[keep]
    err, _, ulps, frac = bf16_figures(y_in, y_p)
    if y_c is not None:
        ctl = bf16_figures(y_in, y_c)[3]
        limit = min(BLOCK_DIFFERING, ctl / 3)
    else:
        ctl, limit, frac = None, BLOCK_DIFFERING, f32_differing(y_in, y_p)
    held = (ulps <= BLOCK_MAX_ULPS and frac <= limit and bool(torch.isfinite(y.float()).all())
            and not bool((y[..., dh:] != 0).any()))
    return err, ulps, frac, limit, ctl, held


def attention_line(sm, fig) -> str:
    """`attention_figures`'s figures as a line's end."""
    import torch
    err, ulps, frac, limit, ctl, _ = fig
    if sm == torch.bfloat16:
        return (f"bf16 softmax: vs plain (exact sums) max ulps {ulps} values differing {frac} "
                f"(held: {BLOCK_MAX_ULPS} ulps, {limit:.4g}; the control, P's rounding "
                f"skipped, {ctl})")
    return (f"float32 softmax: vs plain (exact sums) max|d| {err} max ulps {ulps} values "
            f"differing by over {F32_OUT_ULPS} ulp {frac} (held: {BLOCK_MAX_ULPS} ulps, "
            f"{limit})")


@contextlib.contextmanager
def skipped_rounding(width=None):
    """A control for the block's bf16 rule: within the block's plain
    version, one bf16 rounding that the kernel makes is skipped. width
    None: the softmax's exponentials (B, H, T', T') stay float32, so P is
    never rounded to bf16; else the SiLU's exponentials over a last axis
    of `width` (the FFN's d_ff) stay float32, so the SiLU's output is not
    rounded either."""
    import torch
    exp = torch.exp

    def unrounded(v):
        hit = (v.dim() == 4 if width is None else v.dim() == 3 and v.shape[-1] == width)
        return exp(v.float()) if hit and v.dtype == torch.bfloat16 else exp(v)
    torch.exp = unrounded
    try:
        yield
    finally:
        torch.exp = exp


def row_times(root: str) -> None:
    """`python3 chip_smoke.py --row_times CHECKOUT`: the kernel times of
    rows 1, 1b, 1c, 2, 3 and 3s at the flagship's main-path shapes (B=128
    x 10 s, T'=249; 3s a streaming round's (32, 8, 112, 32) with 75 keys
    masked) for the package of the checkout at CHECKOUT (this one, or
    another commit's unpacked beside it), built there: the median of 5
    CUDA-event timings of 20 calls each, as one line "ROWS {json}". Two
    commits are compared on one card in alternating calls (parent, change,
    change, parent)."""
    import statistics
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from early_exit_tpu_torch import checkpoint, runtime
    from early_exit_tpu_torch.data.synthetic import synth_batch
    from early_exit_tpu_torch.ops import frontend
    from early_exit_tpu_torch.ops.kernels import KERNEL_SOURCES, _build
    from early_exit_tpu_torch.ops.kernels import attention as katt
    from early_exit_tpu_torch.ops.kernels import conformer_block as kcb
    from early_exit_tpu_torch.ops.kernels import head_argmax as kha
    from early_exit_tpu_torch.serving.recognizer import Recognizer
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    runtime.exact_float32()
    _build.build_all(KERNEL_SOURCES)
    dev = torch.device("cuda")
    rec = Recognizer.from_flagship("cuda", fused=True)
    model, cfg, acfg = rec.model, rec.model.cfg, rec.acfg
    B, N = 128, 160000
    wav_np, _, _ = synth_batch(checkpoint.load_calib().get("bench_eval", {}), B, seed=4242)
    wav = np.zeros((B, N), np.float32)
    m = min(N, wav_np.shape[1])
    wav[:, :m] = wav_np[:, :m]
    wav = torch.as_tensor(wav, device=dev)
    full = torch.full((B,), N, device=dev)
    kw = dict(n_heads=cfg.n_heads, kernel_size=cfg.depthwise_kernel_size,
              compute_dtype=cfg.dtype, residual_dtype=cfg.rdtype,
              attn_softmax_dtype=cfg.sm_dtype)
    kw32 = dict(kw, compute_dtype=torch.float32, residual_dtype=torch.float32,
                attn_softmax_dtype=torch.float32)
    with torch.no_grad():
        feats = frontend.mel_spectrogram(wav, acfg, method="dft")
        x, _, mask = model.frontend_embed(feats, frontend.mel_lengths(full, acfg.hop_length))
        x, lengths = x.contiguous(), mask.sum(1, dtype=torch.int32)
        f0 = model.stack.folded()[0]
        q8 = Recognizer.from_flagship("cuda", fused=True,
                                      quantize="int8").model.stack.folded()[0]
        f32 = Recognizer.from_flagship("cuda", fused=True,
                                       compute_dtype="float32").model.stack.folded()[0]
        _, hs = model.stack(x, mask, collect_outputs=True,
                            collect_every=cfg.n_enc_layers_per_exit)
        hid = hs.to(torch.bfloat16).contiguous()
        hw, hb = model.heads_w.to(torch.bfloat16), model.heads_b.to(torch.bfloat16)
        T, dh = x.shape[1], cfg.d_model // cfg.n_heads
        g = torch.Generator().manual_seed(3)
        qb, kb, vb = (torch.randn(B, cfg.n_heads, T, dh, generator=g).to(dev, torch.bfloat16)
                      for _ in range(3))
        maskf = torch.arange(T, device=dev)[None, :] < lengths[:, None]
        qs, ks, vs = (torch.randn(32, cfg.n_heads, 112, dh, generator=g).to(dev, torch.bfloat16)
                      for _ in range(3))
        ms = torch.ones(32, 112, dtype=torch.bool, device=dev)
        ms[:, :75] = False
        big = torch.empty(8192, 8192, device=dev).normal_()
        fns = {"1": lambda: kcb.conformer_block(f0, x, lengths, **kw),
               "1b": lambda: kcb.conformer_block(q8, x, lengths, quantize="int8", **kw),
               "1c": lambda: kcb.conformer_block(f32, x.float(), lengths, **kw32),
               "2": lambda: kha.head_argmax(hid, hw, hb),
               "3": lambda: katt.fused_attention(qb, kb, vb, maskf),
               "3s": lambda: katt.fused_attention(qs, ks, vs, ms)}
        out = {}
        for name, fn in fns.items():
            # the short launches behind ~20 ms of float32 FMAs
            behind = (lambda: torch.matmul(big, big)) if name in ("2", "3s") else None
            out[name] = statistics.median(cuda_ms(fn, 20, 3, behind=behind) for _ in range(5))
    print("ROWS " + json.dumps({"root": root, "card": card_line(), **out}))


def main() -> None:
    t_start = time.perf_counter()
    faulthandler.enable()
    if sys.argv[1:2] == ["--row_times"]:
        row_times(sys.argv[2] if len(sys.argv) > 2 else HERE)
        return
    if not os.path.isdir(os.path.join(HERE, "early_exit_tpu_torch")):
        fail("early_exit_tpu_torch/ not found beside chip_smoke.py; run it "
             "from a checkout of the repository")
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")

    from early_exit_tpu_torch import runtime
    from early_exit_tpu_torch.ops.kernels import KERNEL_SOURCES, _build

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)            # nvidia-smi's name and power limit, as it gives them
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")
    runtime.exact_float32()
    dev = torch.device("cuda")

    # ---- 1. build
    t0 = time.perf_counter()
    # the ablation library (phase 18b) builds beside the production ones
    _build.build_all((*KERNEL_SOURCES, "conformer_block_ablate"))
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    for name in (*KERNEL_SOURCES, "conformer_block_ablate"):
        with open(_build.lib_path(name) + ".log") as f:
            regs = [ln.split(":", 1)[1].strip() for ln in f
                    if "Used" in ln and "registers" in ln]
        print(f"ptxas {name}: {regs}")

    # the serving programs of phases 11, 14c and 18a, captured and compiled
    # by a child process at a lower priority beside the other phases
    # (`export_child`)
    work_dir = tempfile.mkdtemp(prefix="eet_export_")
    child_pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    try:
        run_phases(t_start, dev, card, kind, child_pool, work_dir)
    finally:
        for proc in list(getattr(child_pool, "_processes", {}).values()):
            if proc.is_alive():
                stop_descendants(proc.pid)   # its compile processes, if any
                proc.terminate()
        child_pool.shutdown(wait=False, cancel_futures=True)
        shutil.rmtree(work_dir, ignore_errors=True)


def stop_descendants(pid: int) -> None:
    """SIGTERM every live process below pid (parents read from /proc)."""
    below = {}
    for d in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        below.setdefault(ppid, []).append(int(d))
    stack, found = [pid], []
    while stack:
        kids = below.get(stack.pop(), [])
        found += kids
        stack += kids
    for p in found:
        try:
            os.kill(p, signal.SIGTERM)
        except OSError:
            pass


def run_phases(t_start, dev, card, kind, child_pool, work_dir) -> None:
    """Phases 1 (after the build) to 18, the kernels line and the last
    line."""
    import numpy as np
    import torch

    from early_exit_tpu_torch import checkpoint, runtime
    from early_exit_tpu_torch.data.synthetic import synth_batch
    from early_exit_tpu_torch.ops import ctc, frontend
    from early_exit_tpu_torch.models.early_exit_gate import gated_apply
    from early_exit_tpu_torch.models.gate_calibration import scaled_confidence
    from early_exit_tpu_torch.nn import core
    from early_exit_tpu_torch.ops.kernels import attention as katt
    from early_exit_tpu_torch.ops.kernels import conformer_block as kcb
    from early_exit_tpu_torch.ops.kernels import head_argmax as kha
    from early_exit_tpu_torch.serving.recognizer import Recognizer, wer_pct

    def reset_counts():
        kcb.conformer_block.launches = 0
        for entry in kcb.conformer_block.entry_launches:
            kcb.conformer_block.entry_launches[entry] = 0
        kha.head_argmax.launches = 0
        katt.fused_attention.launches = 0
        kcb.block_gemm_s8.launches = 0
        kcb.layer_norm_quantize.launches = 0

    def read_counts():
        """Launches per wrapper; the two W8A8 wrappers for checks must show
        none on any path (the block's C entry runs their kernels)."""
        torch.cuda.synchronize()
        return {**{"conformer_block_" + e: n for e, n in
                   kcb.conformer_block.entry_launches.items()},
                "head_argmax": kha.head_argmax.launches,
                "attention": katt.fused_attention.launches,
                "block_gemm_s8": kcb.block_gemm_s8.launches,
                "layer_norm_quantize": kcb.layer_norm_quantize.launches}

    def expect_counts(what, **want):
        got = read_counts()
        full = {k: want.get(k, 0) for k in got}
        print(f"{what} launches: {got}")
        if got != full:
            fail(f"{what}: launches {got}, expected {full}")
        return got

    # ---- flagship, both paths, and the in-distribution requests
    rec_k = Recognizer.from_flagship("cuda", fused=True)
    rec_u = Recognizer.from_flagship("cuda", fused=False)
    model, cfg, acfg = rec_k.model, rec_k.model.cfg, rec_k.acfg
    knobs = checkpoint.load_calib().get("bench_eval", {})
    B, N = 128, 10 * acfg.sample_rate
    wav_np, counts_np, refs = synth_batch(knobs, B, seed=4242)
    wav = np.zeros((B, N), np.float32)
    m = min(N, wav_np.shape[1])
    wav[:, :m] = wav_np[:, :m]
    wav = torch.as_tensor(wav, device=dev)
    counts = torch.as_tensor(np.minimum(counts_np, N), device=dev)
    kw = dict(n_heads=cfg.n_heads, kernel_size=cfg.depthwise_kernel_size,
              compute_dtype=cfg.dtype, residual_dtype=cfg.rdtype,
              attn_softmax_dtype=cfg.sm_dtype)
    folded = model.stack.folded()
    heads_w = model.heads_w.to(torch.bfloat16)
    heads_b = model.heads_b.to(torch.bfloat16)

    def embed(w, c):
        """mel -> subsampling + PE: (x, sub_len, mask, lengths int32)."""
        feats = frontend.mel_spectrogram(w, acfg, method="dft")
        x, sub_len, mask = model.frontend_embed(
            feats, frontend.mel_lengths(c, acfg.hop_length))
        return x.contiguous(), sub_len, mask, mask.sum(1, dtype=torch.int32)

    def exit_hidden(m, w, c):
        """(E, B, T', D) bf16 exit hiddens of model m's trunk."""
        x, _, mask, _ = embed(w, c)
        _, hs = m.stack(x, mask, collect_outputs=True,
                        collect_every=cfg.n_enc_layers_per_exit)
        return hs.to(torch.bfloat16).contiguous()

    def block_vs_plain(x, lengths, what, **over):
        """Block kernel (kw overridden by `over`) against the plain version
        in the main path's profile: (max|d|, within the tolerance)."""
        y_k = kcb.conformer_block(folded[0], x, lengths, **{**kw, **over})
        y_p = kcb.conformer_block_plain(folded[0], x, lengths, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(y_k.float()).all():
            fail(f"conformer_block kernel gave non-finite values ({what})")
        if (y_k[lengths == 0] != 0).any():
            fail("conformer_block kernel: an empty item is not all zeros")
        err, mean, ulps, frac = bf16_figures(y_k, y_p)
        print(f"conformer_block vs plain, {what} (B={x.shape[0]}, "
              f"T'={x.shape[1]}, lengths {lengths.tolist()}): max|d| {err} "
              f"mean|d| {mean} max ulps {ulps} values differing {frac} "
              f"(tolerance {BLOCK_MAX_ULPS} ulps, {BLOCK_DIFFERING})")
        return err, ulps <= BLOCK_MAX_ULPS and frac <= BLOCK_DIFFERING

    def denominator_order(x, lengths, what):
        """How far the order of the softmax denominator's float32 sum alone
        moves the block: the plain version against itself with that sum
        exact (a reading, not a check)."""
        y_p = kcb.conformer_block_plain(folded[0], x, lengths, **kw)
        with exact_key_sums():
            y_x = kcb.conformer_block_plain(folded[0], x, lengths, **kw)
        _, _, ulps, frac = bf16_figures(y_p, y_x)
        print(f"plain version vs itself with the softmax denominator summed "
              f"exactly, {what} (T'={x.shape[1]}): max ulps {ulps} values "
              f"differing {frac}")

    def heads_vs_plain(hh, ww, bb, what):
        """head_argmax against its plain version: every id equal, ties too
        broken as the plain version breaks them (the lowest index)."""
        ids_k = kha.head_argmax(hh, ww, bb)
        ids_p = kha.head_argmax_plain(hh, ww, bb)
        torch.cuda.synchronize()
        n_diff = int((ids_k != ids_p).sum())
        print(f"head_argmax vs plain, {what} (E={hh.shape[0]}, "
              f"{hh.shape[1] * hh.shape[2]} rows): {n_diff} ids differ")
        if n_diff:
            fail(f"head_argmax kernel differs from the plain version ({what})")

    def lnq_vs_plain(rows, g, b, what):
        """layer_norm_quantize against its plain version, value for value;
        then against the plain LayerNorm followed by quantize_int8 (the
        model's two-pass LayerNorm, and the block plain version's one-pass
        one): an int8 value may differ there by one level, and only where
        the reference's v / sx lies within LNQ_TIE of a rounding tie; the
        scales within LNQ_SCALE_RTOL."""
        q_k, s_k = kcb.layer_norm_quantize(rows, g, b)
        q_p, s_p = kcb.layer_norm_quantize_plain(rows, g, b)
        torch.cuda.synchronize()
        n_q, n_s = int((q_k != q_p).sum()), int((s_k != s_p).sum())
        print(f"layer_norm_quantize vs plain, {what} ({rows.shape[0]} rows of "
              f"{rows.shape[1]}): {n_q} int8 values and {n_s} scales differ")
        if n_q or n_s:
            fail(f"layer_norm_quantize kernel differs from its plain version ({what})")
        for ln_name, ln in (("two-pass core.layer_norm", core.layer_norm(rows, g, b)),
                            ("one-pass LayerNorm of the block's plain version",
                             kcb._ln_one_pass(rows, g, b, 1e-5))):
            q_r, s_r = core.quantize_int8(ln)
            s_r = s_r[:, 0]
            t = ln / s_r[:, None]                  # the levels before rounding
            tie = ((t - torch.floor(t)) - 0.5).abs()
            diff = q_k != q_r
            n_d = int(diff.sum())
            far = float(tie[diff].max()) if n_d else 0.0
            step = int((q_k.int() - q_r.int()).abs().max())
            s_rel = float(((s_k - s_r).abs() / s_r).max())
            print(f"layer_norm_quantize vs {ln_name} + quantize_int8, {what}: {n_d} "
                  f"of {q_k.numel()} int8 values differ (at most {step} level; the "
                  f"farthest from a rounding tie at {far:.3e} of a level, tolerance "
                  f"{LNQ_TIE}); scales' max relative difference {s_rel:.3e} "
                  f"(tolerance {LNQ_SCALE_RTOL})")
            if step > 1 or far > LNQ_TIE or s_rel > LNQ_SCALE_RTOL:
                fail(f"layer_norm_quantize kernel disagrees with the {ln_name} + "
                     f"quantize_int8 ({what})")

    # ---- 2. each kernel against its plain version, B=8, one short item
    with torch.no_grad():
        c8 = counts[:8].clone()
        c8[-1] = acfg.sample_rate          # a 1 s request among ~10 s ones
        c8[-2] = 0                         # and an empty one
        x8, _, _, len8 = embed(wav[:8], c8)
        # past the TPU kernel's T' <= 512: 60 s and 45 s of the requests
        # laid end to end
        long_c = torch.tensor([60, 45], device=dev) * acfg.sample_rate
        xl, _, _, lenl = embed(wav[:12].reshape(2, -1), long_c)
        other = (torch.float32 if cfg.sm_dtype == torch.bfloat16
                 else torch.bfloat16)
        r = [block_vs_plain(x8, len8, "main-path shape"),
             block_vs_plain(xl, lenl, "past T'=512"),
             block_vs_plain(x8, len8, f"kernel with {other} softmax",
                            attn_softmax_dtype=other),
             block_vs_plain(xl, lenl, f"past T'=512, kernel with {other} softmax",
                            attn_softmax_dtype=other)]
        if not (r[0][1] and r[1][1]):
            fail("conformer_block kernel disagrees with its plain version")
        if r[2][1] or r[3][1]:
            fail("the block tolerance cannot tell the softmax dtypes apart")
        blk_err = max(r[0][0], r[1][0])
        denominator_order(x8, len8, "main-path shape")
        denominator_order(xl, lenl, "past T'=512")

        h8 = exit_hidden(rec_u.model, wav[:8], c8)
        ids_k = kha.head_argmax(h8, heads_w, heads_b)
        ids_p = kha.head_argmax_plain(h8, heads_w, heads_b)
        torch.cuda.synchronize()
        logits = (torch.matmul(h8.float(), heads_w.float()[:, None])
                  .to(torch.bfloat16) + heads_b[:, None, None]).float()
        l_k = logits.gather(-1, ids_k.long()[..., None])
        l_p = logits.gather(-1, ids_p.long()[..., None])
        n_diff = int((ids_k != ids_p).sum())
        n_nontie = int(((ids_k != ids_p) & (l_k[..., 0] != l_p[..., 0])).sum())
        head_err = float((l_k - l_p).abs().max())
        print(f"head_argmax vs plain (E=6, B=8, T'={h8.shape[2]}): "
              f"{n_diff} ids differ, {n_nontie} not at exact bf16 ties")
        if n_nontie:
            fail("head_argmax kernel id differs from the plain version at a non-tie")
        # forced exact ties: each exit's most frequent id copied into two
        # other columns, so its rows tie three ways; and row counts that
        # leave the last 64-row tile ragged
        tie_w, tie_b = heads_w.clone(), heads_b.clone()
        for e in range(tie_w.shape[0]):
            top = int(torch.mode(ids_p[e].flatten().long()).values)
            for c in {(top + 97) % 256, (top + 181) % 256} - {top}:
                tie_w[e, :, c], tie_b[e, c] = heads_w[e, :, top], heads_b[e, top]
        for what, hh, ww, bb in (("forced ties", h8, tie_w, tie_b),
                                 ("rows 3 x 37", h8[:, :3, :37].contiguous(), heads_w, heads_b),
                                 ("forced ties, rows 1 x 1", h8[:, :1, :1].contiguous(),
                                  tie_w, tie_b)):
            heads_vs_plain(hh, ww, bb, what)

        # the attention kernel on block 1's q, k, v, bf16 and float32
        blk0 = rec_u.model.stack.blocks[0]
        mask8 = torch.arange(x8.shape[1], device=dev)[None, :] < len8[:, None]
        H, dh = cfg.n_heads, cfg.d_model // cfg.n_heads

        def qkv_of(x, dt):
            y = core.layer_norm(x, blk0.attn.ln_g, blk0.attn.ln_b)
            return [core.linear(y, getattr(blk0.attn, "w" + n),
                                getattr(blk0.attn, "b" + n), compute_dtype=dt)
                    .reshape(x.shape[0], x.shape[1], H, dh).transpose(1, 2)
                    .contiguous() for n in "qkv"]

        att_err = 0.0
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = qkv_of(x8, dt)
            o_k = katt.fused_attention(q, k, v, mask8)
            o_p = katt.fused_attention_plain(q, k, v, mask8)
            torch.cuda.synchronize()
            err = float((o_k - o_p).abs().max())
            empty = float((o_k[-2] - v[-2].float().mean(1, keepdim=True)).abs().max())
            # an output is a convex combination of the rows of v: the
            # tolerance is relative to the largest |v|
            tol = ATT_RTOL * max(1.0, float(v.float().abs().max()))
            print(f"attention vs plain, {dt} inputs (B=8, H={H}, T'={x8.shape[1]}, "
                  f"dh={dh}): max|d| {err} (tolerance {tol:.3e} = {ATT_RTOL} x "
                  f"max|v|); empty item vs the mean of v: {empty}")
            if not torch.isfinite(o_k).all() or err > tol or empty > tol:
                fail(f"attention kernel disagrees with its plain version ({dt})")
            att_err = max(att_err, err)

        # the float32 and W8A8 entries of the block kernel
        sd0 = blk0.state_dict()
        f32_0 = kcb.fold_block_params(sd0, compute_dtype=torch.float32)
        kw32 = dict(kw, compute_dtype=torch.float32, residual_dtype=torch.float32,
                    attn_softmax_dtype=torch.float32)
        y32 = kcb.conformer_block(f32_0, x8.float(), len8, **kw32)
        y32_p = kcb.conformer_block_plain(f32_0, x8.float(), len8, **kw32)
        torch.cuda.synchronize()
        f32_err = float((y32 - y32_p).abs().max())
        print(f"conformer_block float32 entry vs plain (B=8, T'={x8.shape[1]}): "
              f"max|d| {f32_err} mean|d| {float((y32 - y32_p).abs().mean())} "
              f"(tolerance {F32_BLOCK_ATOL})")
        if (not torch.isfinite(y32).all() or f32_err > F32_BLOCK_ATOL
                or (y32[len8 == 0] != 0).any()):
            fail("conformer_block float32 entry disagrees with its plain version")

        q8_0 = kcb.fold_block_params(sd0, quantize="int8")
        w8_err = 0.0
        for sm in (cfg.sm_dtype, other):
            kwq = dict(kw, attn_softmax_dtype=sm)
            y_q = kcb.conformer_block(q8_0, x8, len8, quantize="int8", **kwq)
            y_qp = kcb.conformer_block_plain(q8_0, x8, len8, quantize="int8", **kwq)
            y_fp = kcb.conformer_block_plain(folded[0], x8, len8, **kwq)
            torch.cuda.synchronize()
            res = []
            for what, ref in (("its plain version", y_qp),
                              ("the unquantized plain version", y_fp)):
                err, mean, ulps, frac = bf16_figures(y_q, ref)
                print(f"conformer_block W8A8 entry ({sm} softmax) vs {what}: "
                      f"max|d| {err} mean|d| {mean} max ulps {ulps} values "
                      f"differing {frac} (tolerance {BLOCK_MAX_ULPS} ulps, "
                      f"{BLOCK_DIFFERING})")
                res.append((err, ulps <= BLOCK_MAX_ULPS and frac <= BLOCK_DIFFERING))
            if (not torch.isfinite(y_q.float()).all() or not res[0][1]
                    or (y_q[len8 == 0] != 0).any()):
                fail("conformer_block W8A8 entry disagrees with its plain version")
            if res[1][1]:
                fail("the block tolerance cannot tell W8A8 from the unquantized block")
            w8_err = max(w8_err, res[0][0])

        # the bf16 and W8A8 entries past their former T' = 1600 limit (K and
        # V of a whole item in shared memory; now streamed in key tiles):
        # 80.02 s (T' = 2000) and its neighbour 79.98 s (T' = 1999) beside
        # 55 s, the requests laid end to end
        for n_hop in (8002, 7998):
            n_long = n_hop * acfg.hop_length
            x80, _, _, len80 = embed(wav[:18].reshape(2, -1)[:, :n_long].contiguous(),
                                     torch.tensor([n_long, 55 * acfg.sample_rate],
                                                  device=dev))
            tp = n_hop // 4
            if x80.shape[1] != tp:
                fail(f"the long check's T' is {x80.shape[1]}, not {tp}")
            r80 = block_vs_plain(x80, len80, f"bf16 entry, T'={tp}")
            denominator_order(x80, len80, f"T'={tp}")
            y_q = kcb.conformer_block(q8_0, x80, len80, quantize="int8", **kw)
            y_qp = kcb.conformer_block_plain(q8_0, x80, len80, quantize="int8", **kw)
            torch.cuda.synchronize()
            err, mean, ulps, frac = bf16_figures(y_q, y_qp)
            print(f"conformer_block W8A8 entry vs its plain version, T'={tp} "
                  f"(lengths {len80.tolist()}): max|d| {err} mean|d| {mean} max ulps "
                  f"{ulps} values differing {frac} (tolerance {BLOCK_MAX_ULPS} ulps, "
                  f"{BLOCK_DIFFERING})")
            if not r80[1]:
                fail(f"conformer_block kernel disagrees with its plain version at T'={tp}")
            if (not torch.isfinite(y_q.float()).all() or ulps > BLOCK_MAX_ULPS
                    or frac > BLOCK_DIFFERING):
                fail(f"conformer_block W8A8 entry disagrees with its plain version "
                     f"at T'={tp}")
            blk_err, w8_err = max(blk_err, r80[0]), max(w8_err, err)
            del x80, y_q, y_qp

        # a row's result must not depend on the rows beside it
        y_b = kcb.conformer_block(folded[0], x8, len8, **kw)
        y_q = kcb.conformer_block(q8_0, x8, len8, quantize="int8", **kw)
        part = slice(2, 5)
        for what, whole, alone in (
                ("bf16", y_b, kcb.conformer_block(
                    folded[0], x8[part].contiguous(), len8[part].contiguous(), **kw)),
                ("W8A8", y_q, kcb.conformer_block(
                    q8_0, x8[part].contiguous(), len8[part].contiguous(),
                    quantize="int8", **kw)),
                ("float32", y32, kcb.conformer_block(
                    f32_0, x8[part].float().contiguous(), len8[part].contiguous(),
                    **kw32))):
            torch.cuda.synchronize()
            same = torch.equal(whole[part], alone)
            print(f"conformer_block {what} entry: rows 2..4 alone equal to the "
                  f"same rows in the batch of 8: {same}")
            if not same:
                fail(f"the {what} block kernel's rows depend on their batch")

        # the bf16 block's product on its own, ragged M, residual in place
        gen = torch.Generator(device="cpu").manual_seed(7)

        def randn_bf16(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen) * scale).to(torch.bfloat16).to(dev)

        D_, F_ = cfg.d_model, cfg.d_feed_forward
        gemm_shapes = (("W1", D_, F_, "silu"), ("W2", F_, D_, "res_half"),
                       ("QKV", D_, 3 * D_, "bias"), ("Wo", D_, D_, "res"),
                       ("PW1", D_, 2 * D_, "bias"), ("PW2", D_, D_, "res"))
        # 15 tiles of 128 rows and 79 more; then less than one warpgroup's 64
        # rows, and widths that leave a tile's columns and its last k ragged
        gemm_cases = [(n, k, m, 1999) for n, k, m, _ in gemm_shapes] + [
            ("W1", D_, F_, 37), ("W2", F_, D_, 37),
            ("K=128, 1.5 tiles wide", 128, 384, 333), ("K=6.5 stages", 416, 128, 333)]
        gemm_err = 0.0
        for name, K_, N_, M_rag in gemm_cases:
            a, w_ = randn_bf16(M_rag, K_), randn_bf16(K_, N_, scale=K_ ** -0.5)
            b_, r_ = randn_bf16(N_), randn_bf16(M_rag, N_)
            worst = (0.0, 0.0)
            for epi in kcb.GEMM_EPILOGUES:
                res = r_.clone() if epi.startswith("res") else None
                y_p = kcb.block_gemm_plain(a, w_, b_, res, epi)
                y_k = kcb.block_gemm(a, w_, b_, res, epi, out=res)
                torch.cuda.synchronize()
                d = (y_k.float() - y_p.float()).abs()
                ulp = torch.exp2(torch.floor(torch.log2(
                    y_p.float().abs().clamp_min(1.0))) - 7)
                ulps, frac = float((d / ulp).max()), float((d > 0).float().mean())
                worst = (max(worst[0], ulps), max(worst[1], frac))
                gemm_err = max(gemm_err, float(d.max()))
                if (not torch.isfinite(y_k.float()).all() or ulps > GEMM_MAX_ULPS
                        or frac > GEMM_DIFFERING):
                    fail(f"block_gemm kernel disagrees with its plain version "
                         f"({name} {K_}->{N_}, M={M_rag}, {epi}): {ulps} ulps, "
                         f"{frac} of values differing")
            print(f"block_gemm vs plain, {name} {K_}->{N_}, M={M_rag}, four epilogues: "
                  f"max ulps {worst[0]} values differing {worst[1]} (tolerance "
                  f"{GEMM_MAX_ULPS} ulps, {GEMM_DIFFERING})")

        # the W8A8 block's int8 product on its own, same shapes, bit for bit.
        # Outputs of the block's scale, as for block_gemm: the SiLU of both
        # products rounds as the plain version's for inputs above -87
        # (gemm_bf16.cuh, silu_bf16x2), far below any the block makes
        def int8_operands(M_, K_, N_):
            aq, sx = core.quantize_int8(randn_bf16(M_, K_, scale=3.0).float())
            wq, sw = core.quantize_int8(randn_bf16(K_, N_, scale=K_ ** -0.5).float(), axis=0)
            return aq, sx[:, 0].contiguous(), wq.t().contiguous(), sw[0].contiguous()

        for name, K_, N_, M_rag in gemm_cases:
            aq, sx, wt, sw = int8_operands(M_rag, K_, N_)
            b_, r_ = randn_bf16(N_).float(), randn_bf16(M_rag, N_)
            for epi in kcb.GEMM_EPILOGUES:
                res = r_.clone() if epi.startswith("res") else None
                y_p = kcb.block_gemm_s8_plain(aq, sx, wt, sw, b_, res, epi)
                y_k = kcb.block_gemm_s8(aq, sx, wt, sw, b_, res, epi, out=res)
                torch.cuda.synchronize()
                if not torch.equal(y_k, y_p):
                    fail(f"block_gemm_s8 kernel differs from its plain version ({name} "
                         f"{K_}->{N_}, M={M_rag}, {epi}): {int((y_k != y_p).sum())} values")
            print(f"block_gemm_s8 vs plain, {name} {K_}->{N_}, M={M_rag}, four epilogues: "
                  f"equal bit for bit")
        # the int8 extremes at K = 256, where the epilogue's exact int ->
        # float conversion meets its bound: sums of +-2^22
        aq = torch.full((64, 256), -128, dtype=torch.int8, device=dev)
        wt = torch.full((256, 256), 127, dtype=torch.int8, device=dev)
        wt[::2] = -128
        ones = torch.ones(256, device=dev)
        y_k = kcb.block_gemm_s8(aq, ones[:64], wt, ones, ones)
        y_p = kcb.block_gemm_s8_plain(aq, ones[:64], wt, ones, ones)
        torch.cuda.synchronize()
        if not torch.equal(y_k, y_p):
            fail("block_gemm_s8 kernel differs from its plain version at int8 extremes")
        print("block_gemm_s8 vs plain, int8 extremes at K=256 (sums of +-2^22): "
              "equal bit for bit")
        # the W8A8 LayerNorm + quantize on block 1's attention LayerNorm
        lnq_vs_plain(x8.reshape(-1, x8.shape[-1]), q8_0["attn_ln_g"],
                     q8_0["attn_ln_b"], "B=8")

        # the float32 attention at one key, either side of its 64-wide tiles
        # and at 12 tiles and a bit, in both layouts
        for T_ in (1, 65, 249, 785):
            len3 = torch.tensor([T_, max(1, T_ // 3), 0], device=dev, dtype=torch.int32)
            mask3 = torch.arange(T_, device=dev)[None, :] < len3[:, None]
            for dt in (torch.bfloat16, torch.float32):
                q, k, v = ((torch.randn(3, H, T_, dh, generator=gen) * 3.0).to(dt).to(dev)
                           for _ in range(3))
                o_k = katt.fused_attention(q, k, v, mask3)
                o_p = katt.fused_attention_plain(q, k, v, mask3)
                torch.cuda.synchronize()
                err = float((o_k - o_p).abs().max())
                empty = float((o_k[-1] - v[-1].float().mean(1, keepdim=True)).abs().max())
                tol = ATT_RTOL * max(1.0, float(v.float().abs().max()))
                print(f"attention vs plain, (B, H, T, dh) layout, T={T_}, {dt}: max|d| "
                      f"{err} empty item vs the mean of v {empty} (tolerance {tol:.3e})")
                if not torch.isfinite(o_k).all() or err > tol or empty > tol:
                    fail(f"attention kernel disagrees with its plain version "
                         f"(T={T_}, {dt})")
                att_err = max(att_err, err)
            # packed q|k|v rows: the float32 block on T_ frames of the long items
            xt = torch.stack([xl[0, :T_], xl[1, :T_], xl[0, -T_:]]).float().contiguous()
            y_k = kcb.conformer_block(f32_0, xt, len3, **kw32)
            y_p = kcb.conformer_block_plain(f32_0, xt, len3, **kw32)
            torch.cuda.synchronize()
            err = float((y_k - y_p).abs().max())
            print(f"conformer_block float32 entry vs plain, packed layout, B=3, T'={T_}: "
                  f"max|d| {err} (tolerance {F32_BLOCK_ATOL})")
            if (not torch.isfinite(y_k).all() or err > F32_BLOCK_ATOL
                    or (y_k[-1] != 0).any()):
                fail(f"conformer_block float32 entry disagrees with its plain "
                     f"version at T'={T_}")
            f32_err = max(f32_err, err)

    # ---- 3. the main path end to end, launch counts around it
    def plain_path_ids(w, c):
        """The kernel path rebuilt from the kernels' plain versions."""
        x, sub_len, _, lengths = embed(w, c)
        hs = []
        for i, f in enumerate(folded):
            x = kcb.conformer_block_plain(f, x, lengths, **kw)
            if (i + 1) % cfg.n_enc_layers_per_exit == 0:
                hs.append(x)
        return kha.head_argmax_plain(torch.stack(hs), heads_w, heads_b), sub_len

    def greedy(ids, sub_len):
        E, Bn, T = ids.shape
        t, n = ctc.greedy_decode_ids(ids.reshape(E * Bn, T), sub_len.repeat(E))
        return t.reshape(E, Bn, T).cpu(), n.reshape(E, Bn).cpu()

    with torch.no_grad():
        reset_counts()
        out_k = rec_k.transcribe(wav, counts)
        launches = expect_counts("all-exit path", conformer_block_bf16=len(folded),
                                 head_argmax=1)
        out_u = rec_u.transcribe(wav, counts)
        tok_p, n_p = greedy(*plain_path_ids(wav, counts))
    ladder = [round(wer_pct(refs, t), 2) for t in out_k.texts]
    ladder_u = [round(wer_pct(refs, t), 2) for t in out_u.texts]
    print(f"exit WER ladder, kernel path (B={B}): {ladder}")
    print(f"exit WER ladder, unfused path: {ladder_u}")
    for i in range(3):
        print(f"EXPECTED: {refs[i]}")
        print(f"EXIT_6:   {out_k.texts[-1][i]}")
    vs_plain = disagreement(out_k.tokens, out_k.n_tokens, tok_p, n_p)
    vs_unfused = disagreement(out_k.tokens, out_k.n_tokens,
                              out_u.tokens, out_u.n_tokens)
    # two bf16 schedules with no kernel in either, for scale
    no_kernel = disagreement(tok_p, n_p, out_u.tokens, out_u.n_tokens)
    print(f"token disagreement, plain-version path vs unfused path (no "
          f"kernel): per exit {[f'{e}/{t}' for e, t in no_kernel]}")
    # the kernel against its plain versions: <= 1% at every exit; against
    # the unfused path: <= 1% pooled and at every exit that transcribes
    for what, dis, every in (("plain versions", vs_plain, True),
                             ("unfused path", vs_unfused, False)):
        pooled = sum(e for e, _ in dis) / sum(t for _, t in dis)
        print(f"token disagreement, kernel path vs {what}: per exit "
              f"{[f'{e}/{t}' for e, t in dis]}, pooled {100 * pooled:.3f}%")
        if pooled > TOKEN_DISAGREE:
            fail(f"kernel path disagrees with the {what} by > 1% pooled")
        for i, ((e, t), wer) in enumerate(zip(dis, ladder)):
            if (every or wer <= SANE_DENSE_WER) and e > TOKEN_DISAGREE * t:
                fail(f"kernel path disagrees with the {what} by > 1% at "
                     f"exit {i + 1}")
    if ladder[-1] > SANE_DENSE_WER:
        fail(f"final-exit WER {ladder[-1]}% > {SANE_DENSE_WER}%: broken harness")

    # ---- 4. times at B=128 x 10 s, full-length requests
    with torch.no_grad():
        full = torch.full_like(counts, N)
        x, _, _, lengths = embed(wav, full)
        f0 = folded[0]
        R, D, T = B * x.shape[1], x.shape[2], x.shape[1]
        # the W8A8 block and its LayerNorm + quantize at the main path's size
        err, mean, ulps, frac = bf16_figures(
            kcb.conformer_block(q8_0, x, lengths, quantize="int8", **kw),
            kcb.conformer_block_plain(q8_0, x, lengths, quantize="int8", **kw))
        print(f"conformer_block W8A8 entry vs its plain version (B={B}, T'={T}): "
              f"max|d| {err} mean|d| {mean} max ulps {ulps} values differing "
              f"{frac} (tolerance {BLOCK_MAX_ULPS} ulps, {BLOCK_DIFFERING})")
        if ulps > BLOCK_MAX_ULPS or frac > BLOCK_DIFFERING:
            fail(f"conformer_block W8A8 entry disagrees with its plain version at B={B}")
        w8_err = max(w8_err, err)
        lnq_vs_plain(x.reshape(R, D), q8_0["attn_ln_g"], q8_0["attn_ln_b"], f"B={B}")
        rows = block_rows(f0, f32_0, q8_0, x, lengths, kw)
        blk, f32, w8 = rows["bf16"], rows["f32"], rows["w8a8"]
        hid = exit_hidden(model, wav, full)
        # the persistent heads at the main path's size (~23 (exit, 64-row)
        # items a block: the ring wraps, a block's run crosses exits)
        heads_vs_plain(hid, heads_w, heads_b, f"B={B}")
        head = head_row(hid, heads_w, heads_b)
        maskf = torch.arange(T, device=dev)[None, :] < lengths[:, None]
        qb, kb_, vb = qkv_of(x, torch.bfloat16)        # path (D) hands it bf16
        att = attention_row(qb, kb_, vb, maskf)

        # each product of the bf16 block on its own, at the main path's M
        gemm_times = []
        big = torch.empty(8192, 8192, device=dev).normal_()

        def blocker():          # ~20 ms of float32 FMAs
            torch.matmul(big, big)

        for name, K_, N_, epi in gemm_shapes:
            a, w_ = randn_bf16(R, K_), randn_bf16(K_, N_, scale=K_ ** -0.5)
            b_ = randn_bf16(N_)
            r_ = randn_bf16(R, N_) if epi.startswith("res") else None
            o_ = torch.empty(R, N_, dtype=torch.bfloat16, device=dev)
            t_k = cuda_ms(lambda: kcb.block_gemm(a, w_, b_, r_, epi, out=o_),
                          behind=blocker)
            t_l = cuda_ms(lambda: torch.matmul(a, w_), behind=blocker)
            gemm_times.append((name, K_, N_, epi, t_k, t_l))
        s8_times = []
        for name, K_, N_, epi in gemm_shapes:
            aq, sx, wt, sw = int8_operands(R, K_, N_)
            b_ = randn_bf16(N_).float()
            r_ = randn_bf16(R, N_) if epi.startswith("res") else None
            o_ = torch.empty(R, N_, dtype=torch.bfloat16, device=dev)
            t_k = cuda_ms(lambda: kcb.block_gemm_s8(aq, sx, wt, sw, b_, r_, epi, out=o_),
                          behind=blocker)
            t_l = cuda_ms(lambda: torch._int_mm(aq, wt.t()), behind=blocker)
            s8_times.append((name, K_, N_, epi, t_k, t_l))
            # and bit for bit at this M (~15 tiles a block when K <= 256: the
            # rings wrap, a block's strip and accumulators are reused)
            if not torch.equal(o_, kcb.block_gemm_s8_plain(aq, sx, wt, sw, b_, r_, epi)):
                fail(f"block_gemm_s8 kernel differs from its plain version ({name} "
                     f"{K_}->{N_}, M={R}, {epi})")
            print(f"block_gemm_s8 vs plain, {name} {K_}->{N_} +{epi}, M={R}: "
                  f"equal bit for bit")
        del a, w_, b_, r_, o_, aq, wt, big
        # the host's side of one bf16 block launch: the wrapper and the C
        # entry's 15 launches, no synchronisation inside the timed calls
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(30):
            kcb.conformer_block(f0, x, lengths, **kw)
        host_ms = (time.perf_counter() - t0) * 1e3 / 30
        torch.cuda.synchronize()

        def forward(rec):
            ids, sub_len = rec.exit_ids(wav, full)
            E_, B_, T_ = ids.shape
            return ctc.greedy_decode_ids(ids.reshape(E_ * B_, T_), sub_len.repeat(E_))

        e2e_ms = cuda_ms(lambda: forward(rec_k), 10, 2)
        e2e_u_ms = cuda_ms(lambda: forward(rec_u), 10, 2)
    audio_s = B * N / acfg.sample_rate
    print(f"times on {card} (B={B}, T'={T}, CUDA events):")
    for name, t in (("conformer_block", blk), ("conformer_block float32", f32),
                    ("conformer_block W8A8", w8), ("head_argmax", head),
                    ("attention (bf16 q, k, v)", att)):
        by = "operations" if t["bound"][0] >= t["bound"][1] else "bytes"
        t["bound_ms"], t["bound_by"] = 1e3 * max(t["bound"]), by
        lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        print(f"  {name}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"library {lib}, bound {t['bound_ms']:.4f} ms "
              f"({by}: {t['bound'][0] * 1e3:.4f} ms ops, {t['bound'][1] * 1e3:.4f} ms bytes)")
    print(f"  attention with float32 q, k, v: kernel {att['ms_f32_in']:.4f} ms; "
          f"library = SDPA on the float32 inputs")
    for name, K_, N_, epi, t_k, t_l in gemm_times:
        print(f"  block_gemm {name} {K_}->{N_} +{epi}, M={R}: {t_k:.4f} ms = "
              f"{2 * R * K_ * N_ / t_k / 1e9:.1f} TFLOP/s (torch.matmul without the "
              f"epilogue {t_l:.4f} ms)")
    for name, K_, N_, epi, t_k, t_l in s8_times:
        print(f"  block_gemm_s8 {name} {K_}->{N_} +{epi}, M={R}: {t_k:.4f} ms = "
              f"{2 * R * K_ * N_ / t_k / 1e9:.1f} TOP/s (torch._int_mm without the "
              f"epilogue {t_l:.4f} ms)")
    print(f"  host time of one bf16 block launch (wrapper + C entry, no "
          f"synchronisation): {host_ms:.4f} ms")
    print(f"  end to end, kernel path: {e2e_ms:.3f} ms per {B} x 10 s = "
          f"{audio_s / (e2e_ms / 1e3):.1f} audio-s/s")
    print(f"  end to end, unfused path: {e2e_u_ms:.3f} ms = "
          f"{audio_s / (e2e_u_ms / 1e3):.1f} audio-s/s")
    profile_forward(lambda: forward(rec_k), "all-exit forward", card, B)
    with torch.no_grad():
        profile_forward(lambda: kcb.conformer_block(q8_0, x, lengths, quantize="int8", **kw),
                        "W8A8 block", card, B, iters=10)

    # ---- 6. gated cascade serving: paths (A) bf16 blocks and (B) W8A8 blocks
    E, npe = cfg.n_enc_exits, cfg.n_enc_layers_per_exit
    k_casc = int(rec_k.calib.get("cascade_k") or 2)
    dense_wer = {"A": ladder[-1]}

    def gated_path(rec, path, entry, what, rows_differ=ROWS_DIFFER):
        """One calibration on the 128 requests: counts around the cascade,
        its decisions against the while-loop gate's and the plain-version
        cascade's, WER and mean exits. Returns its block launches."""
        with torch.no_grad():
            reset_counts()
            out = rec.transcribe_gated(wav, counts)
            want = k_casc * npe + ((E - k_casc) * npe if out.rows_packed else 0)
            got = expect_counts(f"path ({path}), {what}",
                                **{"conformer_block_" + entry: want})
            gate = rec.transcribe_gated(wav, counts, strategy="whileloop")
            with plain_versions(kcb, katt):
                plain = rec.transcribe_gated(wav, counts)
        agree = int((out.chosen_exit == gate.chosen_exit).sum())
        differ = float((out.chosen_exit != plain.chosen_exit).float().mean())
        hist = torch.bincount(out.chosen_exit.long(), minlength=E + 1)[1:].tolist()
        print(f"path ({path}), {what}: chosen exits equal to the while-loop gate's "
              f"on {agree}/{B} rows; differing from the plain-version cascade on "
              f"{100 * differ:.2f}% of rows; rows per exit {hist}, mean exit "
              f"{float(out.chosen_exit.float().mean()):.3f}, escalated "
              f"{100 * out.escalated_share:.2f}% ({out.rows_packed} rows packed), "
              f"exits computed per request "
              f"{(k_casc * B + (E - k_casc) * out.rows_packed) / B:.3f}; gated WER "
              f"{wer_pct(refs, out.texts):.2f}% (while-loop gate "
              f"{wer_pct(refs, gate.texts):.2f}%, plain-version cascade "
              f"{wer_pct(refs, plain.texts):.2f}%) beside the dense final-exit "
              f"{dense_wer[path]:.2f}%")
        if agree != B:
            fail(f"path ({path}), {what}: the cascade and the while-loop gate "
                 f"choose different exits on {B - agree} rows")
        # the heads are torch.matmul, whose result for a row may depend on
        # the batch it is in (packed phase-B rows vs the whole batch)
        n_text = sum(a != b for a, b in zip(out.texts, gate.texts))
        print(f"path ({path}), {what}: rows whose text differs from the while-loop "
              f"gate's: {n_text}/{B}")
        if n_text > ROWS_DIFFER * B:
            fail(f"path ({path}), {what}: the cascade and the gate decode different "
                 f"text on {n_text} rows")
        if differ > rows_differ:
            fail(f"path ({path}), {what}: chosen exits differ from the plain-version "
                 f"cascade's on more than {100 * rows_differ:.0f}% of rows")
        if wer_pct(refs, out.texts) > SANE_DENSE_WER:
            fail(f"path ({path}), {what}: gated WER beyond the sanity bound")
        return got["conformer_block_" + entry], out

    def cascade_times(rec, path):
        def dense():
            ids, sub_len = rec.exit_ids(wav, counts)
            E_, B_, T_ = ids.shape
            return ctc.greedy_decode_ids(ids.reshape(E_ * B_, T_), sub_len.repeat(E_))

        def whileloop():
            logp, _, sub_len, _ = gated_apply(rec.model, *rec._features(wav, counts),
                                              **rec.gate_settings())
            return ctc.greedy_decode(logp, sub_len)

        with torch.no_grad():
            t_c = cuda_ms(lambda: rec.cascade_pass(wav, counts), 10, 2)
            t_g = cuda_ms(whileloop, 10, 2)
            t_d = cuda_ms(dense, 10, 2)
        true_s = float(counts.sum()) / acfg.sample_rate
        print(f"path ({path}) times on {card} (B={B}, true audio {true_s:.1f} s): one "
              f"cascade pass, mask fetch and host packing included, {t_c:.3f} ms = "
              f"{true_s / (t_c / 1e3):.1f} audio-s/s; while-loop gate {t_g:.3f} ms; "
              f"all-exit forward {t_d:.3f} ms = {true_s / (t_d / 1e3):.1f} audio-s/s")

    def median_threshold(rec):
        """The calibration with exit k's threshold at the batch's median
        confidence there: half the rows escalate."""
        gate = rec.gate_settings()
        with torch.no_grad():
            lp, sub_len = rec.model.encode_exit(*rec._features(wav, counts), k_casc)
            m = torch.arange(lp.shape[1], device=dev)[None, :] < sub_len[:, None]
            conf = scaled_confidence(lp, m, gate["score"],
                                     gate["temperatures"][k_casc - 1])
        thr = list(gate["threshold"])
        thr[k_casc - 1] = float(conf.sort().values[B // 2 - 1:B // 2 + 1].mean())
        return {**rec.calib, "thresholds": thr}

    rec_q = Recognizer.from_flagship("cuda", fused=True, quantize="int8")
    with torch.no_grad():
        out_q = rec_q.transcribe(wav, counts)
    ladder_q = [round(wer_pct(refs, t), 2) for t in out_q.texts]
    print(f"exit WER ladder, W8A8 kernel path (B={B}): {ladder_q}")
    dense_wer["B"] = ladder_q[-1]
    if ladder_q[-1] > SANE_DENSE_WER:
        fail(f"W8A8 final-exit WER {ladder_q[-1]}% > {SANE_DENSE_WER}%")
    gated_launches = {}
    for path, rec, entry in (("A", rec_k, "bf16"), ("B", rec_q, "w8a8")):
        committed = rec.calib
        n1, _ = gated_path(rec, path, entry, "committed calibration")
        cascade_times(rec, path)
        profile_forward(lambda: rec.cascade_pass(wav, counts),
                        f"path ({path}) cascade pass, committed calibration",
                        card, B, top=12)
        rec.calib = median_threshold(rec)
        n2, out_m = gated_path(rec, path, entry, "exit 2's threshold at the median",
                               ROWS_DIFFER_AT_MEDIAN)
        if not 0.4 <= out_m.escalated_share <= 0.6:
            fail(f"path ({path}): the moved threshold escalated "
                 f"{out_m.escalated_share:.2f} of the rows, not about half")
        cascade_times(rec, path)
        rec.calib = committed
        gated_launches[entry] = (n1, n2)

    # ---- 7. paths (C) float32 fused and (D) unfused with the attention kernel
    def allexit_path(path, rec, ref, n, **want):
        with torch.no_grad():
            reset_counts()
            out = rec.transcribe(wav[:n], counts[:n])
            got = expect_counts(f"path ({path})", **want)
            out_r = ref.transcribe(wav[:n], counts[:n])
            with plain_versions(kcb, katt):
                out_p = rec.transcribe(wav[:n], counts[:n])
        wers = [round(wer_pct(refs[:n], t), 2) for t in out.texts]
        print(f"path ({path}) exit WER ladder ({n} requests): {wers}")
        for what, o in (("the unfused path of the same configuration", out_r),
                        ("the same path built from the plain versions", out_p)):
            dis = disagreement(out.tokens, out.n_tokens, o.tokens, o.n_tokens)
            pooled = sum(e for e, _ in dis) / sum(t for _, t in dis)
            print(f"path ({path}) token disagreement vs {what}: per exit "
                  f"{[f'{e}/{t}' for e, t in dis]}, pooled {100 * pooled:.3f}%")
            if pooled > TOKEN_DISAGREE:
                fail(f"path ({path}) disagrees with {what} by > 1% pooled")
            for i, ((e, t), w) in enumerate(zip(dis, wers)):
                if w <= SANE_DENSE_WER and e > TOKEN_DISAGREE * t:
                    fail(f"path ({path}) disagrees with {what} by > 1% at exit {i + 1}")
        if wers[-1] > SANE_DENSE_WER:
            fail(f"path ({path}): final-exit WER {wers[-1]}%")
        return got

    n_cd = 16
    rec_f = Recognizer.from_flagship("cuda", fused=True, compute_dtype="float32")
    rec_fu = Recognizer.from_flagship("cuda", fused=False, compute_dtype="float32")
    got_c = allexit_path("C", rec_f, rec_fu, n_cd, conformer_block_f32=len(folded))
    del rec_f, rec_fu
    rec_a = Recognizer.from_flagship("cuda", fused=False, attention_impl="pallas")
    got_d = allexit_path("D", rec_a, rec_u, n_cd, attention=len(folded))
    del rec_a, rec_q

    # ---- the serving programs of phases 11, 14c and 18a: captured and
    # compiled in a child process beside phases 8-18d, once the kernels'
    # times above are taken; those three phases run last
    export_job = child_pool.submit(export_child, work_dir, EXPORT_WORKERS)

    # ---- 8. training on the card
    train_phase(dev, card, knobs, reset_counts, expect_counts)

    # ---- 9. the inference CLI on the card; 10. streaming, over its corpus;
    # 12. the AED mode and 13. the zoo, over it; 15-17; 18b-d; then 11. the
    # serving export, 14. calibration and the zoo's bundles, 18a. the zoo's
    # poly programs, served from the bundles alone
    tmp = tempfile.mkdtemp(prefix="eet_infer_")
    try:
        t9 = time.perf_counter()
        corp = infer_phase(dev, card, knobs, reset_counts, read_counts, tmp)
        print(f"phase 9: {time.perf_counter() - t9:.1f} s")
        t10 = time.perf_counter()
        streamed = streaming_phase(dev, card, reset_counts, read_counts, corp)
        print(f"phase 10: {time.perf_counter() - t10:.1f} s")
        aed = aed_phase(dev, card, knobs, reset_counts, read_counts, corp, tmp)
        zoo = zoo_phase(dev, card, knobs, reset_counts, read_counts, corp, tmp, model,
                        wav, counts)
        ref = reference_phase(dev, card, reset_counts, read_counts, corp, tmp, rec_k, wav,
                              counts)
        parallel_phase(dev, card, knobs, reset_counts, read_counts, tmp)
        tools = tools_phase(dev, card, reset_counts, read_counts, corp, tmp, rec_k, wav,
                            counts)
        with torch.no_grad():
            x18, _, _, len18 = embed(wav, counts)
        meas = measure_phase(dev, card, reset_counts, read_counts, folded, x18, len18, kw)
        print(f"phase 18b-d: {sum(meas['secs'].values()):.1f} s on {card} (" + ", ".join(
            f"18{k} {v:.1f} s" for k, v in meas["secs"].items()) + ")")
        t19 = time.perf_counter()
        errs19 = widths_kernels(dev, card)
        widths = widths_phase(dev, card, reset_counts, read_counts, corp, tmp, wav, counts,
                              checkpoint.load_calib(), errs19)
        print(f"phase 19: {time.perf_counter() - t19:.1f} s on {card}")
        conformer_s = conformer_s_phase(dev, card, reset_counts, read_counts, corp, tmp, wav,
                                        counts, errs19)
        t11 = time.perf_counter()
        exported = export_phase(dev, card, reset_counts, read_counts, rec_k, wav, counts,
                                out_k, ladder, export_job, work_dir)
        print(f"phase 11: {time.perf_counter() - t11:.1f} s")
        zoo_export = {"models": zoo_models(dev), "dir": work_dir, "aoti": exported["aoti"],
                      "capture_s": exported["capture_s"]}
        gate = gate_phase(dev, card, reset_counts, read_counts, corp, tmp, wav, counts, refs,
                          zoo_export)
        poly = poly_phase(dev, card, reset_counts, read_counts, zoo_export, wav, counts,
                          refs)
        print(f"phase 18a: {poly['secs']:.1f} s on {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    blk_src = "early_exit_tpu_torch/csrc/conformer_block.cu"
    blk_line = "early_exit_tpu/ops/pallas/conformer_block.py:368"
    rows = []
    for name, t, err, src, line, n, path in (
            ("conformer_block", blk, blk_err, blk_src, blk_line,
             launches["conformer_block_bf16"],
             f"all-exit path; the cascade (A): {gated_launches['bf16'][0]} with no "
             f"row escalated, {gated_launches['bf16'][1]} with half; the exported "
             f"all-exit program (phase 11): {exported['allexit_launches']} over "
             f"{exported['calls']} calls, through the op eet::conformer_block; the "
             f"AED CLI's trunk (phase 12): {aed['launches']} over {aed['batches']} "
             f"batches, twice; the zoo's inference CLIs (phase 13): " + ", ".join(
                 f"{n} {b} over {nb} sub-batches" for n, (b, _, nb) in zoo["launches"].items())
             + f"; calibrate_gate's gated CLIs (phase 14): {gate['gate_launches']}; "
             f"escalation_report (phase 14): {gate['escalation_launches']}; the zoo's "
             f"exported all-exit programs (phase 14): {gate['export_launches']} over "
             f"{ZOO_EXPORT_ROWS // EXPORT_BUCKET[0]} calls each; the flagship imported "
             f"from its reference state_dict (phase 15): "
             f"{ref['launches']['conformer_block_bf16']} over one call; trace() around "
             f"two all-exit forwards (phase 17a): {tools['trace_launches']['conformer_block_bf16']}; "
             f"streaming_demo's full decodes (phase 17c): "
             f"{tools['demo_launches']['conformer_block_bf16']} over 8 utterances; the zoo's "
             f"poly programs (phase 18a): {poly['launches']}; the measuring tools "
             f"(phase 18c): {meas['child_launches']['ablate_head_path']['conformer_block_bf16']} "
             f"in ablate_head_path, {meas['child_launches']['bench_int8']['conformer_block_bf16']} "
             f"in bench_int8's bf16 fused legs; the ablation library's entry (18b): "
             f"{meas['ablate_launches']}"),
            ("conformer_block_f32", f32, f32_err, blk_src,
             blk_line + " (compute_dtype=float32)", got_c["conformer_block_f32"],
             f"(C) all-exit float32, {n_cd} requests"),
            ("conformer_block_w8a8", w8, w8_err, blk_src,
             blk_line + " (quantize='int8', body :225)", gated_launches["w8a8"][1],
             f"(B) the W8A8 cascade with half the rows escalated; "
             f"{gated_launches['w8a8'][0]} with none; bench_int8's int8 fused legs "
             f"(phase 18c): {meas['child_launches']['bench_int8']['conformer_block_w8a8']}"),
            ("head_argmax", head, head_err, "early_exit_tpu_torch/csrc/head_argmax.cu",
             "early_exit_tpu/ops/pallas/head_argmax.py:53", launches["head_argmax"],
             "all-exit path; the zoo's inference CLIs (phase 13): " + ", ".join(
                 f"{n} {h} over {nb} sub-batches (E={6 if n == 'splitformer' else 1})"
                 for n, (_, h, nb) in zoo["launches"].items())
             + f"; the imported flagship (phase 15): {ref['launches']['head_argmax']} over "
             f"one call; trace() around two all-exit forwards (phase 17a): "
             f"{tools['trace_launches']['head_argmax']}; ablate_head_path's kernel_all "
             f"(phase 18c): {meas['child_launches']['ablate_head_path']['head_argmax']}"),
            ("attention", att, att_err, "early_exit_tpu_torch/csrc/attention.cu",
             "early_exit_tpu/ops/pallas/attention.py:51", got_d["attention"],
             f"(D) unfused, attention_impl='pallas', {n_cd} requests"),
            ("attention_streaming", streamed["attention"], streamed["attention_err"],
             "early_exit_tpu_torch/csrc/attention.cu",
             "early_exit_tpu/ops/pallas/attention.py:51", streamed["launches"],
             "StreamPool with attention_impl='pallas' over the corpus (10.2), 12 a "
             "dispatch; timed at (32, 8, 112, 32) on streaming key masks; "
             f"streaming_demo's windows over 8 utterances (phase 17c): "
             f"{tools['demo_launches']['attention']}")):
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": line, "launches": n, "path": path,
                     "max_abs_err": err, "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    for key, name, src, line in (
            ("1@d512", "conformer_block_d512", blk_src, blk_line + " (d 512, 8 heads of 64)"),
            ("1b@d512", "conformer_block_w8a8_d512", blk_src,
             blk_line + " (quantize='int8', d 512, 8 heads of 64)"),
            ("1c@d512", "conformer_block_f32_d512", blk_src,
             blk_line + " (compute_dtype=float32, d 512, 8 heads of 64)"),
            ("2@V32", "head_argmax_V32", "early_exit_tpu_torch/csrc/head_argmax.cu",
             "early_exit_tpu/ops/pallas/head_argmax.py:53 (V 32, D 256)"),
            ("2@V5000·D512", "head_argmax_V5000_D512",
             "early_exit_tpu_torch/csrc/head_argmax.cu",
             "early_exit_tpu/ops/pallas/head_argmax.py:53 (V 5000, D 512)"),
            ("3@dh64", "attention_dh64", "early_exit_tpu_torch/csrc/attention.cu",
             "early_exit_tpu/ops/pallas/attention.py:51 (dh 64)"),
            *((key, name, blk_src, blk_line + f" ({how}{at})")
              for at_key, at in (("144", "Conformer-S: d 144, 4 heads of 36 padded to 48 "
                                         "(64 in float32), ff 576, k 32"),
                                 ("d1024", "d 1024, 8 heads of 128, ff 4096"))
              for key, name, how in (
                  (f"1@{at_key}", f"conformer_block_{at_key}", ""),
                  (f"1b@{at_key}", f"conformer_block_w8a8_{at_key}", "quantize='int8', "),
                  (f"1c@{at_key}", f"conformer_block_f32_{at_key}", "compute_dtype=float32, "),
                  (f"(i)@{at_key}", f"conformer_block_f32_sm_bf16_{at_key}",
                   "compute_dtype=float32, attn_softmax_dtype=bfloat16, body :276-300; "),
                  (f"(ii)@{at_key}", f"conformer_block_bf16_res_f32_{at_key}",
                   "residual_dtype=float32, "))),
            ("2@D144", "head_argmax_D144", "early_exit_tpu_torch/csrc/head_argmax.cu",
             "early_exit_tpu/ops/pallas/head_argmax.py:53 (D 144, V 256)"),
            ("2@D1024", "head_argmax_D1024", "early_exit_tpu_torch/csrc/head_argmax.cu",
             "early_exit_tpu/ops/pallas/head_argmax.py:53 (D 1024, V 256)"),
            ("3@dh36", "attention_dh36", "early_exit_tpu_torch/csrc/attention.cu",
             "early_exit_tpu/ops/pallas/attention.py:51 (dh 36, padded to 64)"),
            ("3@dh128", "attention_dh128", "early_exit_tpu_torch/csrc/attention.cu",
             "early_exit_tpu/ops/pallas/attention.py:51 (dh 128)")):
        t = widths[key] if key in widths else conformer_s[key]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": line,
                     "launches": t["launches"], "path": t["path"],
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    rows[0]["export_launches"] = exported["allexit_launches"]
    rows[0]["aed_launches"] = aed["launches"]
    rows[0]["zoo_launches"] = {n: b for n, (b, _, _) in zoo["launches"].items()}
    rows[1]["zoo_launches"] = zoo["f32_launches"]
    rows[3]["zoo_launches"] = {n: h for n, (_, h, _) in zoo["launches"].items()}
    rows[0]["zoo_export_launches"] = gate["export_launches"]
    rows[0]["reference_launches"] = ref["launches"]["conformer_block_bf16"]
    rows[3]["reference_launches"] = ref["launches"]["head_argmax"]
    rows[0]["tools_launches"] = {"trace": tools["trace_launches"]["conformer_block_bf16"],
                                 "streaming_demo": tools["demo_launches"]["conformer_block_bf16"]}
    rows[3]["tools_launches"] = {"trace": tools["trace_launches"]["head_argmax"]}
    rows[5]["tools_launches"] = {"streaming_demo": tools["demo_launches"]["attention"]}
    child = meas["child_launches"]
    rows[0]["poly_launches"] = poly["launches"]
    rows[0]["ablate_launches"] = meas["ablate_launches"]
    rows[0]["measure_tool_launches"] = {
        t: child[t]["conformer_block_bf16"] for t in ("ablate_head_path", "bench_int8")}
    rows[2]["measure_tool_launches"] = {"bench_int8": child["bench_int8"]["conformer_block_w8a8"]}
    rows[3]["measure_tool_launches"] = {
        "ablate_head_path": child["ablate_head_path"]["head_argmax"]}
    print(f"chip_smoke.py: {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


def parallel_phase(dev, card, knobs, reset_counts, read_counts, tmp) -> dict:
    """Phase 16: `--conv_norm group` and data + tensor parallelism in
    training, at the flagship's widths (d 256, 8 heads, ffn 2048, 12 blocks,
    6 exits, V 256). (a) The committed flagship's weights under
    conv_norm="group" (the BatchNorm's g and b read as the GroupNorm's): one
    float32 CTC train step on the card against the CPU (TF32 off, phase
    8a's tolerances, the running statistics passed through unchanged); 5
    bf16 train steps from the same weights at warmup 100 with the loss
    falling, beside the same steps at warmup 10, under group and batch
    norm (printed: ten times the learning rate); the inference CLI with
    `--conv_norm group --fused_block false` over 8 of phase 9's utterances,
    card against CPU, float32 tokens equal and bf16 within phase 3's
    contract, with the tokens counted an exit and no kernel launched; and
    `--fused_block true` refused by name. (b) A world of one over NCCL: one
    train step of the distributed code (process group up, data=1 x
    model=1) against the plain step, twice, bit for bit where the plain
    step repeats itself bit for bit, else within its own run-to-run spread.
    (c) Four gloo ranks on the one card with CUDA tensors
    (`multiprocess_smoke.run_world`): data=2 on two of them, then data=2 x
    model=2, two float32 steps each of the flagship against the
    single-rank card step (loss and grad norm within 1e-4, the next step's
    loss within 2e-3, the BatchNorm statistics of the first step within
    1e-5), and the 4-rank run's checkpoint, loaded into the single-rank
    model, written back equal to itself, its tree and shapes a single-rank
    checkpoint's. Returns the seconds of each part."""
    import contextlib
    import dataclasses
    import io

    import numpy as np
    import torch
    import torch.distributed as dist
    from early_exit_tpu_torch import checkpoint, inference, interop, parallel
    from early_exit_tpu_torch import multiprocess_smoke as mps
    from early_exit_tpu_torch.configs import AudioConfig, ModelConfig, TrainConfig, train_profile
    from early_exit_tpu_torch.data import text
    from early_exit_tpu_torch.data.pipeline import Pipeline
    from early_exit_tpu_torch.data.synthetic import synth_batch
    from early_exit_tpu_torch.decoding.lexicon import edit_distance
    from early_exit_tpu_torch.models.conformer import GROUP_NORM_FUSED
    from early_exit_tpu_torch.models.registry import build_model
    from early_exit_tpu_torch.optim.noam import global_norm
    from early_exit_tpu_torch.tokenizer import load_tokenizer
    from early_exit_tpu_torch.training import checkpoint as tck
    from early_exit_tpu_torch.training import trainer

    t_phase = time.perf_counter()
    secs = {}
    tok = load_tokenizer(checkpoint.bound_tokenizer(checkpoint.load_calib()))
    tcfg = TrainConfig()
    cpu_pipe = Pipeline([], tok, AudioConfig(), tcfg, device="cpu")
    tree = checkpoint.load_tree(checkpoint.FLAGSHIP_CKPT)

    def batch_of(n, seed):
        """n requests of bench_eval's distribution as one CPU sub-batch."""
        wav, counts, refs = synth_batch(knobs, n, seed)
        items = []
        for i in range(n):
            label = text.clean_train_label(refs[i])
            items.append((wav[i, :counts[i]], text.encode_target(label, tok), label))
        host = {k: torch.from_numpy(v) for k, v in cpu_pipe.host_subbatch(items).items()}
        return cpu_pipe.to_device(host)

    batch4 = batch_of(4, 777)                         # phase 8a's requests
    T_ = int(batch4["feats"].shape[1])

    # -- 16a. group norm
    t0 = time.perf_counter()
    gn32 = ModelConfig(compute_dtype="float32", drop_prob=0.0, conv_norm="group")

    def gn_step(device):
        model = interop.from_jax_params(tree["params"], tree["model_state"], gn32,
                                        trainable=True).to(device)
        before = {k: v.detach().clone() for k, v in model.state()["blocks"]["conv_bn"].items()}
        total, _, new_state = trainer.loss_fn(model, tcfg,
                                              {k: v.to(device) for k, v in batch4.items()})
        params = list(model.parameters())
        grads = torch.autograd.grad(total, params)
        leaves = {k: np.asarray(v, np.float64) for k, v in
                  _flat(interop.jax_tree(model, dict(zip(params, grads)))).items()}
        passed = all(torch.equal(new_state["blocks"]["conv_bn"][k], before[k]) for k in before)
        return float(total.detach()), float(global_norm(grads)), leaves, passed

    card_step, cpu_step = gn_step(dev), gn_step(torch.device("cpu"))
    zero_leaf = ZERO_GRAD_LEAVES[0]        # the key bias; the depthwise bias moves a GroupNorm
    rel = {k: np.linalg.norm(card_step[2][k] - h) / np.linalg.norm(h)
           for k, h in cpu_step[2].items() if k != zero_leaf}
    worst = max(rel, key=rel.get)
    zero = max(np.linalg.norm(card_step[2][zero_leaf]),
               np.linalg.norm(cpu_step[2][zero_leaf])) / cpu_step[1]
    d_loss = abs(card_step[0] - cpu_step[0]) / abs(cpu_step[0])
    d_norm = abs(card_step[1] - cpu_step[1]) / cpu_step[1]
    print(f"16a. group norm (the flagship's weights, conv_norm='group'), one float32 CTC "
          f"train step (B=4, T={T_}), card vs CPU: loss {card_step[0]:.6f} vs "
          f"{cpu_step[0]:.6f} (relative {d_loss:.3e}); grad_norm {card_step[1]:.6f} vs "
          f"{cpu_step[1]:.6f} ({d_norm:.3e}); worst gradient leaf relative L2 "
          f"{rel[worst]:.3e} ({worst}); the key bias's share of the norm {zero:.3e}; "
          f"running statistics passed through unchanged: card {card_step[3]}, CPU "
          f"{cpu_step[3]}")
    if not np.isfinite([card_step[0], card_step[1]]).all():
        fail("16a: non-finite group-norm train step on the card")
    if (d_loss > TRAIN_F32_LOSS or d_norm > TRAIN_F32_NORM or rel[worst] > TRAIN_F32_LEAF
            or zero > ZERO_GRAD_SHARE or not (card_step[3] and cpu_step[3])):
        fail("16a: the group-norm train step on the card disagrees with the CPU")

    batch16 = {k: v.to(dev) for k, v in batch_of(16, 4343).items()}

    def bf16_steps(norm, warmup):
        """5 bf16 train steps (train profile, dropout 0.1) from the
        flagship's weights under conv_norm=norm; their losses."""
        model = interop.from_jax_params(tree["params"], tree["model_state"],
                                        train_profile(conv_norm=norm), trainable=True).to(dev)
        tr = trainer.Trainer(model, tcfg, warmup=warmup)
        return [round(float(tr.step(batch16)["loss"]), 4) for _ in range(5)]

    losses = bf16_steps("group", 100)
    print(f"16a. group norm, 5 bf16 train steps from the flagship's weights (train profile, "
          f"dropout 0.1, warmup 100: learning rates 1.25e-4 to 3.75e-4, phase 8b's "
          f"sub-batch of 16, T={batch16['feats'].shape[1]}): loss {losses}; the same steps "
          f"at warmup 10 (3.95e-3 to 1.19e-2): group norm {bf16_steps('group', 10)}, "
          f"batch norm {bf16_steps('batch', 10)}")
    if not np.isfinite(losses).all() or losses[-1] >= losses[0]:
        fail("16a: the group-norm model's loss did not fall over 5 bf16 steps")
    del batch16

    small = os.path.join(tmp, "cpu8")
    base = ["--decoder_mode", "ctc", "--load_model_path", checkpoint.FLAGSHIP_CKPT,
            "--eval_splits", "test-clean", "--data_root", small, "--conv_norm", "group",
            "--fused_block", "false"]
    f32_flags = ["--compute_dtype", "float32", "--attn_softmax_dtype", "float32"]

    def cli(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            inference.main(argv)
        return buf.getvalue()

    def exit_ids(out):
        ids = {}
        for ln in out.splitlines():
            if "BEAM_OUT_" in ln:
                e = int(ln.split("BEAM_OUT_")[1].split(":")[0])
                ids.setdefault(e, []).append(tok.encode_as_ids(
                    ln.split(" : ", 1)[1] if " : " in ln else ""))
        return ids

    gaps = {}
    for what, flags in (("float32", f32_flags), ("bf16", [])):
        reset_counts()
        out_c = cli(base + flags)
        launched = {k: v for k, v in read_counts().items() if v}
        out_h = cli(base + flags + ["--device", "cpu"])
        ic, ih = exit_ids(out_c), exit_ids(out_h)
        if sorted(ic) != sorted(ih) or any(len(ic[e]) != len(ih[e]) for e in ih) or not ih:
            fail(f"16a: the {what} CLI prints other BEAM_OUT lines on the card than on the CPU")
        gaps[what] = {e: (sum(edit_distance(x, y) for x, y in zip(ic[e], ih[e])),
                          sum(len(y) for y in ih[e])) for e in sorted(ih)}
        wers = [ln.split(": ", 1)[1] for ln in out_h.splitlines() if " WER exit " in ln]
        print(f"16a. the inference CLI, --conv_norm group --fused_block false, {what}, card "
              f"vs CPU over {len(ih[min(ih)])} of phase 9's utterances: edits / CPU tokens "
              f"per exit {[f'{e}/{t}' for e, t in gaps[what].values()]}; WER per exit (CPU) "
              f"{wers}; kernels launched on the card {launched or 'none'}")
        if launched:
            fail(f"16a: the unfused group-norm CLI launched {launched}")
    edits32 = sum(e for e, _ in gaps["float32"].values())
    e16 = sum(e for e, _ in gaps["bf16"].values())
    t16 = sum(t for _, t in gaps["bf16"].values())
    if sum(t for _, t in gaps["float32"].values()) == 0 or t16 == 0:
        fail("16a: the group-norm CLI emitted no token: the comparison would see nothing")
    if edits32:
        fail(f"16a: the float32 group-norm CLI's tokens differ on the card ({edits32} edits)")
    if e16 > TOKEN_DISAGREE * t16:
        fail(f"16a: the bf16 group-norm CLI disagrees with the CPU on {e16} of {t16} tokens")
    try:
        cli(base[:-1] + ["true"])
        fail("16a: --fused_block true ran a group-norm model")
    except ValueError as e:
        if str(e) != GROUP_NORM_FUSED:
            raise
        print(f"16a. --conv_norm group --fused_block true on the card raises: {e}")
    secs["a"] = time.perf_counter() - t0

    # -- 16b. a world of one over NCCL
    t0 = time.perf_counter()
    f32 = dataclasses.asdict(ModelConfig(compute_dtype="float32", drop_prob=0.0))
    one_step = {"model": f32, "steps": 1, "load": checkpoint.FLAGSHIP_CKPT,
                "keep_params": True}
    index = torch.cuda.current_device()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{mps.free_port()}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", index))
    try:
        mesh = parallel.make_mesh(dp=1, tp=1)
        plain = mps.run_scenario(one_step, batch4, dev)
        dist_step = mps.run_scenario(one_step, batch4, dev, mesh)
        again = mps.run_scenario(one_step, batch4, dev)
    finally:
        dist.destroy_process_group()

    def apart(a, b):
        """Loss, grad norm and parameters: (all equal bit for bit, max |d| of
        the parameters)."""
        d = max(float((x - y).abs().max()) for x, y in zip(a["params"], b["params"]))
        same = (a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
                and all(torch.equal(x, y) for x, y in zip(a["params"], b["params"])))
        return same, d

    same_dist, d_dist = apart(dist_step, plain)
    same_plain, d_plain = apart(again, plain)
    print(f"16b. a world of one over NCCL, data=1 x model=1: the distributed step vs the "
          f"plain step (float32, B=4): loss {dist_step['loss']!r} vs {plain['loss']!r}, "
          f"grad_norm {dist_step['grad_norm']!r} vs {plain['grad_norm']!r}, bit for bit "
          f"{same_dist} (parameters max|d| {d_dist:.3e}); the plain step against itself: "
          f"bit for bit {same_plain} (max|d| {d_plain:.3e})")
    if dist_step["loss"] != plain["loss"] or (same_plain and not same_dist) or d_dist > d_plain:
        fail("16b: the distributed step in a world of one is not the plain step")
    secs["b"] = time.perf_counter() - t0

    # -- 16c. four gloo ranks on the one card, CUDA tensors
    t0 = time.perf_counter()
    two = dict(one_step, steps=2, keep_params=False)
    single = mps.run_scenario(dict(two, save=os.path.join(tmp, "par_single")), batch4, dev)
    four_dir = os.path.join(tmp, "par_four")
    got = mps.run_world([dict(two, name="data=2", mesh={"ranks": [0, 1], "dp": 2}),
                         dict(two, name="data=2 x model=2", mesh={"dp": 2, "tp": 2},
                              save=four_dir)],
                        {"main": batch4}, world=4, device="cuda", backend="gloo",
                        timeout=400, workdir=tmp)
    secs["c_world"] = time.perf_counter() - t0
    for name, res in got.items():
        faults = mps.check(name, res, single)
        bn = max(float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))
                 for a, b in zip(_flat(res["state"][0]).values(),
                                 _flat(single["state"][0]).values()))
        print(f"16c. {name} on 4 gloo ranks sharing the card (CUDA tensors) vs the "
              f"single-rank card step: loss {res['loss']} vs {single['loss']}, grad_norm "
              f"{res['grad_norm'][0]:.6f} vs {single['grad_norm'][0]:.6f}; BN running "
              f"statistics after step 1 max|d| {bn:.3e} (of max(1, max|ref|))")
        if faults or bn > TRAIN_F32_BN:
            fail("16c: " + "; ".join(faults or [f"{name}: BN statistics {bn:.3e}"]))
    four = tck.load_tree(tck.model_ckpt_path(four_dir, 0))
    ref = tck.load_tree(tck.model_ckpt_path(os.path.join(tmp, "par_single"), 0))
    f4, fr = _flat(four), _flat(ref)
    if sorted(f4) != sorted(fr) or any(np.shape(f4[k]) != np.shape(fr[k]) for k in fr):
        fail("16c: the 4-rank checkpoint's tree or shapes are not a single rank's")
    model = build_model(ModelConfig(**f32)).to(dev)
    tck.load_model_file(model, tck.model_ckpt_path(four_dir, 0))
    os.makedirs(os.path.join(tmp, "par_back"))
    tck.save_epoch(os.path.join(tmp, "par_back"), 0, model)
    back = _flat(tck.load_tree(tck.model_ckpt_path(os.path.join(tmp, "par_back"), 0)))
    d_back = max(float(np.abs(np.asarray(back[k]) - np.asarray(f4[k])).max()) for k in f4)
    d_single = max(float(np.abs(np.asarray(fr[k]) - np.asarray(f4[k])).max()) for k in f4)
    print(f"16c. the data=2 x model=2 checkpoint: {len(f4)} leaves, the single rank's "
          f"tree and shapes; loaded into the single-rank model and written back, max|d| "
          f"{d_back:.3e}; against the single rank's own after the same 2 steps, max|d| "
          f"{d_single:.3e} (Adam's first steps move each weight by ~lr whatever the "
          f"gradient's size)")
    if d_back != 0.0:
        fail("16c: the 4-rank checkpoint does not load into the single-rank model as it is")
    secs["c"] = time.perf_counter() - t0
    total = time.perf_counter() - t_phase
    print(f"phase 16: {total:.1f} s on {card} (16a {secs['a']:.1f} s, 16b {secs['b']:.1f} "
          f"s, 16c {secs['c']:.1f} s of which the 4-rank world {secs['c_world']:.1f} s)")
    return {**secs, "total": total}


def tools_phase(dev, card, reset_counts, read_counts, corp, tmp, rec, wav, counts) -> dict:
    """Phase 17: the evaluation and profiling tools on the card. (a)
    `utils.profiling.trace` and `annotate` around the flagship's all-exit
    forward (`Recognizer.exit_ids`, block and head kernels) at phase 3's
    B=128 x 10 s: the Chrome trace holds the span and the block's and the
    head's kernels; `StepTimer.rtf_x` against the same steps timed with
    CUDA events, within TIMER_RTOL. (b) `score_wer` over phase 9's greedy
    CLI log: its per-exit WERs equal the CLI's own lines. (c)
    `streaming_demo --fused_block true --attention_impl pallas` at phase
    10's geometry over the 8-utterance cpu8 corpus: 12 block launches an
    utterance (the full decode), 12 attention launches a window dispatch,
    the streamed and the full WER within the sanity bound. (d)
    `streaming_gate_report` over the same 8
    utterances with one threshold (two child processes of the inference
    CLI): its ungated ladder equal to the CLI's run in this process with
    the tool's flags, the gated leg's histogram over every chunk. (e)
    `dress_rehearsal --fast --legs ctc` on the card: the loss falls and
    every test utterance is decoded."""
    import io
    import torch
    from early_exit_tpu_torch import dress_rehearsal, inference, score_wer
    from early_exit_tpu_torch import streaming_demo, streaming_gate_report
    from early_exit_tpu_torch.utils.profiling import StepTimer, annotate, trace

    t_phase = time.perf_counter()
    secs = {}
    flagship = os.path.join(HERE, "assets", "flagship_ckpt")
    small = os.path.join(tmp, "cpu8")

    def quiet(fn, *a):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = fn(*a)
        return res, buf.getvalue()

    # -- 17a. trace, annotate and StepTimer around the flagship's forward
    t0 = time.perf_counter()
    audio = float(counts.sum()) / 16000.0
    log_dir = os.path.join(tmp, "profile")
    with torch.no_grad():
        rec.exit_ids(wav, counts)
        torch.cuda.synchronize()
        reset_counts()
        with trace(log_dir):
            for _ in range(2):
                with annotate("eet_flagship_forward"):
                    rec.exit_ids(wav, counts)[0].cpu()
        got = trace_launches = read_counts()
        with open(os.path.join(log_dir, "trace.json")) as f:
            names = {ev.get("name", "") for ev in json.load(f)["traceEvents"]}
        want = {"span": "eet_flagship_forward", "block GEMM": "gemm_wgmma_kernel",
                "block conv module": "conv_module_kernel",
                "block attention": "attention_kernel", "head": "head_argmax_kernel"}
        found = {k: sum(v in n for n in names) for k, v in want.items()}
        print(f"17a. trace() over 2 annotated all-exit forwards at B={wav.shape[0]} x 10 s "
              f"on {card}: {len(names)} event names; names holding " + ", ".join(
                  f"{k} '{v}': {found[k]}" for k, v in want.items())
              + f"; launches {got}")
        if not all(found.values()):
            fail(f"17a: the trace lacks {[k for k, n in found.items() if not n]}")
        if got["conformer_block_bf16"] != 24 or got["head_argmax"] != 2:
            fail(f"17a: launches {got}, expected 24 block and 2 head launches")
        timer = StepTimer(warmup_steps=2)
        ev_ms = []
        for i in range(TIMER_STEPS + 2):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            timer.start()
            e0.record()
            rec.exit_ids(wav, counts)
            e1.record()
            torch.cuda.synchronize()
            timer.stop(audio_seconds=audio)
            if i >= 2:
                ev_ms.append(e0.elapsed_time(e1))
    rtf_ev = audio * len(ev_ms) / (sum(ev_ms) / 1e3)
    rel = abs(timer.rtf_x - rtf_ev) / rtf_ev
    print(f"17a. StepTimer over {TIMER_STEPS} forwards after 2 warm-up ({audio:.1f} s of audio "
          f"each, synchronized before stop): {timer.steps_per_sec:.2f} steps/s, rtf_x "
          f"{timer.rtf_x:.1f}; CUDA events over the same steps: {sum(ev_ms) / len(ev_ms):.3f} "
          f"ms a step, rtf_x {rtf_ev:.1f}; relative difference {rel:.4f} (tolerance "
          f"{TIMER_RTOL})")
    if rel > TIMER_RTOL:
        fail("17a: StepTimer's rtf_x disagrees with the CUDA events'")
    secs["a"] = time.perf_counter() - t0

    # -- 17b. score_wer over phase 9's greedy CLI log
    t0 = time.perf_counter()
    log = corp["greedy_log"]
    scored, _ = quiet(score_wer.score, log.splitlines())
    mine = {int(ln.split()[1].rstrip(":")): float(ln.split("WER ")[1].split("%")[0])
            for ln in scored if ln.startswith("exit ")}
    cli = {int(ln.split("WER exit ")[1].split(":")[0]): float(ln.split(": ")[1].split("%")[0])
           for ln in log.splitlines() if " WER exit " in ln}
    print(f"17b. score_wer over phase 9's greedy CLI log: {scored}; the CLI's own: {cli}")
    if mine != cli:
        fail(f"17b: score_wer {mine} != the CLI's {cli}")
    secs["b"] = time.perf_counter() - t0

    # -- 17c. streaming_demo, block kernel for the full decode, attention
    # kernel in the windows
    t0 = time.perf_counter()
    argv = ["--load_model_path", flagship, "--data_root", small, "--eval_splits",
            "test-clean", "--left_s", "3.0", "--right_s", "0.5", "--fused_block", "true",
            "--attention_impl", "pallas", "--device", dev.type]
    reset_counts()
    demo, out = quiet(streaming_demo.main, argv)
    demo_launches = read_counts()
    wall = time.perf_counter() - t0
    n_utt = sum("] ref :" in ln for ln in out.splitlines())
    print(f"17c. streaming_demo {' '.join(argv[4:])} over {demo['utts']} utterances on "
          f"{card}: {json.dumps(demo)}; launches {demo_launches}; {wall:.1f} s")
    blocks, att = demo_launches["conformer_block_bf16"], demo_launches["attention"]
    others = {k: v for k, v in demo_launches.items()
              if k not in ("conformer_block_bf16", "attention") and v}
    if (demo["utts"] != 8 or n_utt != 8 or blocks != 12 * 8 or not att or att % 12
            or others):
        fail(f"17c: {demo['utts']} utterances, launches {demo_launches}: expected 8, 96 "
             f"block launches and 12 attention launches a window dispatch")
    if max(demo["stream_wer_pct"], demo["full_wer_pct"]) > SANE_DENSE_WER:
        fail(f"17c: WER above {SANE_DENSE_WER}%: {demo}")
    secs["c"] = time.perf_counter() - t0

    # -- 17d. streaming_gate_report: two legs in child processes; its
    # ungated ladder against the CLI's in this process with its flags
    t0 = time.perf_counter()
    report, _ = quiet(streaming_gate_report.main,
                      ["--ckpt", flagship, "--data_root", small, "--splits", "test-clean",
                       "--thresholds", "0.85", "--device", dev.type,
                       "--out", os.path.join(tmp, "streaming_gated.json")])
    _, cli_out = quiet(inference.main,
                       ["--decoder_mode", "ctc", "--streaming", "true",
                        "--load_model_path", flagship, "--data_root", small,
                        "--eval_splits", "test-clean", "--batch_size", "32", "--n_workers",
                        "2", "--compute_dtype", "bfloat16", "--device", dev.type])
    want = streaming_gate_report.parse(cli_out)
    got_u, gated = report["ungated_all_exits"], report["gated"]["0.85"]["test-clean"]
    print(f"17d. streaming_gate_report over 8 utterances, threshold 0.85, on {card}: "
          f"ungated {got_u}; the CLI in this process {want}; gated {gated}; "
          f"{time.perf_counter() - t0:.1f} s")
    if got_u != want or got_u["test-clean"]["eval_utts"] != 8:
        fail("17d: the report's ungated ladder differs from the CLI's")
    if sum(gated["exit_histogram"].values()) == 0 or "mean_exit" not in gated:
        fail(f"17d: the gated leg parsed no histogram: {gated}")
    secs["d"] = time.perf_counter() - t0

    # -- 17e. the dress rehearsal on the card
    t0 = time.perf_counter()
    try:
        summary, _ = quiet(dress_rehearsal.main,
                           ["--fast", "--legs", "ctc", "--device", dev.type,
                            "--workdir", os.path.join(tmp, "dress_rehearsal")])
    except SystemExit as e:
        fail(f"17e: dress_rehearsal exited: {e}")
    print(f"17e. dress_rehearsal --fast --legs ctc on {card}: {json.dumps(summary)}; "
          f"{time.perf_counter() - t0:.1f} s")
    if (summary["test_utts"] != 6 or not summary["loss_last"] < summary["loss_first"]
            or not summary["wer_pct"]):
        fail(f"17e: {summary}")
    secs["e"] = time.perf_counter() - t0
    total = time.perf_counter() - t_phase
    print(f"phase 17: {total:.1f} s on {card} (" + ", ".join(
        f"17{k} {v:.1f} s" for k, v in secs.items()) + ")")
    return {"trace_launches": trace_launches, "demo_launches": demo_launches,
            "secs": secs, "total": total}


class _DecodeClock:
    """Host wall time spent inside the CLI's decoders, the device drained
    on entry and on exit so that the forward's device time stays outside
    and the decoder's own inside."""

    def __init__(self, targets):
        self.targets, self.seconds, self.depth = targets, 0.0, 0

    def __enter__(self):
        import torch
        self.saved = [(obj, name, getattr(obj, name)) for obj, name in self.targets]
        for obj, name, fn in self.saved:
            def timed(*a, _fn=fn, **k):
                if self.depth:                  # a decoder inside a decoder
                    return _fn(*a, **k)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                self.depth += 1
                try:
                    out = _fn(*a, **k)
                    torch.cuda.synchronize()
                finally:
                    self.depth -= 1
                self.seconds += time.perf_counter() - t0
                return out
            setattr(obj, name, timed)
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self.saved:
            setattr(obj, name, fn)


def make_corpus(knobs, tmp) -> dict:
    """Phase 9's corpus: N_CORPUS utterances of bench_eval's distribution
    in the LibriSpeech layout under tmp/full (and the first 8 under
    tmp/cpu8), written with the port's FLAC writer and read back equal to
    their int16 sources; the native library built. Returns its root, the
    dataset, the waveforms, the seconds of audio and the sources."""
    import numpy as np
    from early_exit_tpu_torch import _native
    from early_exit_tpu_torch.data.flac import write_flac_verbatim
    from early_exit_tpu_torch.data.librispeech import LibriSpeechDataset
    from early_exit_tpu_torch.data.synthetic import SyntheticDataset

    t0 = time.perf_counter()
    ds = SyntheticDataset(n_items=N_CORPUS, seed=9090,
                          min_words=knobs.get("min_words", 18),
                          max_words=knobs.get("max_words", 22),
                          noise=knobs.get("noise", 0.02), noise_hi=knobs.get("noise_hi"),
                          speaker_warp=knobs.get("speaker_warp", 0.0),
                          dur_jitter=knobs.get("dur_jitter", 0.0),
                          amp_jitter=knobs.get("amp_jitter", 0.0))
    src = {}
    for sub, n in (("full", N_CORPUS), ("cpu8", 8)):
        for i in range(n):
            utt = ds[i]
            spk, ch = str(100 + i % 4), str(10 + i // 4)
            d = os.path.join(tmp, sub, "LibriSpeech", "test-clean", spk, ch)
            os.makedirs(d, exist_ok=True)
            stem = f"{spk}-{ch}-{i:04d}"
            write_flac_verbatim(os.path.join(d, stem + ".flac"), utt.waveform)
            with open(os.path.join(d, f"{spk}-{ch}.trans.txt"), "a") as f:
                f.write(f"{stem} {utt.transcript}\n")
            quant = (np.clip(utt.waveform, -1, 1) * 32767).astype(np.int16)
            src[stem] = (quant.astype(np.float32) / 32768.0, utt.transcript)
    corpus = LibriSpeechDataset(os.path.join(tmp, "full"), "test-clean")
    if len(corpus) != N_CORPUS:
        fail(f"the corpus lists {len(corpus)} utterances, not {N_CORPUS}")
    waves = []
    for i in range(len(corpus)):
        u = corpus[i]
        want, transcript = src[u.utterance_id]
        if u.transcript != transcript or not np.array_equal(u.waveform, want):
            fail(f"{u.utterance_id} does not read back as its int16 source")
        waves.append(u.waveform)
    audio_s = sum(len(w) for w in waves) / 16000.0
    _native.build()
    print(f"inference corpus: {len(corpus)} utterances, {audio_s:.1f} s of audio, "
          f"written as FLAC and read back equal to the int16 sources "
          f"({time.perf_counter() - t0:.1f} s, native library built)")
    return dict(root=os.path.join(tmp, "full"), corpus=corpus, waves=waves,
                audio_s=audio_s, src=src)


def infer_phase(dev, card, knobs, reset_counts, read_counts, tmp) -> dict:
    """Phase 9: the inference CLI (`python -m early_exit_tpu_torch.inference`)
    on the card over a LibriSpeech-layout FLAC corpus written beforehand
    under tmp: greedy, the prefix beam, the lexicon beam with an ARPA LM,
    and the gated cascade, with launch counts, WER, held results and
    times. Returns the corpus for phase 10: its root, the dataset, the
    waveforms, greedy's WER at each exit and greedy's log (phase 17b)."""
    import contextlib
    import io

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from early_exit_tpu_torch import checkpoint, inference, train_arpa
    from early_exit_tpu_torch.cli import get_args
    from early_exit_tpu_torch.data import text
    from early_exit_tpu_torch.data.librispeech import LibriSpeechDataset
    from early_exit_tpu_torch.data.pipeline import Pipeline
    from early_exit_tpu_torch.decoding import prefix_beam
    from early_exit_tpu_torch.decoding.lexicon import edit_distance
    from early_exit_tpu_torch.decoding.lexicon_beam import LexiconBeamDecoder
    from early_exit_tpu_torch.models.gate_calibration import scaled_confidence
    from early_exit_tpu_torch.ops import ctc
    from early_exit_tpu_torch.serving.recognizer import Recognizer
    from early_exit_tpu_torch.tokenizer import load_tokenizer

    tok = load_tokenizer(checkpoint.bound_tokenizer(checkpoint.load_calib()))
    # ---- 9.1 the corpus: N_CORPUS utterances of bench_eval's distribution
    corp = make_corpus(knobs, tmp)
    corpus, waves, audio_s, src = corp["corpus"], corp["waves"], corp["audio_s"], corp["src"]
    arpa = os.path.join(tmp, "lm.arpa")
    train_arpa.write_arpa(train_arpa.train(
        [t.lower().split() for _, t in src.values()], order=2), arpa)

    # a calibration under which the cascade escalates part of the
    # corpus (the committed one accepts it all at exit 2): exit 2's
    # threshold in the middle of the widest gap between the corpus's
    # exit-2 confidences in their middle half, so that no row lies
    # within a bf16 schedule's reach of it
    rec = Recognizer.from_flagship("cuda", fused=True)
    wav = np.zeros((len(waves), max(len(w) for w in waves)), np.float32)
    for i, w in enumerate(waves):
        wav[i, :len(w)] = w
    counts = np.array([len(w) for w in waves])
    k_casc, gate = int(rec.calib["cascade_k"]), rec.gate_settings()
    with torch.no_grad():
        lp, sub_len = rec.model.encode_exit(*rec._features(wav, counts), k_casc)
        m = torch.arange(lp.shape[1], device=dev)[None, :] < sub_len[:, None]
        conf = scaled_confidence(lp, m, gate["score"],
                                 gate["temperatures"][k_casc - 1]).sort().values
    lo, hi = N_CORPUS // 4, 3 * N_CORPUS // 4
    j = lo + int((conf[lo + 1:hi + 1] - conf[lo:hi]).argmax())
    thr = list(gate["threshold"])
    thr[k_casc - 1] = float(conf[j:j + 2].mean())
    calib_esc = {**rec.calib, "thresholds": thr}
    esc_path = os.path.join(tmp, "calib_escalating.json")
    with open(esc_path, "w") as f:
        json.dump(calib_esc, f)
    print(f"escalating calibration: exit {k_casc}'s threshold {thr[k_casc - 1]:.6f}, "
          f"in a gap of {float(conf[j + 1] - conf[j]):.3e} between the corpus's "
          f"confidences; {j + 1} of {N_CORPUS} below it")
    del lp, sub_len, m

    base = ["--decoder_mode", "ctc", "--load_model_path",
            os.path.join(HERE, "assets", "flagship_ckpt"), "--eval_splits",
            "test-clean", "--fused_block", "true"]
    modes = {
        "greedy": [],
        "prefix_beam": ["--decode", "prefix_beam", "--beam_size", "10"],
        "lexicon_beam": ["--decode", "lexicon_beam", "--lm_path", arpa],
        "cascade": ["--gate_calibration",
                    os.path.join(HERE, "assets", "flagship_calib.json"),
                    "--cascade_k", str(k_casc)],
        "cascade_escalating": ["--gate_calibration", esc_path,
                               "--cascade_k", str(k_casc)],
    }

    def cli(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            inference.main(argv)
        return buf.getvalue()

    def wer_lines(out):
        return {int(ln.split("WER exit ")[1].split(":")[0]):
                float(ln.split(": ")[1].split("%")[0])
                for ln in out.splitlines() if " WER exit " in ln}

    def sub_batches(root):
        args, _, tcfg, acfg, tk = get_args(base + ["--data_root", root], mode="infer")
        pipe = Pipeline(LibriSpeechDataset(root, "test-clean"), tk, acfg, tcfg,
                        shuffle=False, infer_mode=True, device="cpu")
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(4) as pool:
            return sum(len(s) for s in pipe._epoch_host(0, pool))

    full = os.path.join(tmp, "full")
    n_sub = sub_batches(full)
    outs, rates = {}, {}
    for mode, extra in modes.items():
        t_mode = time.perf_counter()
        argv = base + ["--data_root", full] + extra
        targets = [(ctc, "greedy_decode_ids"), (ctc, "greedy_decode"),
                   (prefix_beam, "prefix_beam_search"),
                   (LexiconBeamDecoder, "decode_batch")]
        reset_counts()
        with _DecodeClock(targets) as clock:
            t0 = time.perf_counter()
            out = cli(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        got = read_counts()
        outs[mode] = out
        blocks, heads = got["conformer_block_bf16"], got["head_argmax"]
        others = {k: v for k, v in got.items()
                  if k not in ("conformer_block_bf16", "head_argmax") and v}
        print(f"CLI {mode}: launches {got} over {n_sub} sub-batches")
        if others:
            fail(f"CLI {mode}: unexpected launches {others}")
        if mode == "greedy" and (blocks, heads) != (12 * n_sub, n_sub):
            fail(f"CLI greedy: {blocks} block and {heads} head launches, expected "
                 f"{12 * n_sub} and {n_sub}")
        if mode in ("prefix_beam", "lexicon_beam") and (blocks, heads) != (12 * n_sub, 0):
            fail(f"CLI {mode}: {blocks} block and {heads} head launches, expected "
                 f"{12 * n_sub} and 0")
        if mode.startswith("cascade"):
            n_esc = int(out.split("cascade escalated: ")[1].split("/")[0])
            # phase A: 2 exits x 2 blocks a sub-batch; phase B: 8 blocks
            # a batch of escalated rows
            a_blocks = 2 * k_casc * n_sub
            if (heads or not a_blocks <= blocks <= 12 * n_sub
                    or (blocks - a_blocks) % (12 - 2 * k_casc)
                    or (blocks > a_blocks) != (n_esc > 0)):
                fail(f"CLI {mode}: {blocks} block and {heads} head launches with "
                     f"{n_esc} rows escalated, expected {2 * k_casc} a sub-batch in "
                     f"phase A and {12 - 2 * k_casc} a phase-B batch")
            if mode == "cascade_escalating" and not n_esc:
                fail("CLI cascade_escalating: no row escalated")
        # the device's busy share, from a second pass under the profiler:
        # device activity only, summed over the profiler's own events (the
        # prefix beam's ~10^6 events: ~6 s, where a Chrome trace took ~32 s
        # to write and read back, with the same sum)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            cli(argv)
            torch.cuda.synchronize()
            wall_p = time.perf_counter() - t1
        busy = sum(ev.duration_ns() for ev in prof.profiler.kineto_results.events()
                   if ev.device_type() == DeviceType.CUDA) / 1e9
        rates[mode] = audio_s / wall
        summary = [ln for ln in out.splitlines()
                   if " WER" in ln or "cascade" in ln or "shallow fusion" in ln]
        for ln in summary:
            print(f"CLI {mode}: {ln}")
        print(f"CLI {mode} on {card}: {audio_s:.1f} s of audio in {wall:.3f} s of wall "
              f"= {audio_s / wall:.1f} audio-s/s (the whole main(): model load, FLAC "
              f"decode, pipeline, forward, decoding, detokenising); decoding {100 * clock.seconds / wall:.1f}% "
              f"of the wall ({clock.seconds:.3f} s); device busy {busy:.3f} s of a "
              f"profiled pass's {wall_p:.3f} s "
              f"({100 * busy / wall_p:.1f}%); both passes "
              f"and the profile's tally {time.perf_counter() - t_mode:.1f} s")

    # ---- 9.3 held results
    wers = {m: wer_lines(o) for m, o in outs.items() if not m.startswith("cascade")}
    for m, w in wers.items():
        if sorted(w) != list(range(1, 7)):
            fail(f"CLI {m}: WER lines {w}")
        # exit 1 (~90% WER on the flagship) does not transcribe
        bad = {e: v for e, v in w.items() if e > 1 and v > SANE_DENSE_WER}
        if bad:
            fail(f"CLI {m}: exits above {SANE_DENSE_WER}% WER: {bad}")
    if wers["prefix_beam"][6] > wers["greedy"][6] + 0.5:
        fail(f"prefix beam exit-6 WER {wers['prefix_beam'][6]}% > greedy's "
             f"{wers['greedy'][6]}% + 0.5")
    print(f"CLI exit-6 WER: greedy {wers['greedy'][6]}%, prefix beam "
          f"{wers['prefix_beam'][6]}%, lexicon beam + LM {wers['lexicon_beam'][6]}%")

    # greedy on the card against the same CLI on the CPU, 8 utterances
    small = os.path.join(tmp, "cpu8")

    def per_exit_hyps(out):
        hyps = {}
        for ln in out.splitlines():
            if "BEAM_OUT_" in ln:
                e = int(ln.split("BEAM_OUT_")[1].split(":")[0])
                hyps.setdefault(e, []).append(ln.split(" : ", 1)[1]
                                              if " : " in ln else "")
        return hyps

    t0 = time.perf_counter()
    out_c = cli(base + ["--data_root", small])
    out_h = cli(base + ["--data_root", small, "--device", "cpu"])
    print(f"CLI greedy on 8 utterances, card then CPU: {time.perf_counter() - t0:.1f} s")
    hc, hh, w8 = per_exit_hyps(out_c), per_exit_hyps(out_h), wer_lines(out_c)
    edits = total = 0
    for e in sorted(hh):
        ee = tt = 0
        for a, b in zip(hc[e], hh[e]):
            ta, tb = tok.encode_as_ids(a), tok.encode_as_ids(b)
            ee += edit_distance(ta, tb)
            tt += max(len(tb), 1)
        print(f"CLI greedy, card vs CPU, 8 utterances, exit {e} (WER {w8[e]}%): "
              f"{ee}/{tt} tokens differ")
        if w8[e] <= SANE_DENSE_WER and ee > TOKEN_DISAGREE * tt:
            fail(f"CLI greedy: card and CPU disagree by > 1% at exit {e}")
        edits, total = edits + ee, total + tt
    print(f"CLI greedy, card vs CPU: pooled {100 * edits / total:.3f}%")
    if edits > TOKEN_DISAGREE * total:
        fail("CLI greedy: card and CPU disagree by > 1% pooled")

    # the prefix beam on the card and on the CPU, the same log-probs
    args, mcfg, tcfg, acfg, tk = get_args(base + ["--data_root", full], mode="infer")
    model = inference.load_model(args, mcfg, dev)
    pipe = Pipeline(corpus, tk, acfg, tcfg, shuffle=False, infer_mode=True, device=dev)
    batch = next(iter(pipe.epoch(0)))
    logp, _, sub_len = inference.exit_outputs(model, batch["feats"], batch["feat_lengths"],
                                              greedy=False, timestamps=False)
    lp_h, len_h = logp.cpu(), sub_len.cpu()
    worst, n_rows, t0 = 0.0, 0, time.perf_counter()
    for e in range(logp.shape[0]):
        a = prefix_beam.prefix_beam_search(logp[e], sub_len, beam_size=10)
        b = prefix_beam.prefix_beam_search(lp_h[e], len_h, beam_size=10)
        a = [t.cpu() for t in a]
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            fail(f"prefix beam: card and CPU tokens differ at exit {e + 1}")
        worst = max(worst, float(((a[2] - b[2]).abs() / b[2].abs()).max()))
        n_rows += a[0].shape[0]
    print(f"prefix beam, card vs CPU on the same log-probs ({n_rows} rows of "
          f"{logp.shape[2]} frames, beam 10): tokens equal, scores' max relative "
          f"difference {worst:.3e} (tolerance 1e-4); {time.perf_counter() - t0:.1f} s")
    if worst > 1e-4:
        fail("prefix beam: card and CPU scores differ by more than 1e-4 relative")
    del model, logp, lp_h

    # the cascade's chosen exits and transcripts against
    # Recognizer.transcribe_gated's under the same calibration
    lex = inference._load_lexicon(args)
    for mode, calib in (("cascade", rec.calib), ("cascade_escalating", calib_esc)):
        chosen_cli, hyp_cli, ref = {}, {}, None
        for ln in outs[mode].splitlines():
            if "EXPECTED:" in ln:
                ref = ln.split("EXPECTED: ", 1)[1] if "EXPECTED: " in ln else ""
            elif "GATED_OUT (exit " in ln:
                e, hyp = ln.split("GATED_OUT (exit ", 1)[1].split(")", 1)
                chosen_cli[ref], hyp_cli[ref] = int(e), hyp[2:]
        rec.calib = calib
        with torch.no_grad():
            g = rec.transcribe_gated(wav, counts)
        n_diff = n_esc = n_text = 0
        tally = {"every row": [0, 0], "the escalated rows": [0, 0]}
        for i in range(len(corpus)):
            label = text.clean_infer_label(corpus.items[i][1])
            key = tok.decode(text.encode_target(label, tok)[1:-1]).lower()
            want = int(g.chosen_exit[i])
            n_diff += chosen_cli.get(key) != want
            a, b = hyp_cli.get(key, ""), lex.apply(g.texts[i].lower())
            n_text += a != b
            ta, tb = tok.encode_as_ids(a), tok.encode_as_ids(b)
            for rows in ("every row",) + (("the escalated rows",) if want > k_casc else ()):
                tally[rows][0] += edit_distance(ta, tb)
                tally[rows][1] += max(len(tb), 1)
            n_esc += want > k_casc
        print(f"CLI {mode} vs Recognizer.transcribe_gated, {len(corpus)} utterances, "
              f"{n_esc} escalated: {n_diff} chosen exits differ; {n_text} transcripts "
              f"differ; tokens differing: " + ", ".join(
                  f"{rows} {e}/{t}" for rows, (e, t) in tally.items()))
        if n_diff or len(chosen_cli) != len(corpus):
            fail(f"the CLI's {mode} chooses other exits than "
                 f"Recognizer.transcribe_gated")
        if any(e > TOKEN_DISAGREE * t for e, t in tally.values()):
            fail(f"the CLI's {mode} transcribes other tokens than "
                 f"Recognizer.transcribe_gated by > 1%")
        if mode == "cascade_escalating" and not n_esc:
            fail("transcribe_gated escalates no row under the escalating calibration")
    print(f"CLI audio-s/s on {card}: " + ", ".join(f"{m} {r:.1f}" for m, r in rates.items()))
    return dict(root=full, corpus=corpus, waves=waves, audio_s=audio_s,
                greedy_wer=wers["greedy"], greedy_log=outs["greedy"])


def _stream_ids(pool, n_exits: int):
    """Per exit, per stream: the pool's ids ([exit][stream])."""
    return [[r.ids_at(e) for r in pool.recs] for e in range(1, n_exits + 1)]


def _ids_disagreement(got, want):
    """Per exit (edits, reference tokens) of got's ids against want's
    ([exit][stream] lists of ids)."""
    from early_exit_tpu_torch.decoding.lexicon import edit_distance
    return [(sum(edit_distance(a, b) for a, b in zip(ga, wa)),
             sum(max(len(b), 1) for b in wa)) for ga, wa in zip(got, want)]


def _hold_token_contract(what: str, dis, wers) -> None:
    """<= 1% of tokens pooled and at every exit that transcribes."""
    pooled = sum(e for e, _ in dis) / max(sum(t for _, t in dis), 1)
    print(f"{what}: tokens differing per exit {[f'{e}/{t}' for e, t in dis]}, "
          f"pooled {100 * pooled:.3f}%")
    if pooled > TOKEN_DISAGREE:
        fail(f"{what}: > 1% of tokens differ pooled")
    for i, ((e, t), w) in enumerate(zip(dis, wers)):
        if w <= SANE_DENSE_WER and e > TOKEN_DISAGREE * t:
            fail(f"{what}: > 1% of tokens differ at exit {i + 1} (WER {w}%)")


@contextlib.contextmanager
def _window_dispatches(streaming, record_conf=None):
    """Count the window programs' dispatches (rows of a batch count once);
    with record_conf, append the gate confidence of every valid row of
    every fast dispatch to it."""
    import torch
    counts = {"fast": 0, "deep": 0, "one_row": 0}
    saved = streaming.window_forward, streaming.window_forward_all_exits

    def single(*a, **k):
        out = saved[0](*a, **k)
        counts["fast" if k.get("with_confidence") else "deep"] += 1
        counts["one_row"] += a[-1].shape[0] == 1
        if record_conf is not None and k.get("with_confidence"):
            n_valid = a[-1]
            record_conf.extend(out[1][n_valid > 0].cpu().tolist())
        return out

    def every(*a, **k):
        counts["deep"] += 1
        counts["one_row"] += a[-1].shape[0] == 1
        return saved[1](*a, **k)

    streaming.window_forward, streaming.window_forward_all_exits = single, every
    try:
        yield counts
    finally:
        streaming.window_forward, streaming.window_forward_all_exits = saved
        torch.cuda.synchronize()


def streaming_phase(dev, card, reset_counts, read_counts, corp) -> dict:
    """Phase 10: streaming serving of the flagship (`StreamPool`,
    `StreamingRecognizer`, the server, the CLI's --streaming) over phase
    9's corpus at the CLI's geometry; the attention kernel on the
    windows' key masks. Returns the attention kernel's streaming row."""
    import io
    import itertools
    import socket
    import threading

    import numpy as np
    import torch
    import torch.nn.functional as F
    from early_exit_tpu_torch import inference, serve
    from early_exit_tpu_torch.data import text
    from early_exit_tpu_torch.ops.kernels import attention as katt
    from early_exit_tpu_torch.serving import StreamingRecognizer, StreamPool, load_test
    from early_exit_tpu_torch.serving import streaming
    from early_exit_tpu_torch.serving.recognizer import Recognizer, wer_pct

    GEO = dict(chunk_s=1.0, left_s=3.0, right_s=0.5)
    waves, audio_s = corp["waves"], corp["audio_s"]
    refs = [text.clean_infer_label(corp["corpus"][i].transcript).lower()
            for i in range(len(waves))]
    flagship = os.path.join(HERE, "assets", "flagship_ckpt")
    n_cpu, n_causal = 8, 16
    rec_x = Recognizer.from_flagship(dev.type, fused=True)
    model, model_acfg, tok = rec_x.model, rec_x.acfg, rec_x.tokenizer
    E, L = model.cfg.n_enc_exits, len(model.stack.blocks)

    def feed_pass(model, ws, **kw):
        """A pool over ws, fed 1 s a round round-robin, polled each round,
        each tail flushed: (pool, wall s)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pool = StreamPool(len(ws), model, model_acfg, **kw)
        step = 16000
        for s0 in range(0, max(len(w) for w in ws), step):
            for i, w in enumerate(ws):
                if s0 < len(w):
                    pool.feed(i, w[s0:s0 + step])
            pool.poll()
        for i in range(len(ws)):
            pool.finish(i)
        torch.cuda.synchronize()
        return pool, time.perf_counter() - t0

    def ladder(per_exit_ids, n=None):
        return [round(wer_pct(refs[:n or len(refs)], [tok.decode(ids) for ids in ex]), 2)
                for ex in per_exit_ids]

    # ---- 10.1 the attention kernel on the windows' key masks
    S, H, T, dh = 32, 8, 112, 32
    kind = torch.arange(S, device=dev) % 5
    # full; 75 leading invalid keys (the stream's first window); a tail
    # flush's 60 valid; both (a short stream's only window); an idle row
    pos0 = torch.where((kind == 1) | (kind == 3), -75, 40)
    n_valid = torch.tensor([T, T, 60, 100, 0], device=dev)[kind]
    ar = torch.arange(T, device=dev)
    mask = ((pos0[:, None] + ar) >= 0) & (ar < n_valid[:, None])
    gen = torch.Generator(device="cpu").manual_seed(1010)
    att_err = 0.0
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = ((torch.randn(S, H, T, dh, generator=gen) * 3.0).to(dt).to(dev)
                   for _ in range(3))
        o_k = katt.fused_attention(q, k, v, mask)
        o_p = katt.fused_attention_plain(q, k, v, mask)
        torch.cuda.synchronize()
        tol = ATT_RTOL * max(1.0, float(v.float().abs().max()))
        err = float((o_k - o_p).abs().max())
        idle = kind == 4
        mean_v = v[idle].float().mean(2, keepdim=True).expand(-1, -1, T, -1)
        idle_err = float((o_k[idle] - mean_v).abs().max())
        per_kind = [float((o_k[kind == i] - o_p[kind == i]).abs().max()) for i in range(5)]
        print(f"attention vs plain on streaming key masks (S={S}, H={H}, T={T}, dh={dh}, "
              f"{dt}): max|d| {err} (full, leading 75 invalid, trailing 52 invalid, both, "
              f"idle: {per_kind}); idle rows vs the mean of v {idle_err} (tolerance {tol:.3e})")
        if not torch.isfinite(o_k).all() or err > tol or idle_err > tol:
            fail(f"attention kernel disagrees with its plain version on streaming "
                 f"key masks ({dt})")
        att_err = max(att_err, err)
    qb, kb, vb = (torch.randn(S, H, T, dh, generator=gen).to(torch.bfloat16).to(dev)
                  for _ in range(3))      # the path hands the kernel bf16 q, k, v
    qf, kf, vf = qb.float(), kb.float(), vb.float()
    big = torch.empty(4096, 4096, device=dev).normal_()
    blocker = lambda: torch.matmul(big, big)        # noqa: E731
    att = dict(
        ms=cuda_ms(lambda: katt.fused_attention(qb, kb, vb, mask), behind=blocker),
        plain_ms=cuda_ms(lambda: katt.fused_attention_plain(qb, kb, vb, mask),
                         behind=blocker),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qf, kf, vf, attn_mask=mask[:, None, None, :]), behind=blocker),
        bound=(4 * S * H * T * T * dh / PEAK_F32,
               (3 * qb.numel() * 2 + qb.numel() * 4 + mask.numel()) / PEAK_BYTES))
    del big
    att["bound_by"] = "operations" if att["bound"][0] >= att["bound"][1] else "bytes"
    att["bound_ms"] = 1e3 * max(att["bound"])
    print(f"attention at the streaming shape (S={S}, 8, 112, 32), bf16 q, k, v, on "
          f"{card}: kernel {att['ms']:.4f} ms, plain {att['plain_ms']:.4f} ms, SDPA on "
          f"float32 {att['library_ms']:.4f} ms, bound {att['bound_ms']:.4f} ms "
          f"({att['bound_by']})")

    # ---- 10.2 StreamPool, every exit, XLA-path attention and the kernel
    rec_p = Recognizer.from_flagship(dev.type, fused=True, attention_impl="pallas")
    card_ids, launches = {}, 0
    for impl, rec in (("xla", rec_x), ("pallas", rec_p)):
        reset_counts()
        with _window_dispatches(streaming) as nd:
            pool, wall = feed_pass(rec.model, waves, all_exits=True, **GEO)
        got = read_counts()
        want = {k: 0 for k in got}
        if impl == "pallas":
            want["attention"] = L * nd["deep"]
            launches = got["attention"]
        print(f"StreamPool ({impl} attention), {len(waves)} streams, {audio_s:.1f} s of "
              f"audio: {nd['deep']} dispatches ({nd['one_row']} of one row: the tails' "
              f"flushes), launches {got}; {wall:.3f} s of wall = "
              f"{audio_s / wall:.1f} audio-s/s on {card}")
        if got != want:
            fail(f"StreamPool ({impl}): launches {got}, expected {want}")
        card_ids[impl] = _stream_ids(pool, E)
        wers = ladder(card_ids[impl])
        print(f"StreamPool ({impl}) streaming WER per exit {wers}; phase 9's batch "
              f"greedy WER {[corp['greedy_wer'][e] for e in range(1, E + 1)]}")
        if wers[-1] > SANE_DENSE_WER:
            fail(f"StreamPool ({impl}): exit-{E} streaming WER {wers[-1]}%")
        # the same code on the CPU, the first n_cpu streams
        t0 = time.perf_counter()
        rec_c = Recognizer.from_flagship("cpu", fused=True, attention_impl=impl)
        pool_c, _ = feed_pass(rec_c.model, waves[:n_cpu], all_exits=True, **GEO)
        cpu_ids = _stream_ids(pool_c, E)
        _hold_token_contract(
            f"StreamPool ({impl}), card vs CPU, {n_cpu} streams",
            _ids_disagreement([ex[:n_cpu] for ex in card_ids[impl]], cpu_ids),
            ladder(cpu_ids, n_cpu))
        print(f"  (CPU pass {time.perf_counter() - t0:.1f} s)")
    _hold_token_contract("StreamPool, kernel attention vs XLA-path attention",
                         _ids_disagreement(card_ids["pallas"], card_ids["xla"]),
                         ladder(card_ids["xla"]))
    del rec_p

    # ---- 10.3 pool vs solo recognizers; chunk = whole utterance vs batch path
    pool4, _ = feed_pass(model, waves[:4], all_exits=True, **GEO)
    solo = []
    for w in waves[:4]:
        r = StreamingRecognizer(model, model_acfg, all_exits=True, **GEO)
        for s0 in range(0, len(w), 16000):
            r.accept_waveform(w[s0:s0 + 16000])
        r.finish()
        solo.append(r)
    solo_ids = [[r.ids_at(e) for r in solo] for e in range(1, E + 1)]
    _hold_token_contract("StreamPool (4 streams) vs 4 StreamingRecognizers",
                         _ids_disagreement(_stream_ids(pool4, E), solo_ids),
                         ladder(solo_ids, 4))
    i_short = int(np.argmin([len(w) for w in waves]))
    w = waves[i_short]
    whole = StreamingRecognizer(model, model_acfg, all_exits=True,
                                chunk_s=len(w) / 16000 + 1.0, left_s=0.0, right_s=0.0)
    whole.accept_waveform(w)
    whole.finish()
    padded = np.zeros((1, whole.win_samples), np.float32)
    padded[0, :len(w)] = w
    rec_u = Recognizer.from_flagship(dev.type, fused=False)
    with torch.no_grad():
        out_u = rec_u.transcribe(torch.from_numpy(padded), torch.tensor([len(w)]))
    batch_ids = [[out_u.tokens[e, 0, :int(out_u.n_tokens[e, 0])].tolist()]
                 for e in range(E)]
    whole_ids = [[whole.ids_at(e)] for e in range(1, E + 1)]
    _hold_token_contract(f"one utterance ({len(w) / 16000:.2f} s) as one chunk with no "
                         f"context vs Recognizer's unfused batch path",
                         _ids_disagreement(whole_ids, batch_ids),
                         [round(wer_pct([refs[i_short]], [tok.decode(x[0])]), 2)
                          for x in batch_ids])
    del rec_u

    # ---- 10.4 the gated pool: fast exit 2, the threshold in the widest gap
    k_fast = 2
    confs = []
    with _window_dispatches(streaming, record_conf=confs):
        feed_pass(model, waves, exit_threshold=1.01, fast_exit=k_fast, **GEO)
    confs = np.sort(np.asarray(confs))
    lo, hi = len(confs) // 4, 3 * len(confs) // 4
    j = lo + int(np.argmax(confs[lo + 1:hi + 1] - confs[lo:hi]))
    thr = float(confs[j:j + 2].mean())
    print(f"gated streaming: {len(confs)} chunks' exit-{k_fast} confidences; threshold "
          f"{thr:.6f} in a gap of {float(confs[j + 1] - confs[j]):.3e}; {j + 1} below it")
    gkw = dict(exit_threshold=thr, fast_exit=k_fast, **GEO)
    with _window_dispatches(streaming) as nd:
        gpool, gwall = feed_pass(model, waves, **gkw)
    exits = [e for r in gpool.recs for e in r.exits_run]
    hist = {e: exits.count(e) for e in sorted(set(exits))}
    esc = exits.count(E) / len(exits)
    gwer = round(wer_pct(refs, [tok.decode(r.ids) for r in gpool.recs]), 2)
    print(f"gated StreamPool (fast exit {k_fast}, threshold {thr:.6f}): chunks per exit "
          f"{hist}, escalated {100 * esc:.1f}%, {nd['fast']} fast and {nd['deep']} deep "
          f"dispatches, WER {gwer}%, {audio_s / gwall:.1f} audio-s/s on {card}")
    if esc in (0.0, 1.0):
        fail(f"gated StreamPool escalated {100 * esc:.0f}% of the chunks")
    n_diff = 0
    gsolo = []
    for i, w in enumerate(waves):
        r = StreamingRecognizer(model, model_acfg, **gkw)
        for s0 in range(0, len(w), 16000):
            r.accept_waveform(w[s0:s0 + 16000])
        r.finish()
        n_diff += r.exits_run != gpool.recs[i].exits_run
        gsolo.append(r.ids)
    dis = _ids_disagreement([[r.ids for r in gpool.recs]], [gsolo])
    print(f"gated StreamPool vs {len(waves)} gated StreamingRecognizers: {n_diff} streams' "
          f"chunk exits differ; tokens differing {dis[0][0]}/{dis[0][1]}")
    if n_diff:
        fail("the gated StreamPool runs other exits than the solo recognizers")
    _hold_token_contract("gated StreamPool vs solo recognizers", dis, [gwer])

    # ---- 10.5 causal windows (pair mask; the plain attention path), card
    # vs CPU over n_causal streams; beside it, the first n_cpu streams on
    # the card at two pool widths, whose products cuBLAS may schedule
    # apart: how far two bf16 schedules move these tokens
    ckw = dict(all_exits=True, causal_attention=True, **GEO)
    cpool, _ = feed_pass(model, waves[:n_causal], **ckw)
    cpool8, _ = feed_pass(model, waves[:n_cpu], **ckw)
    card_c = _stream_ids(cpool, E)
    rec_c = Recognizer.from_flagship("cpu", fused=True)
    cpool_c, _ = feed_pass(rec_c.model, waves[:n_causal], **ckw)
    causal_ids = _stream_ids(cpool_c, E)
    print(f"causal windows, streaming WER per exit {ladder(causal_ids, n_causal)} "
          f"(the flagship was not trained with chunked attention)")
    dis8 = _ids_disagreement([ex[:n_cpu] for ex in card_c],
                             [ex[:n_cpu] for ex in causal_ids])
    env8 = _ids_disagreement(_stream_ids(cpool8, E), [ex[:n_cpu] for ex in card_c])
    print(f"causal windows, first {n_cpu} streams: card vs CPU per exit "
          f"{[f'{e}/{t}' for e, t in dis8]}; the card at {n_cpu} streams vs at "
          f"{n_causal} {[f'{e}/{t}' for e, t in env8]}")
    _hold_token_contract(f"causal windows, card vs CPU, {n_causal} streams",
                         _ids_disagreement(card_c, causal_ids),
                         ladder(causal_ids, n_causal))
    del rec_c

    # ---- 10.6 load: the load test's round loop on flagship pools
    load = []
    for gated, S_ in [(g, n) for g in (False, True) for n in LOAD_STREAMS]:
        rng = np.random.RandomState(S_)
        bank = itertools.count()

        def draw(n):
            w_ = waves[next(bank) % len(waves)]
            return w_[:n] if len(w_) >= n else np.pad(w_, (0, n - len(w_)))

        def new_len():
            return int((2.0 + 12.0 * rng.rand()) * 16000)

        kw = dict(gkw) if gated else dict(GEO)
        lpool = StreamPool(S_, model, model_acfg, **kw)
        res = load_test.run_rounds(lpool, rounds=LOAD_ROUNDS, chunk_s=1.0, draw=draw,
                                   new_len=new_len)
        print(f"load (load_test.run_rounds) on {card}: {json.dumps(res)}")
        load.append(res)

        def one_round():
            for i in range(S_):
                lpool.feed(i, draw(16000))
            lpool.poll()
        profile_forward(one_round, f"{'gated ' if gated else ''}StreamPool round "
                        f"(S={S_})", card, S_, iters=1, top=10,
                        shape=f"S={S_} windows of 112 sub frames")

    # ---- 10.7 the server: 4 concurrent loopback connections
    holder = []
    srv = serve.make_server(["--load_model_path", flagship, "--port", "0",
                             "--device", dev.type], port_holder=holder)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    first_need = StreamingRecognizer(srv.model, srv.acfg, **srv.rec_kw)._window_bounds(0)[1]
    results = [None] * 4

    def client(i):
        pcm = np.clip(waves[i] * 32768.0, -32768, 32767).astype(np.int16)
        lines, t_full = [], None
        t0 = time.perf_counter()
        with socket.create_connection(("127.0.0.1", holder[0])) as s:
            f = s.makefile("rb")

            def reader():
                for ln in f:
                    lines.append((time.perf_counter(), json.loads(ln)))
            rt = threading.Thread(target=reader)
            rt.start()
            s.sendall(b'{"sample_rate": 16000, "format": "s16le"}\n')
            sent = 0
            for p in range(0, len(pcm), 3331):
                s.sendall(pcm[p:p + 3331].tobytes())
                sent += len(pcm[p:p + 3331])
                if t_full is None and sent >= first_need:
                    t_full = time.perf_counter()
            s.shutdown(socket.SHUT_WR)
            rt.join(timeout=300)
        results[i] = (pcm, lines, t_full, time.perf_counter() - t0)

    clients = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=300)
    srv.shutdown()
    srv.server_close()
    for i, res in enumerate(results):
        if res is None:
            fail(f"server: connection {i} did not finish")
        pcm, lines, t_full, wall_c = res
        finals = [m for _, m in lines if "final" in m]
        partials = [(t, m) for t, m in lines if "partial" in m]
        if len(finals) != 1:
            fail(f"server: connection {i} got {len(finals)} final lines: {lines[-3:]}")
        local = StreamingRecognizer(srv.model, srv.acfg, srv.tok, **srv.rec_kw)
        local.accept_waveform(pcm.astype(np.float32) / 32768.0)
        local.finish()
        first = (f"{(partials[0][0] - t_full) * 1e3:.1f} ms" if partials and t_full
                 else "no partial line")
        print(f"server connection {i} ({len(pcm) / 16000:.2f} s of audio) on {card}: "
              f"{wall_c:.3f} s of wall, {len(partials)} partial lines, first partial "
              f"{first} after the last byte of the first full window; final ids "
              f"{'equal' if finals[0]['ids'] == local.ids else 'DIFFER from'} a local "
              f"StreamingRecognizer's")
        if finals[0]["ids"] != local.ids:
            fail(f"server: connection {i}'s final differs from a local recognizer's")

    # ---- 10.8 the CLI's --streaming over the corpus, ungated and gated
    base = ["--decoder_mode", "ctc", "--load_model_path", flagship, "--data_root",
            corp["root"], "--eval_splits", "test-clean", "--streaming", "true",
            "--device", dev.type]
    for mode, extra in (("ungated", []),
                        ("gated", ["--exit_threshold", repr(thr), "--fast_exit",
                                   str(k_fast)])):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            inference.main(base + extra)
        wall = time.perf_counter() - t0
        out = buf.getvalue().splitlines()
        n_exp = sum("EXPECTED:" in ln for ln in out)
        n_out = sum("STREAM_OUT (exit " in ln for ln in out)
        wer_l = {int(ln.split("WER exit ")[1].split(":")[0]):
                 float(ln.split(": ")[1].split("%")[0])
                 for ln in out if "streaming WER exit " in ln}
        for ln in out:
            if "streaming WER" in ln or "histogram" in ln:
                print(f"CLI --streaming ({mode}): {ln}")
        print(f"CLI --streaming ({mode}) on {card}: {audio_s:.1f} s of audio in "
              f"{wall:.3f} s = {audio_s / wall:.1f} audio-s/s (the whole main())")
        want_out = len(waves) * (1 if extra else E)
        if (n_exp != len(waves) or n_out != want_out
                or sorted(wer_l) != ([E] if extra else list(range(1, E + 1)))
                or (extra and not any("histogram" in ln for ln in out))):
            fail(f"CLI --streaming ({mode}): {n_exp} EXPECTED, {n_out} STREAM_OUT lines, "
                 f"WER lines {wer_l}")
        if wer_l[E] > SANE_DENSE_WER:
            fail(f"CLI --streaming ({mode}): exit-{E} WER {wer_l[E]}%")
    return {"attention": att, "attention_err": att_err, "launches": launches,
            "load": load}


def export_phase(dev, card, reset_counts, read_counts, rec, wav, counts, out_k,
                 ladder, export_job, work_dir) -> dict:
    """Phase 11 (run after phase 18d): once `export_child` (export_job)
    has captured and compiled the programs into work_dir, the flagship's
    (rec, bf16, fused block) served from the bundle alone
    (`ExportedRecognizer`) on phase 3's 128 requests in 16 batches of 8
    and held against the eager paths. Returns the export path's launch
    counts and times for the kernels line, and the zoo's capture and
    compile seconds and package MB for phases 14c and 18a."""
    import numpy as np
    import torch
    from early_exit_tpu_torch import runtime
    from early_exit_tpu_torch.models.early_exit_gate import exit_confidence
    from early_exit_tpu_torch.models.gate_calibration import scaled_confidence
    from early_exit_tpu_torch.ops import frontend
    from early_exit_tpu_torch.serving import export as ex
    from early_exit_tpu_torch.serving.packing import PACK_BATCH

    model, acfg = rec.model, rec.acfg
    gate = rec.gate_settings()
    committed = rec.calib
    k = int(committed.get("cascade_k") or 2)
    E, npe = model.cfg.n_enc_exits, model.cfg.n_enc_layers_per_exit
    L = E * npe
    Bk, Sk = EXPORT_BUCKET
    bkey = f"{Bk}x{Sk}"
    B = wav.shape[0]
    batches = [slice(i, i + Bk) for i in range(0, B, Bk)]
    wav_np = wav.cpu().numpy()
    cnt_np = counts.cpu().numpy().astype(np.int32)
    counts32 = counts.to(torch.int32)

    def launched(what, **want):
        got = read_counts()
        full = {name: want.get(name, 0) for name in got}
        if got != full:
            fail(f"{what}: launches {got}, expected {full}")
        return got

    class Mel(torch.nn.Module):
        def forward(self, w):
            return frontend.mel_spectrogram(w, acfg, method=acfg.mel_method)

    # ---- 11.1 the programs, captured and compiled beside phases 8-18d
    t0 = time.perf_counter()
    built = export_job.result()
    secs = built["aoti"]
    print(f"export on {card}: {sum(map(len, secs.values()))} programs captured ("
          + ", ".join(f"{n} {v:.1f} s" for n, v in built["capture_s"].items()) + ") and "
          f"compiled by AOTInductor, {EXPORT_WORKERS} at a time, in a child process "
          f"beside phases 8-19 (the child's wall {built['wall_s']:.1f} s); phase 11 waited "
          f"{time.perf_counter() - t0:.1f} s for them")
    path = os.path.join(work_dir, "flagship.eetx")
    mel_path = os.path.join(work_dir, "mel.pt2")
    try:
        bundle = ex.load_bundle(path)
        man = bundle.manifest
        print(f"  the flagship's bundle {os.path.getsize(path) / 1e6:.1f} MB (ops called: "
              f"{man['ops']}); the features' program compiled in {secs['mel'][''][0]:.1f} s")
        for key, sec in man["aoti_compile_s"].items():
            print(f"  {key}: AOTInductor compile {sec:.1f} s, package "
                  f"{len(bundle.packages[key]) / 1e6:.1f} MB, exported program "
                  f"{len(bundle.programs['cuda'][key]) / 1e6:.1f} MB")
        # ---- 11.2 the graphs hold the block op, once per block run
        want = {bkey: L, "gated/" + bkey: L, "poly": L,
                **{f"gated/poly/{e}": npe for e in range(E)},
                "cascade_a/" + bkey: k * npe, "cascade_b/" + bkey: (E - k) * npe}
        nodes = {key: c.get("eet::conformer_block", 0)
                 for key, c in man["op_nodes"]["cuda"].items()}
        print(f"eet::conformer_block nodes per exported graph: {nodes} (the gated "
              f"bucket graph: {npe} in each of the {E} exits' cond branches; the gated "
              f"poly program: one graph an exit)")
        if nodes != want:
            fail(f"exported graphs: block op nodes {nodes}, expected {want}")
        del bundle

        rec_x = ex.ExportedRecognizer(path)
        serve = ex.make_serve_fn(model, acfg, gate_score=gate["score"])
        gserve = ex.make_gated_serve_fn(model, acfg, gate_score=gate["score"])

        # ---- 11.3 the program's features, full float32 (TF32 off)
        with torch.no_grad():
            f_x = torch._inductor.aoti_load_package(mel_path)(wav[:Bk])
            f_e = Mel()(wav[:Bk])
            torch.backends.cuda.matmul.allow_tf32 = True
            f_t = Mel()(wav[:Bk])
            runtime.exact_float32()
        scale = float(f_e.abs().max())
        rel_x = float((f_x - f_e).abs().max()) / scale
        rel_t = float((f_t - f_e).abs().max()) / scale
        print(f"mel features, AOTInductor program vs eager ({Bk} x {Sk}): max|d| / "
              f"max|f| {rel_x:.3e} (tolerance {FEATURE_RTOL}); eager with TF32 on "
              f"vs off {rel_t:.3e}")
        if rel_x > FEATURE_RTOL:
            fail("the exported program's mel features are not full float32")
        if rel_t <= FEATURE_RTOL:
            fail("the feature tolerance cannot tell TF32 from float32")

        # ---- 11.4 all-exit parity, 16 batches of 8
        toks, ntok, conf_x, conf_e = [], [], [], []
        reset_counts()
        for sl in batches:
            t, n, c = rec_x(wav_np[sl], cnt_np[sl])
            toks.append(torch.from_numpy(t))
            ntok.append(torch.from_numpy(n))
            conf_x.append(torch.from_numpy(c))
        allexit = launched("exported all-exit program",
                           conformer_block_bf16=L * len(batches))
        with torch.no_grad():
            for sl in batches:
                conf_e.append(serve(wav[sl], counts32[sl])[2].cpu())
        toks, ntok = torch.cat(toks, 1), torch.cat(ntok, 1)
        conf_x, conf_e = torch.cat(conf_x, 1), torch.cat(conf_e, 1)
        dis = disagreement(toks, ntok, out_k.tokens, out_k.n_tokens)
        _hold_token_contract("exported all-exit program vs Recognizer.transcribe "
                             f"({B} requests)", dis, ladder)
        same = sum(bool(torch.equal(toks[e, i, :ntok[e, i]],
                                    out_k.tokens[e, i, :out_k.n_tokens[e, i]]))
                   for e in range(E) for i in range(B))
        dconf = float((conf_x - conf_e).abs().max())
        print(f"exported all-exit program: {allexit['conformer_block_bf16']} block "
              f"launches over {len(batches)} calls; {same}/{E * B} (exit, request) "
              f"rows equal to Recognizer.transcribe's; max|dconf| vs the eager serve "
              f"module {dconf:.3e}")

        # ---- 11.5 gated parity: threshold 0 and each batch's median exit-1 conf
        for name in ("0.0", "the batch's median exit-1 confidence"):
            n_eq = 0
            for sl in batches:
                # the median of an even count: halfway between the two middle
                # rows, never at a row's own confidence
                mid = conf_e[0, sl].sort().values[Bk // 2 - 1:Bk // 2 + 1]
                thr = 0.0 if name == "0.0" else float(mid.mean())
                reset_counts()
                _, _, ch = rec_x.gated(wav_np[sl], cnt_np[sl], thr)
                got = read_counts()
                with torch.no_grad():
                    ch_e = gserve(wav[sl], counts32[sl],
                                  torch.tensor(thr, device=dev))[2].cpu().numpy()
                n_eq += int((ch == ch_e).sum())
                if name == "0.0" and (got["conformer_block_bf16"] != npe
                                      or (ch != 1).any()):
                    fail(f"gated program at threshold 0: launches {got}, exits {ch}")
                if got["conformer_block_bf16"] != npe * int(ch.max()):
                    fail(f"gated program: {got} block launches for exits {ch}")
            print(f"exported gated program, threshold {name}: chosen exits equal to "
                  f"eager gated_apply's on {n_eq}/{B} rows")
            if n_eq != B:
                fail(f"exported gated program (threshold {name}) chooses other "
                     f"exits than gated_apply")

        # ---- 11.6 cascade parity: the committed calibration, exit k at the median
        with torch.no_grad():
            lp, sub_len = model.encode_exit(*rec._features(wav, counts), k)
            m = torch.arange(lp.shape[1], device=dev)[None, :] < sub_len[:, None]
            conf_k = scaled_confidence(lp, m, gate["score"], gate["temperatures"][k - 1])
        thr_m = list(gate["threshold"])
        thr_m[k - 1] = float(conf_k.sort().values[B // 2 - 1:B // 2 + 1].mean())
        casc = {}
        for name, calib in (("committed calibration", committed),
                            (f"exit {k}'s threshold at the median",
                             {**committed, "thresholds": thr_m})):
            rec.calib = calib
            thr = np.asarray(calib["thresholds"], np.float32)
            n_eq, n_esc, t_x, n_x, t_g, n_g = 0, 0, [], [], [], []
            for sl in batches:
                reset_counts()
                tx, nx, ch, esc = rec_x.cascade(wav_np[sl], cnt_np[sl], thr)
                want_n = k * npe + ((E - k) * npe if esc.any() else 0)
                launched(f"exported cascade ({name})", conformer_block_bf16=want_n)
                g = rec.transcribe_gated(wav[sl], counts[sl])
                n_eq += int((ch == g.chosen_exit.numpy()).sum())
                n_esc += int(esc.sum())
                t_x.append(torch.from_numpy(tx))
                n_x.append(torch.from_numpy(nx))
                t_g.append(g.tokens)
                n_g.append(g.n_tokens)
            dis = disagreement(torch.cat(t_x)[None], torch.cat(n_x)[None],
                               torch.cat(t_g)[None], torch.cat(n_g)[None])
            print(f"exported cascade, {name}: chosen exits equal to "
                  f"Recognizer.transcribe_gated's on {n_eq}/{B} rows; {n_esc} rows "
                  f"escalated (phase B at {PACK_BATCH} packed rows a batch)")
            _hold_token_contract(f"exported cascade vs transcribe_gated ({name})",
                                 dis, [0.0])
            if n_eq != B:
                fail(f"exported cascade ({name}) chooses other exits than "
                     f"Recognizer.transcribe_gated")
            casc[name] = n_esc
        rec.calib = committed
        if not casc[f"exit {k}'s threshold at the median"]:
            fail("the median threshold escalated no row: phase B never ran")

        # ---- 11.7 poly parity at lengths no bucket covers: the token
        # contract at 12.3 s and 17.9 s each, and over all the lengths
        # pooled (a 0.10-0.14 s request holds ~1-2 tokens a row, where one
        # flip at a near tie is a 1.5% share of its 8 rows)
        # (called directly: the runner would pad a request under the
        # bucket's length into the bucket program)
        poly, pooled = rec_x._fn("poly"), None
        for n_samp in EXPORT_POLY_LENGTHS:
            w = wav[:2 * Bk].reshape(Bk, -1)[:, :n_samp].contiguous()
            c = torch.full((Bk,), n_samp, dtype=torch.int32, device=dev)
            reset_counts()
            with torch.no_grad():
                t, n = (v.cpu().numpy() for v in poly(w, c)[:2])
            launched(f"poly program at {n_samp} samples", conformer_block_bf16=L)
            ref = rec.transcribe(w, c)
            if t.shape != tuple(ref.tokens.shape):
                fail(f"poly program at {n_samp} samples: tokens {t.shape}, eager "
                     f"{tuple(ref.tokens.shape)}")
            dis = disagreement(torch.from_numpy(t), torch.from_numpy(n),
                               ref.tokens, ref.n_tokens)
            what = (f"exported poly program vs Recognizer.transcribe at {n_samp} samples "
                    f"({n_samp / acfg.sample_rate:.2f} s, T' {t.shape[2]})")
            if n_samp < Sk:
                print(f"{what}: tokens differing per exit {[f'{e}/{u}' for e, u in dis]} "
                      f"(held pooled with the other lengths)")
            else:
                _hold_token_contract(what, dis, ladder)
            pooled = dis if pooled is None else [
                (a + e, b + u) for (a, b), (e, u) in zip(pooled, dis)]
        _hold_token_contract(f"exported poly program vs Recognizer.transcribe at "
                             f"{EXPORT_POLY_LENGTHS} samples", pooled, ladder)

        # ---- 11.7b the gated poly program (one program an exit, stepped on
        # the host) at the same lengths, and its time at the bucket's shape
        # against the same gate as one cond program (the yardstick that
        # `export_child` compiled beside it; served nowhere)
        def request(S):
            return (wav[:2 * Bk].reshape(Bk, -1)[:, :S].contiguous(),
                    torch.full((Bk,), S, dtype=torch.int32, device=dev))
        gated_poly(model, rec_x, acfg, request, (*EXPORT_POLY_LENGTHS, Sk), reset_counts,
                   read_counts, "11.7b. the flagship's", score=gate["score"], direct=True)
        cond_x = torch._inductor.aoti_load_package(os.path.join(work_dir, "flagship_cond.pt2"))
        w8, c8 = wav[:Bk].contiguous(), counts32[:Bk].contiguous()
        with torch.no_grad():
            feats = frontend.mel_spectrogram(w8, acfg, method=acfg.mel_method)
            lp, sub = model.encode_exit(feats, frontend.mel_lengths(c8, acfg.hop_length), 1)
            mask = torch.arange(lp.shape[1], device=dev)[None, :] < sub[:, None]
            c1 = exit_confidence(lp, mask, gate["score"]).sort().values
            for thr in (0.0, float(c1[Bk // 2 - 1:Bk // 2 + 1].mean()), 1.01):
                t = torch.tensor(thr, device=dev)
                cond = lambda: cond_x(w8, c8, t)
                step = lambda: rec_x._gated_exits("poly", w8, c8, t)
                ch_c, ch_s = cond()[2], step()[2]
                ms = [cuda_ms(fn, 20, 3) for fn in (cond, step, step, cond)]
                t_c, t_s = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
                print(f"11.7b. the flagship's gated poly program at {Bk} x {Sk} on {card}, "
                      f"threshold {thr:.4f} (exits chosen {ch_s.tolist()}; the cond "
                      f"program's {'the same' if torch.equal(ch_c, ch_s) else ch_c.tolist()})"
                      f": stepped {ms[1]:.3f} / {ms[2]:.3f} ms a call, the same gate as one "
                      f"cond program {ms[0]:.3f} / {ms[3]:.3f} ms ({100 * (t_s / t_c - 1):+.1f}%"
                      f", CUDA events, c s s c)")
        del cond_x

        # ---- 11.8 times
        run = rec_x._fn(bkey)
        w8, c8 = wav[:Bk].contiguous(), counts32[:Bk].contiguous()
        audio_s = Bk * Sk / acfg.sample_rate
        with torch.no_grad():
            t_x = cuda_ms(lambda: run(w8, c8), 20, 3)
            t_e = cuda_ms(lambda: serve(w8, c8), 20, 3)
            thr = np.asarray(committed["thresholds"], np.float32)
            t_cx = cuda_ms(lambda: rec_x.cascade(wav_np[:Bk], cnt_np[:Bk], thr), 20, 3)
            t_ce = cuda_ms(lambda: rec.cascade_pass(wav[:Bk], counts[:Bk]), 20, 3)
        true_s = float(counts[:Bk].sum()) / acfg.sample_rate
        print(f"times on {card} ({Bk} x {Sk / acfg.sample_rate:.0f} s, CUDA events): "
              f"exported all-exit program {t_x:.3f} ms = {audio_s / t_x * 1e3:.1f} "
              f"audio-s/s, the eager serve module {t_e:.3f} ms = "
              f"{audio_s / t_e * 1e3:.1f} audio-s/s; exported cascade (numpy in and "
              f"out) {t_cx:.3f} ms = {true_s / t_cx * 1e3:.1f} audio-s/s, "
              f"Recognizer.cascade_pass {t_ce:.3f} ms = {true_s / t_ce * 1e3:.1f}")
        busy = {
            "exported all-exit": profile_forward(lambda: run(w8, c8),
                                                 "exported all-exit program", card,
                                                 Bk, iters=5, top=8),
            "eager all-exit": profile_forward(lambda: serve(w8, c8),
                                              "eager serve module", card, Bk,
                                              iters=5, top=8),
            "exported cascade": profile_forward(
                lambda: rec_x.cascade(wav_np[:Bk], cnt_np[:Bk], thr),
                "exported cascade", card, Bk, iters=5, top=8),
            "eager cascade": profile_forward(
                lambda: rec.cascade_pass(wav[:Bk], counts[:Bk]),
                "Recognizer.cascade_pass", card, Bk, iters=5, top=8)}
        print(f"device-busy share per path: "
              f"{ {key: round(100 * v, 1) for key, v in busy.items()} } %")
        rec_x.close()
    finally:
        for stale in (path, mel_path):
            if os.path.exists(stale):
                os.remove(stale)
    return {"allexit_launches": allexit["conformer_block_bf16"],
            "calls": len(batches), "ms": t_x, "eager_ms": t_e, "aoti": secs,
            "capture_s": built["capture_s"]}


@contextlib.contextmanager
def float64_math():
    """The port's float32 training path computed in float64: every compute,
    residual and softmax dtype, and every float32 cast of its ops
    (`Tensor.float`), widened; a yardstick that float32 runs on either
    device are measured against (the sinusoidal PE and the masks keep
    their float32 values)."""
    import torch
    from early_exit_tpu_torch import configs
    from early_exit_tpu_torch.models import conformer
    saved = torch.Tensor.float, configs._dt, conformer._dt
    torch.Tensor.float = lambda v, *a, **k: v.double()
    configs._dt = conformer._dt = (
        lambda name: torch.bfloat16 if name == "bfloat16" else torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float, configs._dt, conformer._dt = saved


@contextlib.contextmanager
def float64_ctc():
    """The port's CTC loss taken in float64 (its log-probs widened, its
    loss rounded back): the rest of the step stays float32."""
    import torch.nn.functional as F
    ctc_loss = F.ctc_loss
    F.ctc_loss = lambda lp, *a, **k: ctc_loss(lp.double(), *a, **k).to(lp.dtype)
    try:
        yield
    finally:
        F.ctc_loss = ctc_loss


def _flat(tree, prefix=""):
    """{"['a'][0]['b']": leaf} of nested dicts and lists of arrays."""
    if isinstance(tree, list):
        tree = dict(enumerate(tree))
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}[{k!r}]"))
    return out


def train_phase(dev, card, knobs, reset_counts, expect_counts) -> None:
    """Phase 8: (a) one train step of the flagship on the card against the
    CPU, in float32 and in the train profile; (b) 40 steps of a fresh
    model on one sub-batch must learn, and the trained model's kernel path
    must agree with its unfused path; (c) the throughput of the training
    loop over the data pipeline, its profile, and a checkpoint pair
    written and read back."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch
    from early_exit_tpu_torch import checkpoint, interop
    from early_exit_tpu_torch.configs import AudioConfig, ModelConfig, TrainConfig, train_profile
    from early_exit_tpu_torch.data import text
    from early_exit_tpu_torch.data.pipeline import Pipeline
    from early_exit_tpu_torch.data.synthetic import SyntheticDataset, synth_batch
    from early_exit_tpu_torch.models.early_conformer import EarlyConformer
    from early_exit_tpu_torch.ops.kernels import conformer_block as kcb
    from early_exit_tpu_torch.optim.noam import global_norm
    from early_exit_tpu_torch.serving.recognizer import Recognizer, wer_pct
    from early_exit_tpu_torch.tokenizer import load_decoder, load_tokenizer
    from early_exit_tpu_torch.training import checkpoint as tck
    from early_exit_tpu_torch.training import trainer

    bound = checkpoint.bound_tokenizer(checkpoint.load_calib())
    tok, decoder = load_tokenizer(bound), load_decoder(bound)
    acfg, tcfg = AudioConfig(), TrainConfig()          # the train profile's FFT mel
    cpu_pipe = Pipeline([], tok, acfg, tcfg, device="cpu")

    def requests(n, seed):
        """n requests of bench_eval's distribution: (items for the
        pipeline, padded waveforms, sample counts, transcripts)."""
        wav, counts, refs = synth_batch(knobs, n, seed)
        items = []
        for i in range(n):
            label = text.clean_train_label(refs[i])
            items.append((wav[i, :counts[i]], text.encode_target(label, tok), label))
        return items, wav, counts, refs

    def host_batch(items):
        return {k: torch.from_numpy(v) for k, v in cpu_pipe.host_subbatch(items).items()}

    # -- 8a. one step of the flagship, card against CPU, same features
    items, _, _, _ = requests(4, seed=777)
    batch_cpu = cpu_pipe.to_device(host_batch(items))
    batch_dev = {k: v.to(dev) for k, v in batch_cpu.items()}
    tree = checkpoint.load_tree(checkpoint.FLAGSHIP_CKPT)

    def one_step(cfg, device, batch, fresh=False):
        """Loss, global grad norm, gradient leaves (the JAX layout) and new
        BN statistics of one step: the flagship's weights, or (fresh) a
        seeded init drawn on the CPU."""
        if fresh:
            model = EarlyConformer(cfg).init(torch.Generator().manual_seed(5))
        else:
            model = interop.from_jax_params(tree["params"], tree["model_state"], cfg)
        model = model.requires_grad_(True).to(device)
        total, per_exit, new_state = trainer.loss_fn(model, tcfg, batch)
        params = list(model.parameters())
        grads = torch.autograd.grad(total, params)
        norm = float(global_norm(grads))
        leaves = {k: np.asarray(v, np.float64) for k, v in
                  _flat(interop.jax_tree(model, dict(zip(params, grads)))).items()}
        bn = {k: v.detach().cpu() for k, v in new_state["blocks"]["conv_bn"].items()}
        return float(total.detach()), norm, leaves, bn

    def compare(a, b):
        """b's figures against the reference a: loss and norm relative
        differences, per-leaf relative L2 and cosine, the zero-gradient
        leaves' share of the norm, the BN statistics' max|d|."""
        rel, cos, zero = {}, {}, {}
        for k, h in a[2].items():
            c = b[2][k]
            if k in ZERO_GRAD_LEAVES:
                zero[k] = max(np.linalg.norm(c), np.linalg.norm(h)) / a[1]
                continue
            rel[k] = np.linalg.norm(c - h) / np.linalg.norm(h)
            cos[k] = float(c.ravel() @ h.ravel() / (np.linalg.norm(c) * np.linalg.norm(h)))
        bn = max(float((b[3][k] - a[3][k]).abs().max()) / max(1.0, float(a[3][k].abs().max()))
                 for k in a[3])
        wr, wc = max(rel, key=rel.get), min(cos, key=cos.get)
        out = dict(loss=abs(b[0] - a[0]) / abs(a[0]), norm=abs(b[1] - a[1]) / a[1],
                   leaf=rel[wr], cos=cos[wc], zero=max(zero.values()), bn=bn)
        text_ = (f"loss {b[0]:.6f} vs {a[0]:.6f} (relative {out['loss']:.3e}); grad_norm "
                 f"{b[1]:.6f} vs {a[1]:.6f} ({out['norm']:.3e}); gradient leaves: worst "
                 f"relative L2 {rel[wr]:.3e} ({wr}), lowest cosine {cos[wc]:.6f} ({wc}); "
                 f"zero-gradient leaves at most {out['zero']:.3e} of the global norm; BN "
                 f"running statistics max|d| {bn:.3e}")
        return out, text_

    T_ = int(batch_cpu["feats"].shape[1])
    f32, b16 = ModelConfig(compute_dtype="float32", drop_prob=0.0), train_profile(drop_prob=0.0)

    def envelope(what, cfg, ref):
        """The card against itself over CHAOS_DRAWS draws of the features
        moved by CHAOS_NOISE relative noise: the grad norms and the lowest
        leaf cosine. Returns the lowest cosine."""
        norms, lows = [], []
        for draw in range(CHAOS_DRAWS):
            noisy = dict(batch_dev)
            noisy["feats"] = batch_dev["feats"] * (1 + CHAOS_NOISE * torch.randn(
                batch_dev["feats"].shape, device=dev,
                generator=torch.Generator(device=dev).manual_seed(draw)))
            step = one_step(cfg, dev, noisy)
            norms.append(step[1])
            lows.append(compare(ref, step)[0]["cos"])
        print(f"train step, {what}, the card against itself with the features x (1 + "
              f"{CHAOS_NOISE} N(0, 1)), {CHAOS_DRAWS} draws: grad_norm "
              f"{min(norms):.6f} .. {max(norms):.6f} (unmoved {ref[1]:.6f}); lowest leaf "
              f"cosine per draw {[round(c, 6) for c in lows]}")
        return min(lows)

    for what, cfg, fresh in (("flagship, float32, TF32 off", f32, False),
                             ("flagship, train profile (bf16)", b16, False),
                             ("fresh init at the flagship's width, train profile (bf16)",
                              b16, True)):
        t0 = time.perf_counter()
        on_card = one_step(cfg, dev, batch_dev, fresh)
        torch.cuda.synchronize()
        t_dev = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = one_step(cfg, torch.device("cpu"), batch_cpu, fresh)
        t_cpu = time.perf_counter() - t0
        got, line = compare(host, on_card)
        print(f"train step, {what} (B=4, T={T_}), card vs CPU: {line}; {t_dev:.2f} s on "
              f"the card, {t_cpu:.2f} s on the CPU")
        if not np.isfinite([on_card[0], on_card[1]]).all():
            fail(f"non-finite train step on the card ({what})")
        if not fresh:       # how far the card moves from itself, for scale
            envelope(what, cfg, on_card)
        if cfg.compute_dtype == "float32":
            bad = (got["loss"] > TRAIN_F32_LOSS or got["norm"] > TRAIN_F32_NORM
                   or got["leaf"] > TRAIN_F32_LEAF or got["bn"] > TRAIN_F32_BN
                   or got["zero"] > ZERO_GRAD_SHARE)
        elif fresh:
            bad = got["loss"] > TRAIN_BF16_LOSS or got["cos"] < TRAIN_BF16_COS
        else:       # the flagship's bf16 gradient is chaotic: its loss only
            bad = got["loss"] > TRAIN_BF16_LOSS
        if bad:
            fail(f"train step on the card disagrees with the CPU ({what})")

    # -- 8b. a fresh model learns one sub-batch; then its kernel path
    cfg = train_profile(fused_block=True)                 # dropout 0.1
    model = EarlyConformer(cfg).to(dev).init(torch.Generator(device=dev).manual_seed(0))
    items, wav16, counts16, refs16 = requests(16, seed=4343)
    batch = {k: v.to(dev) for k, v in cpu_pipe.to_device(host_batch(items)).items()}
    tr = trainer.Trainer(model, dataclasses.replace(tcfg, specaugment=True), warmup=10)
    rec = Recognizer(model, decoder, device=dev)
    wav16, counts16 = torch.as_tensor(wav16, device=dev), torch.as_tensor(counts16, device=dev)
    with torch.no_grad():
        before = rec.transcribe(wav16, counts16)          # builds the kernel layout
        stale = [{k: v.clone() for k, v in f.items()} for f in model.stack.folded()]
    losses = []
    t0 = time.perf_counter()
    for _ in range(LEARN_STEPS):
        losses.append(float(tr.step(batch)["loss"]))
    t_learn = time.perf_counter() - t0
    print(f"learning: {LEARN_STEPS} steps on one sub-batch of 16 (T={batch['feats'].shape[1]}), "
          f"fresh init, dropout 0.1, SpecAugment, warmup 10, {t_learn:.2f} s: loss "
          f"{[round(v, 4) for v in losses[:3]]} ... {[round(v, 4) for v in losses[-3:]]}, "
          f"last / first {losses[-1] / losses[0]:.4f} (must be < {LEARN_RATIO})")
    if not np.isfinite(losses).all() or losses[-1] >= LEARN_RATIO * losses[0]:
        fail("training on the card did not learn the sub-batch")
    with torch.no_grad():
        reset_counts()
        after = rec.transcribe(wav16, counts16)
        expect_counts("trained model, kernel path", conformer_block_bf16=len(model.stack.blocks),
                      head_argmax=1)
        twin = EarlyConformer(dataclasses.replace(cfg, fused_block=False)).requires_grad_(False)
        twin.load_state_dict(model.state_dict())
        unfused = Recognizer(twin, decoder, device=dev).transcribe(wav16, counts16)
    wers = [round(wer_pct(refs16, t), 2) for t in after.texts]
    dis = disagreement(after.tokens, after.n_tokens, unfused.tokens, unfused.n_tokens)
    moved = disagreement(before.tokens, before.n_tokens, after.tokens, after.n_tokens)
    pooled = sum(e for e, _ in dis) / sum(t for _, t in dis)
    print(f"trained model (WER per exit {wers}): kernel path vs unfused path, token "
          f"disagreement per exit {[f'{e}/{t}' for e, t in dis]}, pooled "
          f"{100 * pooled:.3f}%; the kernel path before training vs after: "
          f"{[f'{e}/{t}' for e, t in moved]}")
    if pooled > TOKEN_DISAGREE or any(
            w <= SANE_DENSE_WER and e > TOKEN_DISAGREE * t for (e, t), w in zip(dis, wers)):
        fail("the trained model's kernel path disagrees with its unfused path")
    # the tokens are mostly blanks after 40 steps, so the layout is checked
    # itself: the cached kernel layout of every block equals, bit for bit,
    # one folded anew from the trained weights and running statistics, and
    # differs from the one folded before training. Then each block kernel,
    # fed the kernel path's own input, against the plain version of the new
    # layout: the first block, fed the embedding as in phase 2, within
    # phase 2's tolerance (ulps and share), which the layout folded before
    # training must miss; every block within its ulps. Phase 2 calibrated
    # the share on the first block; past it, on a block's bf16 LayerNorm
    # output, more values differ by the same ulps (printed here)
    scfg = model.stack.cfg
    kw = dict(n_heads=scfg.n_heads, kernel_size=scfg.kernel_size, compute_dtype=scfg.dtype,
              residual_dtype=scfg.rdtype, attn_softmax_dtype=scfg.sm_dtype)
    fresh_fig, stale_fig, equal, moved = [], [], [], []
    with torch.no_grad():
        x, _, mask = model.frontend_embed(batch["feats"], batch["feat_lengths"])
        h, lengths = x.contiguous(), mask.sum(1, dtype=torch.int32)
        for blk, f, f_old in zip(model.stack.blocks, model.stack.folded(), stale):
            f_new = kcb.fold_block_params(blk.state_dict(), compute_dtype=scfg.dtype,
                                          quantize=scfg.quant)
            equal.append(f.keys() == f_new.keys() and all(torch.equal(f[k], f_new[k]) for k in f))
            moved.append(any(not torch.equal(f_old[k], f_new[k]) for k in f_new))
            y_k = kcb.conformer_block(f, h, lengths, **kw)
            fresh_fig.append(bf16_figures(y_k, kcb.conformer_block_plain(f_new, h, lengths, **kw)))
            stale_fig.append(bf16_figures(y_k, kcb.conformer_block_plain(f_old, h, lengths, **kw)))
            if not torch.isfinite(y_k.float()).all():
                fail("the trained model's block kernel gave non-finite values")
            h = y_k
    fmt = lambda figs: [f"{u:.1f} ulps/{100 * fr:.3f}%" for _, _, u, fr in figs]
    within = lambda fig: fig[2] <= BLOCK_MAX_ULPS and fig[3] <= BLOCK_DIFFERING
    print(f"trained model's kernel layout: equal bit for bit to one folded anew from the "
          f"trained weights in {sum(equal)} of {len(equal)} blocks, moved from the one "
          f"folded before training in {sum(moved)}; each block kernel vs the plain version "
          f"of the new layout (B={h.shape[0]}, T'={h.shape[1]}; tolerance {BLOCK_MAX_ULPS} "
          f"ulps, and {BLOCK_DIFFERING} of values differing at the first block): "
          f"{fmt(fresh_fig)}; vs the layout folded before training: {fmt(stale_fig)}")
    if not all(equal) or not all(moved):
        fail("the trained model's cached kernel layout is not its weights'")
    if not within(fresh_fig[0]) or any(u > BLOCK_MAX_ULPS for _, _, u, _ in fresh_fig):
        fail("the trained model's block kernel disagrees with the plain version")
    if within(stale_fig[0]):
        fail("the tolerance does not tell the layout before training from the trained one")
    del model, tr, rec, twin, batch, stale

    # -- 8c. throughput of the training loop over the pipeline
    n_warm, n_timed, n_prof = 3, 30, 3
    ds = SyntheticDataset(n_items=tcfg.batch_size * 10, seed=99,
                          min_words=knobs.get("min_words", 18),
                          max_words=knobs.get("max_words", 22),
                          noise=knobs.get("noise", 0.02), noise_hi=knobs.get("noise_hi"),
                          speaker_warp=knobs.get("speaker_warp", 0.0),
                          dur_jitter=knobs.get("dur_jitter", 0.0),
                          amp_jitter=knobs.get("amp_jitter", 0.0))
    # the corpus is made before the run (set-up, as a disk corpus is read):
    # numpy synthesis holds the GIL, ~11 ms an utterance
    t0 = time.perf_counter()
    utts = [ds[i] for i in range(len(ds))]
    t_data = time.perf_counter() - t0
    pipe = Pipeline(utts, tok, acfg, tcfg, workers=8, device=dev)
    model = EarlyConformer(train_profile()).to(dev).init(torch.Generator(device=dev).manual_seed(1))
    warmup = pipe.batches_per_epoch() * tcfg.n_batch_split
    tr = trainer.Trainer(model, tcfg, warmup=warmup)
    it = pipe.epoch(0)
    t0 = time.perf_counter()
    for _ in range(n_warm):
        tr.step(next(it))
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    events, losses, wait = [], [], 0.0
    audio = torch.zeros((), device=dev)
    hop = acfg.hop_length
    t0 = time.perf_counter()
    for _ in range(n_timed):
        t1 = time.perf_counter()
        b = next(it)
        wait += time.perf_counter() - t1
        audio += ((b["feat_lengths"] - 1).clamp_min(0) * b["item_mask"]).sum() * hop
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(tr.step(b)["loss"])
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = [s.elapsed_time(e) for s, e in events]
    peak = torch.cuda.max_memory_allocated(dev)
    audio_s = float(audio) / acfg.sample_rate
    losses = torch.stack(losses).cpu().numpy()
    print(f"train throughput on {card} (flagship width, train profile, "
          f"--batch_size {tcfg.batch_size} --n_batch_split {tcfg.n_batch_split}: "
          f"sub-batches of 16, {n_timed} steps after {n_warm} warm-up steps of {t_warm:.2f} s; "
          f"{len(utts)} utterances made in {t_data:.2f} s before): "
          f"{np.mean(step_ms):.3f} ms per step by CUDA events (min {min(step_ms):.3f}, "
          f"max {max(step_ms):.3f}); wall {1e3 * wall / n_timed:.3f} ms per step; "
          f"{audio_s / wall:.1f} trained audio-s per s ({audio_s:.1f} s of audio); peak "
          f"memory {peak / 2 ** 30:.3f} GiB; host waiting on the pipeline "
          f"{100 * wait / wall:.1f}% of the wall time; loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    if not np.isfinite(losses).all():
        fail("non-finite training loss in the throughput run")
    # the CLI's own path: the Pipeline over the SyntheticDataset itself, whose
    # items are synthesised in the loader threads as the consumer asks for
    # each batch of 64 (every n_batch_split steps)
    lazy = Pipeline(ds, tok, acfg, tcfg, workers=8, device=dev).epoch(1)
    tr.step(next(lazy))
    torch.cuda.synchronize()
    n_lazy, lazy_wait, lazy_losses = 3 * tcfg.n_batch_split, 0.0, []
    t0 = time.perf_counter()
    for _ in range(n_lazy):
        t1 = time.perf_counter()
        b = next(lazy)
        lazy_wait += time.perf_counter() - t1
        lazy_losses.append(tr.step(b)["loss"])
    torch.cuda.synchronize()
    lazy_wall = time.perf_counter() - t0
    lazy.close()
    print(f"train loop over the SyntheticDataset itself (the CLI's path, synthesis in the "
          f"loader threads), {n_lazy} steps: wall {1e3 * lazy_wall / n_lazy:.3f} ms per step; "
          f"host waiting on the pipeline {100 * lazy_wait / lazy_wall:.1f}% of the wall time "
          f"(the pre-made corpus above: {100 * wait / wall:.1f}%)")
    if not np.isfinite(torch.stack(lazy_losses).cpu().numpy()).all():
        fail("non-finite training loss over the SyntheticDataset")
    busy = profile_forward(lambda: tr.step(next(it)), "train step", card, 16, iters=n_prof,
                           top=15, grad=True, shape="sub-batch of 16, ~10 s")
    print(f"train step: the device idles {100 * (1 - busy):.1f}% of the wall time "
          f"(the host's share)")
    # a checkpoint pair, written and read back
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    d = tempfile.mkdtemp(dir=os.path.join(HERE, "build"))
    try:
        tck.save_epoch(d, 0, model, tr.opt)
        back = EarlyConformer(train_profile()).to(dev)
        tr2 = trainer.Trainer(back, tcfg, warmup=warmup)
        tck.load_model_file(back, tck.model_ckpt_path(d, 0))
        tck.load_opt_tree(back, tr2.opt, checkpoint.load_tree(tck.opt_ckpt_path(d, 0)))
        same = (all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                       back.state_dict().values()))
                and all(torch.equal(a, b) for a, b in zip(tr.opt.mu + tr.opt.nu,
                                                          tr2.opt.mu + tr2.opt.nu))
                and tr2.step_count == tr.step_count)
        sizes = [os.path.getsize(p) for p in (tck.model_ckpt_path(d, 0), tck.opt_ckpt_path(d, 0))]
    finally:
        shutil.rmtree(d)
    print(f"checkpoint pair (mod {sizes[0]} bytes, lr {sizes[1]} bytes, step "
          f"{tr.step_count}) read back equal: {same}")
    if not same:
        fail("the checkpoint pair did not read back equal")


def aed_phase(dev, card, knobs, reset_counts, read_counts, corp, tmp) -> dict:
    """Phase 12: the AED mode at the flagship's widths (a seeded
    `full_conformer`: d 256, 8 heads, ffn 2048, k 31, 6 x 2 blocks,
    AED_DEC_LAYERS decoder layers per exit, BPE-256). (a) One joint-loss train step on
    the card against the CPU in float32; (b) LEARN_STEPS steps in the train
    profile on one sub-batch of 16 must learn; (c) the trained model served
    through `python -m early_exit_tpu_torch.inference --decoder_mode aed
    --fused_block true` over phase 9's corpus, without and with
    --rescore_ctc_weight 0.5, with launch counts (12 block launches a
    batch, no head launch); the float32 beam and the rescoring's CTC lane
    scores card against CPU; the bf16 beam on the kernel-encoded memory
    against the plain-version-encoded memory; times. Returns the CLI's
    block launches and batches (one pass)."""
    import copy
    import dataclasses
    import io

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from early_exit_tpu_torch import checkpoint, inference, interop
    from early_exit_tpu_torch.cli import get_args
    from early_exit_tpu_torch.configs import AudioConfig, ModelConfig, TrainConfig, train_profile
    from early_exit_tpu_torch.data import text
    from early_exit_tpu_torch.data.pipeline import Pipeline
    from early_exit_tpu_torch.data.synthetic import synth_batch
    from early_exit_tpu_torch.decoding import aed_beam, rescore
    from early_exit_tpu_torch.decoding.lexicon import edit_distance
    from early_exit_tpu_torch.models.full_conformer import FullConformer
    from early_exit_tpu_torch.ops.kernels import attention as katt
    from early_exit_tpu_torch.ops.kernels import conformer_block as kcb
    from early_exit_tpu_torch.optim.noam import global_norm
    from early_exit_tpu_torch.serving.recognizer import wer_pct
    from early_exit_tpu_torch.tokenizer import load_tokenizer
    from early_exit_tpu_torch.training import checkpoint as tck
    from early_exit_tpu_torch.training import trainer

    t_phase = time.perf_counter()
    tok = load_tokenizer(checkpoint.bound_tokenizer(checkpoint.load_calib()))
    acfg, tcfg = AudioConfig(), TrainConfig(decoder_mode="aed")
    cpu_pipe = Pipeline([], tok, acfg, tcfg, device="cpu")

    def requests(n, seed):
        """A sub-batch of n requests of bench_eval's distribution, mel on
        the CPU."""
        wav, counts, refs = synth_batch(knobs, n, seed)
        items = []
        for i in range(n):
            label = text.clean_train_label(refs[i])
            items.append((wav[i, :counts[i]], text.encode_target(label, tok), label))
        host = {k: torch.from_numpy(v) for k, v in cpu_pipe.host_subbatch(items).items()}
        return cpu_pipe.to_device(host)

    # -- 12a. one joint-loss step, card against CPU, float32, same features
    f32 = ModelConfig(model_type="full_conformer", compute_dtype="float32", drop_prob=0.0,
                      n_dec_layers=AED_DEC_LAYERS)
    seeded = FullConformer(f32).init(torch.Generator().manual_seed(12))
    n_params = sum(p.numel() for p in seeded.parameters())
    batch_cpu = requests(4, seed=1212)
    batch_dev = {k: v.to(dev) for k, v in batch_cpu.items()}

    def one_step(device, batch):
        model = copy.deepcopy(seeded).requires_grad_(True).to(device)
        total, per_exit, _ = trainer.loss_fn(model, tcfg, batch)
        params = list(model.parameters())
        grads = torch.autograd.grad(total, params)
        leaves = {k: np.asarray(v, np.float64) for k, v in
                  _flat(interop.jax_tree(model, dict(zip(params, grads)))).items()}
        return float(total.detach()), float(global_norm(grads)), leaves

    t0 = time.perf_counter()
    on_card = one_step(dev, batch_dev)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = one_step(torch.device("cpu"), batch_cpu)
    t_cpu = time.perf_counter() - t0
    rel = {k: np.linalg.norm(on_card[2][k] - h) / np.linalg.norm(h)
           for k, h in host[2].items() if k not in AED_ZERO_GRAD_LEAVES}
    zero = max(max(np.linalg.norm(on_card[2][k]), np.linalg.norm(host[2][k])) / host[1]
               for k in AED_ZERO_GRAD_LEAVES)
    worst = max(rel, key=rel.get)
    d_loss = abs(on_card[0] - host[0]) / abs(host[0])
    d_norm = abs(on_card[1] - host[1]) / host[1]
    print(f"12a. AED train step, seeded full_conformer ({n_params:,} parameters), float32, "
          f"TF32 off, B=4, T={batch_cpu['feats'].shape[1]}, L={batch_cpu['labels'].shape[1]}, "
          f"card vs CPU: joint loss {on_card[0]:.6f} vs {host[0]:.6f} (relative "
          f"{d_loss:.3e}); grad_norm {on_card[1]:.6f} vs {host[1]:.6f} ({d_norm:.3e}); "
          f"worst leaf relative L2 {rel[worst]:.3e} ({worst}); zero-gradient leaves at most "
          f"{zero:.3e} of the norm; {t_dev:.2f} s on the card, {t_cpu:.2f} s on the CPU")
    if not np.isfinite([on_card[0], on_card[1]]).all():
        fail("non-finite AED train step on the card")
    if (d_loss > TRAIN_F32_LOSS or d_norm > TRAIN_F32_NORM or rel[worst] > TRAIN_F32_LEAF
            or zero > ZERO_GRAD_SHARE):
        fail("the AED train step on the card disagrees with the CPU")
    del seeded, batch_cpu, batch_dev, on_card, host

    # -- 12b. a fresh model learns one sub-batch (joint loss, train profile)
    model = FullConformer(train_profile(model_type="full_conformer",
                                        n_dec_layers=AED_DEC_LAYERS)).to(dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    batch = {k: v.to(dev) for k, v in requests(16, seed=4343).items()}
    tr = trainer.Trainer(model, dataclasses.replace(tcfg, specaugment=True), warmup=10)
    losses = []
    t0 = time.perf_counter()
    for _ in range(LEARN_STEPS):
        losses.append(float(tr.step(batch)["loss"]))
    t_learn = time.perf_counter() - t0
    print(f"12b. AED learning: {LEARN_STEPS} joint-loss steps on one sub-batch of 16 "
          f"(T={batch['feats'].shape[1]}), fresh init, train profile, dropout 0.1, "
          f"SpecAugment, warmup 10, {t_learn:.2f} s ({1e3 * t_learn / LEARN_STEPS:.1f} ms a "
          f"step of wall): loss {[round(v, 4) for v in losses[:3]]} ... "
          f"{[round(v, 4) for v in losses[-3:]]}, last / first {losses[-1] / losses[0]:.4f} "
          f"(must be < {LEARN_RATIO})")
    if not np.isfinite(losses).all() or losses[-1] >= LEARN_RATIO * losses[0]:
        fail("AED training on the card did not learn the sub-batch")
    ck_dir = os.path.join(tmp, "aed_ck")
    tck.save_epoch(ck_dir, 0, model)
    del model, tr, batch

    # -- 12c. the trained model through the inference CLI, both modes
    argv = ["--decoder_mode", "aed", "--load_model_path", tck.model_ckpt_path(ck_dir, 0),
            "--data_root", corp["root"], "--eval_splits", "test-clean",
            "--fused_block", "true", "--beam_size", str(AED_BEAM),
            "--n_dec_layers", str(AED_DEC_LAYERS)]

    def cli(a):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            inference.main(a)
        return buf.getvalue()

    n_batches = [0]
    encode = FullConformer.encode

    def counted(self, *a, **k):
        n_batches[0] += 1
        return encode(self, *a, **k)

    FullConformer.encode = counted
    outs, passes = {}, {}
    try:
        for mode, extra in (("beam", []), ("rescored", ["--rescore_ctc_weight", "0.5"])):
            n_batches[0] = 0
            reset_counts()
            t0 = time.perf_counter()
            out = cli(argv + extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = read_counts()
            outs[mode] = out
            blocks = got["conformer_block_bf16"]
            others = {k: v for k, v in got.items() if k != "conformer_block_bf16" and v}
            wers = [ln.split(": ", 1)[1] for ln in out.splitlines() if " WER exit " in ln]
            n_out = sum("BEAM_OUT_" in ln for ln in out.splitlines())
            passes[mode] = (blocks, n_batches[0], wall)
            print(f"12c. AED CLI ({mode}): launches {got} over {n_batches[0]} batches; "
                  f"{n_out} BEAM_OUT lines; WER per exit {wers}; {corp['audio_s']:.1f} s of "
                  f"audio in {wall:.3f} s of wall = {corp['audio_s'] / wall:.1f} audio-s/s "
                  f"on {card}")
            if others or blocks != 12 * n_batches[0]:
                fail(f"AED CLI ({mode}): {blocks} block launches over {n_batches[0]} "
                     f"batches and {others}, expected 12 a batch and nothing else")
            if n_out != 6 * len(corp["corpus"]) or len(wers) != 6:
                fail(f"AED CLI ({mode}): {n_out} BEAM_OUT lines, {len(wers)} WER lines")
    finally:
        FullConformer.encode = encode

    # the models and one batch of the corpus, as the CLI builds them
    args, mcfg, tcfg_i, acfg_i, tk = get_args(argv, mode="infer")
    model_k = inference.load_model(args, mcfg, dev)
    args32, mcfg32, _, _, _ = get_args(argv + ["--fused_block", "false", "--compute_dtype",
                                               "float32", "--attn_softmax_dtype", "float32"],
                                       mode="infer")
    m32 = inference.load_model(args32, mcfg32, dev)
    pipe = Pipeline(corp["corpus"], tk, acfg_i, tcfg_i, shuffle=False, infer_mode=True,
                    device=dev)
    batch = next(iter(pipe.epoch(0)))
    feats, flen = batch["feats"], batch["feat_lengths"]
    refs = [r for r in inference._references(batch, tk)[0]]

    def limits(fl):
        lens = [inference._aed_max_lengths(int(n)) for n in fl.cpu().tolist()]
        return (inference._bucket(max(m for m, _ in lens)),
                torch.tensor([mn for _, mn in lens]))

    def best_ids(out):
        toks, lens, _, best = (t.cpu() for t in out)
        return [aed_beam.trim_hypothesis(toks[r][best[r]], lens[r][best[r]],
                                         eos_id=mcfg.eos_id, bos_id=mcfg.bos_id)
                for r in range(toks.shape[0])]

    # the float32 beam and the rescoring, card against CPU, the same memory
    n = min(AED_CMP_UTTS, feats.shape[0])
    max_len, min_lens = limits(flen[:n])
    m32_cpu = copy.deepcopy(m32).to("cpu")
    t0 = time.perf_counter()
    with torch.no_grad():
        hid32, sub32 = m32.encode(feats[:n], flen[:n])
        for e in AED_CMP_EXITS:
            kw = dict(n_exit=e, beam_size=AED_BEAM, max_length=max_len)
            a = aed_beam.beam_search_exit_batch(m32, hid32[e - 1], min_lens, **kw)
            b = aed_beam.beam_search_exit_batch(m32_cpu, hid32[e - 1].cpu(), min_lens, **kw)
            ia, ib = best_ids(a), best_ids(b)
            sa = a[2].cpu().gather(1, a[3].cpu()[:, None])[:, 0]
            sb = b[2].gather(1, b[3][:, None])[:, 0]
            d_s = float(((sa - sb).abs() / sb.abs()).max())
            lanes = float((a[0].cpu() == b[0]).all(-1).float().mean())
            lp = m32.apply_heads(hid32[e - 1:e])[0]
            ra = rescore.rescore_batch(lp, sub32, *a[:3], ctc_weight=0.5)
            rb = rescore.rescore_batch(lp.cpu(), sub32.cpu(), *(t.cpu() for t in a[:3]),
                                       ctc_weight=0.5)
            d_c = float(((ra[2].cpu() - rb[2]).abs() / rb[2].abs()).max())
            print(f"12c. float32 beam (K={AED_BEAM}, max_length {max_len}), exit {e}, "
                  f"{n} utterances, card vs CPU on the card's memory: best hypotheses equal "
                  f"on {sum(x == y for x, y in zip(ia, ib))}/{n} rows (lengths "
                  f"{[len(x) for x in ia]}), best scores' max relative difference {d_s:.3e}, "
                  f"lanes equal {100 * lanes:.0f}%; rescoring's CTC lane scores (in "
                  f"[{float(rb[2].min()):.4g}, {float(rb[2].max()):.4g}]) max relative "
                  f"difference {d_c:.3e}, chosen lanes {ra[0].cpu().tolist()} vs "
                  f"{rb[0].tolist()} (the beam's {a[3].cpu().tolist()})")
            if ia != ib or d_s > AED_RTOL:
                fail(f"the float32 beam at exit {e} differs between the card and the CPU")
            if d_c > AED_RTOL or not torch.equal(ra[0].cpu(), rb[0]):
                fail(f"the rescoring at exit {e} differs between the card and the CPU")
    print(f"12c. float32 comparisons: {time.perf_counter() - t0:.1f} s")
    del m32, m32_cpu, hid32

    # bf16: the beam on the kernel-encoded memory against the plain-encoded
    max_len, min_lens = limits(flen)
    with torch.no_grad():
        reset_counts()
        hk, sub_k = model_k.encode(feats, flen)
        got = read_counts()
        if got["conformer_block_bf16"] != 12:
            fail(f"AED encode: {got}, expected 12 block launches")
        with plain_versions(kcb, katt):
            hp, _ = model_k.encode(feats, flen)
        t_enc = cuda_ms(lambda: model_k.encode(feats, flen), 5, 1)
        beam_ms, rows_eq, edits, total, wers_k = [], 0, 0, 0, []
        real = [i for i, r in enumerate(refs) if r is not None]
        for e in range(1, 7):
            kw = dict(n_exit=e, beam_size=AED_BEAM, max_length=max_len)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            ok = aed_beam.beam_search_exit_batch(model_k, hk[e - 1], min_lens, **kw)
            end.record()
            torch.cuda.synchronize()
            beam_ms.append(start.elapsed_time(end))
            op = aed_beam.beam_search_exit_batch(model_k, hp[e - 1], min_lens, **kw)
            ik, ip = best_ids(ok), best_ids(op)
            for i in real:
                rows_eq += ik[i] == ip[i]
                edits += edit_distance(ik[i], ip[i])
                total += max(len(ip[i]), 1)
            hyps = [inference._hyp(tk, None, ik[i]) for i in real]
            wers_k.append(round(wer_pct([refs[i] for i in real], hyps), 2))
        lp = model_k.apply_heads(hk)
        t_res = cuda_ms(lambda: rescore.rescore_batch(lp[-1], sub_k, *ok[:3], ctc_weight=0.5),
                        3, 1)
        trace = os.path.join(tmp, "aed_trace.json")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            aed_beam.beam_search_exit_batch(model_k, hk[5], min_lens, n_exit=6,
                                            beam_size=AED_BEAM, max_length=max_len)
            torch.cuda.synchronize()
            wall_p = time.perf_counter() - t1
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            evs = [ev for ev in json.load(f)["traceEvents"]
                   if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        busy = sum(ev.get("dur", 0) for ev in evs) / 1e6
    B = feats.shape[0]
    rates = ", ".join(f"{m} {corp['audio_s'] / w:.1f}" for m, (_, _, w) in passes.items())
    print(f"12c. bf16 beam (K={AED_BEAM}, max_length {max_len}) on {len(real)} utterances of "
          f"the corpus (B={B}): kernel-encoded vs plain-encoded memory, best hypotheses "
          f"equal on {rows_eq}/{6 * len(real)} (exit, row) pairs, {edits}/{total} tokens "
          f"differ; AED WER per exit (kernel-encoded) {wers_k}")
    print(f"12c. AED times on {card} (B={B}, T'={hk.shape[2]}, CUDA events): encode "
          f"{t_enc:.3f} ms (12 block launches); beam per exit "
          f"{[round(t, 1) for t in beam_ms]} ms ({max_len} steps, "
          f"{sum(beam_ms) / (6 * max_len):.3f} ms a step); the rescoring at exit 6 "
          f"{t_res:.3f} ms; the CLI {rates} audio-s/s")
    print(f"12c. profile of one beam (exit 6, B={B}, K={AED_BEAM}, {max_len} steps, "
          f"torch.profiler): {len(evs)} device operations = {len(evs) / max_len:.1f} a step "
          f"({len(evs) / (max_len * mcfg.n_dec_layers):.1f} a step and decoder layer); device "
          f"busy {busy:.3f} s of {wall_p:.3f} s ({100 * busy / wall_p:.1f}%)")
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s")
    blocks, batches, _ = passes["beam"]
    return {"launches": blocks, "batches": batches}


def zoo_phase(dev, card, knobs, reset_counts, read_counts, corp, tmp, flagship,
              wav, counts) -> dict:
    """Phase 13: the model zoo at the flagship's widths (d 256, 8 heads,
    ffn 2048, k 31, BPE-256): the splitformer (6 exits x 2 blocks and its
    two branch blocks) and the early_zipformer (19 x 1 blocks, one exit).
    (a) One float32 train step of each, seeded, on the card against the
    CPU (the zipformer's also against a float64 yardstick); (b) ZOO_STEPS
    steps of `python -m early_exit_tpu_torch.train` each on the synthetic
    corpus must learn; (c) checkpoints of the flagship's trained blocks in
    the zoo's layouts through
    `python -m early_exit_tpu_torch.inference --fused_block true` over
    phase 9's corpus, with launch counts, the float32 CLI card against CPU
    and the bf16 kernel path against the plain-version path; (d) the block
    kernel at each of the zipformer's six stacks' inputs and the head
    kernel at E=1, B=128 x 10 s; (e) the splitformer's gate on the card;
    (f) the four legacy models, card against CPU; times. Returns the
    launches of the CLIs' passes."""
    import copy
    import io

    import numpy as np
    import torch
    from early_exit_tpu_torch import checkpoint, inference, interop, train
    from early_exit_tpu_torch.cli import get_args
    from early_exit_tpu_torch.configs import AudioConfig, ModelConfig, TrainConfig
    from early_exit_tpu_torch.data import text
    from early_exit_tpu_torch.data.librispeech import LibriSpeechDataset
    from early_exit_tpu_torch.data.pipeline import Pipeline
    from early_exit_tpu_torch.data.synthetic import synth_batch
    from early_exit_tpu_torch.decoding.lexicon import edit_distance
    from early_exit_tpu_torch.models import legacy_transformer as lt
    from early_exit_tpu_torch.models.early_exit_gate import exit_confidence, gated_apply
    from early_exit_tpu_torch.models.registry import build_model
    from early_exit_tpu_torch.ops import ctc, frontend
    from early_exit_tpu_torch.ops.kernels import attention as katt
    from early_exit_tpu_torch.ops.kernels import conformer_block as kcb
    from early_exit_tpu_torch.ops.kernels import head_argmax as kha
    from early_exit_tpu_torch.optim.noam import global_norm
    from early_exit_tpu_torch.tokenizer import load_tokenizer
    from early_exit_tpu_torch.training import checkpoint as tck
    from early_exit_tpu_torch.training import trainer

    t_phase = time.perf_counter()
    tok = load_tokenizer(checkpoint.bound_tokenizer(checkpoint.load_calib()))
    acfg, tcfg = AudioConfig(), TrainConfig()
    cpu_pipe = Pipeline([], tok, acfg, tcfg, device="cpu")
    shapes = {"splitformer": dict(model_type="splitformer"),
              "early_zipformer": dict(model_type="early_zipformer", n_enc_exits=19,
                                      n_enc_layers_per_exit=1)}
    zoo = {name: [a for k, v in over.items() for a in (f"--{k}", str(v))]
           for name, over in shapes.items()}
    n_blocks = {"splitformer": 12, "early_zipformer": 19}
    n_out = {"splitformer": 6, "early_zipformer": 1}

    def requests(n, seed):
        """A sub-batch of n requests of bench_eval's distribution, mel on
        the CPU."""
        w, c, refs = synth_batch(knobs, n, seed)
        items = []
        for i in range(n):
            label = text.clean_train_label(refs[i])
            items.append((w[i, :c[i]], text.encode_target(label, tok), label))
        host = {k: torch.from_numpy(v) for k, v in cpu_pipe.host_subbatch(items).items()}
        return cpu_pipe.to_device(host)

    def cli(main, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv)
        return buf.getvalue()

    # -- 13a. one float32 step of each family, card against CPU; the
    # zipformer's also against a float64 yardstick on the CPU
    batch_cpu = requests(4, seed=1313)
    batch_dev = {k: v.to(dev) for k, v in batch_cpu.items()}
    for name in zoo:
        f32 = ModelConfig(compute_dtype="float32", attn_softmax_dtype="float32",
                          drop_prob=0.0, **shapes[name])
        seeded = build_model(f32).init(torch.Generator().manual_seed(13))
        n_params = sum(p.numel() for p in seeded.parameters())

        def one_step(device, batch, wide=False):
            model = copy.deepcopy(seeded).requires_grad_(True).to(device)
            if wide:
                model = model.double()
                batch = {k: v.double() if v.is_floating_point() else v
                         for k, v in batch.items()}
            total, _, new_state = trainer.loss_fn(model, tcfg, batch)
            params = list(model.parameters())
            grads = torch.autograd.grad(total, params)
            leaves = {k: np.asarray(v, np.float64) for k, v in
                      _flat(interop.jax_tree(model, dict(zip(params, grads)))).items()}
            bn = {k: np.asarray(v, np.float64)
                  for k, v in _flat(interop.numpy_tree(new_state)).items()}
            return float(total.detach()), float(global_norm(grads)), leaves, bn

        t0 = time.perf_counter()
        on_card = one_step(dev, batch_dev)
        torch.cuda.synchronize()
        t_dev = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = one_step(torch.device("cpu"), batch_cpu)
        t_cpu = time.perf_counter() - t0
        zero_keys = [k for k in host[2] if k.endswith(ZOO_ZERO_GRAD)]

        def gaps(a, ref):
            """(relative norm gap, relative L2 of each leaf) of run a to ref."""
            return abs(a[1] - ref[1]) / ref[1], {
                k: np.linalg.norm(a[2][k] - h) / np.linalg.norm(h)
                for k, h in ref[2].items() if k not in zero_keys}

        d_norm, rel = gaps(on_card, host)
        zero = max(max(np.linalg.norm(on_card[2][k]), np.linalg.norm(host[2][k])) / host[1]
                   for k in zero_keys)
        bn = max(float(np.abs(on_card[3][k] - h).max()) / max(1.0, float(np.abs(h).max()))
                 for k, h in host[3].items())
        worst = max(rel, key=rel.get)
        d_loss = abs(on_card[0] - host[0]) / abs(host[0])
        norm_bound = ZIP_F32_NORM if name == "early_zipformer" else TRAIN_F32_NORM
        print(f"13a. {name} train step, seeded ({n_params:,} parameters), float32, TF32 "
              f"off, dropout 0, no SpecAugment, B=4, T={batch_cpu['feats'].shape[1]}, card "
              f"vs CPU: loss {on_card[0]:.6f} vs {host[0]:.6f} (relative {d_loss:.3e}); "
              f"grad_norm {on_card[1]:.6f} vs {host[1]:.6f} (relative gap {d_norm:.3e}, "
              f"held {norm_bound:g}); worst leaf relative L2 {rel[worst]:.3e} ({worst}); "
              f"zero-gradient leaves at most {zero:.3e} of the norm; BN running statistics "
              f"({len(host[3])} leaves) max|d| {bn:.3e}; {t_dev:.2f} s on the card, "
              f"{t_cpu:.2f} s on the CPU")
        if not np.isfinite([on_card[0], on_card[1]]).all():
            fail(f"non-finite {name} train step on the card")
        if (d_loss > TRAIN_F32_LOSS or d_norm > norm_bound or rel[worst] > TRAIN_F32_LEAF
                or zero > ZERO_GRAD_SHARE or bn > TRAIN_F32_BN):
            fail(f"the {name} train step on the card disagrees with the CPU")
        if name == "early_zipformer":
            # C4: where each float32 run lies from the same step in float64,
            # whether cuDNN's choice of algorithm moves the card's, and what
            # is left of each with the CTC loss alone taken in float64
            t0 = time.perf_counter()
            with float64_math():
                wide = one_step(torch.device("cpu"), batch_cpu, wide=True)
            t_wide = time.perf_counter() - t0
            torch.backends.cudnn.deterministic = True
            try:
                det = one_step(dev, batch_dev)
            finally:
                torch.backends.cudnn.deterministic = False
            with float64_ctc():
                runs = {"card": on_card, "CPU": host, "card, cudnn deterministic": det,
                        "card, its CTC loss in float64": one_step(dev, batch_dev),
                        "CPU, its CTC loss in float64": one_step(torch.device("cpu"),
                                                                 batch_cpu)}
            for what, run in runs.items():
                g_norm, g_rel = gaps(run, wide)
                top = sorted(g_rel, key=g_rel.get, reverse=True)
                print(f"13a. {name}, float32 {what} vs the float64 step on the CPU "
                      f"({t_wide:.1f} s): loss relative {abs(run[0] - wide[0]) / wide[0]:.3e}, "
                      f"grad_norm relative gap {g_norm:.3e}; leaves' relative L2 median "
                      f"{g_rel[top[len(top) // 2]]:.3e}, the 10 worst: " + ", ".join(
                          f"{k} {g_rel[k]:.3e}" for k in top[:10]))
            print(f"13a. {name}, card with cudnn deterministic vs CPU: grad_norm relative "
                  f"gap {gaps(det, host)[0]:.3e} (the default card's {d_norm:.3e})")
            # the CTC loss's gradient alone, on the float64 model's log-probs
            with float64_math():
                m64 = copy.deepcopy(seeded).double()
                lp64 = m64.apply(batch_cpu["feats"].double(), batch_cpu["feat_lengths"])[0]
            ctc_grads = {}
            for where, device, dtype in (("CPU", torch.device("cpu"), torch.float64),
                                         ("card", dev, torch.float32),
                                         ("CPU", torch.device("cpu"), torch.float32)):
                x = lp64.detach()[0].to(device, dtype).requires_grad_(True)
                with float64_math() if dtype == torch.float64 else contextlib.nullcontext():
                    nll = ctc.ctc_loss(x, torch.full((x.shape[0],), x.shape[1], device=device),
                                       batch_cpu["labels"].to(device),
                                       batch_cpu["label_lengths"].to(device), reduction="none")
                    nll.sum().backward()
                ctc_grads[(where, dtype)] = (nll.detach().double().cpu(),
                                             x.grad.double().cpu())
            nll_ref, g_ref = ctc_grads[("CPU", torch.float64)]
            print(f"13a. {name}, the CTC loss's gradient alone on the float64 step's "
                  f"log-probs (B=4, T''={lp64.shape[2]}, NLL "
                  f"{[round(v, 1) for v in nll_ref.tolist()]}), float32 "
                  f"vs float64 on the CPU, relative L2: " + ", ".join(
                      f"{where} {float((g - g_ref).norm() / g_ref.norm()):.3e}"
                      for (where, dt), (_, g) in ctc_grads.items() if dt == torch.float32))
        del seeded, on_card, host
    del batch_cpu, batch_dev

    # -- 13b. ZOO_STEPS steps of the training CLI on the synthetic corpus
    ckpt, learn = {}, {}
    step = trainer.Trainer.step
    for name in zoo:
        ck_dir = os.path.join(tmp, f"zoo_{name}")
        argv = (["--decoder_mode", "ctc", "--synthetic_data", "true", "--batch_size",
                 str(ZOO_BATCH), "--n_batch_split", "1", "--n_epochs",
                 str(ZOO_STEPS * ZOO_BATCH // 64), "--warmup", "10", "--seed", "13",
                 "--save_model_dir", ck_dir, "--log_dir", ck_dir + "_runs"] + zoo[name])
        losses, events = [], []

        def timed(self, batch, _losses=losses, _events=events):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = step(self, batch)
            b.record()
            _events.append((a, b))
            _losses.append(out["loss"])
            return out

        trainer.Trainer.step = timed
        torch.cuda.reset_peak_memory_stats()
        try:
            t0 = time.perf_counter()
            out = cli(train.main, argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            trainer.Trainer.step = step
        losses = [float(v) for v in losses]
        ms = [a.elapsed_time(b) for a, b in events]
        epoch = tck.latest_epoch(ck_dir)
        ckpt[name] = tck.model_ckpt_path(ck_dir, epoch)
        count = [ln for ln in out.splitlines() if "trainable parameters" in ln]
        learn[name] = (losses, ms, wall)
        print(f"13b. {name}: `python -m early_exit_tpu_torch.train "
              f"{' '.join(argv).replace(tmp, '<tmp>')}`: "
              f"{count[0] if count else 'no parameter line'}; {len(losses)} steps of "
              f"{ZOO_BATCH} requests; loss {[round(v, 3) for v in losses[:3]]} ... "
              f"{[round(v, 3) for v in losses[-3:]]}, last / first "
              f"{losses[-1] / losses[0]:.4f} (must be < {LEARN_RATIO}); "
              f"{np.mean(ms[2:]):.1f} ms a step on the card (CUDA events, steps 3..), "
              f"{1e3 * wall / len(losses):.1f} ms a step of the CLI's wall ({wall:.1f} s, "
              f"data synthesis and checkpoints included); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; checkpoint epoch {epoch}; "
              f"on {card}")
        if len(losses) != ZOO_STEPS:
            fail(f"{name}: the training CLI took {len(losses)} steps, not {ZOO_STEPS}")
        if not np.isfinite(losses).all() or losses[-1] >= LEARN_RATIO * losses[0]:
            fail(f"{name}: the training CLI did not learn")

    # -- 13c. the inference CLI on checkpoints of the flagship's trained
    # blocks in the zoo's layouts (`interop.flagship_zoo_tree`): 13b's
    # models, 40 steps from their init, emit ~2 tokens an utterance, too few
    # for the token checks below; these emit 10 to 50
    flagship_ckpt = {}
    for name in zoo:
        params, state = interop.flagship_zoo_tree(name)
        flagship_ckpt[name] = os.path.join(tmp, f"zoo_{name}_flagship")
        checkpoint.save_tree({"params": params, "model_state": state}, flagship_ckpt[name])
    launches, f32_launches, rates = {}, {}, {}
    small = os.path.join(tmp, "cpu8")
    f32_flags = ["--compute_dtype", "float32", "--attn_softmax_dtype", "float32"]
    n_batches = [0]
    exit_outputs = inference.exit_outputs

    def counted(*a, **k):
        n_batches[0] += 1
        return exit_outputs(*a, **k)

    def per_exit_ids(out):
        ids = {}
        for ln in out.splitlines():
            if "BEAM_OUT_" in ln:
                e = int(ln.split("BEAM_OUT_")[1].split(":")[0])
                ids.setdefault(e, []).append(tok.encode_as_ids(
                    ln.split(" : ", 1)[1] if " : " in ln else ""))
        return ids

    def token_gaps(a, b):
        """Per exit (edits, tokens) of a's transcripts against b's."""
        ia, ib = per_exit_ids(a), per_exit_ids(b)
        if sorted(ia) != sorted(ib) or any(len(ia[e]) != len(ib[e]) for e in ia):
            fail("two CLI passes print different BEAM_OUT lines")
        return {e: (sum(edit_distance(x, y) for x, y in zip(ia[e], ib[e])),
                    sum(max(len(y), 1) for y in ib[e])) for e in sorted(ib)}

    @contextlib.contextmanager
    def plain_path():
        """The block and head wrappers run their plain versions."""
        saved = inference.head_argmax
        inference.head_argmax = kha.head_argmax_plain
        try:
            with plain_versions(kcb, katt):
                yield
        finally:
            inference.head_argmax = saved

    inference.exit_outputs = counted
    try:
        for name in zoo:
            base = (["--decoder_mode", "ctc", "--load_model_path", flagship_ckpt[name],
                     "--eval_splits", "test-clean", "--fused_block", "true"] + zoo[name])
            n_batches[0] = 0
            reset_counts()
            t0 = time.perf_counter()
            out = cli(inference.main, base + ["--data_root", corp["root"]])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = read_counts()
            nb, L = n_batches[0], n_blocks[name]
            blocks, heads = got["conformer_block_bf16"], got["head_argmax"]
            others = {k: v for k, v in got.items()
                      if k not in ("conformer_block_bf16", "head_argmax") and v}
            wers = [ln.split(": ", 1)[1] for ln in out.splitlines() if " WER exit " in ln]
            n_lines = sum("BEAM_OUT_" in ln for ln in out.splitlines())
            launches[name] = (blocks, heads, nb)
            rates[name] = corp["audio_s"] / wall
            print(f"13c. {name} inference CLI, bf16, --fused_block true: launches {got} over "
                  f"{nb} sub-batches ({blocks / max(nb, 1):.0f} block and "
                  f"{heads / max(nb, 1):.0f} head launches a sub-batch, expected {L} and 1); "
                  f"{n_lines} BEAM_OUT lines; WER per exit {wers}; {corp['audio_s']:.1f} s of "
                  f"audio in {wall:.3f} s = {rates[name]:.1f} audio-s/s on {card}")
            if others or blocks != L * nb or heads != nb or nb == 0:
                fail(f"{name} CLI: {blocks} block and {heads} head launches over {nb} "
                     f"sub-batches and {others}, expected {L} and 1 a sub-batch")
            if n_lines != n_out[name] * len(corp["corpus"]) or len(wers) != n_out[name]:
                fail(f"{name} CLI: {n_lines} BEAM_OUT lines and {len(wers)} WER lines")
            # bf16: the kernel path against the plain-version path, the same CLI
            with plain_path():
                out_p = cli(inference.main, base + ["--data_root", corp["root"]])
            gaps = token_gaps(out, out_p)
            print(f"13c. {name}, bf16 kernel path vs plain-version path on the card "
                  f"(reported, not held: the flagship's blocks in another layout "
                  f"transcribe at 30-150% WER, where two bf16 schedules part at near "
                  f"ties): edits / tokens compared per exit "
                  f"{[f'{e}/{t}' for e, t in gaps.values()]} (predicted <= 5% at every exit)")
            # float32 (row 1c), card against CPU on 8 utterances
            n_batches[0] = 0
            reset_counts()
            out_c = cli(inference.main, base + ["--data_root", small] + f32_flags)
            got = read_counts()
            f32_launches[name] = got["conformer_block_f32"]
            if got["conformer_block_f32"] != L * n_batches[0] or any(
                    v for k, v in got.items() if k != "conformer_block_f32"):
                fail(f"{name} float32 CLI: launches {got} over {n_batches[0]} sub-batches, "
                     f"expected {L} float32 block launches a sub-batch and nothing else")
            t0 = time.perf_counter()
            out_h = cli(inference.main, base + ["--data_root", small, "--device", "cpu"]
                        + f32_flags)
            gaps = token_gaps(out_c, out_h)
            print(f"13c. {name}, float32 (--compute_dtype float32 --attn_softmax_dtype "
                  f"float32), card vs CPU on 8 utterances: launches {got}; edits / tokens "
                  f"compared per exit {[f'{e}/{t}' for e, t in gaps.values()]} (held <= 1% "
                  f"at every exit); the CPU pass {time.perf_counter() - t0:.1f} s")
            if any(e > TOKEN_DISAGREE * t for e, t in gaps.values()):
                fail(f"{name}: the float32 CLI on the card disagrees with the CPU by > 1%")
            # the same forward frame by frame: the CLI's exit_outputs on one
            # sub-batch's features
            args, mcfg, tcfg_i, acfg_i, tk = get_args(base + f32_flags, mode="infer")
            m_card = inference.load_model(args, mcfg, dev)
            m_cpu = copy.deepcopy(m_card).to("cpu")
            pipe = Pipeline(LibriSpeechDataset(small, "test-clean"), tk, acfg_i, tcfg_i,
                            shuffle=False, infer_mode=True, device="cpu")
            b = next(iter(pipe.epoch(0)))
            ids_h, _, sub_h = exit_outputs(m_cpu, b["feats"], b["feat_lengths"],
                                           greedy=True, timestamps=False)
            ids_c = exit_outputs(m_card, b["feats"].to(dev), b["feat_lengths"].to(dev),
                                 greedy=True, timestamps=False)[0].cpu()
            valid = torch.arange(ids_h.shape[2])[None, :] < sub_h[:, None]
            frames = [float((ids_c[e] != ids_h[e])[valid].float().mean())
                      for e in range(ids_h.shape[0])]
            blank = float((ids_h[:, valid] == mcfg.blank_id).float().mean())
            print(f"13c. {name}, float32, card vs CPU frame by frame ({int(valid.sum())} "
                  f"valid frames of {b['feats'].shape[0]} rows, {100 * blank:.1f}% blank): "
                  f"argmax ids differing per exit {[round(f, 5) for f in frames]} (held <= 1%)")
            if max(frames) > TOKEN_DISAGREE:
                fail(f"{name}: the float32 forward on the card disagrees with the CPU's "
                     f"frame ids by > 1%")
            del m_card, m_cpu
    finally:
        inference.exit_outputs = exit_outputs

    # the models as the CLI builds them, and phase 3's requests (B=128, 10 s)
    models = {}
    for name in zoo:
        args, mcfg, _, acfg_i, _ = get_args(["--decoder_mode", "ctc", "--load_model_path",
                                             ckpt[name], "--fused_block", "true"] + zoo[name],
                                            mode="infer")
        models[name] = inference.load_model(args, mcfg, dev)
    with torch.no_grad():
        feats = frontend.mel_spectrogram(wav, acfg_i, method=acfg_i.mel_method)
        lengths = frontend.mel_lengths(counts, acfg_i.hop_length)

    # -- 13d. the block kernel at the zipformer's six stacks, B=128 x 10 s,
    # on 13b's trained model and on the model of the flagship's blocks
    # (13c's), each stack held by the readings of ROADMAP Queue C's C6
    zm = models["early_zipformer"]
    t_sizes = zipformer_stack_readings(zm, feats, lengths, plain_path,
                                       f"{ZOO_STEPS} steps from its seeded init")
    args, mcfg, _, _, _ = get_args(["--decoder_mode", "ctc", "--load_model_path",
                                    flagship_ckpt["early_zipformer"], "--fused_block", "true"]
                                   + zoo["early_zipformer"], mode="infer")
    zipformer_stack_readings(inference.load_model(args, mcfg, dev), feats, lengths, plain_path,
                             "the flagship's blocks", c6_pre=True)

    # -- 13e. the splitformer's gate on the card, float32
    args, mcfg, _, _, _ = get_args(["--decoder_mode", "ctc", "--load_model_path",
                                    ckpt["splitformer"], "--fused_block", "true"]
                                   + zoo["splitformer"] + f32_flags, mode="infer")
    sm = inference.load_model(args, mcfg, dev)
    fb, lb = feats[:ZOO_GATE_ROWS], lengths[:ZOO_GATE_ROWS]
    with torch.no_grad():
        lp_all, sub = sm.apply(fb, lb)
        mask = torch.arange(lp_all.shape[2], device=dev)[None, :] < sub[:, None]
        conf = torch.stack([exit_confidence(lp_all[e], mask) for e in range(6)])
        c1 = conf[0].sort().values
        lo, hi = ZOO_GATE_ROWS // 4, 3 * ZOO_GATE_ROWS // 4
        j = lo + int((c1[lo + 1:hi + 1] - c1[lo:hi]).argmax())
        median = float(c1[j:j + 2].mean())
        for label, thr in (("0", 0.0), ("1.01", 1.01), ("median", median)):
            lp, chosen, sl, n_run = gated_apply(sm, fb, lb, threshold=thr)
            ok = conf >= thr
            ok[-1] = True
            want = ok.float().argmax(0) + 1                       # first exit clearing thr
            want_run = int(want.max())
            got_lp = lp_all[chosen.long() - 1, torch.arange(ZOO_GATE_ROWS, device=dev)]
            d_lp = float((lp - got_lp).abs().max())
            n_bad = int((chosen != want).sum())
            print(f"13e. splitformer gate, float32, B={ZOO_GATE_ROWS} x 10 s, threshold "
                  f"{label} ({thr:.6f}): {int(n_run)} exits run, chosen exits "
                  f"{torch.bincount(chosen.long(), minlength=7)[1:].tolist()} (per exit), "
                  f"{n_bad} rows differ from the all-exit forward's confidences; chosen "
                  f"log-probs vs the all-exit forward's max|d| {d_lp:.3e} (held 1e-4)")
            if n_bad or d_lp > 1e-4 or not torch.equal(sl, sub) or int(n_run) != want_run:
                fail(f"the splitformer's gate at threshold {label} disagrees with its "
                     f"all-exit forward")
            if label == "0" and want_run != 1 or label == "1.01" and want_run != 6:
                fail(f"the splitformer's gate at threshold {label} ran {int(n_run)} exits")
    del sm, lp_all

    # -- 13f. the legacy family, card against CPU, float32, seeded
    lcfg = ModelConfig(compute_dtype="float32", attn_softmax_dtype="float32", drop_prob=0.0)
    batch = requests(4, seed=1616)
    lf, trg = batch["feats"], batch["labels"][:, :-1]
    for kind in ("CTCSelfAttention", "EarlyEncoder", "EarlyTransformer", "LegacyTransformer"):
        m = getattr(lt, kind)(lcfg).init(torch.Generator().manual_seed(16))
        m_dev = copy.deepcopy(m).to(dev)
        with torch.no_grad():
            args_c = (lf,) if kind in ("CTCSelfAttention", "EarlyEncoder") else (lf, trg)
            a = m_dev.apply(*(t.to(dev) for t in args_c))
            b = m.apply(*args_c)
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        d = max(float((x.cpu() - y).abs().max()) for x, y in zip(a, b))
        print(f"13f. {kind} ({sum(p.numel() for p in m.parameters()):,} parameters), float32, "
              f"B=4, T={lf.shape[1]}: outputs {[tuple(x.shape) for x in b]}, card vs CPU "
              f"max|d| {d:.3e} (held 1e-4)")
        if d > 1e-4:
            fail(f"the legacy {kind} on the card disagrees with the CPU")
        del m, m_dev

    # -- times: the all-exit forward at B=128 x 10 s, beside the flagship's
    B = wav.shape[0]
    audio_s = B * wav.shape[1] / acfg_i.sample_rate
    fwd = {}
    with torch.no_grad():
        for name, m in (("early_conformer (the flagship)", flagship), *models.items()):
            ms = cuda_ms(lambda: inference.exit_outputs(m, feats, lengths, greedy=True,
                                                        timestamps=False), 5, 1)
            fwd[name] = ms
        print(f"13. all-exit forward (blocks + head kernel, greedy ids), B={B} x 10 s, on "
              f"{card}: " + ", ".join(f"{n} {ms:.3f} ms = {audio_s / (ms / 1e3):.0f} audio-s/s"
                                      for n, ms in fwd.items()))
        busy = profile_forward(lambda: inference.exit_outputs(
            zm, feats, lengths, greedy=True, timestamps=False),
            "early_zipformer all-exit forward (six stacks at T' " + ", ".join(
                map(str, t_sizes)) + ")", card, B, top=12)
    print(f"13. CLI audio-s/s on {card}: " + ", ".join(
        f"{n} {r:.1f}" for n, r in rates.items()) + f"; zipformer forward device busy "
        f"{100 * busy:.1f}%")
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "f32_launches": f32_launches}


def zipformer_stack_readings(zm, feats, lengths, plain_path, what, c6_pre=False):
    """Phase 13d: the block kernel against its plain version on the first
    block of each of zm's six stacks, fed the plain path's input; the head
    kernel at E=1. Every stack is taken apart by `c6_readings` (ROADMAP
    Queue C's C6 and C3) and held by them: the kernel within phase 2's
    tolerance of the plain version run with the kernel's own products and
    LayerNorms, and each weight product within 1 ulp of the float64
    product on at most twice the share cuBLAS's bf16 product moves. The
    pre stack (fed the embedding, as phase 2's block) is also held to
    phase 2's tolerance against the plain version itself, but with c6_pre
    (the flagship's blocks fed the one-conv embedding, C6), where only the
    readings hold it. Returns the stacks' T'."""
    import torch
    from early_exit_tpu_torch.ops.kernels import conformer_block as kcb
    from early_exit_tpu_torch.ops.kernels import head_argmax as kha
    kw = dict(n_heads=zm.cfg.n_heads, kernel_size=zm.cfg.depthwise_kernel_size,
              compute_dtype=zm.cfg.dtype, residual_dtype=zm.cfg.rdtype,
              attn_softmax_dtype=zm.cfg.sm_dtype)
    inputs = []

    def record(i, stack, x, mask):
        inputs.append((x.contiguous(), mask.sum(1, dtype=torch.int32)))
        return stack(x, mask)

    with torch.no_grad(), plain_path():
        hidden, _ = zm._forward(feats, lengths, record)
    with torch.no_grad():
        for i, (x, lens) in enumerate(inputs):
            f0 = zm.stacks()[i].folded()[0]
            y_k = kcb.conformer_block(f0, x, lens, **kw)
            y_p = kcb.conformer_block_plain(f0, x, lens, **kw)
            torch.cuda.synchronize()
            with exact_product_sums():
                y_e = kcb.conformer_block_plain(f0, x, lens, **kw)
            err, mean, ulps, frac = bf16_figures(y_k, y_p)
            ulps_e, frac_e = bf16_figures(y_e, y_p)[2:]
            where = "pre" if i == 0 else f"stage {i}"
            direct = i == 0 and not c6_pre
            print(f"13d. early_zipformer ({what}) {where}, its first block, kernel vs "
                  f"plain on the plain path's input (B={x.shape[0]}, T'={x.shape[1]}, "
                  f"lengths {int(lens.min())}..{int(lens.max())}): max|d| {err} "
                  f"mean|d| {mean} max ulps {ulps} values differing {frac}; the plain "
                  f"version with every product summed exactly vs itself: max ulps "
                  f"{ulps_e} values differing {frac_e} (" + (
                      f"tolerance {BLOCK_MAX_ULPS} ulps and {BLOCK_DIFFERING} of values, "
                      f"fed the embedding; and " if direct else "") +
                  "held by the C6 readings below)")
            if not torch.isfinite(y_k.float()).all() or direct and (
                    ulps > BLOCK_MAX_ULPS or frac > BLOCK_DIFFERING):
                fail(f"the block kernel at the zipformer's {where} (T'={x.shape[1]}, "
                     f"{what}) disagrees with its plain version")
            c6_readings(f0, x, lens, y_k, y_p, kw, f"{what}, {where}")
        hb = hidden.to(torch.bfloat16).contiguous()
        wb, bb = zm.heads_w.to(torch.bfloat16), zm.heads_b.to(torch.bfloat16)
        ids_k, ids_p = kha.head_argmax(hb, wb, bb), kha.head_argmax_plain(hb, wb, bb)
        n_diff = int((ids_k != ids_p).sum())
        print(f"13d. head_argmax at E=1 ({what}), {tuple(hb.shape)}, vs its plain "
              f"version: {n_diff} of {ids_p.numel()} ids differ (held: none)")
        if n_diff:
            fail("head_argmax at E=1 disagrees with its plain version")
    return [x.shape[1] for x, _ in inputs]


def c6_readings(f0, x, lens, y_k, y_p, kw, where: str) -> None:
    """ROADMAP Queue C's C6 and C3: the block kernel at one of the
    zipformer's stacks (`where`; C6 was its pre stack built from the
    flagship's block 1, fed the one-conv embedding, where it lies 7 bf16
    ulps from its plain version on 4.5% of values; C3 its five stages,
    fed a block's output, 8.1-28.6% of values up to 4.8 ulps). Prints
    the LayerNorm statistics of the input rows (mu^2 / var, where the
    one-pass variance E[x^2] - mu^2 would cancel), the block's LayerNorm
    kernel alone against its plain version and the float64 two-pass
    LayerNorm, and the kernel and its plain version against the plain
    version with every sum exact (`exact_sums`) and with the kernel's own
    products and LayerNorms (`kernel_products_and_norms`). Holds (a) the
    kernel against the latter within phase 2's tolerance: everything but
    the products (attention, softmax, conv module, epilogues) agrees on
    this input; (b) each of the block's eight weight products, on the
    inputs the plain version gives them, rounded to bf16, against the
    float64 product: at most 1 ulp, on at most twice the share of values
    that cuBLAS's bf16 product (tensor cores, float32 accumulation) moves
    (or the float32 product's share, if larger).
    The float32 product (TF32 off) is printed beside them: it moves ~10x
    fewer values at K = 2048, which is why the plain version lies nearer
    the exact sums than the kernel on this input."""
    import torch
    from early_exit_tpu_torch.ops.kernels import conformer_block as kcb
    valid = torch.arange(x.shape[1], device=x.device)[None, :] < lens[:, None]
    rows = x[valid].contiguous()
    r64 = rows.double()
    mu, var = r64.mean(-1), r64.var(-1, unbiased=False)
    ratio = (mu * mu / var).float()
    q = torch.quantile(ratio, torch.tensor([0.5, 0.99], device=ratio.device))
    print(f"13d. C6 ({where}): {rows.shape[0]} valid input rows: mu^2/var max "
          f"{float(ratio.max())} p99 {float(q[1])} median {float(q[0])}; |x| max "
          f"{float(rows.float().abs().max())}, var {float(var.min())}..{float(var.max())}")
    for name in ("ffn1", "attn", "conv", "ffn2", "final"):
        g, b = f0[name + "_ln_g"], f0[name + "_ln_b"]
        ln_k, ln_p = kcb.block_layer_norm(rows, g, b), kcb.block_layer_norm_plain(rows, g, b)
        m64 = r64.mean(-1, keepdim=True)
        ln_x = ((r64 - m64) * torch.rsqrt(((r64 - m64) ** 2).mean(-1, keepdim=True) + 1e-5)
                * g.double() + b.double()).to(torch.bfloat16)
        torch.cuda.synchronize()
        k_p, k_x, p_x = (bf16_figures(a, c)[2:] for a, c in
                         ((ln_k, ln_p), (ln_k, ln_x), (ln_p, ln_x)))
        print(f"13d. C6 ({where}): the {name} LayerNorm's weights on those rows, kernel vs plain: "
              f"max ulps {k_p[0]} values differing {k_p[1]}; vs the float64 two-pass "
              f"LayerNorm: kernel {k_x[0]} ulps on {k_x[1]}, plain {p_x[0]} ulps on {p_x[1]}")
    with exact_key_sums():
        y_z = kcb.conformer_block_plain(f0, x, lens, **kw)
    with exact_sums():
        y_x = kcb.conformer_block_plain(f0, x, lens, **kw)
    with kernel_products_and_norms():
        y_g = kcb.conformer_block_plain(f0, x, lens, **kw)
    torch.cuda.synchronize()
    figs = {"plain, softmax denominator exact, vs plain": bf16_figures(y_z, y_p)[2:],
            "kernel vs every sum exact": bf16_figures(y_k, y_x)[2:],
            "plain vs every sum exact": bf16_figures(y_p, y_x)[2:],
            "the kernel's products and LayerNorms, every other sum exact, vs every sum "
            "exact": bf16_figures(y_g, y_x)[2:]}
    for name, (u, fr) in figs.items():
        print(f"13d. C6 ({where}): {name}: max ulps {u} values differing {fr}")
    ulps, frac = bf16_figures(y_k, y_g)[2:]
    print(f"13d. C6 ({where}): kernel vs the kernel's products and LayerNorms, every other sum exact: "
          f"max ulps {ulps} values differing {frac} (tolerance {BLOCK_MAX_ULPS} ulps and "
          f"{BLOCK_DIFFERING} of values)")
    if ulps > BLOCK_MAX_ULPS or frac > BLOCK_DIFFERING:
        fail(f"C6 ({where}): the block kernel disagrees with its plain version run with "
             f"the kernel's own products and LayerNorms")
    # the block's eight weight products one by one, on the inputs the plain
    # version gives them with every sum exact
    taken, matmul = [], torch.matmul
    with exact_sums():
        mm = torch.matmul

        def take(a, b):
            if b.dim() == 2:
                taken.append((a.reshape(-1, a.shape[-1]).to(torch.bfloat16).contiguous(),
                              b.to(torch.bfloat16).contiguous()))
            return mm(a, b)
        torch.matmul = take
        try:
            kcb.conformer_block_plain(f0, x, lens, **kw)
        finally:
            torch.matmul = mm
    names = ("ffn1_w1", "ffn1_w2", "wqkv", "wo", "pw1_w", "pw2_w", "ffn2_w1", "ffn2_w2")
    for name, (a, w) in zip(names, taken):
        zero = torch.zeros(w.shape[1], dtype=torch.bfloat16, device=a.device)
        want = matmul(a.double(), w.double()).float().to(torch.bfloat16)
        got_k = kcb.block_gemm(a, w, zero)
        got_f = matmul(a.float(), w.float()).to(torch.bfloat16)
        got_t = matmul(a, w)        # exact_float32: no reduced-precision reductions
        torch.cuda.synchronize()
        fk, ff, ft = (bf16_figures(g, want)[2:] for g in (got_k, got_f, got_t))
        print(f"13d. C6 ({where}): product {name} ({a.shape[0]} x {a.shape[1]} x {w.shape[1]}), rounded "
              f"to bf16, against the float64 product: the block's max ulps {fk[0]} values "
              f"differing {fk[1]}; cuBLAS's bf16 product max ulps {ft[0]} values differing "
              f"{ft[1]} (held: the block's at most 1 ulp on at most twice that share, or "
              f"the float32 product's); "
              f"float32 max ulps {ff[0]} values differing {ff[1]}")
        if fk[0] > 1 or fk[1] > max(2 * ft[1], ff[1]):
            fail(f"C6 ({where}): the block's product {name} moves more values than "
                 f"cuBLAS's bf16 product")


def zoo_models(dev) -> dict:
    """The splitformer and the zipformer of the flagship's trained blocks
    (`interop.flagship_zoo_tree`) in the bf16 inference profile, fused, on
    dev."""
    import dataclasses

    from early_exit_tpu_torch import interop
    from early_exit_tpu_torch.configs import inference_profile

    prof = inference_profile(fused_block=True)
    models = {}
    for name, over in (("splitformer", {}),
                       ("early_zipformer", dict(n_enc_exits=19, n_enc_layers_per_exit=1))):
        params, state = interop.flagship_zoo_tree(name)
        models[name] = interop.from_jax_params(
            params, state, dataclasses.replace(prof, model_type=name, **over)).to(dev).eval()
    return models


def export_child(out_dir: str, workers: int) -> dict:
    """Every serving program of phases 11, 14c and 18a, captured and
    compiled by AOTInductor in a spawned child process at nice 10 (which
    its compile processes inherit) while the main process runs phases 8
    to 18d: the flagship's features' program and its programs at
    EXPORT_BUCKET (all-exit, gated, the committed calibration's cascade)
    and over symbolic (b, s) up to EXPORT_POLY_MAX samples (all-exit,
    gated), then from `zoo_models` the splitformer's all-exit and gated
    programs and the zipformer's all-exit program at EXPORT_BUCKET and the
    all-exit poly program of each, and the splitformer's gated poly
    program (one program an exit, as every gated poly program), and the
    flagship's gated poly program as one cond program, the stepped one's
    yardstick. Each program goes to a pool of `workers` compile processes (`export._compile_file`, one compile
    thread) as soon as it is captured; an AOTInductor compile costs about
    two core-minutes whatever the graph, and more of them at once slow
    the main process's phases more than they gain. Writes
    out_dir/<stem>.eetx (stems "flagship", "<zoo name>" and "<zoo
    name>.poly"), out_dir/mel.pt2 and out_dir/flagship_cond.pt2; returns {"capture_s": {stem:
    seconds}, "aoti": {stem: {key: (compile seconds, package MB)}}}, the
    features' program as {"mel": {"": ...}}."""
    os.nice(10)
    sys.path.insert(0, HERE)
    import torch
    from early_exit_tpu_torch import runtime
    from early_exit_tpu_torch.configs import AudioConfig
    from early_exit_tpu_torch.ops import frontend
    from early_exit_tpu_torch.serving import export as ex
    from early_exit_tpu_torch.serving.recognizer import Recognizer

    runtime.exact_float32()
    dev = torch.device("cuda")
    work = tempfile.mkdtemp(prefix="eet_aoti_", dir=out_dir)
    pool = ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"))
    capture_s, bundles, jobs = {}, {}, {}

    def submit(stem, programs):
        for key, blob in programs.items():
            stub = os.path.join(work, f"{stem}:{key}".replace("/", "_"))
            with open(stub + ".ep.pt2", "wb") as f:
                f.write(blob)
            jobs[stem, key] = (stub + ".pt2", pool.submit(
                ex._compile_file, stub + ".ep.pt2", stub + ".pt2", 1))

    t_child = time.perf_counter()
    try:
        t0 = time.perf_counter()
        rec = Recognizer.from_flagship("cuda", fused=True)
        acfg, gate = rec.acfg, rec.gate_settings()

        class Mel(torch.nn.Module):
            def forward(self, w):
                return frontend.mel_spectrogram(w, acfg, method=acfg.mel_method)

        submit("mel", {"": ex._saved(ex._capture(Mel(), (torch.zeros(EXPORT_BUCKET,
                                                                     device=dev),)))})
        bundles["flagship"] = ex.export_recognizer(
            rec.model, acfg, [EXPORT_BUCKET], platforms=("cuda",),
            gate_score=gate["score"], symbolic_max_samples=EXPORT_POLY_MAX, gated=True,
            cascade_k=int(rec.calib.get("cascade_k") or 2),
            gate_temperatures=gate["temperatures"], compile_aoti=False)
        submit("flagship", bundles["flagship"].programs["cuda"])
        capture_s["flagship"] = time.perf_counter() - t0
        # the yardstick of the stepped gated poly program: the same gate
        # as one cond program (`make_gated_serve_fn`), timed beside it in
        # phase 11.7 and served nowhere
        t0 = time.perf_counter()
        s_min = acfg.hop_length * 10
        nb = torch.export.Dim.DYNAMIC(min=1)
        ns = torch.export.Dim.DYNAMIC(min=s_min, max=EXPORT_POLY_MAX)
        w_ex = torch.zeros(2, 4 * s_min, device=dev)
        n_ex = torch.full((2,), 4 * s_min, dtype=torch.int32, device=dev)
        cond = ex.make_gated_serve_fn(ex._on(rec.model, dev), acfg, gate_score=gate["score"])
        submit("flagship_cond", {"": ex._saved(ex._capture(
            cond, (w_ex, n_ex, torch.zeros((), device=dev)),
            ({0: nb, 1: ns}, {0: nb}, None), size_oblivious=True))})
        capture_s["flagship_cond"] = time.perf_counter() - t0
        del rec, cond
        zoo_acfg = AudioConfig(mel_method="dft")
        for name, m in zoo_models(dev).items():
            for stem, shapes, kw in (
                    (name, [EXPORT_BUCKET], dict(gated=name == "splitformer")),
                    (f"{name}.poly", [], dict(symbolic_max_samples=EXPORT_POLY_MAX,
                                              gated=name == "splitformer"))):
                t0 = time.perf_counter()
                bundles[stem] = ex.export_recognizer(m, zoo_acfg, shapes, platforms=("cuda",),
                                                     compile_aoti=False, **kw)
                submit(stem, bundles[stem].programs["cuda"])
                capture_s[stem] = time.perf_counter() - t0
        aoti = {}
        for (stem, key), (path, job) in jobs.items():
            secs = job.result()
            with open(path, "rb") as f:
                blob = f.read()
            aoti.setdefault(stem, {})[key] = (secs, len(blob) / 1e6)
            if stem in ("mel", "flagship_cond"):
                with open(os.path.join(out_dir, stem + ".pt2"), "wb") as f:
                    f.write(blob)
            else:
                bundles[stem].packages[key] = blob
                bundles[stem].manifest["aoti_compile_s"][key] = secs
        for stem, b in bundles.items():
            ex.save_bundle(os.path.join(out_dir, f"{stem}.eetx"), b)
    finally:
        pool.shutdown(cancel_futures=True)
        shutil.rmtree(work, ignore_errors=True)
    return {"capture_s": capture_s, "aoti": aoti, "wall_s": time.perf_counter() - t_child}


def gate_phase(dev, card, reset_counts, read_counts, corp, tmp, wav, counts,
               refs, zoo_export) -> dict:
    """Phase 14: the calibrate -> export -> serve path on the card, on the
    flagship (`assets/flagship_ckpt`) and the zoo models built from its
    trained blocks (`interop.flagship_zoo_tree`). (a) `calibrate_gate`
    over phase 9's corpus (bf16 inference profile, --fused_block true) for
    the flagship and the splitformer: the simulated gated WER of every
    score within its target, recomputed from the tool's own pass; the
    inference CLI under the written --gate_calibration choosing, per
    utterance, simulate_gate's exit (rows within GATE_NEAR of a threshold
    counted, not held); in float32 on 8 utterances the tool on the card and
    on the CPU: per-exit WERs, temperatures, mean exit and gated WER equal,
    thresholds within GATE_THR_ATOL. (b) `escalation_report` at the
    settings of `reports/escalation_v3_seed1.json` held to that record.
    (c) the bundles in zoo_export["dir"] (`export_child`: the
    splitformer's all-exit and gated programs and the zipformer's all-exit
    program at EXPORT_BUCKET, compiled beside phases 8-18d); phase 3's
    first ZOO_EXPORT_ROWS requests served from each bundle in batches of 8
    against the eager `Recognizer` (block and head kernels) and
    `gated_apply`. Returns the launch counts for the kernels line."""
    import io

    import numpy as np
    import torch
    from early_exit_tpu_torch import calibrate_gate, checkpoint, escalation_report
    from early_exit_tpu_torch import inference, interop
    from early_exit_tpu_torch.cli import get_args
    from early_exit_tpu_torch.configs import AudioConfig
    from early_exit_tpu_torch.data.librispeech import LibriSpeechDataset
    from early_exit_tpu_torch.data.pipeline import Pipeline
    from early_exit_tpu_torch.models import gate_calibration as gc
    from early_exit_tpu_torch.models.early_exit_gate import exit_confidence, gated_apply
    from early_exit_tpu_torch.ops import frontend
    from early_exit_tpu_torch.serving import export as ex
    from early_exit_tpu_torch.serving.recognizer import Recognizer, wer_pct
    from early_exit_tpu_torch.tokenizer import load_decoder

    t_phase = time.perf_counter()

    def cli(main, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv)
        return buf.getvalue()

    def launched(what, **want):
        got = read_counts()
        full = {name: want.get(name, 0) for name in got}
        if got != full:
            fail(f"{what}: launches {got}, expected {full}")
        return got

    zoo_ck = {}
    for name in ("splitformer", "early_zipformer"):
        params, state = interop.flagship_zoo_tree(name)
        zoo_ck[name] = os.path.join(tmp, f"gate_{name}")
        checkpoint.save_tree({"params": params, "model_state": state}, zoo_ck[name])

    # -- 14a. calibrate_gate, then the inference CLI under what it wrote
    n_batches = [0]
    figures = calibrate_gate._batch_figures

    def counted(*a, **k):
        n_batches[0] += 1
        return figures(*a, **k)

    gate_launches = {}
    f32 = ["--compute_dtype", "float32", "--attn_softmax_dtype", "float32"]
    for name, ck in (("early_conformer", checkpoint.FLAGSHIP_CKPT),
                     ("splitformer", zoo_ck["splitformer"])):
        base = ["--decoder_mode", "ctc", "--load_model_path", ck, "--eval_splits",
                "test-clean", "--fused_block", "true", "--model_type", name]
        out_json = os.path.join(tmp, f"calib_{name}.json")
        calibrate_gate._batch_figures = counted
        try:
            n_batches[0] = 0
            reset_counts()
            t0 = time.perf_counter()
            log = cli(calibrate_gate.main, ["--out", out_json, "--target_wer_delta",
                                            str(GATE_DELTA_PP), "--data_root", corp["root"]]
                      + base)
            wall = time.perf_counter() - t0
            # the trunk's 12 blocks a batch (the splitformer's branch
            # blocks run unfused)
            got = launched(f"calibrate_gate ({name})",
                           conformer_block_bf16=12 * n_batches[0])
        finally:
            calibrate_gate._batch_figures = figures
        with open(out_json) as f:
            report = json.load(f)
        print(f"14a. {name}: `python -m early_exit_tpu_torch.calibrate_gate --target_wer_delta "
              f"{GATE_DELTA_PP} --fused_block true` over phase 9's corpus "
              f"({report['eval_utts']} utterances, {corp['audio_s']:.1f} s) in {wall:.1f} s "
              f"on {card}; launches {got} over {n_batches[0]} batches; exit WERs "
              f"{[p['exit_wer_pct'] for p in report['per_score']['maxprob']['per_exit']]}; "
              + "; ".join(f"{s_}: temperatures {[round(t, 3) for t in e['temperatures']]} "
                          f"thresholds {[round(t, 6) for t in e['thresholds']]} mean exit "
                          f"{e['mean_exit']} gated WER {e['gated_wer_pct']}%"
                          for s_, e in report["per_score"].items())
              + f"; recommended {report['score']}")
        # the tool's pass again, per utterance: each score's gated WER
        # against its target, and the exits the gate must choose
        args, mcfg, tcfg, acfg_i, tk = get_args(base, mode="infer")
        model = inference.load_model(args, mcfg, dev)
        pipe = Pipeline(LibriSpeechDataset(corp["root"], "test-clean"), tk, acfg_i, tcfg,
                        shuffle=False, infer_mode=True, device=dev)
        temps = list(gc.DEFAULT_TEMP_GRID)
        scores = list(report["per_score"])
        conf, errors, words = calibrate_gate.calibration_set(model, pipe, tk, scores, temps,
                                                             mcfg.blank_id)
        target = errors[-1].sum() / words.sum() + GATE_DELTA_PP / 100.0
        chosen = {}
        for si, s_ in enumerate(scores):
            e_ = report["per_score"][s_]
            cal = np.stack([conf[si, temps.index(t), e] for e, t in
                            enumerate(e_["temperatures"])])
            mean_exit, gated, chosen[s_] = gc.simulate_gate(cal, e_["thresholds"], errors,
                                                            words)
            if gated > target + 1e-12 or round(100 * gated, 2) != e_["gated_wer_pct"]:
                fail(f"calibrate_gate ({name}, {s_}): simulated gated WER {100 * gated:.4f}% "
                     f"against the target {100 * target:.4f}% (the report says "
                     f"{e_['gated_wer_pct']}%)")
        s_ = report["score"]
        cal = np.stack([conf[scores.index(s_), temps.index(t), e]
                        for e, t in enumerate(report["temperatures"])])
        near = (np.abs(cal[:-1] - np.asarray(report["thresholds"][:-1])[:, None])
                <= GATE_NEAR).any(0)
        reset_counts()
        out = cli(inference.main, base + ["--data_root", corp["root"], "--gate_calibration",
                                          out_json])
        got = read_counts()
        gate_launches[name] = got["conformer_block_bf16"]
        if any(v for k, v in got.items() if k != "conformer_block_bf16") or not got[
                "conformer_block_bf16"]:
            fail(f"the gated CLI ({name}): launches {got}")
        cli_exits = np.asarray([int(ln.split("GATED_OUT (exit ", 1)[1].split(")")[0])
                                for ln in out.splitlines() if "GATED_OUT (exit " in ln])
        summary = [ln for ln in out.splitlines() if "gated WER" in ln]
        if cli_exits.shape != chosen[s_].shape:
            fail(f"the gated CLI ({name}) printed {cli_exits.size} GATED_OUT lines for "
                 f"{chosen[s_].size} utterances")
        n_diff = int((cli_exits[~near] != chosen[s_][~near]).sum())
        print(f"14a. {name}: the inference CLI with --gate_calibration: {summary}; launches "
              f"{got}; chosen exits per exit {np.bincount(cli_exits, minlength=7)[1:].tolist()}"
              f", simulate_gate's {np.bincount(chosen[s_], minlength=7)[1:].tolist()}; "
              f"{int(near.sum())} rows within {GATE_NEAR} of a threshold (not held), "
              f"{n_diff} of the other {int((~near).sum())} differ (held: none)")
        if n_diff:
            fail(f"the inference CLI under the calibration of {name} chooses other exits "
                 f"than simulate_gate")
        del model
        # float32, card against CPU, on 8 utterances
        small = os.path.join(tmp, "cpu8")
        runs = {}
        for where, extra in (("card", []), ("CPU", ["--device", "cpu"])):
            path = os.path.join(tmp, f"calib_{name}_{where}.json")
            t0 = time.perf_counter()
            cli(calibrate_gate.main, ["--out", path, "--target_wer_delta", str(GATE_DELTA_PP),
                                      "--data_root", small] + base + f32 + extra)
            with open(path) as f:
                runs[where] = (json.load(f), time.perf_counter() - t0)
        a, b = runs["card"][0], runs["CPU"][0]
        bad = []
        for s_, eb in b["per_score"].items():
            ea = a["per_score"][s_]
            if [p["exit_wer_pct"] for p in ea["per_exit"]] != [
                    p["exit_wer_pct"] for p in eb["per_exit"]]:
                bad.append(f"{s_} exit WERs")
            if ea["temperatures"] != eb["temperatures"]:
                bad.append(f"{s_} temperatures")
            if (ea["mean_exit"], ea["gated_wer_pct"]) != (eb["mean_exit"], eb["gated_wer_pct"]):
                bad.append(f"{s_} mean exit / gated WER")
            if np.abs(np.subtract(ea["thresholds"], eb["thresholds"])).max() > GATE_THR_ATOL:
                bad.append(f"{s_} thresholds")
        d_thr = max(float(np.abs(np.subtract(a["per_score"][k]["thresholds"],
                                             b["per_score"][k]["thresholds"])).max())
                    for k in b["per_score"])
        print(f"14a. {name}: calibrate_gate in float32 (--compute_dtype float32 "
              f"--attn_softmax_dtype float32) on 8 utterances, card ({runs['card'][1]:.1f} s) "
              f"vs CPU ({runs['CPU'][1]:.1f} s): exit WERs "
              f"{[p['exit_wer_pct'] for p in a['per_score']['maxprob']['per_exit']]} and "
              f"{[p['exit_wer_pct'] for p in b['per_score']['maxprob']['per_exit']]}; "
              f"thresholds max|d| {d_thr:.3e} (held {GATE_THR_ATOL}); differing: "
              f"{bad or 'nothing'}")
        if bad:
            fail(f"calibrate_gate ({name}) in float32 on the card disagrees with the CPU: "
                 f"{bad}")

    # -- 14b. escalation_report at the committed record's settings
    with open(os.path.join(HERE, "reports", "escalation_v3_seed1.json")) as f:
        record = json.load(f)
    reset_counts()
    t0 = time.perf_counter()
    cli(escalation_report.main, ["--ckpt", checkpoint.FLAGSHIP_CKPT, "--calib",
                                 checkpoint.FLAGSHIP_CALIB, "--out",
                                 os.path.join(tmp, "escalation.json"), "--n_utts",
                                 str(record["n_utts"]), "--seed", str(record["seed"]),
                                 "--sweep", "0.8,0.9,0.95", "--fused_block"])
    wall = time.perf_counter() - t0
    with open(os.path.join(tmp, "escalation.json")) as f:
        rep = json.load(f)
    esc = launched("escalation_report",
                   conformer_block_bf16=12 * -(-record["n_utts"] // 32))
    print(f"14b. `python -m early_exit_tpu_torch.escalation_report --fused_block --sweep "
          f"0.8,0.9,0.95` ({rep['n_utts']} utterances, seed {rep['seed']}) in {wall:.1f} s "
          f"on {card}; launches {esc}; exit WER ladder {rep['exit_wer_ladder']} (the record "
          f"{record['exit_wer_ladder']}); sigma/conf Pearson at the first reachable exit "
          f"{rep['sigma_conf_pearson_first_reachable']} "
          f"({record['sigma_conf_pearson_first_reachable']})")
    for pt, rp in zip(rep["operating_points"], record["operating_points"]):
        print(f"14b.   {pt['point']}: thresholds {pt['thresholds']}, accept histogram "
              f"{pt['accept_histogram']}, mean exits {pt['mean_exits']}, escalated "
              f"{pt['escalated_share']}, gated WER {pt['gated_wer_pct']}% (the record "
              f"{rp['accept_histogram']}, {rp['mean_exits']}, {rp['gated_wer_pct']}%); SNR "
              f"buckets " + ", ".join(f"{b_['sigma_range']}: exit {b_['mean_chosen_exit']} "
                                     f"WER {b_['gated_wer_pct']}%" for b_ in pt["snr_buckets"]))
    same_utts = (rep["seed"] == record["seed"] and rep["n_utts"] == record["n_utts"]
                 and [b_["sigma_range"] for b_ in rep["snr_buckets"]]
                 == [b_["sigma_range"] for b_ in record["snr_buckets"]])
    ladder_gap = max(abs(rep["exit_wer_ladder"][f"exit{e}"]
                         - record["exit_wer_ladder"][f"exit{e}"]) for e in range(2, 7))
    hist_gap = max(abs(rep["accept_histogram"][k] - v)
                   for k, v in record["accept_histogram"].items())
    gated_gap = abs(rep["gated_wer_pct"] - record["gated_wer_pct"])
    print(f"14b. against the record: the same utterances {same_utts}; exits 2-6 WER within "
          f"{ladder_gap:.2f} points (held {ESC_WER_PP}); accept histogram within "
          f"{hist_gap:.4f} (held {ESC_HIST}); gated WER {rep['gated_wer_pct']}% vs "
          f"{record['gated_wer_pct']}% (held {ESC_WER_PP} points)")
    if not same_utts or ladder_gap > ESC_WER_PP or hist_gap > ESC_HIST or gated_gap > ESC_WER_PP:
        fail("escalation_report on the card departs from reports/escalation_v3_seed1.json")

    # -- 14c. the zoo's bundles (compiled beside phases 8-18d), served
    acfg = AudioConfig(mel_method="dft")
    tok = load_decoder(checkpoint.bound_tokenizer(checkpoint.load_calib()))
    models = zoo_export["models"]
    Bk, Sk = EXPORT_BUCKET
    bkey = f"{Bk}x{Sk}"
    paths = {name: os.path.join(zoo_export["dir"], f"{name}.eetx") for name in models}
    bundles = {name: ex.load_bundle(path) for name, path in paths.items()}
    for name, bundle in bundles.items():
        man = bundle.manifest
        print(f"14c. {name} exported for cuda at {bkey}: bundle "
              f"{os.path.getsize(paths[name]) / 1e6:.1f} MB, n_exits {man['n_exits']}, "
              f"shapes {man['shapes']}; " + "; ".join(
                  f"{key}: AOTInductor {secs:.1f} s (beside phases 8-18d), package "
                  f"{len(bundle.packages[key]) / 1e6:.1f} MB" for key, secs in
                  man["aoti_compile_s"].items()))
    nodes = {f"{name}/{key}": c.get("eet::conformer_block", 0)
             for name, b in bundles.items() for key, c in b.manifest["op_nodes"]["cuda"].items()}
    want = {f"splitformer/{bkey}": 12, f"splitformer/gated/{bkey}": 12,
            f"early_zipformer/{bkey}": 19}
    print(f"14c. eet::conformer_block nodes per graph: {nodes} (the gated graph: 2 in each "
          f"of the 6 exits' cond branches; the branch blocks unfused)")
    if nodes != want:
        fail(f"the zoo's exported graphs: block op nodes {nodes}, expected {want}")
    n_exits = {name: b.manifest["n_exits"] for name, b in bundles.items()}
    if n_exits != {"splitformer": 6, "early_zipformer": 1}:
        fail(f"the zoo bundles' manifests say n_exits {n_exits}")
    del bundles

    R = ZOO_EXPORT_ROWS
    w, c = wav[:R].contiguous(), counts[:R].to(torch.int32).contiguous()
    w_np, c_np = w.cpu().numpy(), c.cpu().numpy()
    batches = [slice(i, i + Bk) for i in range(0, R, Bk)]
    export_launches = {}
    for name, m in models.items():
        L, E = (12, 6) if name == "splitformer" else (19, 1)
        rec_e = Recognizer(m, tok, acfg=acfg, device=dev)
        reset_counts()
        eager = rec_e.transcribe(w, c)
        launched(f"Recognizer.transcribe ({name})", conformer_block_bf16=L, head_argmax=1)
        ladder = [round(wer_pct(refs[:R], t), 2) for t in eager.texts]
        rec_x = ex.ExportedRecognizer(paths[name])
        toks, ntok = [], []
        reset_counts()
        for sl in batches:
            t, n, _ = rec_x(w_np[sl], c_np[sl])
            toks.append(torch.from_numpy(t))
            ntok.append(torch.from_numpy(n))
        got = launched(f"exported all-exit program ({name})",
                       conformer_block_bf16=L * len(batches))
        export_launches[name] = got["conformer_block_bf16"]
        dis = disagreement(torch.cat(toks, 1), torch.cat(ntok, 1), eager.tokens,
                           eager.n_tokens)
        print(f"14c. {name}: the eager Recognizer's WER per exit {ladder}; tokens per "
              f"utterance {[round(float(eager.n_tokens[e].float().mean()), 1) for e in range(E)]}")
        _hold_token_contract(f"14c. {name} exported all-exit program vs Recognizer.transcribe "
                             f"({R} requests)", dis, ladder)
        if name == "splitformer":
            feats = frontend.mel_spectrogram(w, acfg, method=acfg.mel_method)
            lengths = frontend.mel_lengths(c, acfg.hop_length)
            for label in ("0", "1.01", "median"):
                n_eq, hist = 0, np.zeros(6, int)
                for sl in batches:
                    if label == "median":
                        with torch.no_grad():
                            lp, sub = m.encode_exit(feats[sl], lengths[sl], 1)
                            mask = (torch.arange(lp.shape[1], device=dev)[None, :]
                                    < sub[:, None])
                            c1 = exit_confidence(lp, mask).sort().values
                        # the widest gap among the middle rows, away from any row
                        lo, hi = Bk // 4, 3 * Bk // 4
                        j = lo + int((c1[lo + 1:hi + 1] - c1[lo:hi]).argmax())
                        thr = float(c1[j:j + 2].mean())
                    else:
                        thr = float(label)
                    reset_counts()
                    _, _, ch = rec_x.gated(w_np[sl], c_np[sl], thr)
                    got = launched(f"exported gated program ({label})",
                                   conformer_block_bf16=2 * int(ch.max()))
                    _, ch_e, _, _ = gated_apply(m, feats[sl], lengths[sl], threshold=thr)
                    n_eq += int((ch == ch_e.cpu().numpy()).sum())
                    hist += np.bincount(ch, minlength=7)[1:]
                print(f"14c. splitformer exported gated program, threshold {label}: chosen "
                      f"exits per exit {hist.tolist()}, equal to eager gated_apply's on "
                      f"{n_eq}/{R} rows")
                if n_eq != R:
                    fail(f"the splitformer's exported gated program (threshold {label}) "
                         f"chooses other exits than gated_apply")
        run = rec_x._fn(bkey)
        w8, c8 = w[:Bk], c[:Bk]
        audio_s = Bk * Sk / acfg.sample_rate
        with torch.no_grad():
            t_x = cuda_ms(lambda: run(w8, c8), 20, 3)
            t_n = cuda_ms(lambda: rec_x(w_np[:Bk], c_np[:Bk]), 20, 3)
            t_e = cuda_ms(lambda: rec_e.transcribe(w8, c8), 20, 3)
        zoo_export.setdefault("bucket_ms", {})[name] = t_x
        print(f"14c. {name} times on {card} ({Bk} x {Sk / acfg.sample_rate:.0f} s, CUDA "
              f"events): the exported all-exit program {t_x:.3f} ms a call = "
              f"{audio_s / t_x * 1e3:.1f} audio-s/s ({t_n:.3f} ms with numpy in and out); "
              f"the eager Recognizer.transcribe {t_e:.3f} ms = {audio_s / t_e * 1e3:.1f} "
              f"audio-s/s")
        rec_x.close()
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    return {"gate_launches": gate_launches, "export_launches": export_launches,
            "escalation_launches": esc["conformer_block_bf16"]}


def reference_phase(dev, card, reset_counts, read_counts, corp, tmp, rec_k, wav,
                    counts) -> dict:
    """Phase 15: reference checkpoints and the whole tokenizer on the card.
    (a) The flagship through `interop.to_reference_state_dict` and
    `torch.save` into `python -m early_exit_tpu_torch.import_reference_checkpoint`
    (a subprocess, on the card, --fused_block true): the imported tree equal
    to the flagship's leaf for leaf (in float32: the flagship's bf16
    parameters widen exactly), and `Recognizer.transcribe` of it over 32 of
    phase 3's requests, through the block and head kernels, giving the
    flagship's tokens at every exit, 0 apart, with the launches of each
    kernel. (b) Seeded splitformer, early_zipformer and full_conformer at
    the flagship's widths: the round trip through the reference state_dict
    exact, and the forward on the card of the model read back bit-equal to
    the original's. (c) An nmt_nfkc BPE-256 tokenizer with the reference
    recipe's ids and a unigram-256, trained over phase 9's transcripts: the
    native and Python engines' ids equal over the corpus, each engine's
    sentences a second; then 5 steps of `python -m early_exit_tpu_torch.train`
    at the flagship's widths with the BPE model as --bpe_model_path, the
    loss finite and falling. Returns the launches of (a)."""
    import dataclasses
    import io

    import numpy as np
    import torch
    from early_exit_tpu_torch import _native, checkpoint, interop, train
    from early_exit_tpu_torch.configs import inference_profile
    from early_exit_tpu_torch.models.registry import build_model
    from early_exit_tpu_torch.serving.recognizer import Recognizer
    from early_exit_tpu_torch.tokenizer import load_tokenizer
    from early_exit_tpu_torch.training import trainer

    t_phase = time.perf_counter()

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k], f"{prefix}/{k}")]
        if isinstance(tree, (list, tuple)):
            return [x for i, v in enumerate(tree) for x in leaves(v, f"{prefix}/{i}")]
        return [(prefix, checkpoint.to_torch(tree).float())]

    def same_tree(a, b):
        la, lb = leaves(a), leaves(b)
        return [p for p, _ in la] == [p for p, _ in lb] and all(
            x.shape == y.shape and torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))

    # -- 15a. the flagship through the reference format and the import tool
    flag = checkpoint.load_tree(checkpoint.FLAGSHIP_CKPT)
    cfg = inference_profile(fused_block=True)
    sd = interop.to_reference_state_dict(*interop.to_jax_params(rec_k.model), cfg)
    pt, out = os.path.join(tmp, "flagship-torch"), os.path.join(tmp, "flagship-imported")
    torch.save({k: torch.from_numpy(v.copy()) for k, v in sd.items()}, pt)
    argv = [sys.executable, "-m", "early_exit_tpu_torch.import_reference_checkpoint",
            "--torch_ckpt", pt, "--out", out, "--decoder_mode", "ctc", "--bpe_model_path",
            os.path.join(HERE, "assets", "spm", "synth.bpe-256.model"), "--fused_block", "true"]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=HERE, capture_output=True, text=True, timeout=300)
    tool_s = time.perf_counter() - t0
    if proc.returncode:
        fail(f"import_reference_checkpoint failed (rc={proc.returncode}):\n"
             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    imported = checkpoint.load_tree(out)
    equal = same_tree(imported, {"params": flag["params"], "model_state": flag["model_state"]})
    print(f"15a. the flagship -> to_reference_state_dict ({len(sd)} tensors) -> torch.save -> "
          f"`python -m early_exit_tpu_torch.import_reference_checkpoint ... --fused_block true` "
          f"on the card ({tool_s:.1f} s, its process's start included): "
          f"{' | '.join(proc.stdout.strip().splitlines()[-2:])}; the imported tree equal to "
          f"the flagship's leaf for leaf: {equal}")
    if not equal:
        fail("the imported flagship's tree differs from the flagship's")
    rec_i = Recognizer(interop.from_jax_params(imported["params"], imported["model_state"], cfg),
                       rec_k.tokenizer, device=dev, calib=rec_k.calib)
    w32, c32 = wav[:32], counts[:32]
    want = rec_k.transcribe(w32, c32)
    reset_counts()
    got = rec_i.transcribe(w32, c32)
    launches = read_counts()
    dis = disagreement(got.tokens, got.n_tokens, want.tokens, want.n_tokens)
    print(f"15a. Recognizer.transcribe of the imported flagship over 32 of phase 3's requests "
          f"(B=32 x 10 s), block and head kernels: launches {launches}; tokens per exit "
          f"against the flagship's (edits, tokens): {dis} (held: 0 edits, 12 block and 1 "
          f"head launches)")
    if any(e for e, _ in dis) or launches["conformer_block_bf16"] != 12 or \
            launches["head_argmax"] != 1:
        fail("the imported flagship does not serve the flagship's tokens through the kernels")
    del rec_i, imported, flag, sd

    # -- 15b. the zoo at the flagship's widths, seeded: exact round trips
    fb, lb = rec_k._features(wav[:4], counts[:4])
    zoo = {"splitformer": dict(model_type="splitformer"),
           "early_zipformer": dict(model_type="early_zipformer", n_enc_exits=19,
                                   n_enc_layers_per_exit=1),
           "full_conformer": dict(model_type="full_conformer", n_dec_layers=6)}
    for seed, (name, over) in enumerate(zoo.items()):
        zcfg = dataclasses.replace(cfg, **over)
        model = build_model(zcfg).to(dev)
        model.init(torch.Generator(device=dev).manual_seed(100 + seed))
        model.eval().requires_grad_(False)
        params, state = interop.to_jax_params(model)
        zsd = interop.to_reference_state_dict(params, state, zcfg)
        back = interop.from_reference_state_dict(zsd, zcfg)
        exact = same_tree(back, (params, state))
        again = interop.from_jax_params(*back, zcfg).to(dev).eval()
        with torch.no_grad():
            if name == "full_conformer":
                trg = torch.tensor([[1, 40, 41, 42]] * fb.shape[0], device=dev)
                a, b = model.apply(fb, lb, trg), again.apply(fb, lb, trg)
                same = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            else:
                a, b = model.apply(fb, lb), again.apply(fb, lb)
                same = torch.equal(a[0], b[0])
        torch.cuda.synchronize()
        print(f"15b. {name} (seeded, the flagship's widths, {len(zsd)} reference tensors): "
              f"round trip exact {exact}; the forward on the card of the model read back "
              f"bit-equal to the original's {same} (B={fb.shape[0]} x 10 s)")
        if not (exact and same):
            fail(f"{name}: the reference round trip is not exact on the card")
        del model, again

    # -- 15c. tokenizers trained with the reference recipe, and a train run
    corpus = os.path.join(tmp, "ref_corpus.txt")
    texts = [u.transcript for u in corp["corpus"]]
    with open(corpus, "w") as f:
        f.write("\n".join(texts) + "\n")
    lib = _native.get_lib()
    tsv = os.path.join(HERE, "csrc", "tokenizer", "data", "nmt_nfkc.tsv").encode()
    models = {}
    for name, mtype in (("bpe", 2), ("unigram", 1)):
        prefix = os.path.join(tmp, f"ref_{name}")
        t0 = time.perf_counter()
        # the reference recipe: --pad_id=126 --unk_id=127 --bos_id=1 --eos_id=2
        # --user_defined_symbols="@", nmt_nfkc
        rc = lib.eet_spm_train_norm_ex(corpus.encode(), prefix.encode(), 256, 127, 1, 2, 126,
                                       b"@", mtype, b"nmt_nfkc", tsv, 0)
        if rc:
            fail(f"training the {name} tokenizer failed ({rc})")
        train_s = time.perf_counter() - t0
        models[name] = prefix + ".model"
        engines = {"native": load_tokenizer(models[name]),
                   "python": load_tokenizer(models[name], prefer_native=False)}
        rates, ids = {}, {}
        for kind, tok in engines.items():
            t1 = time.perf_counter()
            for _ in range(20):
                ids[kind] = [tok.encode_as_ids(t) for t in texts]
            rates[kind] = 20 * len(texts) / (time.perf_counter() - t1)
        same = ids["native"] == ids["python"]
        print(f"15c. {name}-256 tokenizer, nmt_nfkc, the reference recipe's ids, trained over "
              f"phase 9's {len(texts)} transcripts in {train_s:.1f} s: "
              f"{engines['python'].get_piece_size()} pieces; native and Python ids equal over "
              f"the corpus: {same}; sentences a second, native {rates['native']:.0f}, Python "
              f"{rates['python']:.0f} (host)")
        if not same:
            fail(f"the {name} tokenizer's native and Python engines disagree")
    ck_dir = os.path.join(tmp, "ref_train")
    argv = ["--decoder_mode", "ctc", "--synthetic_data", "true", "--batch_size", "13",
            "--n_batch_split", "1", "--n_epochs", "1", "--warmup", "10", "--seed", "15",
            "--bpe_model_path", models["bpe"], "--save_model_dir", ck_dir,
            "--log_dir", ck_dir + "_runs"]
    losses, step = [], trainer.Trainer.step

    def logged(self, batch):
        res = step(self, batch)
        losses.append(res["loss"])
        return res
    trainer.Trainer.step = logged
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            train.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        trainer.Trainer.step = step
    losses = [float(v) for v in losses]
    print(f"15c. `python -m early_exit_tpu_torch.train {' '.join(argv).replace(tmp, '<tmp>')}` "
          f"at the flagship's widths with the nmt_nfkc BPE model: {len(losses)} steps, loss "
          f"{[round(v, 3) for v in losses]} ({wall:.1f} s)")
    if len(losses) != 5 or not np.isfinite(losses).all() or losses[-1] >= losses[0]:
        fail("the training CLI with the nmt_nfkc tokenizer did not take 5 falling steps")
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s on {card}")
    return {"launches": launches}


def poly_phase(dev, card, reset_counts, read_counts, zoo_export, wav, counts,
               refs) -> dict:
    """Phase 18a (run last): the zoo's shape-polymorphic programs
    (captured and compiled by `export_child` beside phases 8-18d), served
    from their bundles alone at lengths no bucket covers (ZOO_POLY_LENGTHS,
    SHORT_POLY_LENGTHS from the JAX package's bound up, and each model's
    former bound, 8 of phase 3's requests cut or zero-padded to each, no
    padding by the runner), through `eet::conformer_block` (12 launches a
    call for the splitformer, 19 for the zipformer). Their tokens are held
    to the eager `Recognizer.transcribe` of the same model under the token
    contract, pooled and at each exit that transcribes (its WER over the 8
    whole requests, against refs, at most 30%). The splitformer's gated poly
    program (one program an exit, stepped by `ExportedRecognizer.gated`:
    ROADMAP C8) at the same lengths, `gated_poly`. Prints compile
    seconds, package MB and ms a call beside the bucket programs' (phase
    14c)."""
    import torch
    from early_exit_tpu_torch import checkpoint
    from early_exit_tpu_torch.configs import AudioConfig
    from early_exit_tpu_torch.serving import export as ex
    from early_exit_tpu_torch.serving.recognizer import Recognizer, wer_pct
    from early_exit_tpu_torch.tokenizer import load_decoder

    t_phase = time.perf_counter()
    capture_s, aoti = zoo_export["capture_s"], zoo_export["aoti"]
    print("18a. the zoo's poly programs captured beside phases 8-18d (" + ", ".join(
        f"{n} {capture_s[n + '.poly']:.1f} s" for n in zoo_export["models"]) + ") and "
        "compiled beside them (" + ", ".join(
            f"{n} {k} {secs:.1f} s" for n in zoo_export["models"]
            for k, (secs, _) in aoti[n + ".poly"].items()) + ")")
    acfg = AudioConfig(mel_method="dft")
    tok = load_decoder(checkpoint.bound_tokenizer(checkpoint.load_calib()))
    Bk, Sk = EXPORT_BUCKET
    launches = {}

    def request(S):
        w = torch.zeros(Bk, S, device=dev)
        w[:, :min(S, wav.shape[1])] = wav[:Bk, :S]
        return w, counts[:Bk].clamp(max=S).to(torch.int32)

    for name, m in zoo_export["models"].items():
        L = 12 if name == "splitformer" else 19
        path = os.path.join(zoo_export["dir"], f"{name}.poly.eetx")
        bundle = ex.load_bundle(path)
        man = bundle.manifest
        s_min = man["shapes"]["poly"]["min_samples"]
        if s_min != acfg.hop_length * 10:
            fail(f"18a: {name}'s poly bundle says min_samples {s_min}, not the JAX "
                 f"package's hop * 10")
        bucket = aoti[name]
        print(f"18a. {name} poly bundle {os.path.getsize(path) / 1e6:.1f} MB, min_samples "
              f"{s_min}, max_samples {man['shapes']['poly']['max_samples']}; " + "; ".join(
                  f"{k}: AOTInductor {secs:.1f} s, package {len(bundle.packages[k]) / 1e6:.1f} "
                  f"MB" for k, secs in man["aoti_compile_s"].items()) + "; the bucket "
              f"programs: " + "; ".join(f"{k}: {secs:.1f} s, {mb:.1f} MB"
                                        for k, (secs, mb) in bucket.items()))
        nodes = {k: c.get("eet::conformer_block", 0)
                 for k, c in man["op_nodes"]["cuda"].items()}
        # the splitformer's gated program: one program an exit, 2 blocks each
        want_nodes = {"poly": L, **{f"gated/poly/{e}": 2 for e in range(6)
                                    if name == "splitformer"}}
        if nodes != want_nodes:
            fail(f"18a: {name}'s poly graphs hold {nodes} block op nodes, expected "
                 f"{want_nodes}")
        rec_x = ex.ExportedRecognizer(path)
        rec_e = Recognizer(m, tok, acfg=acfg, device=dev)
        n_launch, per_exit, lengths = 0, None, (*ZOO_POLY_LENGTHS, *SHORT_POLY_LENGTHS,
                                                  ZOO_FORMER_BOUND[name])
        for S in lengths:
            w, c = request(S)
            w_np, c_np = w.cpu().numpy(), c.cpu().numpy()
            reset_counts()
            t, n, _ = rec_x(w_np, c_np)
            got = read_counts()
            want = {k: (L if k == "conformer_block_bf16" else 0) for k in got}
            if got != want:
                fail(f"18a: {name} poly at S={S}: launches {got}, expected {want}")
            n_launch += L
            eager = rec_e.transcribe(w, c)
            if t.shape != tuple(eager.tokens.shape):
                fail(f"18a: {name} poly at S={S}: tokens {t.shape}, eager "
                     f"{tuple(eager.tokens.shape)}")
            dis = disagreement(torch.from_numpy(t), torch.from_numpy(n), eager.tokens,
                               eager.n_tokens)
            per_exit = dis if per_exit is None else [
                (a + e, b + u) for (a, b), (e, u) in zip(per_exit, dis)]
        whole = rec_e.transcribe(*request(max(ZOO_POLY_LENGTHS)))
        wers = [round(wer_pct(refs[:Bk], t), 2) for t in whole.texts]
        _hold_token_contract(f"18a. {name} poly program at S = {lengths} ({Bk} rows each) vs "
                             f"Recognizer.transcribe (exit WERs {wers})", per_exit, wers)
        if name == "splitformer":
            gated_poly(m, rec_x, acfg, request, lengths, reset_counts, read_counts,
                       "18a. the splitformer's")
        run = rec_x._fn("poly")
        w8, c8 = wav[:Bk].contiguous(), counts[:Bk].to(torch.int32).contiguous()
        with torch.no_grad():
            t_p = cuda_ms(lambda: run(w8, c8), 20, 3)
        print(f"18a. {name} on {card}: the poly program {t_p:.3f} ms a call at {Bk} x "
              f"{Sk / acfg.sample_rate:.0f} s (CUDA events), the {Bk}x{Sk} bucket program "
              f"{zoo_export['bucket_ms'][name]:.3f} ms (14c)")
        launches[name] = n_launch
        rec_x.close()
    return {"launches": launches, "secs": time.perf_counter() - t_phase}


def gated_poly(m, rec_x, acfg, request, lengths, reset_counts, read_counts, what: str,
               score: str = "maxprob", direct: bool = False) -> list:
    """A model's gated poly program from its bundle (one program an exit,
    stepped on the host) at each of `lengths` and at thresholds 0, 1.01
    and the widest gap among the middle rows' exit-1 confidences: n block
    launches an exit run (n blocks an exit; as many exits as the deepest
    chosen one), chosen exits equal to eager `gated_apply`'s on every
    row; the chosen tokens' disagreement with the eager gate's greedy
    tokens printed. direct: the bundle's poly program called as it is,
    where `ExportedRecognizer.gated` would pad a short request into a
    bucket's. Returns the thresholds used at each length."""
    import numpy as np
    import torch
    from early_exit_tpu_torch.models.early_exit_gate import exit_confidence, gated_apply
    from early_exit_tpu_torch.ops import ctc, frontend
    from early_exit_tpu_torch.decoding.lexicon import edit_distance
    npe, E = m.cfg.n_enc_layers_per_exit, m.cfg.n_enc_exits
    seen, edits, total, rows, used = set(), 0, 0, 0, []
    for S in lengths:
        w, c = request(S)
        w_np, c_np = w.cpu().numpy(), c.cpu().numpy()
        feats = frontend.mel_spectrogram(w, acfg, method=acfg.mel_method)
        flen = frontend.mel_lengths(c, acfg.hop_length)
        with torch.no_grad():
            lp, sub = m.encode_exit(feats, flen, 1)
            mask = torch.arange(lp.shape[1], device=w.device)[None, :] < sub[:, None]
            c1 = exit_confidence(lp, mask, score).sort().values
        lo, hi = len(c1) // 4, 3 * len(c1) // 4
        j = lo + int((c1[lo + 1:hi + 1] - c1[lo:hi]).argmax())
        thrs = (0.0, 1.01, float(c1[j:j + 2].mean()))
        used.append((S, thrs))
        for thr in thrs:
            reset_counts()
            if direct:      # the poly program whatever the length: no bucket
                t, n, ch = (v.cpu().numpy() for v in rec_x._gated_exits(
                    "poly", w, c, torch.tensor(thr, device=w.device)))
            else:
                t, n, ch = rec_x.gated(w_np, c_np, thr)
            got = read_counts()
            want = {k: (npe * int(ch.max()) if k == "conformer_block_bf16" else 0)
                    for k in got}
            if got != want:
                fail(f"{what} gated poly program at S={S}, threshold {thr}: launches "
                     f"{got}, expected {want}")
            with torch.no_grad():
                lp_e, ch_e, sl_e, _ = gated_apply(m, feats, flen, threshold=thr, score=score)
                te, ne = ctc.greedy_decode(lp_e, sl_e, blank=m.cfg.blank_id)
            if not np.array_equal(ch, ch_e.cpu().numpy()):
                fail(f"{what} gated poly program at S={S}, threshold {thr}, chooses other "
                     f"exits than gated_apply")
            te, ne = te.cpu(), ne.cpu()
            for i in range(len(ch)):
                edits += edit_distance(t[i, :n[i]].tolist(), te[i, :ne[i]].tolist())
                total += max(int(ne[i]), 1)
            seen.update(ch.tolist())
            rows += len(ch)
    print(f"{what} gated poly program ({E} programs, one an exit, stepped on the host) "
          f"at S = {lengths}, thresholds 0, 1.01 and the median gap: chosen exits equal "
          f"to eager gated_apply's on all {rows} rows (exits chosen {sorted(seen)}); its "
          f"tokens against the eager gate's {edits}/{total} edits / tokens")
    if not {1, E} <= seen:
        fail(f"{what} gated poly program never chose exit 1 or exit {E}")
    return used


def measure_phase(dev, card, reset_counts, read_counts, folded, x, lengths, kw) -> dict:
    """Phase 18b-d: the measuring tools on the card. (b) The ablation
    library (`conformer_block.cu` built with -DEET_ABLATE): its full block
    bit-equal to `eet_conformer_block_bf16` on the main path's input and
    within ABLATE_TIME_RTOL of its time over the flagship's 12 blocks;
    each ablation within phase 2's bf16 rule of the plain version with the
    same `ablate`; `ablate_fused_block`'s savings. (c) `ablate_head_path`,
    `bench_int8` and `ablate_decode` in child processes: the head kernel's
    ids equal torch.matmul heads' but at bf16 ties, the collapse variants
    equal, the int8 legs' tokens within the token contract of the bf16
    unfused leg's. (d) `warm_cache` at WARM_ARGS. Returns the children's
    launch counts, the ablation entry's launches and each part's seconds."""
    import torch
    from early_exit_tpu_torch import ablate_fused_block as afb
    from early_exit_tpu_torch import runtime
    from early_exit_tpu_torch.ops.kernels import conformer_block as kcb

    secs = {}
    t0 = time.perf_counter()
    akw = dict(n_heads=kw["n_heads"], kernel_size=kw["kernel_size"],
               attn_softmax_dtype=kw["attn_softmax_dtype"])
    with torch.no_grad():
        kcb.conformer_block_ablate.launches = 0
        y_p = kcb.conformer_block(folded[0], x, lengths, **kw)
        y_a = kcb.conformer_block_ablate(folded[0], x, lengths, **akw)
        torch.cuda.synchronize()
        if not torch.equal(y_p, y_a):
            fail("18b: the ablation library's full block differs from "
                 "eet_conformer_block_bf16")

        def stack(fn, **over):
            def run():
                y = x
                for f in folded:
                    y = fn(f, y, lengths, **over)
                return y
            return run

        t = [cuda_ms(stack(kcb.conformer_block, **kw), 10, 2),
             cuda_ms(stack(kcb.conformer_block_ablate, **akw), 10, 2),
             cuda_ms(stack(kcb.conformer_block_ablate, **akw), 10, 2),
             cuda_ms(stack(kcb.conformer_block, **kw), 10, 2)]
        prod, abl = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        print(f"18b. the ablation library's full block is bit-equal to the production "
              f"entry at (B={x.shape[0]}, T'={x.shape[1]}); {len(folded)} blocks on {card}: "
              f"production {t[0]:.4f} / {t[3]:.4f} ms, ablation library {t[1]:.4f} / "
              f"{t[2]:.4f} ms ({100 * (abl / prod - 1):+.2f}%)")
        if abs(abl / prod - 1) > ABLATE_TIME_RTOL:
            fail(f"18b: the ablation library's full block takes {abl:.4f} ms, the "
                 f"production entry {prod:.4f} ms")
        # each ablation on the tool's weights (N(0, 0.02), LayerNorm rows
        # included): the flagship's trained LayerNorm gains, left
        # unnormalised by "ln", grow the residual stream past 1e14, where
        # two float32 summation orders part by far more than a bf16 step
        f_r = afb.make_folded(torch.Generator().manual_seed(0), x.shape[2],
                              folded[0]["ffn1_w1"].shape[1], kw["kernel_size"], dev)
        outside = []
        for ab in afb.ABLATIONS[1:]:
            y_k = kcb.conformer_block_ablate(f_r, x, lengths, ablate=ab, **akw)
            y_pl = kcb.conformer_block_plain(f_r, x, lengths, ablate=ab, **kw)
            torch.cuda.synchronize()
            err, mean, ulps, frac = bf16_figures(y_k, y_pl)
            top = float(y_pl.float().abs().max())
            if "ln" in ab:
                # no LayerNorm normalises: a residual of scale `top` carries
                # the bf16 steps of its largest values into every row, so
                # the ulps are those of max|plain|
                ulps = err / 2.0 ** (math.floor(math.log2(max(top, 1.0))) - 7)
            print(f"18b. -{','.join(ab)}: against the plain version with the same ablate "
                  f"max|d| {err:.4g} (max|plain| {top:.4g}), {ulps:.2f} ulps"
                  f"{' of max|plain|' if 'ln' in ab else ''}, {100 * frac:.3f}% of values "
                  f"differ")
            if not torch.isfinite(y_k.float()).all() or ulps > BLOCK_MAX_ULPS \
                    or frac > BLOCK_DIFFERING:
                outside.append(ab)
        if outside:
            fail(f"18b: the ablations {outside} are outside the bf16 rule of their plain "
                 f"versions")
        afb.run(dev, x.shape[0], x.shape[1], x.shape[2], kw["n_heads"],
                folded[0]["ffn1_w1"].shape[1], kw["kernel_size"], len(folded), 10,
                out=lambda ln: print("18b. " + ln))
        torch.cuda.synchronize()
    ablate_launches = kcb.conformer_block_ablate.launches
    secs["b"] = time.perf_counter() - t0

    def child(name, args, env=None):
        t = time.perf_counter()
        proc = subprocess.run(runtime.module_command(name) + list(args), cwd=HERE,
                              env={**runtime.child_env(), **(env or {})},
                              capture_output=True, text=True, timeout=300)
        for ln in proc.stdout.splitlines():
            print(f"18. {name}: {ln}")
        if proc.returncode:
            fail(f"18: {name} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
        print(f"18. {name}: {time.perf_counter() - t:.1f} s in a child process")
        return proc.stdout

    def launches_of(out):
        line = [ln for ln in out.splitlines() if ln.startswith("launches: ")][-1]
        return json.loads(line[len("launches: "):])

    t0 = time.perf_counter()
    children = {}
    out = child("ablate_head_path", ["--iters", "10"], {"AB_B": "128"})
    children["ablate_head_path"] = launches_of(out)
    if " 0 not at a bf16 tie" not in out:
        fail("18c: ablate_head_path's kernel ids differ from torch.matmul's at a non-tie")
    out = child("bench_int8", ["128", "64", "--iters", "10"])
    children["bench_int8"] = launches_of(out)
    pairs = [ln.rsplit(" ", 1)[-1].split("/") for ln in out.splitlines()
             if "tokens vs bf16 unfused" in ln]
    dis = sum(int(a) for a, _ in pairs) / max(1, sum(int(b) for _, b in pairs))
    print(f"18c. bench_int8: every leg's last-exit tokens against the bf16 unfused leg's: "
          f"pooled disagreement {100 * dis:.3f}%")
    if len(pairs) != 8 or dis > TOKEN_DISAGREE:
        fail("18c: bench_int8's legs disagree with the bf16 unfused leg by > 1% pooled")
    child("ablate_decode", ["--iters", "50"])
    secs["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = child("warm_cache", ["--decoder_mode", "ctc", "--device", "cuda", *WARM_ARGS])
    if "done: 6 shape combinations warmed" not in out:
        fail("18d: warm_cache did not warm its 6 buckets")
    secs["d"] = time.perf_counter() - t0
    return {"child_launches": children, "ablate_launches": ablate_launches, "secs": secs}


def held_block(f, x, lengths, kw, what: str):
    """A block launch at the new widths on seeded weights, held by phase
    2's rule against a reference that rounds where the kernel rounds:
    every value within BLOCK_MAX_ULPS bf16 ulps of max(|y|, 1), and a share
    of the values differing within the limit below (for a float32 output
    -- float32 compute with the bf16 softmax, bf16 compute with the float32
    residual -- differing by more than F32_OUT_ULPS of a bf16 ulp: the
    float32 sums of the two sides differ in their last places everywhere,
    and the float32 residual carries the effect of one product rounded the
    other way to every row its keys reach). The
    bf16 entries' reference is the plain version run with the kernel's own
    products and LayerNorms (`kernel_products_and_norms`, as phase 13d
    holds the zipformer's stacks); the W8A8 entry's, its plain version run
    with the kernel's own LayerNorm + quantize (`kernel_quantized_norms`);
    float32 compute's, its plain version with every sum exact
    (`exact_sums`), where what remains is the bf16 rounding of the
    scores. The bf16-compute references take the kernel's own attention
    as well (`kernel_attention`): with the attention's sums exact
    instead, one score that rounds the other way reaches its whole row,
    and at d 1024 such rows were as many as a third of a misplaced
    rounding's. That attention launch is held in its turn, on the block's
    own q, k and v, against the plain attention with every sum exact and
    with P's control (`attention_figures`, `attention_held`'s rule). The
    ulps bound widens to the reference's own spread where that is larger:
    for float32 compute, the plain version itself against the reference.
    Controls, the same reference with a bf16 rounding skipped -- of the
    FFN's SiLU (bf16 compute), or of P (float32 compute with the bf16
    softmax) -- set the share's limit:
    SEEDED_DIFFERING of the entry, and at most a third of the nearer
    control's share, so that a misplaced rounding falls outside it even
    where the block barely moves its input. The figures against the plain
    version itself are printed beside them. Returns (max|d| against the
    plain version, the kernel's output)."""
    import torch
    from early_exit_tpu_torch.ops.kernels import conformer_block as kcb
    int8 = kw.get("quantize") == "int8"
    f32_compute = kw.get("compute_dtype") == torch.float32
    y_k = kcb.conformer_block(f, x, lengths, **kw)
    y_p = kcb.conformer_block_plain(f, x, lengths, **kw)
    err, mean, ulps_p, frac_p = bf16_figures(y_k, y_p)
    f32_out = y_k.dtype == torch.float32

    def figures(y, ref):
        """(max ulps, share differing) of y against ref"""
        ulps, frac = bf16_figures(y, ref)[2:]
        return ulps, f32_differing(y, ref) if f32_out else frac

    @contextlib.contextmanager
    def ref(held=None):
        if f32_compute:
            with exact_sums():
                yield
            return
        with (kernel_quantized_norms(f) if int8 else kernel_products_and_norms(f=f)), \
                kernel_attention(held):
            yield
    controls = ([("P", None)] if f32_compute else
                [("the FFN's SiLU", f["ffn1_w1"].shape[1])])
    held = []
    with ref(held):
        y_g = kcb.conformer_block_plain(f, x, lengths, **kw)
    with ref():
        ctl = []
        for name, width in controls:
            with skipped_rounding(width):
                y_c = kcb.conformer_block_plain(f, x, lengths, **kw)
            ctl.append((name, *figures(y_k, y_c)))
            del y_c
    spread, spread_frac = figures(y_p, y_g) if f32_compute else (0.0, 0.0)
    ulps, frac = figures(y_k, y_g)
    bound = max(BLOCK_MAX_ULPS, spread)
    limit = min(SEEDED_DIFFERING["w8a8" if int8 else "bf16"], min(c for _, _, c in ctl) / 3)
    print(f"{what}: vs its reference max ulps {ulps} values differing {frac} (held: "
          f"{bound} ulps, the reference's own spread {spread} ulps, {spread_frac} of the "
          f"values; {limit:.4g}); controls, "
          f"the reference with the rounding of "
          + ", ".join(f"{n} skipped: max ulps {u} values differing {c}" for n, u, c in ctl)
          + f"; vs the plain version max|d| {err} mean|d| {mean} max ulps {ulps_p} "
          f"values differing {frac_p}"
          + "".join(f"; its attention on the block's q, k, v, {attention_line(sm, fig)}"
                    for sm, fig in held))
    if not torch.isfinite(y_k.float()).all() or ulps > bound or frac > limit:
        fail(f"{what}: the block kernel lies outside phase 2's rule of its reference")
    if not all(fig[-1] for _, fig in held):
        fail(f"{what}: the block's attention kernel disagrees with its plain version on "
             f"the block's own q, k and v")
    return err, y_k


def attention_held(B, H, T, dh, dev, g, what: str) -> float:
    """The bf16 entries' attention (`block_attention`, the mma.sync kernel
    inside the bf16, W8A8 and float32-residual blocks) on seeded q, k, v
    of B items, H heads of dh padded as the block pads them (zero
    columns), T keys, lengths T x (B - 2), a short item and an empty one,
    in both softmax dtypes, each held by `attention_figures`. Returns the
    largest max|d|."""
    import torch
    import torch.nn.functional as F
    from early_exit_tpu_torch.ops.kernels import conformer_block as kcb
    dhp = kcb.padded_head(dh)
    q, k, v = (F.pad(torch.randn(B, H, T, dh, generator=g), (0, dhp - dh)).to(
        dev, torch.bfloat16) for _ in range(3))
    lens = torch.tensor([T] * (B - 2) + [max(T // 7, 1), 0], device=dev)
    valid = torch.arange(T, device=dev)[None, :] < lens[:, None]
    worst = 0.0
    for sm in (torch.bfloat16, torch.float32):
        y = kcb.block_attention(q, k, v, valid, dh, sm)
        fig = attention_figures(y, q, k, v, valid, dh, sm, kcb._attention)
        worst = max(worst, fig[0])
        print(f"{what}, {attention_line(sm, fig)}")
        if not fig[-1]:
            fail(f"{what}: the block's attention kernel disagrees with its plain version")
    return worst


def heads_held(hh, ww, bb, what: str, exact: bool):
    """head_argmax against its plain version on (E, B, T', D) hidden
    states: every id equal where `exact` (dyadic inputs, whose sums are
    exact in any order). Else an id may differ only at a near-tie of the
    sum order: the two chosen columns' logits, from the float64 sums
    rounded as both sides round (float32, bf16, + the bf16 bias), within
    HEAD_NEAR_TIE_ULPS bf16 ulps of each other. Returns the ids."""
    import torch
    from early_exit_tpu_torch.ops.kernels import head_argmax as kha
    ids_k = kha.head_argmax(hh, ww, bb)
    ids_p = kha.head_argmax_plain(hh, ww, bb)
    diff = ids_k != ids_p
    n_diff = int(diff.sum())
    gap = 0.0
    if n_diff:
        e, b_, t_ = diff.nonzero(as_tuple=True)
        h = hh[e, b_, t_].double()

        def logit(col):
            s = (h * ww[e, :, col].double()).sum(-1).float().to(torch.bfloat16)
            return (s + bb[e, col]).float()
        la, lc = logit(ids_k[diff]), logit(ids_p[diff])
        top = torch.maximum(la.abs(), lc.abs()).clamp_min(2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
        gap = float(((la - lc).abs() / ulp).max())
    print(f"{what}: head_argmax vs plain, {ids_k.numel()} rows (E={hh.shape[0]}, D="
          f"{hh.shape[-1]}, V={ww.shape[-1]}): {n_diff} ids differ"
          + ("" if exact else f", the two logits of each at most {gap} bf16 ulps apart "
             f"(held: {HEAD_NEAR_TIE_ULPS})"))
    if n_diff if exact else gap > HEAD_NEAR_TIE_ULPS:
        fail(f"{what}: head_argmax kernel differs from its plain version")
    return ids_k


def seeded_block(D: int, H: int, F: int, seed: int, dev, K: int = 31):
    """One Conformer block at (d_model D, H heads, d_ff F, k K) from the
    port's initialisation at `seed`, folded three ways in the card's
    padded layout (bf16, float32, W8A8), on `dev`: (f_bf16, f_f32,
    f_w8a8)."""
    import torch
    from early_exit_tpu_torch.models.conformer import ConformerConfig, ConformerStack
    from early_exit_tpu_torch.ops.kernels import conformer_block as kcb
    stack = ConformerStack(ConformerConfig(d_model=D, n_heads=H, d_ff=F, kernel_size=K), 1)
    stack.init(torch.Generator().manual_seed(seed))
    sd = stack.blocks[0].state_dict()
    on = lambda f: {k: v.to(dev) for k, v in f.items()}
    return (on(kcb.fold_block_params(sd, n_heads=H)),
            on(kcb.fold_block_params(sd, compute_dtype=torch.float32, n_heads=H)),
            on(kcb.fold_block_params(sd, quantize="int8", n_heads=H)))


def dyadic_head(E, B, T, D, V, seed, dev):
    """Head operands whose products and partial sums are all exact in
    float32 (small dyadic values), so the kernel and its plain version
    round the same logits to bf16 whatever the order of their sums, and
    the exact ties among them are the same on both sides: (E, B, T, D)
    hidden, (E, D, V) head, (E, V) bias, bf16. Columns V - 1 and, past
    256, 256 are copies of columns 100 and 255: exact ties across the
    kernel's 256-column V tiles, which win on part of the rows."""
    import torch
    # drawn on the device: the main path's rows at D 1024 are 196M values
    r = torch.Generator(device=dev).manual_seed(seed)

    def draw(lo, hi, shape, div):
        return (torch.randint(lo, hi, shape, generator=r, device=dev).float() / div).to(
            torch.bfloat16)
    h = draw(-4, 5, (E, B, T, D), 4)
    w = draw(-4, 5, (E, D, V), 16)
    b = draw(-8, 9, (E, V), 16)
    # the pairs win on part of the rows: exit 0 lifts (255, 256), exit 1
    # (100, V - 1), by 2 (a logit's spread is ~0.1 sqrt(D))
    for e, (src, dst) in enumerate(((255, 256), (min(100, V - 1), V - 1))):
        if dst < V and src != dst:
            w[:, :, dst], b[:, dst] = w[:, :, src], b[:, src]
            if e < E:
                b[e, src] += 2.0
                b[e, dst] = b[e, src]
    return h.contiguous(), w.contiguous(), b.contiguous()


def widths_kernels(dev, card) -> dict:
    """Phase 19a: each kernel instantiation past the flagship's widths
    against its plain version on the card (WIDTH_BLOCKS, WIDTH_HEADS,
    WIDTH_ATT_DH at WIDTH_ATT_T, the W8A8 LayerNorm + quantize at d 512).
    Returns the largest max|d| of each new row's checks."""
    import torch
    from early_exit_tpu_torch.ops.kernels import attention as katt
    from early_exit_tpu_torch.ops.kernels import conformer_block as kcb
    from early_exit_tpu_torch.ops.kernels import head_argmax as kha
    g = torch.Generator(device="cpu").manual_seed(19)
    t0 = time.perf_counter()
    errs = {"1@d512": 0.0, "1b@d512": 0.0, "1c@d512": 0.0, "3@dh64": 0.0,
            "2@V32": 0.0, "2@V5000·D512": 0.0}
    with torch.no_grad():
        # -- the block, three entries, B=8 at T'=249 with a short and an empty item
        for name, (D, H, F) in WIDTH_BLOCKS.items():
            attention_held(8, H, 249, D // H, dev, g, f"19a. the block's attention at {H} "
                           f"heads of {D // H} (B=8, T'=249, lengths 249 x 6, 35, 0)")
            fb, f32, f8 = seeded_block(D, H, F, 190, dev)
            x = torch.randn(8, 249, D, generator=g).to(dev, torch.bfloat16)
            lengths = torch.tensor([249] * 6 + [37, 0], dtype=torch.int32, device=dev)
            kw = dict(n_heads=H, kernel_size=31)
            for entry, f, over in (
                    ("bf16", fb, dict(attn_softmax_dtype=torch.bfloat16)),
                    ("w8a8", f8, dict(attn_softmax_dtype=torch.bfloat16, quantize="int8")),
                    ("w8a8, float32 softmax", f8, dict(quantize="int8")),
                    ("float32", f32, dict(compute_dtype=torch.float32,
                                          residual_dtype=torch.float32))):
                what = (f"19a. conformer_block {entry} at d {D}, {H} heads (dh {D // H}), "
                        f"ff {F}, seeded (B=8, T'=249, lengths 249 x 6, 37, 0)")
                if entry != "float32":
                    err, y_k = held_block(f, x, lengths, {**kw, **over}, what)
                else:
                    y_k = kcb.conformer_block(f, x.float(), lengths, **kw, **over)
                    y_p = kcb.conformer_block_plain(f, x.float(), lengths, **kw, **over)
                    err = float((y_k - y_p).abs().max())
                    print(f"{what}: vs plain max|d| {err} (tolerance {F32_BLOCK_ATOL})")
                    if not torch.isfinite(y_k).all() or err > F32_BLOCK_ATOL:
                        fail(f"{what}: the float32 block kernel disagrees with its plain "
                             f"version")
                if (y_k[-1] != 0).any():
                    fail(f"{what}: the empty item is not all zeros")
                if D == 512:
                    row = {"bf16": "1@d512", "float32": "1c@d512"}.get(entry, "1b@d512")
                    errs[row] = max(errs[row], err)
            del fb, f32, f8
        # -- the attention at dh 16 and 64, both input types
        for dh in WIDTH_ATT_DH:
            for T in WIDTH_ATT_T:
                lens = torch.tensor([T, max(T // 2, 1), 0], device=dev)
                mask = torch.arange(T, device=dev)[None, :] < lens[:, None]
                q, k, v = (torch.randn(3, 4, T, dh, generator=g).to(dev) for _ in range(3))
                for dt in (torch.bfloat16, torch.float32):
                    qq, kk, vv = (t.to(dt) for t in (q, k, v))
                    o_k = katt.fused_attention(qq, kk, vv, mask)
                    o_p = katt.fused_attention_plain(qq, kk, vv, mask)
                    torch.cuda.synchronize()
                    rel = float((o_k - o_p).abs().max() / vv.float().abs().max())
                    print(f"19a. attention vs plain, dh {dh}, T={T}, {dt}: max|d| / max|v| "
                          f"{rel:.3e} (tolerance {ATT_RTOL})")
                    if not rel <= ATT_RTOL:
                        fail(f"attention kernel disagrees with its plain version at dh {dh}, "
                             f"T={T}, {dt}")
                    if dh == 64:
                        errs["3@dh64"] = max(errs["3@dh64"], float((o_k - o_p).abs().max()))
        # -- the head at any V, D 256 and 512, on dyadic inputs with ties
        # across the V tiles: ragged rows (E=3 x 3 x 83, one item a block)
        # and the main path's rows (E=6 x 128 x 249: a block's run crosses
        # exits and reloads its head, the rings wrap)
        for V, D in WIDTH_HEADS:
            for E, B, T in ((3, 3, 83), (6, 128, 249)):
                h, w, b = dyadic_head(E, B, T, D, V, V + D, dev)
                lg = (torch.matmul(h.float(), w.float()[:, None]).to(torch.bfloat16)
                      + b[:, None, None]).float()
                ties = int(((lg == lg.amax(-1, keepdim=True)).sum(-1) > 1).sum())
                del lg
                kind = "resident" if V <= 256 and D <= 256 else "streamed"
                heads_held(h, w, b, f"19a. dyadic, {B} x {T} rows an exit ({kind} head, "
                           f"{ties} rows with an exact tie at the maximum)", exact=True)
                del h, w, b
        # -- the W8A8 LayerNorm + quantize at d 512, value for value
        rows = torch.randn(4099, 512, generator=g).to(dev, torch.bfloat16)
        gg = (1 + 0.3 * torch.randn(512, generator=g)).to(dev)
        bb = (0.2 * torch.randn(512, generator=g)).to(dev)
        q_k, s_k = kcb.layer_norm_quantize(rows, gg, bb)
        q_p, s_p = kcb.layer_norm_quantize_plain(rows, gg, bb)
        torch.cuda.synchronize()
        n_q, n_s = int((q_k != q_p).sum()), int((s_k != s_p).sum())
        print(f"19a. layer_norm_quantize vs plain at d 512 (4099 rows): {n_q} int8 values "
              f"and {n_s} scales differ")
        if n_q or n_s:
            fail("layer_norm_quantize kernel differs from its plain version at d 512")
        errs.update(widths_kernels_any(dev, g))
    print(f"phase 19a: {time.perf_counter() - t0:.1f} s on {card}")
    return errs


def widths_kernels_any(dev, g) -> dict:
    """Phase 19a, the rest: every width the JAX package's Pallas kernels
    take, on the card's padded layout (WIDTH_BLOCKS_ANY in the five
    entries -- bf16, W8A8 with either softmax, float32 and float32
    compute with the bf16 softmax -- and bf16 compute with the float32
    residual, held by `held_block` or, float32, within F32_BLOCK_ATOL;
    WIDTH_ATT_DH_ANY at WIDTH_ATT_T; WIDTH_HEADS_ANY on dyadic inputs;
    WIDTH_LNQ_ANY value for value). Returns the largest max|d| of each
    new row's checks."""
    import torch
    import torch.nn.functional as F
    from early_exit_tpu_torch.ops.kernels import attention as katt
    from early_exit_tpu_torch.ops.kernels import conformer_block as kcb
    bf, f32 = torch.bfloat16, torch.float32
    errs = {}
    for name, (D, H, Fd, K) in WIDTH_BLOCKS_ANY.items():
        t0 = time.perf_counter()
        err = attention_held(8, H, 249, D // H, dev, g, f"19a. the block's attention at {H} "
                             f"heads of {D // H} (padded to {kcb.padded_head(D // H)}; B=8, "
                             f"T'=249, lengths 249 x 6, 35, 0)")
        if name in ("conformer_s", "d1024"):
            key = "1@144" if name == "conformer_s" else "1@d1024"
            errs[key] = max(errs.get(key, 0.0), err)
        fb, ff, f8 = seeded_block(D, H, Fd, 191, dev, K)
        P = kcb.pitch(D)
        x = F.pad(torch.randn(8, 249, D, generator=g), (0, P - D)).to(dev, bf)
        lengths = torch.tensor([249] * 6 + [37, 0], dtype=torch.int32, device=dev)
        kw = dict(n_heads=H, kernel_size=K, d_model=D)
        plan = kcb.block_plan(D, H, Fd, K)
        for entry, f, over in (
                ("bf16", fb, dict(attn_softmax_dtype=bf)),
                ("w8a8", f8, dict(attn_softmax_dtype=bf, quantize="int8")),
                ("w8a8, float32 softmax", f8, dict(quantize="int8")),
                ("float32", ff, dict(compute_dtype=f32, residual_dtype=f32)),
                ("float32 compute, bf16 softmax", ff,
                 dict(compute_dtype=f32, residual_dtype=f32, attn_softmax_dtype=bf)),
                ("bf16 compute, float32 residual", fb,
                 dict(residual_dtype=f32, attn_softmax_dtype=bf))):
            k = {**kw, **over}
            xx = x.to(k.get("residual_dtype", bf))
            what = (f"19a. conformer_block {entry} at d {D} (pitch {P}), {H} heads of "
                    f"{D // H} (padded to {kcb.padded_head(D // H)}), "
                    f"ff {Fd} (to {plan.ff_pad}), k {K}, seeded (B=8, T'=249, lengths 249 x 6, "
                    f"37, 0)")
            if entry != "float32":
                err, y_k = held_block(f, xx, lengths, k, what)
            else:
                y_k = kcb.conformer_block(f, xx, lengths, **k)
                err = float((y_k - kcb.conformer_block_plain(f, xx, lengths, **k)).abs().max())
                print(f"{what}: vs plain max|d| {err} (tolerance {F32_BLOCK_ATOL})")
                if not torch.isfinite(y_k).all() or err > F32_BLOCK_ATOL:
                    fail(f"{what}: the float32 block kernel disagrees with its plain version")
            if (y_k[-1] != 0).any() or (y_k[..., D:] != 0).any():
                fail(f"{what}: the empty item or the padded columns are not all zeros")
            if name in ("conformer_s", "d1024"):
                row = {"bf16": "1", "float32": "1c", "float32 compute, bf16 softmax": "(i)",
                       "bf16 compute, float32 residual": "(ii)"}.get(entry, "1b")
                row += "@144" if name == "conformer_s" else "@d1024"
                errs[row] = max(errs.get(row, 0.0), err)
        del fb, ff, f8
        print(f"19a. the block at d {D}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for dh in WIDTH_ATT_DH_ANY:
        for T in WIDTH_ATT_T:
            lens = torch.tensor([T, max(T // 2, 1), 0], device=dev)
            mask = torch.arange(T, device=dev)[None, :] < lens[:, None]
            q, k, v = (torch.randn(3, 4, T, dh, generator=g).to(dev) for _ in range(3))
            for dt in (bf, f32):
                qq, kk, vv = (t.to(dt) for t in (q, k, v))
                o_k = katt.fused_attention(qq, kk, vv, mask)
                o_p = katt.fused_attention_plain(qq, kk, vv, mask)
                torch.cuda.synchronize()
                rel = float((o_k - o_p).abs().max() / vv.float().abs().max())
                print(f"19a. attention vs plain, dh {dh} (padded to "
                      f"{next(w for w in katt.HEAD_WIDTHS if w >= dh)}), T={T}, {dt}: max|d| / "
                      f"max|v| {rel:.3e} (tolerance {ATT_RTOL})")
                if not rel <= ATT_RTOL or o_k.shape != q.shape:
                    fail(f"attention kernel disagrees with its plain version at dh {dh}, "
                         f"T={T}, {dt}")
                row = f"3@dh{dh}"
                errs[row] = max(errs.get(row, 0.0), float((o_k - o_p).abs().max()))
    print(f"19a. the attention kernel at dh {WIDTH_ATT_DH_ANY}: "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for V, D in WIDTH_HEADS_ANY:
        for E, B, T in ((3, 3, 83), (6, 128, 249)):
            h, w, b = dyadic_head(E, B, T, D, V, V + D, dev)
            kind = ("resident" if V <= 256 and D <= 256 else "streamed" if D <= 512
                    else "k-tiled")
            heads_held(h, w, b, f"19a. dyadic, {B} x {T} rows an exit ({kind} head)",
                       exact=True)
            del h, w, b
    print(f"19a. the head at (V, D) {WIDTH_HEADS_ANY}: {time.perf_counter() - t0:.1f} s")
    for D in WIDTH_LNQ_ANY:
        P = kcb.pitch(D)
        rows = F.pad(torch.randn(4099, D, generator=g), (0, P - D)).to(dev, bf)
        gg = F.pad(1 + 0.3 * torch.randn(D, generator=g), (0, P - D)).to(dev)
        bb = F.pad(0.2 * torch.randn(D, generator=g), (0, P - D)).to(dev)
        q_k, s_k = kcb.layer_norm_quantize(rows, gg, bb, d_model=D)
        q_p, s_p = kcb.layer_norm_quantize_plain(rows, gg, bb, d_model=D)
        torch.cuda.synchronize()
        n_q, n_s = int((q_k != q_p).sum()), int((s_k != s_p).sum())
        print(f"19a. layer_norm_quantize vs plain at d {D} (pitch {P}, 4099 rows): {n_q} "
              f"int8 values and {n_s} scales differ")
        if n_q or n_s:
            fail(f"layer_norm_quantize kernel differs from its plain version at d {D}")
    return errs


def d512_config():
    """The d-512 early conformer the JAX CLI builds with --d_model 512
    --n_heads 8 --d_feed_forward 2048 --depthwise_kernel_size 31
    --n_enc_exits 6 --n_enc_layers_per_exit 2, BPE-256, in the inference
    profile (bf16, the block kernel)."""
    import dataclasses
    from early_exit_tpu_torch.configs import inference_profile
    return dataclasses.replace(inference_profile(fused_block=True), **D512)


def seeded_model(cfg, seed: int, dev):
    """A model of cfg from the port's initialisation at seed, on dev."""
    import torch
    from early_exit_tpu_torch.models.registry import build_model
    model = build_model(cfg)
    model.init(torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def widths_phase(dev, card, reset_counts, read_counts, corp, tmp, wav, counts,
                 calib, errs) -> dict:
    """Phase 19b-e: the d-512 early conformer (`d512_config`, the port's
    init at seed 0) served through the normal entries at B=128 x 10 s and
    through the inference CLI; the CLI with --bpe false at the flagship's
    widths (the head at V = 32); the new rows' times. errs: 19a's largest
    max|d| of each new row, raised here by 19b's. Returns the new rows."""
    import dataclasses
    import torch
    from early_exit_tpu_torch import checkpoint, inference
    from early_exit_tpu_torch.configs import inference_profile
    from early_exit_tpu_torch.models.gate_calibration import scaled_confidence
    from early_exit_tpu_torch.ops import ctc
    from early_exit_tpu_torch.ops.kernels import attention as katt
    from early_exit_tpu_torch.ops.kernels import conformer_block as kcb
    from early_exit_tpu_torch.ops.kernels import head_argmax as kha
    from early_exit_tpu_torch.serving.recognizer import Recognizer
    from early_exit_tpu_torch.tokenizer import load_decoder
    from early_exit_tpu_torch.training import checkpoint as tck
    t_start = time.perf_counter()
    B, N = wav.shape
    tok = load_decoder(checkpoint.bound_tokenizer(calib))
    cfg = d512_config()
    model = seeded_model(cfg, 0, dev)
    rec = Recognizer(model, tok, device=dev, calib=calib)
    folded = model.stack.folded()
    D, H, K = cfg.d_model, cfg.n_heads, cfg.depthwise_kernel_size
    kw = dict(n_heads=H, kernel_size=K, compute_dtype=cfg.dtype,
              residual_dtype=cfg.rdtype, attn_softmax_dtype=cfg.sm_dtype)
    heads_w, heads_b = model.heads_w.to(torch.bfloat16), model.heads_b.to(torch.bfloat16)
    npe = cfg.n_enc_layers_per_exit

    def launches_of(fn, what, **want):
        reset_counts()
        out = fn()
        got = read_counts()
        full = {k: want.get(k, 0) for k in got}
        print(f"19. {what}: launches {got}")
        if got != full:
            fail(f"{what}: launches {got}, expected {full}")
        return out, got

    with torch.no_grad():
        # -- 19b. the all-exit greedy path: launches, every block launch by
        # phase 2's rule, each exit's head ids against the plain head
        out_k, got = launches_of(lambda: rec.transcribe(wav, counts),
                                 f"19b. d-512 all-exit path (B={B} x 10 s)",
                                 conformer_block_bf16=len(folded), head_argmax=1)
        n_blocks = got["conformer_block_bf16"]
        feats, lengths_f = rec._features(wav, counts)
        x, sub_len, mask = model.frontend_embed(feats, lengths_f)
        x, lengths = x.contiguous(), mask.sum(1, dtype=torch.int32)
        x_in = x
        hs = []
        for i, f in enumerate(folded):
            err, y_k = held_block(f, x, lengths, kw, f"19b. d-512 block {i + 1} on the kernel "
                                  f"path's own input (B={B} x 10 s)")
            errs["1@d512"] = max(errs["1@d512"], err)
            x = y_k
            if (i + 1) % npe == 0:
                hs.append(y_k)
        hid = torch.stack(hs).contiguous()
        heads_held(hid, heads_w, heads_b, "19b. d-512: the head kernel at D 512 on the "
                   "kernel path's hidden states", exact=False)
        # the W8A8 and float32 entries, each block on its own kernel path's
        # input at the same size
        q_model = seeded_model(dataclasses.replace(cfg, quantize="int8"), 0, dev)
        f_cfg = dataclasses.replace(cfg, compute_dtype="float32", attn_softmax_dtype="float32")
        f_model = seeded_model(f_cfg, 0, dev)
        kw8 = dict(kw, quantize="int8")
        kw32 = dict(kw, compute_dtype=f_cfg.dtype, residual_dtype=f_cfg.rdtype,
                    attn_softmax_dtype=f_cfg.sm_dtype)
        xq, x32 = x_in, x_in.to(f_cfg.rdtype)
        for i, (fq, f32) in enumerate(zip(q_model.stack.folded(), f_model.stack.folded())):
            err, xq = held_block(fq, xq, lengths, kw8, f"19b. d-512 W8A8 block {i + 1} on "
                                 f"the kernel path's own input (B={B} x 10 s)")
            errs["1b@d512"] = max(errs["1b@d512"], err)
            y_p = kcb.conformer_block_plain(f32, x32, lengths, **kw32)
            x32 = kcb.conformer_block(f32, x32, lengths, **kw32)
            err = float((x32 - y_p).abs().max())
            print(f"19b. d-512 float32 block {i + 1} on the kernel path's own input (B={B} x "
                  f"10 s): vs plain max|d| {err} (tolerance {F32_BLOCK_ATOL})")
            if not torch.isfinite(x32).all() or err > F32_BLOCK_ATOL:
                fail(f"19b. d-512 float32 block {i + 1}: the float32 block kernel disagrees "
                     f"with its plain version")
            errs["1c@d512"] = max(errs["1c@d512"], err)
        del xq, x32, y_p
        # the per-exit token disagreement against the plain path (reported:
        # random weights transcribe nothing)
        xp, hp = x_in, []
        for i, f in enumerate(folded):
            xp = kcb.conformer_block_plain(f, xp, lengths, **kw)
            if (i + 1) % npe == 0:
                hp.append(xp)
        ids_pp = kha.head_argmax_plain(torch.stack(hp), heads_w, heads_b)
        E, Bn, T = ids_pp.shape
        tp, n_p = ctc.greedy_decode_ids(ids_pp.reshape(E * Bn, T), sub_len.repeat(E))
        dis = disagreement(out_k.tokens, out_k.n_tokens, tp.reshape(E, Bn, T).cpu(),
                           n_p.reshape(E, Bn).cpu())
        print(f"19b. d-512 greedy tokens, kernel path vs plain-version path: per exit "
              f"{[f'{e}/{t}' for e, t in dis]} (edits / tokens; the 1% contract is "
              f"reported, not applied: the seeded model transcribes nothing); tokens "
              f"per utterance at exit 6 {float(out_k.n_tokens[-1].float().mean()):.1f}")

        # -- 19c. the gated paths: the cascade with bf16 and with W8A8 blocks,
        # under the committed calibration and with exit k's threshold at the
        # batch's median confidence, chosen exits equal to the while-loop gate's
        k_casc = int(calib.get("cascade_k") or 2)
        gated = {}
        rec_q = Recognizer(q_model, tok, device=dev, calib=calib)
        for entry, r in (("bf16", rec), ("w8a8", rec_q)):
            gate = r.gate_settings()
            lp, sl = r.model.encode_exit(*r._features(wav, counts), k_casc)
            m = torch.arange(lp.shape[1], device=dev)[None, :] < sl[:, None]
            conf = scaled_confidence(lp, m, gate["score"], gate["temperatures"][k_casc - 1])
            thr = list(gate["threshold"])
            thr[k_casc - 1] = float(conf.sort().values[B // 2 - 1:B // 2 + 1].mean())
            for what, c in (("committed calibration", calib),
                            ("exit k's threshold at the median", {**calib, "thresholds": thr})):
                r.calib = c
                reset_counts()
                out = r.transcribe_gated(wav, counts)
                got = read_counts()
                want = k_casc * npe + ((cfg.n_enc_exits - k_casc) * npe
                                       if out.rows_packed else 0)
                gate_out = r.transcribe_gated(wav, counts, strategy="whileloop")
                agree = int((out.chosen_exit == gate_out.chosen_exit).sum())
                hist = torch.bincount(out.chosen_exit.long(),
                                      minlength=cfg.n_enc_exits + 1)[1:].tolist()
                print(f"19c. d-512 cascade, {entry} blocks, {what}: launches {got} "
                      f"(expected {want} {entry} block launches); rows per exit {hist}, "
                      f"escalated {100 * out.escalated_share:.2f}% ({out.rows_packed} rows "
                      f"packed); chosen exits equal to the while-loop gate's on "
                      f"{agree}/{B} rows")
                others = {k: v for k, v in got.items() if k != "conformer_block_" + entry and v}
                if got["conformer_block_" + entry] != want or others or agree != B:
                    fail(f"19c. d-512 cascade ({entry}, {what}): launches {got} or chosen "
                         f"exits unlike the while-loop gate's on {B - agree} rows")
                gated[(entry, what)] = got["conformer_block_" + entry]
            r.calib = calib
        q8_0 = q_model.stack.folded()[0]
        del rec_q, q_model

    # -- 19d. the inference CLI at d 512, and with --bpe false at the
    # flagship's widths, over phase 9's corpus
    def cli(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            inference.main(argv)
        return buf.getvalue()

    n_batches = [0]
    exit_outputs = inference.exit_outputs

    def counted(*a, **k):
        n_batches[0] += 1
        return exit_outputs(*a, **k)

    ck512 = os.path.join(tmp, "d512")
    tck.save_epoch(ck512, 0, model)
    # the flagship's widths (the CLI's defaults) with the JAX CLI's
    # character vocabulary (early_exit_tpu/cli.py:430-432)
    char_cfg = dataclasses.replace(inference_profile(fused_block=True), vocab_size=32,
                                   blank_id=0, pad_id=30, bos_id=1, eos_id=31)
    char_model = seeded_model(char_cfg, 1, dev)
    ck_char = os.path.join(tmp, "char")
    tck.save_epoch(ck_char, 0, char_model)
    d512_flags = [a for k, v in D512.items() for a in (f"--{k}", str(v))]
    cli_launches = {}
    inference.exit_outputs = counted
    try:
        for name, ck, extra in (
                ("d-512", ck512, d512_flags),
                ("--bpe false", ck_char, ["--bpe", "false"])):
            argv = ["--decoder_mode", "ctc", "--load_model_path",
                    os.path.join(ck, "mod000-transformer"), "--data_root", corp["root"],
                    "--eval_splits", "test-clean", "--fused_block", "true", *extra]
            n_batches[0] = 0
            reset_counts()
            t0 = time.perf_counter()
            out = cli(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = read_counts()
            nb = n_batches[0]
            n_lines = sum("BEAM_OUT_" in ln for ln in out.splitlines())
            wers = [ln.split(": ", 1)[1] for ln in out.splitlines() if " WER exit " in ln]
            print(f"19d. `python -m early_exit_tpu_torch.inference --decoder_mode ctc "
                  f"--fused_block true {' '.join(extra)}` over {len(corp['corpus'])} "
                  f"utterances: launches {got} over {nb} sub-batches; {n_lines} BEAM_OUT "
                  f"lines; WER per exit {wers}; {corp['audio_s'] / wall:.1f} audio-s/s on "
                  f"{card}")
            others = {k: v for k, v in got.items()
                      if k not in ("conformer_block_bf16", "head_argmax") and v}
            if (nb == 0 or got["conformer_block_bf16"] != 12 * nb
                    or got["head_argmax"] != nb or others
                    or n_lines != 6 * len(corp["corpus"])):
                fail(f"19d. the {name} CLI: {got} over {nb} sub-batches, {n_lines} lines; "
                     f"expected 12 block and 1 head launches a sub-batch, 6 lines an "
                     f"utterance")
            cli_launches[name] = got["head_argmax"]
    finally:
        inference.exit_outputs = exit_outputs

    # -- 19e. the new rows' times at B=128 x 10 s (T' 249)
    with torch.no_grad():
        full = torch.full_like(counts, N)
        feats, lengths_f = rec._features(wav, full)
        x, _, mask = model.frontend_embed(feats, lengths_f)
        x, lengths = x.contiguous(), mask.sum(1, dtype=torch.int32)
        T, F = x.shape[1], cfg.d_feed_forward
        f32_0 = f_model.stack.folded()[0]
        blocks = block_rows(folded[0], f32_0, q8_0, x, lengths, kw)
        rows = {"1@d512": dict(
            blocks["bf16"], launches=n_blocks,
            path=f"the d-512 all-exit path (19b, B={B}); the cascade's (19c): "
                 + ", ".join(f"{n} ({w})" for (e, w), n in gated.items() if e == "bf16")
                 + "; the d-512 inference CLI (19d)")}
        rows["1c@d512"] = blocks["f32"]
        rows["1b@d512"] = dict(
            blocks["w8a8"], launches=gated[("w8a8", "exit k's threshold at the median")],
            path="the d-512 W8A8 cascade (19c), exit k's threshold at the median; "
                 f"{gated[('w8a8', 'committed calibration')]} under the committed "
                 f"calibration")
        # the heads, each held against its plain version before it is
        # timed: V 32 at D 256 (the char model's hidden states), V 5000 at
        # D 512 (the d-512 model's, with a seeded 5000-column head)
        _, hs512 = model.stack(x, mask, collect_outputs=True, collect_every=npe)
        hid512 = hs512.to(torch.bfloat16).contiguous()
        xc, _, mc = char_model.frontend_embed(*rec._features(wav, full))
        _, hsc = char_model.stack(xc.contiguous(), mc, collect_outputs=True,
                                  collect_every=npe)
        hid_c = hsc.to(torch.bfloat16).contiguous()
        w_c, b_c = char_model.heads_w.to(torch.bfloat16), char_model.heads_b.to(torch.bfloat16)
        v_model = seeded_model(dataclasses.replace(cfg, vocab_size=5000), 2, dev)
        w5k, b5k = v_model.heads_w.to(torch.bfloat16), v_model.heads_b.to(torch.bfloat16)
        reset_counts()
        ids5k, _ = Recognizer(v_model, tok, device=dev).exit_ids(wav, full)
        n5k = read_counts()["head_argmax"]
        hid_v = v_model.apply_hidden(*rec._features(wav, full))[0]
        ids_v = heads_held(hid_v.to(torch.bfloat16).contiguous(), w5k, b5k,
                           "19e. the V-5000 model's own trunk (seed 2)", exact=False)
        if n5k != 1 or not torch.equal(ids5k, ids_v):
            fail("19e. the V-5000 model's exit_ids: not one head launch, or ids unlike "
                 "the head kernel's on its hidden states")
        del hid_v, ids_v
        heads_held(hid_c, w_c, b_c, "19e. the char model's trunk (V 32)", exact=False)
        heads_held(hid512, w5k, b5k, "19e. the d-512 trunk with the 5000-column head",
                   exact=False)
        big = torch.empty(8192, 8192, device=dev).normal_()
        for name, hh, ww, bb, n, path in (
                ("2@V32", hid_c, w_c, b_c, cli_launches["--bpe false"],
                 "the --bpe false inference CLI at the flagship's widths (19d)"),
                ("2@V5000·D512", hid512, w5k, b5k, n5k,
                 "`Recognizer.exit_ids` of the d-512 trunk with a seeded 5000-piece "
                 "head (19e)")):
            # behind ~20 ms of float32 FMAs
            rows[name] = dict(head_row(hh, ww, bb, behind=lambda: torch.matmul(big, big)),
                              launches=n, path=path)
        del v_model, ids5k, w5k, b5k, hid512, big
        # the attention at dh 64: the d-512 model unfused with the attention
        # kernel (attention_impl="pallas") on 16 requests, and timed at the
        # main path's shape on random q, k, v
        u_model = seeded_model(dataclasses.replace(cfg, fused_block=False,
                                                   attention_impl="pallas"), 0, dev)
        _, got = launches_of(lambda: Recognizer(u_model, tok, device=dev).transcribe(
            wav[:16], counts[:16]), "19e. d-512 unfused, attention_impl='pallas' (16 "
            "requests)", attention=len(folded))
        del u_model
        g = torch.Generator(device="cpu").manual_seed(64)
        qb, kb, vb = (torch.randn(B, H, T, D // H, generator=g).to(dev, torch.bfloat16)
                      for _ in range(3))
        maskf = torch.arange(T, device=dev)[None, :] < lengths[:, None]
        rows["3@dh64"] = dict(
            attention_row(qb, kb, vb, maskf), launches=got["attention"],
            path="the d-512 model unfused with attention_impl='pallas', 16 requests (19e)")
        _, got = launches_of(lambda: Recognizer(f_model, tok, device=dev).transcribe(
            wav[:16], counts[:16]), "19e. d-512 in float32 (16 requests)",
            conformer_block_f32=len(folded))
        del f_model
        rows["1c@d512"].update(launches=got["conformer_block_f32"],
                               path="the d-512 model's all-exit path in float32, 16 "
                                    "requests (19e)")
        e2e = cuda_ms(lambda: rec.exit_ids(wav, full), 5, 1)
    print(f"19e. times on {card} (B={B}, T'={T}, CUDA events; d {D}, {H} heads of "
          f"{D // H}, ff {F}):")
    for name, t in rows.items():
        by = "operations" if t["bound"][0] >= t["bound"][1] else "bytes"
        t["bound_ms"], t["bound_by"] = 1e3 * max(t["bound"]), by
        t["max_abs_err"] = errs[name]
        print(f"  {name}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({by}: "
              f"{t['bound'][0] * 1e3:.4f} ms ops, {t['bound'][1] * 1e3:.4f} ms bytes), "
              f"{t['launches']} launches on a path")
    print(f"  the d-512 all-exit forward (exit_ids): {e2e:.3f} ms per {B} x 10 s = "
          f"{B * N / 16000 / (e2e / 1e3):.1f} audio-s/s")
    print(f"phase 19b-e: {time.perf_counter() - t_start:.1f} s on {card}")
    return rows


def conformer_s_phase(dev, card, reset_counts, read_counts, corp, tmp, wav, counts,
                      errs) -> dict:
    """Phase 20: Conformer-S (`CONFORMER_S`, the port's init at seed 0,
    BPE-256, 16 blocks, 8 exits) served on the card through the normal
    entries at B=128 x 10 s: (a) `Recognizer.transcribe` (16 bf16 block
    launches and 1 head launch; the first and the last block launch held by
    `held_block` on the kernel path's own input, each exit's head ids
    against the plain head's, the per-exit token disagreement against the
    plain-version path printed), the forward's audio-s/s; (b)
    `Recognizer.cascade_pass` with bf16 and W8A8 blocks at thresholds 0,
    1.01 and exit 2's median confidence: chosen exits equal to the
    while-loop gate's (`gated_apply`) on every row; (c) `python -m
    early_exit_tpu_torch.inference --fused_block true` over the first
    N_CLI_S utterances of phase 9's corpus in the four profiles (bf16,
    --compute_dtype float32 with the CLI's bf16 softmax, --residual_dtype
    float32, --quantize int8) and unfused with --attention_impl pallas,
    each with its launches and audio-s/s; (d) the d-1024 model (`D1024`)
    on 16 requests in bf16, W8A8, float32, float32 with the bf16 softmax,
    the float32 residual and unfused with the attention kernel; (e) the new
    rows' times at B=128 x 10 s. errs: 19a's largest max|d| of each row.
    Returns the rows."""
    import dataclasses
    import torch
    from early_exit_tpu_torch import checkpoint, inference
    from early_exit_tpu_torch.configs import inference_profile
    from early_exit_tpu_torch.models.gate_calibration import scaled_confidence
    from early_exit_tpu_torch.ops import ctc
    from early_exit_tpu_torch.ops.kernels import conformer_block as kcb
    from early_exit_tpu_torch.ops.kernels import head_argmax as kha
    from early_exit_tpu_torch.serving.recognizer import Recognizer
    from early_exit_tpu_torch.tokenizer import load_decoder
    from early_exit_tpu_torch.training import checkpoint as tck
    t_start = time.perf_counter()
    B, N = wav.shape
    calib = checkpoint.load_calib()
    tok = load_decoder(checkpoint.bound_tokenizer(calib))
    cfg = dataclasses.replace(inference_profile(fused_block=True), **CONFORMER_S)
    model = seeded_model(cfg, 0, dev)
    rec = Recognizer(model, tok, device=dev, calib=calib)
    folded = model.stack.folded()
    L, npe, E = len(folded), cfg.n_enc_layers_per_exit, cfg.n_enc_exits
    D, H, K = cfg.d_model, cfg.n_heads, cfg.depthwise_kernel_size
    kw = dict(n_heads=H, kernel_size=K, compute_dtype=cfg.dtype, residual_dtype=cfg.rdtype,
              attn_softmax_dtype=cfg.sm_dtype, d_model=D)
    heads_w, heads_b = model.heads_w.to(torch.bfloat16), model.heads_b.to(torch.bfloat16)
    launches = {}

    def launches_of(fn, what, **want):
        reset_counts()
        out = fn()
        got = read_counts()
        full = {k: want.get(k, 0) for k in got}
        print(f"20. {what}: launches {got}")
        if got != full:
            fail(f"{what}: launches {got}, expected {full}")
        return out, got

    with torch.no_grad():
        # -- 20a. all-exit greedy
        out_k, got = launches_of(lambda: rec.transcribe(wav, counts),
                                 f"20a. Conformer-S all-exit path (B={B} x 10 s)",
                                 conformer_block_bf16=L, head_argmax=1)
        launches["1@144"] = got["conformer_block_bf16"]
        launches["2@D144"] = got["head_argmax"]
        feats, lengths_f = rec._features(wav, counts)
        x, sub_len, mask = model.frontend_embed(feats, lengths_f)
        x = torch.nn.functional.pad(x, (0, kcb.pitch(D) - D)).contiguous()
        lengths = mask.sum(1, dtype=torch.int32)
        hs, hp, xk, xp = [], [], x, x
        for i, f in enumerate(folded):
            if i in (0, L - 1):
                err, y_k = held_block(f, xk, lengths, kw, f"20a. Conformer-S block {i + 1} on "
                                      f"the kernel path's own input (B={B} x 10 s)")
                errs["1@144"] = max(errs.get("1@144", 0.0), err)
            else:
                y_k = kcb.conformer_block(f, xk, lengths, **kw)
            xk, xp = y_k, kcb.conformer_block_plain(f, xp, lengths, **kw)
            if (i + 1) % npe == 0:
                hs.append(xk[..., :D])
                hp.append(xp[..., :D])
        hid = torch.stack(hs).contiguous()
        heads_held(hid, heads_w, heads_b, "20a. Conformer-S: the head kernel at D 144 on the "
                   "kernel path's hidden states", exact=False)
        ids_pp = kha.head_argmax_plain(torch.stack(hp), heads_w, heads_b)
        Ee, Bn, T = ids_pp.shape
        tp, n_p = ctc.greedy_decode_ids(ids_pp.reshape(Ee * Bn, T), sub_len.repeat(Ee))
        dis = disagreement(out_k.tokens, out_k.n_tokens, tp.reshape(Ee, Bn, T).cpu(),
                           n_p.reshape(Ee, Bn).cpu())
        print(f"20a. Conformer-S greedy tokens, kernel path vs plain-version path: per exit "
              f"{[f'{e}/{t}' for e, t in dis]} (edits / tokens; the 1% contract is "
              f"reported, not applied: the seeded model transcribes nothing); tokens per "
              f"utterance at exit {E} {float(out_k.n_tokens[-1].float().mean()):.1f}")
        del hs, hp, xk, xp, hid
        full = torch.full_like(counts, N)
        e2e = cuda_ms(lambda: rec.exit_ids(wav, full), 5, 1)
        print(f"20a. the Conformer-S all-exit forward (exit_ids) on {card}: {e2e:.3f} ms per "
              f"{B} x 10 s = {B * N / 16000 / (e2e / 1e3):.1f} audio-s/s")
        profile_forward(lambda: rec.exit_ids(wav, full), "Conformer-S all-exit forward", card,
                        B, top=12)

        # -- 20b. the cascade, bf16 and W8A8 blocks, at thresholds 0, 1.01
        # and exit 2's median confidence (temperature 1)
        k_casc = 2
        q_model = seeded_model(dataclasses.replace(cfg, quantize="int8"), 0, dev)
        rec_q = Recognizer(q_model, tok, device=dev, calib=calib)
        gated = {}
        for entry, r in (("bf16", rec), ("w8a8", rec_q)):
            lp, sl = r.model.encode_exit(*r._features(wav, counts), k_casc)
            m = torch.arange(lp.shape[1], device=dev)[None, :] < sl[:, None]
            conf = scaled_confidence(lp, m, "maxprob", 1.0)
            med = float(conf.sort().values[B // 2 - 1:B // 2 + 1].mean())
            for label, thr in (("0", 0.0), ("1.01", 1.01),
                               ("exit 2's median", [2.0, med] + [2.0] * (E - 2))):
                r.calib = {"score": "maxprob", "thresholds": thr, "cascade_k": k_casc}
                reset_counts()
                out = r.transcribe_gated(wav, counts)
                got = read_counts()
                want = k_casc * npe + ((E - k_casc) * npe if out.rows_packed else 0)
                gate_out = r.transcribe_gated(wav, counts, strategy="whileloop")
                agree = int((out.chosen_exit == gate_out.chosen_exit).sum())
                hist = torch.bincount(out.chosen_exit.long(), minlength=E + 1)[1:].tolist()
                print(f"20b. Conformer-S cascade, {entry} blocks, threshold {label}: launches "
                      f"{got} (expected {want} {entry} block launches); rows per exit {hist}, "
                      f"escalated {100 * out.escalated_share:.2f}% ({out.rows_packed} rows "
                      f"packed); chosen exits equal to the while-loop gate's on {agree}/{B} rows")
                others = {k: v for k, v in got.items() if k != "conformer_block_" + entry and v}
                if got["conformer_block_" + entry] != want or others or agree != B:
                    fail(f"20b. Conformer-S cascade ({entry}, threshold {label}): launches "
                         f"{got} or chosen exits unlike the while-loop gate's on {B - agree} rows")
                gated[(entry, label)] = got["conformer_block_" + entry]
            r.calib = calib
        launches["1b@144"] = gated[("w8a8", "exit 2's median")]
        q0 = q_model.stack.folded()[0]
        del rec_q, q_model

    # -- 20c. the inference CLI over the first N_CLI_S utterances
    root = os.path.join(tmp, "conformer_s_corpus")
    for i in range(N_CLI_S):
        u = corp["corpus"][i]
        spk, ch = u.utterance_id.split("-")[:2]
        src = os.path.join(corp["root"], "LibriSpeech", "test-clean", spk, ch)
        dst = os.path.join(root, "LibriSpeech", "test-clean", spk, ch)
        os.makedirs(dst, exist_ok=True)
        shutil.copy(os.path.join(src, u.utterance_id + ".flac"), dst)
        with open(os.path.join(dst, f"{spk}-{ch}.trans.txt"), "a") as fo:
            fo.write(f"{u.utterance_id} {u.transcript}\n")
    audio_s = sum(len(w) for w in corp["waves"][:N_CLI_S]) / 16000.0
    ck = os.path.join(tmp, "conformer_s")
    tck.save_epoch(ck, 0, model)
    flags = [a for k, v in CONFORMER_S.items() for a in (f"--{k}", str(v))]
    n_batches = [0]
    exit_outputs = inference.exit_outputs

    def counted(*a, **k):
        n_batches[0] += 1
        return exit_outputs(*a, **k)

    cli_rates = {}
    inference.exit_outputs = counted
    try:
        for name, extra, entry, head in (
                ("bf16", [], "conformer_block_bf16", 1),
                ("--compute_dtype float32", ["--compute_dtype", "float32"],
                 "conformer_block_f32_sm_bf16", 0),
                ("--residual_dtype float32", ["--residual_dtype", "float32"],
                 "conformer_block_bf16_res_f32", 1),
                ("--quantize int8", ["--quantize", "int8"], "conformer_block_w8a8", 1),
                ("--fused_block false --attention_impl pallas",
                 ["--fused_block", "false", "--attention_impl", "pallas"], "attention", 0)):
            argv = ["--decoder_mode", "ctc", "--load_model_path",
                    os.path.join(ck, "mod000-transformer"), "--data_root", root,
                    "--eval_splits", "test-clean", "--fused_block", "true", *flags, *extra]
            n_batches[0] = 0
            reset_counts()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                inference.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = read_counts()
            nb, out = n_batches[0], buf.getvalue()
            n_lines = sum("BEAM_OUT_" in ln for ln in out.splitlines())
            want = {k: 0 for k in got}
            want[entry] = L * nb
            want["head_argmax"] = head * nb
            cli_rates[name] = audio_s / wall
            print(f"20c. `python -m early_exit_tpu_torch.inference --decoder_mode ctc "
                  f"--fused_block true {' '.join(flags + extra)}` over {N_CLI_S} utterances "
                  f"({audio_s:.1f} s): launches {got} over {nb} sub-batches; {n_lines} "
                  f"BEAM_OUT lines; {cli_rates[name]:.1f} audio-s/s on {card}")
            if nb == 0 or got != want or n_lines != E * N_CLI_S:
                fail(f"20c. the Conformer-S CLI ({name}): {got} over {nb} sub-batches, "
                     f"{n_lines} lines; expected {want} and {E} lines an utterance")
            launches[{"bf16": "1@144", "--compute_dtype float32": "(i)@144",
                      "--residual_dtype float32": "(ii)@144", "--quantize int8": "1b@144",
                      "--fused_block false --attention_impl pallas": "3@dh36"}[name] + ":cli"] = \
                got[entry]
    finally:
        inference.exit_outputs = exit_outputs

    with torch.no_grad():
        # -- 20d. the d-1024 model on 16 requests in each profile
        cfg_k = dataclasses.replace(inference_profile(fused_block=True), **D1024)
        Lk = D1024["n_enc_exits"] * D1024["n_enc_layers_per_exit"]
        models_k = {}
        for name, over, entry, head in (
                ("bf16", {}, "conformer_block_bf16", 1),
                ("W8A8", dict(quantize="int8"), "conformer_block_w8a8", 1),
                ("float32", dict(compute_dtype="float32", attn_softmax_dtype="float32"),
                 "conformer_block_f32", 0),
                ("float32 compute, bf16 softmax", dict(compute_dtype="float32"),
                 "conformer_block_f32_sm_bf16", 0),
                ("float32 residual", dict(residual_dtype="float32"),
                 "conformer_block_bf16_res_f32", 1),
                ("unfused, attention_impl='pallas'",
                 dict(fused_block=False, attention_impl="pallas"), "attention", 0)):
            m_k = seeded_model(dataclasses.replace(cfg_k, **over), 3, dev)
            _, got = launches_of(lambda: Recognizer(m_k, tok, device=dev).transcribe(
                wav[:16], counts[:16]), f"20d. d-1024 (8 heads of 128, 2 exits of 1 block) "
                f"{name} (16 requests)", **{entry: Lk, "head_argmax": head})
            row = {"bf16": "1@d1024", "W8A8": "1b@d1024", "float32": "1c@d1024",
                   "float32 compute, bf16 softmax": "(i)@d1024", "float32 residual":
                   "(ii)@d1024", "unfused, attention_impl='pallas'": "3@dh128"}[name]
            launches[row] = got[entry]
            if head:
                launches["2@D1024"] = got["head_argmax"]
            if name in ("bf16", "float32", "W8A8"):
                models_k[name] = m_k
            else:
                del m_k

        # -- 20e. the new rows' times at B=128 x 10 s
        feats, lengths_f = rec._features(wav, full)
        x, _, mask = model.frontend_embed(feats, lengths_f)
        lengths = mask.sum(1, dtype=torch.int32)
        f32_model = seeded_model(dataclasses.replace(cfg, compute_dtype="float32",
                                                     attn_softmax_dtype="float32"), 0, dev)
        _, got = launches_of(lambda: Recognizer(f32_model, tok, device=dev).transcribe(
            wav[:16], counts[:16]), "20e. Conformer-S in float32 (16 requests)",
            conformer_block_f32=L)
        launches["1c@144"] = got["conformer_block_f32"]
        rows = block_rows(folded[0], f32_model.stack.folded()[0], q0, x.contiguous(),
                          lengths, kw, sd=model.stack.blocks[0].state_dict(), new_profiles=True)
        rows_k = {}
        xk1, _, mk1 = models_k["bf16"].frontend_embed(feats, lengths_f)
        kwk = dict(n_heads=cfg_k.n_heads, kernel_size=cfg_k.depthwise_kernel_size,
                   compute_dtype=cfg_k.dtype, residual_dtype=cfg_k.rdtype,
                   attn_softmax_dtype=cfg_k.sm_dtype, d_model=cfg_k.d_model)
        rows_k = block_rows(models_k["bf16"].stack.folded()[0],
                            models_k["float32"].stack.folded()[0],
                            models_k["W8A8"].stack.folded()[0], xk1.contiguous(),
                            mk1.sum(1, dtype=torch.int32), kwk,
                            sd=models_k["bf16"].stack.blocks[0].state_dict(), new_profiles=True)
        _, hs144 = model.stack(x.contiguous(), mask, collect_outputs=True, collect_every=npe)
        _, hsk = models_k["bf16"].stack(xk1.contiguous(), mk1, collect_outputs=True,
                                        collect_every=1)
        big = torch.empty(8192, 8192, device=dev).normal_()
        behind = lambda: torch.matmul(big, big)
        m_b = models_k["bf16"]
        out_rows = {
            "2@D144": head_row(hs144.to(torch.bfloat16).contiguous(), heads_w, heads_b,
                               behind=behind),
            "2@D1024": head_row(hsk.to(torch.bfloat16).contiguous(),
                                m_b.heads_w.to(torch.bfloat16), m_b.heads_b.to(torch.bfloat16),
                                behind=behind)}
        del big, models_k, m_b, hs144, hsk
        T = x.shape[1]
        gq = torch.Generator(device="cpu").manual_seed(36)
        for name, h, dh in (("3@dh36", H, D // H), ("3@dh128", 8, 128)):
            qb, kb, vb = (torch.randn(B, h, T, dh, generator=gq).to(dev, torch.bfloat16)
                          for _ in range(3))
            maskf = torch.arange(T, device=dev)[None, :] < lengths[:, None]
            out_rows[name] = attention_row(qb, kb, vb, maskf)
            del qb, kb, vb
        for key, src in (("1@144", rows["bf16"]), ("1b@144", rows["w8a8"]),
                         ("1c@144", rows["f32"]), ("(i)@144", rows["f32_sm_bf16"]),
                         ("(ii)@144", rows["bf16_res_f32"]), ("1@d1024", rows_k["bf16"]),
                         ("1b@d1024", rows_k["w8a8"]), ("1c@d1024", rows_k["f32"]),
                         ("(i)@d1024", rows_k["f32_sm_bf16"]),
                         ("(ii)@d1024", rows_k["bf16_res_f32"])):
            out_rows[key] = src
        paths = {
            "1@144": f"the Conformer-S all-exit path (20a, B={B}); the CLI (20c): "
                     f"{launches['1@144:cli']}; the cascade's (20b): " + ", ".join(
                         f"{n} (threshold {t})" for (e, t), n in gated.items() if e == "bf16"),
            "1b@144": f"the Conformer-S W8A8 cascade (20b), exit 2's median threshold; the "
                      f"--quantize int8 CLI (20c): {launches['1b@144:cli']}",
            "1c@144": "Conformer-S in float32, 16 requests (20e)",
            "(i)@144": "the Conformer-S CLI with --compute_dtype float32 (the bf16 softmax, 20c)",
            "(ii)@144": "the Conformer-S CLI with --residual_dtype float32 (20c)",
            "2@D144": "the Conformer-S all-exit path (20a)",
            "3@dh36": "the Conformer-S CLI unfused with --attention_impl pallas (20c)",
            "3@dh128": "the d-1024 model unfused with attention_impl='pallas', 16 requests "
                       "(20d)",
            "2@D1024": "the d-1024 model's all-exit path, 16 requests (20d)"}
        for key in ("1@d1024", "1b@d1024", "1c@d1024", "(i)@d1024", "(ii)@d1024"):
            paths[key] = "the d-1024 model's all-exit path in its profile, 16 requests (20d)"
        launches["(i)@144"] = launches["(i)@144:cli"]
        launches["(ii)@144"] = launches["(ii)@144:cli"]
        launches["3@dh36"] = launches["3@dh36:cli"]
    print(f"20e. times on {card} (B={B}, T'={T}, CUDA events; Conformer-S d {D}, {H} heads "
          f"of {D // H}, ff {cfg.d_feed_forward}, k {K}; d-1024 8 heads of 128, ff 4096):")
    for name, t in out_rows.items():
        by = "operations" if t["bound"][0] >= t["bound"][1] else "bytes"
        t["bound_ms"], t["bound_by"] = 1e3 * max(t["bound"]), by
        t["max_abs_err"] = errs.get(name, 0.0)
        t["launches"], t["path"] = launches[name], paths[name]
        print(f"  {name}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({by}: "
              f"{t['bound'][0] * 1e3:.4f} ms ops, {t['bound'][1] * 1e3:.4f} ms bytes), "
              f"{t['launches']} launches on a path")
    print(f"20. CLI audio-s/s on {card}: " + ", ".join(f"{n} {v:.1f}" for n, v in
                                                      cli_rates.items()))
    print(f"phase 20: {time.perf_counter() - t_start:.1f} s on {card}")
    return out_rows


def profile_forward(forward, what: str, card: str, B: int, iters: int = 3,
                    top: int = 25, grad: bool = False, shape: str = None) -> float:
    """Device time per kernel name over `iters` calls of `forward` (each
    B x 10 s, or `shape`), and the share of the wall time the device was
    busy, which it returns. grad: autograd stays on (a train step)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    mode = torch.enable_grad() if grad else torch.no_grad()
    with mode, profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            forward()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    rows = sorted(((ev.key, ev.self_device_time_total / 1e3 / iters,
                    ev.count // iters) for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA),   # kernels only
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"profile of the {what} on {card} ({shape or f'B={B} x 10 s'}, "
          f"torch.profiler): wall {wall_ms:.3f} ms per call, device busy "
          f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}%), "
          f"{sum(r[2] for r in rows)} kernel launches per call")
    print(f"{'ms/call':>11} {'calls':>6}  kernel")
    for name, ms, n in rows[:top]:
        print(f"{ms:11.4f} {n:6d}  {name[:110]}")
    return busy / wall_ms


def block_library(f, x, lengths, n_heads, mm=None):
    """Yardstick: the same block composed of library calls (cuBLAS
    products, or `mm` such as `library_int8_mm`'s, SDPA, cuDNN depthwise
    conv, torch LayerNorm). Timed here only; the port never calls it."""
    import torch
    import torch.nn.functional as F
    B, T, D = x.shape
    valid = torch.arange(T, device=x.device)[None, :] < lengths[:, None]
    if mm is None:
        def mm(v, w, b):     # an activation of another type than the weight's: cast
            return torch.matmul(v.to(f[w].dtype), f[w]) + f[b]

    def ln(v, g, b):
        return F.layer_norm(v, (D,), g.to(v.dtype), b.to(v.dtype))

    def ffn(v, pre):
        y = F.silu(mm(ln(v, f[pre + "_ln_g"], f[pre + "_ln_b"]), pre + "_w1", pre + "_b1"))
        return mm(y, pre + "_w2", pre + "_b2")

    x = x + 0.5 * ffn(x, "ffn1")
    qkv = mm(ln(x, f["attn_ln_g"], f["attn_ln_b"]), "wqkv", "bqkv")
    q, k, v = (t.reshape(B, T, n_heads, D // n_heads).transpose(1, 2)
               for t in qkv.split(D, -1))
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=valid[:, None, None, :])
    x = x + mm(o.transpose(1, 2).reshape(B, T, D), "wo", "bo")
    y = mm(ln(x, f["conv_ln_g"], f["conv_ln_b"]), "pw1_w", "pw1_b")
    y = F.glu(y, dim=-1) * valid[..., None]
    k_ = f["dw_w"].shape[0]
    yt = y.transpose(1, 2)
    if k_ % 2 == 0:          # an even kernel: the extra tap on the right, as the block's
        yt = F.pad(yt, (0, 1))
    y = F.conv1d(yt, f["dw_w"].t()[:, None, :], f["dw_b"].to(y.dtype),
                 padding=(k_ - 1) // 2, groups=D).transpose(1, 2)
    y = F.silu(y * f["bn_scale"].to(y.dtype) + f["bn_shift"].to(y.dtype))
    x = x + mm(y, "pw2_w", "pw2_b")
    x = x + 0.5 * ffn(x, "ffn2")
    return ln(x, f["final_ln_g"], f["final_ln_b"]) * valid[..., None]


def library_int8_mm(f):
    """The W8A8 products for `block_library`: a row quantize in torch ops,
    torch._int_mm on the int8 twins, the float32 rescale and bias."""
    import torch

    def mm(v, name, bias):
        v2 = v.reshape(-1, v.shape[-1]).float()
        sx = v2.abs().amax(-1, keepdim=True).clamp_min(1e-8) / 127
        q = (v2 / sx).round().clamp(-127, 127).to(torch.int8)
        y = torch._int_mm(q, f[name + "_t"].t()).float() * (sx * f[name + "_s"]) + f[bias]
        return y.to(torch.bfloat16).reshape(*v.shape[:-1], -1)
    return mm


def block_rows(fb, f32, q8, x, lengths, kw, sd=None, new_profiles=False) -> dict:
    """Rows 1, 1c and 1b: the block's bf16, float32 and W8A8 entries on
    the folded params fb, f32 and q8 at x's shape (B, T', D), bf16, by
    CUDA events: {"bf16", "f32", "w8a8"} -> {ms, plain_ms, library_ms,
    bound}. kw: the bf16 entry's keywords; the float32 entry runs in
    float32 throughout. bound: (seconds of operations, seconds of bytes):
    the ten products, the scores and P V, and the conv's taps at the
    card's peak rate for their type (the W8A8 products at int8's); x read
    and y written once, the weights and lengths read once -- all at the
    model's widths, not the padded layout's. sd (the block's state_dict):
    the layouts are the card's padded ones; the library yardstick and the
    weights' bytes take the unpadded layouts folded from sd. new_profiles:
    also "f32_sm_bf16" (float32 compute with the bf16 softmax, on f32;
    its yardstick the float32 composition) and "bf16_res_f32" (bf16
    compute with a float32 residual, on fb; the bf16 composition on a
    float32 residual)."""
    import torch
    from early_exit_tpu_torch.ops.kernels import conformer_block as kcb
    B, T, P = x.shape
    D = kw.get("d_model") or P
    R, H = B * T, kw["n_heads"]
    F = fb["ffn1_w1"].shape[1] if sd is None else sd["ffn1.w1"].shape[1]
    gemm_ops = 2 * R * D * (4 * F + 3 * D + D + 2 * D + D)
    blk_flops = gemm_ops + 4 * B * H * T * T * (D // H) + 2 * R * D * kw["kernel_size"]
    if sd is None:
        lb, l32, l8 = fb, f32, q8
    else:
        lb, l32, l8 = (kcb.fold_block_params(sd, compute_dtype=cd, quantize=q)
                       for cd, q in ((torch.bfloat16, None), (torch.float32, None),
                                     (torch.bfloat16, "int8")))
        lb, l32, l8 = ({k: v.to(x.device) for k, v in f.items()} for f in (lb, l32, l8))
    xl = x[..., :D].contiguous()

    def nbytes(f, names=None):
        return sum(t.numel() * t.element_size() for n, t in f.items()
                   if names is None or n in names)
    kw32 = dict(kw, compute_dtype=torch.float32, residual_dtype=torch.float32,
                attn_softmax_dtype=torch.float32)
    kw8 = dict(kw, quantize="int8")
    x32 = x.float()
    rows = {
        "bf16": dict(
            ms=cuda_ms(lambda: kcb.conformer_block(fb, x, lengths, **kw)),
            plain_ms=cuda_ms(lambda: kcb.conformer_block_plain(fb, x, lengths, **kw), 5, 1),
            library_ms=cuda_ms(lambda: block_library(lb, xl, lengths, H)),
            bound=(blk_flops / PEAK_BF16, (2 * R * D * 2 + nbytes(lb) + B * 4) / PEAK_BYTES)),
        "f32": dict(
            ms=cuda_ms(lambda: kcb.conformer_block(f32, x32, lengths, **kw32), 10, 2),
            plain_ms=cuda_ms(lambda: kcb.conformer_block_plain(f32, x32, lengths, **kw32),
                             5, 1),
            library_ms=cuda_ms(lambda: block_library(l32, xl.float(), lengths, H), 10, 2),
            bound=(blk_flops / PEAK_F32, (2 * R * D * 4 + nbytes(l32) + B * 4) / PEAK_BYTES)),
        "w8a8": dict(
            ms=cuda_ms(lambda: kcb.conformer_block(q8, x, lengths, **kw8)),
            plain_ms=cuda_ms(lambda: kcb.conformer_block_plain(q8, x, lengths, **kw8), 5, 1),
            library_ms=cuda_ms(lambda: block_library(l8, xl, lengths, H,
                                                     mm=library_int8_mm(l8))),
            bound=(gemm_ops / PEAK_INT8 + (blk_flops - gemm_ops) / PEAK_BF16,
                   (2 * R * D * 2 + nbytes(l8, kcb.PARAM_ORDER_INT8) + B * 4) / PEAK_BYTES))}
    if new_profiles:
        kwi = dict(kw32, attn_softmax_dtype=torch.bfloat16)
        kwii = dict(kw, residual_dtype=torch.float32)
        rows["f32_sm_bf16"] = dict(
            ms=cuda_ms(lambda: kcb.conformer_block(f32, x32, lengths, **kwi), 10, 2),
            plain_ms=cuda_ms(lambda: kcb.conformer_block_plain(f32, x32, lengths, **kwi),
                             5, 1),
            library_ms=rows["f32"]["library_ms"],
            bound=rows["f32"]["bound"])
        rows["bf16_res_f32"] = dict(
            ms=cuda_ms(lambda: kcb.conformer_block(fb, x32, lengths, **kwii)),
            plain_ms=cuda_ms(lambda: kcb.conformer_block_plain(fb, x32, lengths, **kwii),
                             5, 1),
            library_ms=cuda_ms(lambda: block_library(lb, xl.float(), lengths, H)),
            bound=(blk_flops / PEAK_BF16, (2 * R * D * 4 + nbytes(lb) + B * 4) / PEAK_BYTES))
    return rows


def head_row(hid, w, b, behind=None) -> dict:
    """Row 2: head_argmax on (E, B, T', D) bf16 hidden states and the (E,
    D, V) head, by CUDA events (the kernel behind `behind`'s work where
    given, so that a launch shorter than the host's time to make it is
    timed on the device), its plain version, and torch.matmul + argmax.
    bound: the E x rows x D x V products at bf16's peak; the hidden rows,
    the head and the bias read once, the int32 ids written once."""
    import torch
    from early_exit_tpu_torch.ops.kernels import head_argmax as kha
    E, B, T, D = hid.shape
    R = B * T
    return dict(
        ms=cuda_ms(lambda: kha.head_argmax(hid, w, b), behind=behind),
        plain_ms=cuda_ms(lambda: kha.head_argmax_plain(hid, w, b)),
        library_ms=cuda_ms(lambda: torch.argmax(
            torch.matmul(hid, w[:, None]) + b[:, None, None], -1)),
        bound=(2 * E * R * D * w.shape[-1] / PEAK_BF16,
               (hid.numel() * 2 + w.numel() * 2 + b.numel() * 2 + E * R * 4) / PEAK_BYTES))


def attention_row(q, k, v, mask) -> dict:
    """Row 3: fused_attention on bf16 (B, H, T', dh) q, k, v under the
    (B, T') key mask, by CUDA events, and on their float32 copies
    (ms_f32_in), its plain version, and SDPA on the float32 copies.
    bound: Q K^T and P V at float32's peak; q, k, v read, the float32
    output written and the mask read once."""
    import torch
    from early_exit_tpu_torch.ops.kernels import attention as katt
    B, H, T, dh = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    return dict(
        ms=cuda_ms(lambda: katt.fused_attention(q, k, v, mask)),
        ms_f32_in=cuda_ms(lambda: katt.fused_attention(qf, kf, vf, mask)),
        plain_ms=cuda_ms(lambda: katt.fused_attention_plain(q, k, v, mask)),
        library_ms=cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qf, kf, vf, attn_mask=mask[:, None, None, :])),
        bound=(4 * B * H * T * T * dh / PEAK_F32,
               (3 * q.numel() * 2 + q.numel() * 4 + mask.numel()) / PEAK_BYTES))


if __name__ == "__main__":
    main()
