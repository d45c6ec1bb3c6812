"""Training entry point of the port: CTC or AED training of the
early-exit Conformer, the same surface as the JAX package's `train.py`.

    python -m early_exit_tpu_torch.train --decoder_mode ctc|aed \\
        --synthetic_data true [--device cpu] ...

Build the model (fresh Xavier init from --seed, a checkpoint file, or an
average of epoch checkpoints) -> the data pipeline -> Noam-AdamW with
warmup defaulting to one epoch of sub-batches -> one train step per
sub-batch, with `step N loss ... grad_norm ... RATE:` every 50 steps and
(CTC mode) a sample greedy decode every 500 -> `LOSS_TOTAL-e :=` per
epoch -> save
the model and optimizer pair when the epoch loss improves (`saving:`,
else `WORST:`), keeping the newest --keep_last_ckpts. A run resumes from
the newest complete pair in --save_model_dir. Runs on CUDA unless
--device cpu; raises without a GPU otherwise.

The corpus is --train_split of the LibriSpeech layout under --data_root,
or the synthetic corpus with --synthetic_data true.

--model_type picks the CTC model: early_conformer, splitformer (its two
branch blocks trained with the trunk) or early_zipformer (which needs
--n_enc_exits 19 --n_enc_layers_per_exit 1: 19 blocks, one exit).
--dynamic_chunk trains the early_conformer only, as the JAX package; the
zoo trains with full attention. --decoder_mode aed trains a
`full_conformer` on the joint loss aed_ce_weight x decoder cross-entropy
+ aed_ctc_weight x CTC.

--conv_norm group trains the masked GroupNorm(1) of the JAX package's
unfused path (with --fused_block false: the block kernel folds BatchNorm
statistics, so a group-norm model with --fused_block true raises by
name). --attention_impl pallas raises in training, as in the JAX
package.

Data and tensor parallelism: under `torchrun` (WORLD_SIZE > 1) each
process is one rank,

    torchrun --nproc_per_node 4 -m early_exit_tpu_torch.train \
        --dp 2 --tp 2 [--device cpu] ...

on the mesh data={dp} x model={tp} (`parallel.make_mesh`; --dp defaults
to WORLD_SIZE // --tp, and dp x tp must equal WORLD_SIZE). --device cpu
runs gloo; on CUDA each rank takes cuda:(LOCAL_RANK % device_count) and
NCCL, and raises without it. The mesh's first rank prints, logs, decodes
the sample and writes the checkpoints (the gathered whole trees, the
files of a single-rank run); every rank resumes from them, whatever the
layout that wrote them. A world of one is the single-process path.
"""

from __future__ import annotations

import os
import sys
import time

import torch
import torch.distributed as dist

from early_exit_tpu_torch import parallel, runtime
from early_exit_tpu_torch.cli import get_args
from early_exit_tpu_torch.data.pipeline import Pipeline
from early_exit_tpu_torch.data.librispeech import LibriSpeechDataset, SyntheticDataset
from early_exit_tpu_torch.models.registry import build_model
from early_exit_tpu_torch.ops import ctc
from early_exit_tpu_torch.training import checkpoint
from early_exit_tpu_torch.training.trainer import Trainer
from early_exit_tpu_torch.utils.metrics import MetricsLogger
from early_exit_tpu_torch.utils.model_utils import count_parameters

LOG_EVERY = 50
DECODE_EVERY = 500


def setup_parallel(args):
    """(device, mesh): the mesh is None in a world of one (no process
    group). Under torchrun: the process group (gloo on the CPU, NCCL on
    CUDA) and the data x model mesh, dp and tp resolved as the JAX
    package's train.py does."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    tp = max(args.tp, 1)
    dp = args.dp if args.dp is not None else max(world // tp, 1)
    if dp * tp != world:
        raise ValueError(f"data x tensor parallelism over --dp {dp} x --tp {tp} = "
                         f"{dp * tp} ranks, but WORLD_SIZE is {world}: launch dp x tp "
                         f"processes with torchrun")
    device = runtime.resolve_device(args.device)
    if world == 1:
        return device, None
    rank = int(os.environ["RANK"])
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("--device cuda with --dp/--tp needs NCCL, which this "
                               "PyTorch lacks")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method="env://", world_size=world,
                                rank=rank, device_id=device)
    else:
        dist.init_process_group("gloo", init_method="env://", world_size=world, rank=rank)
    return device, parallel.make_mesh(dp=dp, tp=tp)


def build_dataset(args):
    if args.synthetic_data:
        return SyntheticDataset(n_items=max(args.batch_size * 4, 64), seed=args.seed)
    try:
        return LibriSpeechDataset(args.data_root, args.train_split)
    except FileNotFoundError as e:
        sys.exit(f"{e}\n(use --data_root to point at LibriSpeech, or "
                 f"--synthetic_data true for a smoke run)")


@torch.no_grad()
def sample_decode(model: torch.nn.Module, batch, tokenizer) -> None:
    """Greedy decode of the sub-batch's first utterance at the last exit,
    with the inference path (the block and head kernels with
    --fused_block on CUDA)."""
    logp, sub_len = model.apply(batch["feats"][:1], batch["feat_lengths"][:1])
    toks, n = ctc.greedy_decode(logp[-1], sub_len, blank=model.cfg.blank_id)
    ll = int(batch["label_lengths"][0])
    print("EXPECTED:", tokenizer.decode(batch["labels"][0, 1:ll].tolist()).lower())
    print("CTC_OUT :", tokenizer.decode(toks[0, :int(n[0])].tolist()).lower())


def _resolve_dir(path: str) -> str:
    return path if os.path.isabs(path) else os.path.join(os.getcwd(), path.lstrip("/"))


def main(argv=None) -> None:
    args, model_cfg, train_cfg, audio_cfg, tokenizer = get_args(argv)
    device, mesh = setup_parallel(args)
    first = mesh is None or mesh.is_first
    say = print if first else (lambda *a, **k: None)
    if device.type == "cuda":
        runtime.exact_float32()
    model = build_model(model_cfg).to(device)
    model.init(torch.Generator(device=device).manual_seed(args.seed))
    if args.load_model_path is not None:
        checkpoint.load_model_file(model, args.load_model_path)
        say(f"loaded checkpoint: {args.load_model_path}")
    elif None not in (args.load_model_dir, args.avg_model_start, args.avg_model_end):
        checkpoint.avg_models(model, args.load_model_dir, args.avg_model_start,
                              args.avg_model_end)
        say(f"averaged checkpoints {args.avg_model_start}.."
            f"{args.avg_model_end} from {args.load_model_dir}")
    say(f"The model has {count_parameters(model):,} trainable parameters")
    if mesh is not None:
        parallel.replicate([*model.parameters(), *model.buffers()], mesh)
        parallel.shard_params(model, mesh)
        say(f"mesh: data={mesh.dp} x model={mesh.tp}")

    pipe = Pipeline(build_dataset(args), tokenizer, audio_cfg, train_cfg,
                    bpe=args.bpe, shuffle=args.shuffle, seed=args.seed,
                    workers=args.n_workers, device=device,
                    shard=None if mesh is None else (mesh.batch_rank, mesh.n_batch))
    warmup = args.warmup
    if warmup == -1:
        warmup = pipe.batches_per_epoch() * args.n_batch_split
    say("batch_size:", args.batch_size, " num_heads:", args.n_heads,
        " num_encoder_layers:", args.n_enc_layers_per_exit,
        " optimizer: NOAM[warmup", warmup, "] vocab_size:",
        model_cfg.vocab_size, "SOS,EOS,PAD", model_cfg.bos_id,
        model_cfg.eos_id, model_cfg.pad_id, "device:",
        torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    trainer = Trainer(model, train_cfg, warmup=warmup)
    logger = MetricsLogger(args.log_dir) if first else None
    moddir = _resolve_dir(args.save_model_dir)
    os.makedirs(moddir, exist_ok=True)

    start_epoch = 0
    if args.load_model_path is None and args.load_model_dir is None:
        resume, warning = checkpoint.resume_epoch(moddir)
        if warning:
            say(warning)
        if resume is not None:
            checkpoint.load_model_file(model, checkpoint.model_ckpt_path(moddir, resume))
            opt_path = checkpoint.opt_ckpt_path(moddir, resume)
            if os.path.exists(opt_path):
                checkpoint.load_opt_tree(model, trainer.opt,
                                         checkpoint.load_tree(opt_path))
            start_epoch = resume + 1
            say(f"auto-resume from epoch {resume} (step {trainer.step_count})")

    twin = []           # under tp: the whole model, for the sample decode

    def decode_sample(batch):
        if mesh is None or mesh.tp == 1:
            if first:
                sample_decode(model, batch, tokenizer)
            return
        tree = checkpoint.model_tree(model)         # a collective: every rank
        if first:
            if not twin:
                twin.append(build_model(model_cfg).requires_grad_(False).to(device))
            checkpoint.load_model_tree(twin[0], tree)
            sample_decode(twin[0], batch, tokenizer)

    best_loss = float("inf")
    prof, prof_left = None, args.profile_steps
    for epoch in range(start_epoch, train_cfg.n_epochs):
        t0 = time.time()
        # the loss stays on the device; the host reads it every LOG_EVERY steps
        loss_sum = torch.zeros((), device=device)
        n_batches = 0
        for i, batch in enumerate(pipe.epoch(epoch)):
            if args.profile_trace and prof is None and prof_left > 0 and i == 1:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                prof.__enter__()
            metrics = trainer.step(batch)
            if prof is not None:
                prof_left -= 1
                if prof_left <= 0:
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    prof.__exit__(None, None, None)
                    if first:
                        os.makedirs(args.profile_trace, exist_ok=True)
                        prof.export_chrome_trace(os.path.join(args.profile_trace,
                                                              "trace.json"))
                    prof = None
                    say(f"profiler trace written to {args.profile_trace}")
            loss_sum += metrics["loss"]
            n_batches += 1
            step = trainer.step_count
            if i % LOG_EVERY == 0 and first:
                loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
                lr = trainer.opt.schedule(step - 1)
                print(f"step {step} loss {loss:.4f} grad_norm {gnorm:.3f} "
                      f"RATE: {lr:.6e}")
                logger.log(step, {"loss": loss, "lr": lr, "grad_norm": gnorm})
            if i % DECODE_EVERY == 0 and train_cfg.decoder_mode == "ctc":
                decode_sample(batch)
        if n_batches == 0:
            sys.exit("empty epoch - no usable utterances")
        loss_total = float(loss_sum) / n_batches
        say(f"LOSS_TOTAL-{epoch} := {loss_total:.4f}  ({time.time() - t0:.1f}s, "
            f"{n_batches} sub-batches)")
        if first:
            logger.log(epoch, {"Total loss": loss_total})
        if loss_total < best_loss:
            best_loss = loss_total
            say("saving:", checkpoint.model_ckpt_path(moddir, epoch))
            checkpoint.save_epoch(moddir, epoch, model, trainer.opt)
            if first:
                pruned = checkpoint.prune_old(moddir, args.keep_last_ckpts)
                if pruned:
                    print(f"pruned {len(pruned)} old checkpoint(s) (--keep_last_ckpts "
                          f"{args.keep_last_ckpts}): epochs {pruned[0]}..{pruned[-1]}")
        else:
            say("WORST: not saving epoch", epoch)
    if first:
        logger.close()
    if mesh is not None:
        dist.barrier(group=mesh.group)
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
