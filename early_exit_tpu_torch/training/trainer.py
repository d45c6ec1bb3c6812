"""Training step of the early-exit Conformer, CTC and AED modes
(counterpart of `early_exit_tpu/training/trainer.py`).

One step: SpecAugment (optional) -> the training forward of every exit
(the zipformer has one) -> the sum over exits of each exit's CTC loss
(per row divided by its label length, then the mean over the real rows)
-> plus self-distillation (optional, CTC mode, more than one exit) ->
backward -> global-norm clip -> AdamW under the Noam schedule -> the new
BatchNorm statistics. In AED mode
(`FullConformer`) the decoders read labels[:, :-1] and the loss is
aed_ce_weight x (the sum over exits of the cross-entropy against
labels[:, 1:], every position counted, pad included, averaged per row
then over the real rows) + aed_ctc_weight x the CTC loss above. Plain
PyTorch with autograd: no TPU kernel lies on the JAX package's training
path.

Randomness: step n's seed is drawn from a CPU `torch.Generator` seeded
with (seed + 1, n), so a resumed run continues the same stream; from it
derive the SpecAugment uniforms (drawn on the features' device), the
dynamic-chunk choice (drawn on the host, `early_conformer` only, as in
the JAX package) and every dropout mask (see
`ConformerTrunk.train_hidden`).

Data and tensor parallelism (a model sharded by `parallel.shard_params`
over a mesh; each rank steps on its rows of the global batch): every
divisor is the global batch's (the real rows of the CTC and
cross-entropy means, the valid frames of the distillation), so each
rank's loss is its part of the global loss, and the gradients are summed
over the batch group, never averaged by its size (the bucket's padding
rows make the ranks' counts unequal). The step's seed, and so the chunk
mask, is the same on every rank; SpecAugment draws the global batch's
uniforms and each rank keeps its rows, so dp = N masks as dp = 1 does.
Dropout folds the rank's batch index into the model's seed
(`fold_seed`): the replicas of the data axis draw independent masks,
and the ranks of a model group the same ones; batch index 0 keeps the
seed, so a mesh of one rank steps exactly as no mesh.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from early_exit_tpu_torch.configs import ModelConfig, TrainConfig
from early_exit_tpu_torch.ops import ctc, specaugment
from early_exit_tpu_torch.optim.noam import NoamAdamW
from early_exit_tpu_torch.parallel import collectives

# dynamic-chunk training: chunk sizes in subsampled frames (40 ms each),
# ~0.5/1/2/4 s
CHUNK_SIZES = (12, 25, 50, 100)


def _global(t: torch.Tensor, mesh) -> torch.Tensor:
    """A count summed over the batch group (itself without a mesh)."""
    return t if mesh is None else collectives.all_reduce_batch(t, mesh)


def _rows(item_mask: Optional[torch.Tensor], B: int, mesh, device):
    """The 0/1 weights of the rows, with a mesh always (the mean is then
    over the global batch's rows)."""
    if item_mask is None and mesh is not None:
        return torch.ones(B, device=device)
    return item_mask


def fold_seed(seed: int, mesh) -> int:
    """The model's dropout seed on this rank: the step's seed, moved by the
    rank's batch index (unmoved at index 0 and without a mesh)."""
    if mesh is None or mesh.batch_rank == 0:
        return seed
    return (seed + mesh.batch_rank * 0x9E3779B97F4A7C15) % 2 ** 62


def ctc_multi_exit_loss(log_probs: torch.Tensor, sub_len: torch.Tensor,
                        labels: torch.Tensor, label_lengths: torch.Tensor, *,
                        blank: int, padded_lengths: bool,
                        item_mask: Optional[torch.Tensor] = None, mesh=None):
    """Sum over exits of the torch-mean CTC loss of (E, B, T', V)
    log-probs. padded_lengths: every row's input length is T' (the
    reference's quirk). item_mask (B,) 0/1: rows added to reach a bucket's
    batch size count for nothing, and the mean is over the real rows.
    Under a mesh the mean's divisor is the global batch's real rows.
    Returns (total, per_exit (E,))."""
    E, B, Tp, V = log_probs.shape
    input_len = (torch.full((B,), Tp, dtype=torch.long, device=log_probs.device)
                 if padded_lengths else sub_len)
    nll = ctc.ctc_loss(log_probs.reshape(E * B, Tp, V), input_len.repeat(E),
                       labels.repeat(E, 1), label_lengths.repeat(E),
                       blank=blank, reduction="none").reshape(E, B)
    per_item = nll / label_lengths.clamp_min(1).float()
    item_mask = _rows(item_mask, B, mesh, log_probs.device)
    if item_mask is None:
        per_exit = per_item.mean(dim=1)
    else:
        m = item_mask.float()
        per_exit = (per_item * m).sum(dim=1) / _global(m.sum(), mesh).clamp_min(1.0)
    return per_exit.sum(), per_exit


def distill_loss(log_probs: torch.Tensor, sub_len: torch.Tensor, *,
                 temperature: float = 2.0,
                 item_mask: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    """Self-distillation: T^2 times the mean over the earlier exits of
    KL(teacher || exit) over the valid frames (the global batch's under a
    mesh), the teacher being the deepest exit's temperature-smoothed
    posterior without gradient."""
    E, B, Tp, V = log_probs.shape
    teacher = torch.log_softmax(log_probs[-1].detach() / temperature, dim=-1)
    frame_mask = (torch.arange(Tp, device=log_probs.device)[None, :]
                  < sub_len[:, None]).float()
    if item_mask is not None:
        frame_mask = frame_mask * item_mask.float()[:, None]
    s = torch.log_softmax(log_probs[:-1] / temperature, dim=-1)
    kl = (teacher.exp() * (teacher - s)).sum(-1)                  # (E-1, B, T')
    kls = (kl * frame_mask).sum((1, 2)) / _global(frame_mask.sum(), mesh).clamp_min(1.0)
    return (temperature ** 2) * kls.mean()


def make_chunk_mask(t_sub: int, c: int, chunk_left: int,
                    device=None) -> torch.Tensor:
    """(T', T') bool: q attends within its chunk (in-chunk lookahead
    included) and up to chunk_left previous chunks."""
    pos = torch.arange(t_sub, device=device)
    qc, kc = pos[:, None] // c, pos[None, :] // c
    return (kc <= qc) & (qc - kc <= chunk_left)


def subsampled_frames(t: int) -> int:
    """Frames after the two VALID k=3 s=2 convolutions."""
    return ((t - 3) // 2 + 1 - 3) // 2 + 1


def sample_attn_mask(t_sub: int, host: torch.Generator, chunk_left: int,
                     device=None) -> Optional[torch.Tensor]:
    """50% full attention (None), else a chunk mask of a uniformly drawn
    size of CHUNK_SIZES."""
    full = bool(torch.rand((), generator=host) < 0.5)
    idx = int(torch.randint(len(CHUNK_SIZES), (), generator=host))
    return None if full else make_chunk_mask(t_sub, CHUNK_SIZES[idx],
                                             chunk_left, device)


def _child_seed(host: torch.Generator) -> int:
    return int(torch.randint(0, 2 ** 62, (), generator=host))


def aed_cross_entropy(dec_logits: torch.Tensor, trg_expect: torch.Tensor,
                      item_mask: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    """The sum over exits of the decoder cross-entropy of (E, B, L, V) raw
    logits against (B, L) ids: every position counts (pad included, the
    reference's CrossEntropyLoss()), averaged per row, then the mean over
    the rows (the real rows, with item_mask; the global batch's under a
    mesh)."""
    logp = torch.log_softmax(dec_logits.float(), dim=-1)
    idx = trg_expect.long()[None, ..., None].expand(logp.shape[0], -1, -1, 1)
    per_item = -logp.gather(-1, idx)[..., 0].mean(-1)             # (E, B)
    item_mask = _rows(item_mask, per_item.shape[1], mesh, per_item.device)
    if item_mask is None:
        return per_item.mean(-1).sum()
    m = item_mask.float()
    return ((per_item * m).sum(-1) / _global(m.sum(), mesh).clamp_min(1.0)).sum()


def loss_fn(model: torch.nn.Module, train_cfg: TrainConfig,
            batch: Dict[str, torch.Tensor], seed: Optional[int] = None):
    """The training loss of one batch ({"feats", "feat_lengths", "labels",
    "label_lengths"[, "item_mask"]}). seed None: no dropout, no
    SpecAugment and full attention. Under a mesh (`model.mesh`) the batch
    is this rank's rows and the loss its part of the global loss. Returns
    (total, per_exit CTC losses (E,), new_state)."""
    mcfg: ModelConfig = model.cfg
    tcfg = train_cfg
    mesh = getattr(model, "mesh", None)
    aed = tcfg.decoder_mode == "aed"
    item_mask = batch.get("item_mask")
    feats, feat_len = batch["feats"], batch["feat_lengths"]
    host = None if seed is None else torch.Generator().manual_seed(seed)
    if tcfg.specaugment and host is not None:
        gen = torch.Generator(device=feats.device).manual_seed(_child_seed(host))
        B = feats.shape[0]
        feats = specaugment.apply(
            gen, feats, feat_len, n_freq_masks=tcfg.sa_freq_masks,
            freq_mask_width=tcfg.sa_freq_width, n_time_masks=tcfg.sa_time_masks,
            time_mask_frac=tcfg.sa_time_frac,
            rows=None if mesh is None else (mesh.batch_rank * B, mesh.n_batch * B))
    if aed:
        labels = batch["labels"]
        dec_logits, log_probs, sub_len, new_state = model.apply_train(
            feats, feat_len, labels[:, :-1],
            seed=None if host is None else fold_seed(_child_seed(host), mesh))
        loss_ctc, per_exit = ctc_multi_exit_loss(
            log_probs, sub_len, labels, batch["label_lengths"], blank=mcfg.blank_id,
            padded_lengths=tcfg.ctc_compat_padded_lengths, item_mask=item_mask, mesh=mesh)
        total = (tcfg.aed_ce_weight * aed_cross_entropy(dec_logits, labels[:, 1:], item_mask,
                                                        mesh)
                 + tcfg.aed_ctc_weight * loss_ctc)
        return total, per_exit, new_state
    attn_mask = None
    # the JAX package samples chunk masks for the flagship only: the
    # splitformer's branch and the zipformer's stages run at other frame
    # rates, so they train with full attention whatever --dynamic_chunk says
    if tcfg.dynamic_chunk and host is not None and mcfg.model_type == "early_conformer":
        attn_mask = sample_attn_mask(subsampled_frames(feats.shape[1]), host,
                                     tcfg.chunk_left, feats.device)
    log_probs, sub_len, new_state = model.apply_train(
        feats, feat_len, seed=None if host is None else fold_seed(_child_seed(host), mesh),
        attn_mask=attn_mask)
    total, per_exit = ctc_multi_exit_loss(
        log_probs, sub_len, batch["labels"], batch["label_lengths"],
        blank=mcfg.blank_id, padded_lengths=tcfg.ctc_compat_padded_lengths,
        item_mask=item_mask, mesh=mesh)
    if tcfg.distill and log_probs.shape[0] > 1:
        total = total + tcfg.distill_weight * distill_loss(
            log_probs, sub_len, temperature=tcfg.distill_temperature,
            item_mask=item_mask, mesh=mesh)
    return total, per_exit, new_state


class Trainer:
    """The train step over a model whose parameters are float32 and
    trainable. `step(batch)` returns device tensors (no synchronisation):
    loss, loss_per_exit, grad_norm (of the unclipped gradients) and the
    step count (an int). Under a mesh (a model sharded by
    `parallel.shard_params`, the batch this rank's rows) the gradients
    are summed over the batch group and the loss and per-exit losses
    reported are the global batch's."""

    def __init__(self, model: torch.nn.Module, train_cfg: TrainConfig, *,
                 warmup: int):
        self.model = model
        self.cfg = train_cfg
        self.mesh = getattr(model, "mesh", None)
        self.params = list(model.parameters())
        self.opt = NoamAdamW(self.params, model.cfg.d_model, warmup,
                             clip=train_cfg.clip, adam_eps=train_cfg.adam_eps,
                             weight_decay=train_cfg.weight_decay, mesh=self.mesh)

    @property
    def step_count(self) -> int:
        return self.opt.count

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, object]:
        host = torch.Generator().manual_seed(
            ((self.cfg.seed + 1) << 32) + self.opt.count)
        total, per_exit, new_state = loss_fn(self.model, self.cfg, batch,
                                             seed=_child_seed(host))
        grads = torch.autograd.grad(total, self.params)
        total, per_exit = total.detach(), per_exit.detach()
        if self.mesh is not None:
            grads = collectives.sum_over_batch(grads, self.mesh)
            total, per_exit = collectives.sum_over_batch([total, per_exit], self.mesh)
        norm = self.opt.step(grads)
        self.model.set_state(new_state)
        return {"loss": total, "loss_per_exit": per_exit,
                "grad_norm": norm, "step": self.opt.count}
