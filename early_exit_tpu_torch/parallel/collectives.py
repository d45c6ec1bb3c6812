"""The four Megatron collectives as autograd functions, over the groups
of a `mesh.Mesh`.

Under tensor parallelism every rank of a model group holds the same
activations and computes the same loss, so a collective's backward must
not sum what every rank already holds; under data parallelism each rank
of a batch group holds other rows, and the gradient of a statistic of
the global batch is the sum of every rank's part. Hence:

- `copy_to_model`: identity forward, all-reduce backward (the input of a
  column-sharded product: each rank's gradient covers its columns only);
- `reduce_from_model`: all-reduce forward, identity backward (the
  partial products of a row-sharded product);
- `gather_from_model`: all-gather along the last axis forward, this
  rank's slice backward (vocabulary-sharded logits before a softmax);
- `all_reduce_batch`: all-reduce over the batch group, forward and
  backward (the global batch's BatchNorm statistics).

`torch.distributed.nn.functional`'s collectives sum the gradient over
the group in every case, which multiplies a model group's gradient by
its size. Only `all_reduce`, `all_gather` and `broadcast` are used, so
gloo runs them on CPU and on CUDA tensors, and NCCL on CUDA tensors.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


def split_sizes(n: int, parts: int) -> List[int]:
    """The sizes `torch.tensor_split` cuts n into: the first n % parts
    pieces one longer."""
    return [n // parts + (i < n % parts) for i in range(parts)]


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, sizes, index):
        ctx.offset, ctx.size = sum(sizes[:index]), sizes[index]
        # all_gather takes pieces of one size: pad each to the largest
        width = max(sizes)
        pad = torch.zeros(x.shape[:-1] + (width,), dtype=x.dtype, device=x.device)
        pad[..., :x.shape[-1]] = x
        pieces = [torch.empty_like(pad) for _ in sizes]
        dist.all_gather(pieces, pad, group=group)
        return torch.cat([p[..., :n] for p, n in zip(pieces, sizes)], dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.offset:ctx.offset + ctx.size].contiguous(), None, None, None


class _AllReduceBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh.model_group)


def gather_from_model(x: torch.Tensor, mesh, full: int) -> torch.Tensor:
    """The model group's shards of the last axis (this rank's `x`, the
    `torch.tensor_split` pieces of `full`) -> the whole axis."""
    return _GatherFromModel.apply(x, mesh.model_group, split_sizes(full, mesh.tp),
                                  mesh.model_rank)


def all_reduce_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    return _AllReduceBatch.apply(x, mesh.batch_group)


@torch.no_grad()
def sum_over_batch(tensors: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """Each tensor summed over the batch group, in one all-reduce a dtype
    (the gradients of a step)."""
    out: List[torch.Tensor] = list(tensors)
    for dtype in {t.dtype for t in tensors}:
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=mesh.batch_group)
        for i, piece in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = piece.view_as(tensors[i])
    return out


@torch.no_grad()
def sum_over_model(t: torch.Tensor, mesh) -> torch.Tensor:
    """A tensor summed over the model group (no gradient)."""
    return _all_reduce(t, mesh.model_group)


@torch.no_grad()
def gather_shard(t: torch.Tensor, shard, mesh) -> torch.Tensor:
    """A tensor sharded along `shard.dim` over the model group -> the whole
    tensor, on every rank of the group."""
    sizes = split_sizes(shard.full, mesh.tp)
    moved = t.movedim(shard.dim, -1)
    return _GatherFromModel.apply(moved, mesh.model_group, sizes,
                                  mesh.model_rank).movedim(-1, shard.dim).contiguous()
