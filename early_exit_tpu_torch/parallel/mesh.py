"""Process meshes and sharding rules over `torch.distributed`
(counterpart of `early_exit_tpu/parallel/mesh.py`).

One process per rank (launched by `torchrun`, or spawned by
`multiprocess_smoke`), laid out on a mesh as the JAX package lays out
devices:

- axis "data": data parallelism. Each rank of a batch group holds other
  rows of the global batch; the gradients are summed over the group.
- axis "model": Megatron-style tensor parallelism. The Conformer FFN's
  w1 (and its bias) is column-sharded and its w2 row-sharded; the vocab
  heads are sharded on V. Every rank of a model group holds the same
  activations and the same loss.
- axis "replica" (dcn > 1): data parallelism across nodes, outermost, so
  that only batch traffic crosses them.

Ranks fill the mesh in row-major order, as the JAX package reshapes its
device list: rank = ((replica * dp) + data) * tp + model. A rank's batch
shard is its (replica, data) index, its model shard its model index.

Sharding never changes the math: a dp x tp step equals the single-device
step within float rounding. The rule table (`param_shard_dim`) is the
JAX package's `param_pspec`, applied to the JAX path of each port
parameter (`interop.param_paths`), so both packages shard the same
leaves. Shards of unequal size follow `torch.tensor_split`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from early_exit_tpu_torch.parallel.collectives import split_sizes

DATA_AXIS = "data"
MODEL_AXIS = "model"
REPLICA_AXIS = "replica"
# the JAX rule table's head names
_HEADS = ("heads", "head", "out_linear", "ctc_heads", "out_heads")


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place on a mesh and its process groups: `model_group`
    (the tp ranks that share a batch shard), `batch_group` (the dcn x dp
    ranks that share a model shard) and `group` (every rank of the
    mesh)."""
    shape: Dict[str, int]              # axis -> size, outermost first
    ranks: Tuple[int, ...]             # world ranks in mesh order
    model_group: object
    batch_group: object
    group: object
    model_rank: int                    # index on the model axis
    batch_rank: int                    # index over (replica, data)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def tp(self) -> int:
        return self.shape[MODEL_AXIS]

    @property
    def dp(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def dcn(self) -> int:
        return self.shape.get(REPLICA_AXIS, 1)

    @property
    def n_batch(self) -> int:
        """Batch shards: dcn x dp."""
        return self.dcn * self.dp

    @property
    def is_first(self) -> bool:
        """The mesh's first rank: the one that writes and prints."""
        return dist.get_rank() == self.ranks[0]


def make_mesh(ranks: Optional[Sequence[int]] = None, *, dp: Optional[int] = None,
              tp: int = 1, dcn: int = 1) -> Optional[Mesh]:
    """A mesh over the given (default: all) world ranks.

    dcn=1: shape (dp, tp), axes (data, model); dcn>1: (dcn, dp, tp), axes
    (replica, data, model). dp=None takes n // (tp * dcn). Every rank of
    the world must call it (it creates process groups); a rank outside
    `ranks` gets None."""
    world = dist.get_world_size()
    ranks = list(range(world)) if ranks is None else list(ranks)
    n = len(ranks)
    if dp is None:
        dp = n // (tp * dcn)
    if dcn * dp * tp != n:
        raise ValueError(f"dcn({dcn}) * dp({dp}) * tp({tp}) != n_ranks({n}): launch "
                         f"dcn x dp x tp processes")
    grid = np.asarray(ranks).reshape(dcn * dp, tp)
    whole = dist.new_group(ranks)
    model_groups = [dist.new_group(row.tolist()) for row in grid]
    batch_groups = [dist.new_group(col.tolist()) for col in grid.T]
    me = dist.get_rank()
    if me not in ranks:
        return None
    b, m = divmod(ranks.index(me), tp)
    shape = ({REPLICA_AXIS: dcn} if dcn > 1 else {}) | {DATA_AXIS: dp, MODEL_AXIS: tp}
    return Mesh(shape, tuple(ranks), model_groups[b], batch_groups[m], whole, m, b)


def make_hybrid_mesh(*, tp: int = 1) -> Mesh:
    """One replica per node (WORLD_SIZE // LOCAL_WORLD_SIZE, torchrun's
    variables), (data, model) within each; `make_mesh` on one node."""
    world = dist.get_world_size()
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    nodes = world // per_node
    if nodes <= 1:
        return make_mesh(tp=tp)
    return make_mesh(dp=per_node // tp, tp=tp, dcn=nodes)


def batch_axes(mesh: Mesh) -> tuple:
    """The mesh axes the batch dimension is sharded over."""
    return tuple(a for a in (REPLICA_AXIS, DATA_AXIS) if a in mesh.axis_names)


# --------------------------------------------------------------------------
# Parameter sharding rules (by the JAX path of each parameter)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Shard:
    """A parameter's slice of its full tensor: `size` entries from
    `offset` along `dim`, of `full`."""
    dim: int
    offset: int
    size: int
    full: int

    def take(self, t: torch.Tensor) -> torch.Tensor:
        return t.narrow(self.dim, self.offset, self.size)


def param_shard_dim(path: Sequence, tensor: torch.Tensor) -> Optional[int]:
    """The dimension of a port tensor that tp shards, by its JAX path
    (None: replicated). The JAX package's `param_pspec` rules, which index
    from the end, so the JAX tree's leading stacked-layer axes do not
    count:
      ffn w1 (..., d, ff)   -> ff   (column parallel), and its bias
      ffn w2 (..., ff, d)   -> ff   (row parallel)
      head w (..., d, V)    -> V, and its bias"""
    names = [str(k) for k in path]
    leaf = names[-1] if names else ""
    parent = names[-2] if len(names) >= 2 else ""
    in_ffn = any(n in ("ffn1", "ffn2") for n in names)
    in_heads = any(n in _HEADS for n in names)
    last = tensor.ndim - 1
    if in_ffn and parent == "w1" and (leaf == "b" or (leaf == "w" and tensor.ndim >= 2)):
        return last
    if in_ffn and parent == "w2" and leaf == "w" and tensor.ndim >= 2:
        return last - 1
    if in_heads and (leaf == "b" or (leaf == "w" and tensor.ndim >= 2)):
        return last
    return None


def shard_dims(model: torch.nn.Module) -> Dict[torch.nn.Parameter, int]:
    """{parameter: the dimension tp shards} over the model's JAX paths."""
    # imported here: interop imports the models, which import the
    # collectives of this package
    from early_exit_tpu_torch import interop
    return {p: d for path, params, _ in interop.param_paths(model) for p in params
            if (d := param_shard_dim(path, p)) is not None}


def shard_params(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Each parameter that the rules shard becomes this rank's
    `torch.tensor_split` piece of it, in place, marked with its `Shard`
    (`p.tp_shard`); every module learns the mesh (`module.mesh`), which
    the FFN, the heads, the BatchNorm and the trainer read."""
    if mesh.tp > 1:
        with torch.no_grad():
            for p, d in shard_dims(model).items():
                full = p.shape[d]
                sizes = split_sizes(full, mesh.tp)
                sh = Shard(d, sum(sizes[:mesh.model_rank]), sizes[mesh.model_rank], full)
                p.data = sh.take(p.data).clone()
                p.tp_shard = sh
    for m in model.modules():
        m.mesh = mesh
    return model


def shard_batch(batch: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch: its (replica, data) piece of the
    leading axis, which must divide evenly."""
    B = next(iter(batch.values())).shape[0]
    if B % mesh.n_batch:
        raise ValueError(f"a global batch of {B} rows is not a multiple of dp x dcn "
                         f"= {mesh.n_batch}")
    n = B // mesh.n_batch
    return {k: v[mesh.batch_rank * n:(mesh.batch_rank + 1) * n] for k, v in batch.items()}


@torch.no_grad()
def replicate(tensors: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Every tensor <- the mesh's first rank's, in place (a broadcast)."""
    for t in tensors:
        dist.broadcast(t.data, src=mesh.ranks[0], group=mesh.group)
