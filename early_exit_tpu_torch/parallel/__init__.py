"""Data and tensor parallelism over `torch.distributed` (counterpart of
`early_exit_tpu/parallel/`): meshes and sharding rules (`mesh`), and the
autograd collectives the sharded model runs (`collectives`)."""

from early_exit_tpu_torch.parallel.mesh import (Mesh, Shard, batch_axes, make_hybrid_mesh,
                                                make_mesh, param_shard_dim, replicate,
                                                shard_batch, shard_dims, shard_params)

__all__ = ["Mesh", "Shard", "batch_axes", "make_hybrid_mesh", "make_mesh",
           "param_shard_dim", "replicate", "shard_batch", "shard_dims", "shard_params"]
