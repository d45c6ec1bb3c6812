"""Epoch checkpoints in the JAX package's files (counterpart of
`early_exit_tpu/training/checkpoint.py`).

- `mod{epoch:03d}-transformer`: {"params", "model_state"} in the JAX
  package's layout (`interop.to_jax_params`) of any model of the
  registry;
- `lr{epoch:03d}-transformer`: {"opt_state", "step"}, the optimizer in
  optax's own tree for `optax.chain(clip_by_global_norm, adamw)`:
  {"0": {}, "1": {"0": {"count", "mu", "nu"}, "1": {}, "2": {"count"}}},
  mu and nu in the params layout, the counts and the step int32.

Under data and tensor parallelism the files are the same: the mesh's
first rank writes the gathered whole trees, and every rank loads the
whole tree and keeps its shard, so a checkpoint of any layout resumes in
any other.

Both are flax-msgpack (`checkpoint.save_tree`, atomic), so the JAX
package's `load_pytree(template, path)` reads what the port writes and
the port reads what the JAX package writes. Also: checkpoint averaging
(accumulated in float64), the saved epochs by regex, pruning to the
newest N, and the resume rule that prefers a complete model + optimizer
pair.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from early_exit_tpu_torch import interop
from early_exit_tpu_torch.checkpoint import load_tree, save_tree
from early_exit_tpu_torch.optim.noam import NoamAdamW
from early_exit_tpu_torch.parallel import collectives


def model_ckpt_path(directory: str, epoch: int) -> str:
    return os.path.join(directory, f"mod{epoch:03d}-transformer")


def opt_ckpt_path(directory: str, epoch: int) -> str:
    return os.path.join(directory, f"lr{epoch:03d}-transformer")


def full_tensors(model: torch.nn.Module, tensors) -> dict:
    """{parameter: its whole tensor} of per-parameter tensors (the
    parameters, gradients or moments): a tensor-parallel shard gathered
    over its model group (every rank of the group must call)."""
    params = list(model.parameters())
    mesh = getattr(model, "mesh", None)
    out = {}
    for p, t in zip(params, tensors):
        shard = getattr(p, "tp_shard", None)
        out[p] = t if shard is None else collectives.gather_shard(t, shard, mesh)
    return out


def opt_tree(model: torch.nn.Module, opt: NoamAdamW) -> dict:
    """{"opt_state", "step"} in optax's tree, whole (a tensor-parallel
    shard's moments gathered)."""
    count = np.asarray(opt.count, np.int32)
    mu = interop.jax_tree(model, full_tensors(model, opt.mu))
    nu = interop.jax_tree(model, full_tensors(model, opt.nu))
    return {"opt_state": {"0": {}, "1": {"0": {"count": count, "mu": mu, "nu": nu},
                                         "1": {}, "2": {"count": count}}},
            "step": count}


def load_opt_tree(model: torch.nn.Module, opt: NoamAdamW, tree: dict) -> None:
    """Restores mu, nu and the count from an optax tree (as `opt_tree`
    writes it or the JAX package saves it); a tensor-parallel shard takes
    its piece."""
    adam = tree["opt_state"]["1"]["0"]
    params = list(model.parameters())
    for name, dest in (("mu", opt.mu), ("nu", opt.nu)):
        src = interop.from_jax_tree(model, adam[name])
        with torch.no_grad():
            for p, d in zip(params, dest):
                d.copy_(interop.local(p, src[p]))
    opt.count = int(tree["step"])
    if int(adam["count"]) != opt.count:
        raise ValueError(f"optimizer count {int(adam['count'])} != step "
                         f"{opt.count} in the checkpoint")


def load_model_tree(model: torch.nn.Module, tree: dict) -> None:
    """{"params", "model_state"} in the JAX layout -> the model, in place."""
    interop.load_params(model, tree["params"], tree["model_state"])


def model_tree(model: torch.nn.Module) -> dict:
    """{"params", "model_state"} in the JAX layout, whole (a
    tensor-parallel shard gathered)."""
    params = list(model.parameters())
    return {"params": interop.jax_tree(model, full_tensors(model, params)),
            "model_state": interop.numpy_tree(model.state())}


def save_epoch(directory: str, epoch: int, model: torch.nn.Module,
               opt: Optional[NoamAdamW] = None) -> None:
    """The epoch's model (and optimizer) files. Under a mesh every rank
    calls: the shards are gathered, the mesh's first rank writes the whole
    trees (the files of a single-rank run) and the others wait for it."""
    mesh = getattr(model, "mesh", None)
    trees = [(model_tree(model), model_ckpt_path(directory, epoch))]
    if opt is not None:
        trees.append((opt_tree(model, opt), opt_ckpt_path(directory, epoch)))
    if mesh is None or mesh.is_first:
        for tree, path in trees:
            save_tree(tree, path)
    if mesh is not None:
        dist.barrier(group=mesh.group)


def load_model_file(model: torch.nn.Module, path: str) -> None:
    load_model_tree(model, load_tree(path))


def avg_models(model: torch.nn.Module, directory: str, start: int,
               end: int) -> None:
    """The model <- leaf-wise average of the epoch checkpoints in
    [start, end], accumulated in float64 (int64 for integer leaves);
    missing epochs after `start` are skipped. Each average is cast back to
    its leaf's dtype in the first file, as the JAX package does: a float
    leaf is rounded to it (a bf16 file gives bf16-rounded means), an
    integer leaf takes the floor of the mean."""
    if start > end:
        raise ValueError("avg_model_start must be <= avg_model_end")
    acc, dtypes, count = None, None, 0
    for epoch in range(start, end + 1):
        path = model_ckpt_path(directory, epoch)
        if epoch != start and not os.path.exists(path):
            continue
        leaves = _leaves(load_tree(path))
        if acc is None:
            dtypes = {k: v.dtype for k, v in leaves.items()}
            acc = {k: _wide(v) for k, v in leaves.items()}
        else:
            for k, v in leaves.items():
                acc[k] += _wide(v)
        count += 1
    if acc is None:
        raise FileNotFoundError(f"no checkpoints in [{start},{end}] under "
                                f"{directory}")
    load_model_tree(model, _unflatten({
        k: ((v / count) if v.dtype.is_floating_point else v // count).to(dtypes[k])
        for k, v in acc.items()}))


def _wide(t: torch.Tensor) -> torch.Tensor:
    return t.double() if t.dtype.is_floating_point else t.long()


def _leaves(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, prefix + (k,)))
        return out
    return {prefix: torch.as_tensor(tree)}


def _unflatten(leaves: dict) -> dict:
    out: dict = {}
    for path, v in leaves.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


_CKPT_RE = re.compile(r"mod(\d+)-transformer$")


def saved_epochs(directory: str) -> List[int]:
    """Sorted epochs with a model checkpoint, parsed by regex (`mod%03d`
    widens to four digits at epoch 1000)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_CKPT_RE.match, os.listdir(directory))
                  if m)


def prune_old(directory: str, keep_last: int, protect=()) -> List[int]:
    """Deletes the model and optimizer files of every saved epoch but the
    newest `keep_last` (<= 0 keeps all) and those in `protect`. Returns
    the pruned epochs."""
    if keep_last <= 0:
        return []
    victims = [e for e in saved_epochs(directory)[:-keep_last]
               if e not in set(protect)]
    for e in victims:
        for path in (model_ckpt_path(directory, e), opt_ckpt_path(directory, e)):
            if os.path.exists(path):
                os.unlink(path)
    return victims


def latest_epoch(directory: str) -> Optional[int]:
    epochs = saved_epochs(directory)
    return epochs[-1] if epochs else None


def resume_epoch(directory: str) -> Tuple[Optional[int], Optional[str]]:
    """The epoch to resume from and a warning, or (None, None) with no
    checkpoint. The newest epoch whose model and optimizer files both
    exist: a params-only resume restarts the Noam schedule and its warmup
    spike wrecks the model. With no complete pair, the newest model file
    alone, and a warning saying so."""
    epochs = saved_epochs(directory)
    if not epochs:
        return None, None
    latest = epochs[-1]
    complete = [e for e in epochs if os.path.exists(opt_ckpt_path(directory, e))]
    if not complete:
        return latest, (f"warning: newest checkpoint epoch {latest} has no "
                        f"optimizer state and no earlier complete pair exists "
                        f"- resuming params-only (LR schedule restarts; "
                        f"expect a warmup loss spike)")
    if complete[-1] != latest:
        return complete[-1], (f"warning: epoch {latest} has no optimizer state "
                              f"(crash during save?) - resuming from the "
                              f"newest complete pair, epoch {complete[-1]}")
    return latest, None
