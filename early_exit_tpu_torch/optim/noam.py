"""Noam learning-rate schedule and AdamW with global-norm clipping
(counterpart of `early_exit_tpu/optim/noam.py`).

The JAX package's optimizer is `optax.chain(clip_by_global_norm(clip),
adamw(noam_schedule, b1=0.9, b2=0.98, eps, weight_decay))` over all
parameters, biases and norms included. `NoamAdamW` is the same update,
written out over a list of tensors with multi-tensor (`torch._foreach_*`)
operations:

    n = ||g||_2 over every leaf; g <- g if n < clip else (g / n) * clip
    mu <- (1 - b1) g + b1 mu;  nu <- (1 - b2) g^2 + b2 nu;  c <- c + 1
    u = (mu / (1 - b1^c)) / (sqrt(nu / (1 - b2^c)) + eps) + wd * p
    p <- p - lr(c - 1) * u

Under tensor parallelism a sharded parameter's moments are its shard's
(the update is elementwise) and the clip reads the global norm of the
whole gradient (`global_norm`).

`clip_grad_norm_`'s clip / (n + 1e-6) scaling is not optax's rule, so the
clip is written out. The step count lives on the host, so the schedule
and the bias corrections cost no device round trip.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from early_exit_tpu_torch.parallel import collectives


def noam_schedule(d_model: int, warmup: int):
    """lr(count): d_model^-0.5 * min(s^-0.5, s * warmup^-1.5) with s =
    count + 1 (optax counts from 0, Noam from 1)."""
    scale = d_model ** -0.5
    w = float(max(warmup, 1))

    def schedule(count: int) -> float:
        step = count + 1.0
        return scale * min(step ** -0.5, step * w ** -1.5)
    return schedule


def global_norm(tensors: Sequence[torch.Tensor], *, mesh=None,
                sharded: Sequence[bool] = ()) -> torch.Tensor:
    """sqrt of the sum of squares of every element, float32, on the device.
    Under a mesh with tp > 1, `sharded[i]` says tensor i is this rank's
    shard of a tensor-parallel leaf: the squares of those are summed over
    the model group once, those of the replicated leaves added once."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    if mesh is None or mesh.tp == 1:
        return torch.linalg.vector_norm(torch.stack(norms))
    sq = torch.stack(norms).square()
    part = torch.as_tensor(list(sharded), device=sq.device)
    split = collectives.sum_over_model(sq[part].sum(), mesh)
    return (split + sq[~part].sum()).sqrt()


class NoamAdamW:
    """AdamW under the Noam schedule with optax's global-norm clip, over
    `params` (float32 tensors updated in place). State: `mu`, `nu` (one
    tensor per parameter) and `count`, the number of updates applied."""

    b1, b2 = 0.9, 0.98                  # the reference's betas

    def __init__(self, params: Sequence[torch.Tensor], d_model: int,
                 warmup: int, *, clip: float = 1.0, adam_eps: float = 1e-9,
                 weight_decay: float = 5e-4, mesh=None):
        self.params: List[torch.Tensor] = list(params)
        self.mesh = mesh
        self.sharded = [hasattr(p, "tp_shard") for p in self.params]
        self.schedule = noam_schedule(d_model, warmup)
        self.clip, self.eps, self.wd = clip, adam_eps, weight_decay
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def _bias(self, decay: float) -> float:
        """1 - decay^count in float32, as optax computes it."""
        return float(np.float32(1.0) - np.float32(decay) ** np.int32(self.count))

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """Applies one update from `grads` (one per parameter, unclipped).
        Returns the global norm of the unclipped gradients (a device
        scalar, not synchronised)."""
        g = [t.float() for t in grads]
        norm = global_norm(g, mesh=self.mesh, sharded=self.sharded)
        # clip: (g / n) * clip where n >= clip, else g unchanged
        factor = torch.where(norm < self.clip, torch.ones_like(norm), norm)
        g = torch._foreach_div(g, factor)
        mult = torch.where(norm < self.clip, torch.ones_like(norm),
                           torch.full_like(norm, self.clip))
        torch._foreach_mul_(g, mult)
        lr = self.schedule(self.count)
        self.count += 1
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1.0 - self.b2)
        mu_hat = torch._foreach_div(self.mu, self._bias(self.b1))
        den = torch._foreach_div(self.nu, self._bias(self.b2))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu_hat, den)
        torch._foreach_add_(upd, self.params, alpha=self.wd)
        torch._foreach_add_(self.params, upd, alpha=-lr)
        return norm
