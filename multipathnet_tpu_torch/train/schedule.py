"""LR schedule and optimizer — port of multipathnet_tpu/train/schedule.py:
SGD with momentum, linear warmup, step decay.

The reference is the optax chain clip_by_global_norm (when
grad_clip_norm > 0) -> add_decayed_weights -> sgd(schedule, momentum).
torch.optim.SGD adds the decay before the momentum, and its momentum buffer
starts at the first (decayed) gradient, as optax's zero-initialized trace
does after one step, so one SGD step with lr = schedule(count) is the
chain's update. Clipping runs first, on the global norm, with optax's rule.
With a tensor-parallel head the norm covers every parameter once: the
squares of each sharded gradient are summed over the model axis, the
replicated ones counted on each rank as they are; momentum and weight
decay stay elementwise on each rank's part.
"""

from __future__ import annotations

from typing import Callable

import torch

from multipathnet_tpu_torch.core.config import TrainConfig
from multipathnet_tpu_torch.core.mesh import all_sum


def make_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """step -> learning rate: optax's join_schedules(linear warmup from 0,
    piecewise_constant), so lr is 0 at step 0 when warmup is on and the
    decay boundaries count from the end of the warmup."""
    factors = {int(s): cfg.lr_decay_factor for s in cfg.lr_decay_steps}

    def decay(step: int) -> float:
        v = cfg.lr
        for boundary, factor in sorted(factors.items()):
            if step >= boundary:
                v *= factor
        return v

    if cfg.warmup_steps <= 0:
        return decay
    w = cfg.warmup_steps

    def schedule(step: int) -> float:
        if step >= w:
            return decay(step - w)
        return (0.0 - cfg.lr) * (1.0 - max(step, 0) / w) + cfg.lr

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over a list of tensors (optax's
    global_norm); 0 for an empty list."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class Optimizer:
    """The reference's optax chain over `params`: `step()` clips the
    gradients to grad_clip_norm by their global norm (when > 0), sets the
    learning rate of this step's count and takes one torch.optim.SGD step
    (momentum, weight decay). Returns the global norm before clipping.
    `sharded`: the parameters that hold one part each of a tensor split
    over `group` (the model axis)."""

    def __init__(self, params, cfg: TrainConfig, sharded=(), group=None):
        self.params = list(params)
        self.sharded = {id(p) for p in sharded}
        self.group = group
        self.lr_schedule = make_lr_schedule(cfg)
        self.grad_clip_norm = cfg.grad_clip_norm
        self.sgd = torch.optim.SGD(self.params, lr=0.0, momentum=cfg.momentum,
                                   weight_decay=cfg.weight_decay)
        self.count = 0

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = self._sharded_norm() if self.sharded else global_norm(grads)
        if self.grad_clip_norm > 0 and grads:
            clip = self.grad_clip_norm
            scale = torch.where(norm < clip, torch.ones_like(norm),
                                clip / norm)
            torch._foreach_mul_(grads, scale)
        for group in self.sgd.param_groups:
            group["lr"] = self.lr_schedule(self.count)
        self.sgd.step()
        self.count += 1
        return norm

    def _sharded_norm(self) -> torch.Tensor:
        def squares(sharded: bool):
            g = [p.grad for p in self.params if p.grad is not None
                 and (id(p) in self.sharded) == sharded]
            if not g:
                return torch.zeros((), device=self.params[0].device)
            return torch.stack(torch._foreach_norm(g)).square().sum()

        return torch.sqrt(squares(False) + all_sum(squares(True),
                                                   self.group))


def make_optimizer(cfg: TrainConfig, params, sharded=(), group=None):
    """-> (Optimizer over params, lr schedule), as the reference returns
    (optax chain, schedule)."""
    opt = Optimizer(params, cfg, sharded, group)
    return opt, opt.lr_schedule
