"""Optimizers and schedules: the paper's finetuning recipes (Sec. V-B).

AdamW (lr 1e-6 with x0.3 decay per epoch: the ResNet50 recipe) and SGD
with momentum 0.728 and weight decay 5e-4 under a cosine one-cycle
schedule (the SSD recipe), with mixed precision: parameters in their own
dtype (bf16 at full size), f32 master copies and moments.

The update rules are functional, as the JAX package's: ``init(params)``
returns a state and ``update(grads, state, params)`` returns (new params,
new state) without touching its arguments.  A state's ``step`` is a 0-dim
int32 tensor on the CPU, so the schedule is evaluated on the host in f32
without waiting on the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core.tree import leaves, tree_map

Tensor = torch.Tensor
Pytree = Any


def _f32(v) -> Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Schedules: step (an int or a 0-dim int tensor) -> 0-dim f32 CPU tensor
# ---------------------------------------------------------------------------


def exponential_decay(base_lr: float, decay: float, steps_per_epoch: int):
    """lr * decay^epoch (the paper's ResNet50 recipe: decay 0.3 per epoch)."""
    def fn(step):
        epoch = torch.as_tensor(step, dtype=torch.int32) // steps_per_epoch
        return base_lr * torch.pow(_f32(decay), epoch.float())
    return fn


def cosine_one_cycle(base_lr: float, total_steps: int,
                     warmup_frac: float = 0.1):
    """One-cycle cosine with linear warmup (the paper's SSD recipe)."""
    warm = max(1, int(total_steps * warmup_frac))

    def fn(step):
        step = torch.clamp(torch.as_tensor(step, dtype=torch.int32),
                           max=total_steps)
        lr_warm = base_lr * step / warm
        t = torch.clamp((step - warm) / max(total_steps - warm, 1), 0, 1)
        lr_cos = base_lr * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warm, lr_warm, lr_cos)
    return fn


def constant(base_lr: float):
    return lambda step: _f32(base_lr)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _master(params):
    return tree_map(lambda p: p.detach().float().clone(), params)


def _cast_like(master, params):
    return tree_map(lambda mp, p: mp.to(p.dtype), master, params)


class AdamWState(NamedTuple):
    step: Tensor        # 0-dim int32, CPU
    mu: Pytree          # f32 first moment
    nu: Pytree          # f32 second moment
    master: Pytree      # f32 master weights (mixed precision)


@dataclasses.dataclass(frozen=True)
class AdamW:
    schedule: Callable[[Tensor], Tensor]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = 1.0

    def init(self, params: Pytree) -> AdamWState:
        return AdamWState(torch.zeros((), dtype=torch.int32),
                          _zeros_f32(params), _zeros_f32(params),
                          _master(params))

    def update(self, grads: Pytree, state: AdamWState, params: Pytree):
        grads = tree_map(lambda g: g.float(), grads)
        grads = clip_by_global_norm(grads, self.grad_clip_norm)
        step = state.step + 1
        lr = self.schedule(step)
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu,
                      grads)
        c1 = 1 - torch.pow(_f32(b1), step.float())
        c2 = 1 - torch.pow(_f32(b2), step.float())

        def upd(master, m, v):
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            u = u + self.weight_decay * master
            return master - lr * u

        master = tree_map(upd, state.master, mu, nu)
        return _cast_like(master, params), AdamWState(step, mu, nu, master)


# ---------------------------------------------------------------------------
# SGD with momentum
# ---------------------------------------------------------------------------


class SGDState(NamedTuple):
    step: Tensor
    velocity: Pytree
    master: Pytree


@dataclasses.dataclass(frozen=True)
class SGD:
    schedule: Callable[[Tensor], Tensor]
    momentum: float = 0.728          # the paper's SSD-ResNet34 value
    weight_decay: float = 5e-4
    grad_clip_norm: Optional[float] = None

    def init(self, params: Pytree) -> SGDState:
        return SGDState(torch.zeros((), dtype=torch.int32),
                        _zeros_f32(params), _master(params))

    def update(self, grads: Pytree, state: SGDState, params: Pytree):
        grads = tree_map(lambda g: g.float(), grads)
        grads = clip_by_global_norm(grads, self.grad_clip_norm)
        step = state.step + 1
        lr = self.schedule(step)
        velocity = tree_map(
            lambda v, g, m: self.momentum * v + g + self.weight_decay * m,
            state.velocity, grads, state.master)
        master = tree_map(lambda m, v: m - lr * v, state.master, velocity)
        return _cast_like(master, params), SGDState(step, velocity, master)


# ---------------------------------------------------------------------------
# Utilities
# ---------------------------------------------------------------------------


def clip_by_global_norm(grads: Pytree, max_norm: Optional[float]) -> Pytree:
    """Scale every gradient by min(1, max_norm / global_norm)."""
    if max_norm is None:
        return grads
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads)


def global_norm(tree: Pytree) -> Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))
