"""Optimizers and schedules: the paper's finetuning recipes (Sec. V-B).

AdamW (lr 1e-6 with x0.3 decay per epoch: the ResNet50 recipe) and SGD
with momentum 0.728 and weight decay 5e-4 under a cosine one-cycle
schedule (the SSD recipe), with mixed precision: parameters in their own
dtype (bf16 at full size), f32 master copies and moments.

The update rules are functional, as the JAX package's: ``init(params)``
returns a state and ``update(grads, state, params)`` returns (new params,
new state) without touching its arguments.  ``update_`` is the rule
itself: it computes the new values leaf by leaf in place, into ``state``
and ``params``, and returns them (the port's form of the JAX driver's
donated train state, which holds one optimizer state on the card, not
two); ``update`` runs it on copies.  A state's ``step`` is a 0-dim
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


@torch.no_grad()
def _on_copies(update_, grads, state, params):
    """The functional form of an in-place ``update_``."""
    return update_(grads, tree_map(torch.clone, state),
                   tree_map(torch.clone, params))


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
        return _on_copies(self.update_, grads, state, params)

    @torch.no_grad()
    def update_(self, grads: Pytree, state: AdamWState, params: Pytree):
        """One step, one leaf at a time, written in place into ``state``'s
        moments and master weights and into ``params``; returns (params,
        new state)."""
        scale = _clip_scale(grads, self.grad_clip_norm)
        step = state.step + 1
        lr = self.schedule(step)
        b1, b2 = self.b1, self.b2
        c1 = 1 - torch.pow(_f32(b1), step.float())
        c2 = 1 - torch.pow(_f32(b2), step.float())
        for g, m, v, master, p in zip(leaves(grads), leaves(state.mu),
                                      leaves(state.nu),
                                      leaves(state.master), leaves(params)):
            g = g.float()
            if scale is not None:
                g = g * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            u = u + self.weight_decay * master
            master.sub_(lr * u)
            p.copy_(master.to(p.dtype))
        return params, AdamWState(step, state.mu, state.nu, state.master)


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
        return _on_copies(self.update_, grads, state, params)

    @torch.no_grad()
    def update_(self, grads: Pytree, state: SGDState, params: Pytree):
        """One step in place (see ``AdamW.update_``)."""
        scale = _clip_scale(grads, self.grad_clip_norm)
        step = state.step + 1
        lr = self.schedule(step)
        for g, vel, master, p in zip(leaves(grads), leaves(state.velocity),
                                     leaves(state.master), leaves(params)):
            g = g.float()
            if scale is not None:
                g = g * scale
            vel.mul_(self.momentum).add_(g).add_(self.weight_decay * master)
            master.sub_(lr * vel)
            p.copy_(master.to(p.dtype))
        return params, SGDState(step, state.velocity, state.master)


# ---------------------------------------------------------------------------
# Utilities
# ---------------------------------------------------------------------------


def _clip_scale(grads: Pytree, max_norm: Optional[float]):
    """min(1, max_norm / global_norm) of the f32 gradients, or None."""
    if max_norm is None:
        return None
    norm = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads: Pytree, max_norm: Optional[float]) -> Pytree:
    """Scale every gradient by min(1, max_norm / global_norm)."""
    scale = _clip_scale(grads, max_norm)
    if scale is None:
        return grads
    return tree_map(lambda g: g * scale, grads)


def global_norm(tree: Pytree) -> Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))
