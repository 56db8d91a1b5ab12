"""The Trainer's optimizers: the optax chains of `build_optimizer`
(`mmlspark_tpu/train/trainer.py:122-154`) as plain functions on tensors.

Each transformation keeps optax's update algebra and order of operations,
so an update matches optax to f32 rounding (`torch.optim` orders its
operations differently):

  * `clip_by_global_norm` first in the chain (when the config sets a clip);
  * `add_decayed_weights` before any optimizer but adamw;
  * sgd: `scale_by_learning_rate`; momentum: `trace` (no dampening) first;
  * adam: `scale_by_adam` (b1 0.9, b2 0.999, eps 1e-8 outside the sqrt,
    bias correction with the count incremented first);
  * adamw: `scale_by_adam` -> `add_decayed_weights` -> learning rate.

The learning rate is a constant or an optax schedule (`cosine_decay_schedule`,
`warmup_cosine_decay_schedule`) evaluated in f32 at the pre-increment
count.  `Optimizer.update` applies the updates in place to the f32 master
parameters; its moments are f32.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

_F32 = np.float32


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the summed squares, in f32."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule requires positive "
                         f"decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        c = min(_F32(count), _F32(decay_steps))
        cosine = _F32(0.5) * (_F32(1) + np.cos(_F32(math.pi) * c
                                               / _F32(decay_steps)))
        return float(_F32(init_value) * ((_F32(1) - _F32(alpha)) * cosine
                                         + _F32(alpha)))
    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                   alpha)

    def warmup(count: int) -> float:
        if warmup_steps <= 0:        # optax's linear schedule is constant
            return init_value
        c = min(max(count, 0), warmup_steps)
        frac = _F32(1) - _F32(c) / _F32(warmup_steps)
        return float(_F32(init_value - peak_value) * frac + _F32(peak_value))

    def schedule(count: int) -> float:
        return warmup(count) if count < warmup_steps \
            else cosine(count - warmup_steps)
    return schedule


def learning_rate_schedule(cfg, total_steps: int):
    """The config's learning rate: a float, or a schedule of the count."""
    base = cfg.learning_rate
    if cfg.lr_schedule == "constant":
        return base
    if cfg.lr_schedule == "cosine":
        return cosine_decay_schedule(base, max(total_steps, 1))
    if cfg.lr_schedule == "warmup_cosine":
        return warmup_cosine_decay_schedule(
            0.0, base, cfg.warmup_steps,
            max(total_steps, cfg.warmup_steps + 1))
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule}")


def clip_by_global_norm(updates: list, max_norm: float) -> list:
    g_norm = global_norm(updates)
    trigger = g_norm < max_norm
    return [torch.where(trigger, u, (u / g_norm) * max_norm) for u in updates]


def add_decayed_weights(updates: list, params: list,
                        weight_decay: float) -> list:
    return [u + weight_decay * p for u, p in zip(updates, params)]


def trace(updates: list, state: dict, decay: float) -> list:
    state["trace"] = [u + decay * t for u, t in zip(updates, state["trace"])]
    return state["trace"]


def scale_by_adam(updates: list, state: dict, count_inc: int,
                  b1: float = ADAM_B1, b2: float = ADAM_B2,
                  eps: float = ADAM_EPS) -> list:
    state["mu"] = [(1 - b1) * g + b1 * m for g, m in zip(updates,
                                                          state["mu"])]
    state["nu"] = [(1 - b2) * (g * g) + b2 * v for g, v in zip(updates,
                                                              state["nu"])]
    bc1 = float(_F32(1) - _F32(b1) ** _F32(count_inc))
    bc2 = float(_F32(1) - _F32(b2) ** _F32(count_inc))
    return [(m / bc1) / (torch.sqrt(v / bc2) + eps)
            for m, v in zip(state["mu"], state["nu"])]


class Optimizer:
    """The config's optax chain over a fixed list of f32 parameters."""

    def __init__(self, cfg, total_steps: int):
        self.kind = cfg.optimizer
        self.lr = learning_rate_schedule(cfg, total_steps)
        self.momentum = cfg.momentum
        self.weight_decay = cfg.weight_decay
        self.clip: Optional[float] = cfg.gradient_clip_norm or None

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        zeros = lambda: [torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
                         for p in params]
        state: dict = {"count": 0}
        if self.kind in ("adam", "adamw"):
            state["mu"], state["nu"] = zeros(), zeros()
        elif self.kind == "momentum":
            state["trace"] = zeros()
        return state

    def step_size(self, count: int) -> float:
        """-learning rate at the pre-increment `count`."""
        return -(self.lr(count) if callable(self.lr) else self.lr)

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: dict,
               params: Sequence[torch.Tensor]) -> None:
        """One optax update, applied in place to `params`."""
        params = list(params)
        u = [g.float() for g in grads]
        if self.clip:
            u = clip_by_global_norm(u, self.clip)
        if self.kind != "adamw" and self.weight_decay:
            u = add_decayed_weights(u, params, self.weight_decay)
        count = state["count"]
        if self.kind in ("adam", "adamw"):
            u = scale_by_adam(u, state, count + 1)
            if self.kind == "adamw":
                u = add_decayed_weights(u, params, self.weight_decay)
        elif self.kind == "momentum":
            u = trace(u, state, self.momentum)
        step = self.step_size(count)
        for p, x in zip(params, u):
            p.add_(x * step)
        state["count"] = count + 1
