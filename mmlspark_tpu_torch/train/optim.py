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

The learning rate is a constant or an optax schedule (cosine decay, warmup
then cosine decay) evaluated in f32 at the pre-increment count
(`scheduled_rate`), over the config's rate or a tensor of per-member
rates (the population sweep).  `Optimizer.update` applies the updates in
place to the f32 master parameters; its moments are f32.

The state crosses to and from optax's own state tree (the `opt_state` of
a JAX Trainer checkpoint, in flax's state-dict form: every chain a dict
of "0", "1", ...) through `opt_state_to_jax` / `opt_state_from_jax`.
The state keeps that tree's skeleton (`layout`, from `chain_layout`):
`{}` for a stateless transformation (clip, decayed weights, a constant
learning rate), `{"count"}` for a schedule, `{"count", "mu", "nu"}` for
`scale_by_adam`, `{"trace"}` for momentum.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

_F32 = np.float32


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the summed squares, in f32, on the first
    tensor's device (each device's part added there: a pipeline's
    stages)."""
    home = tensors[0].device
    return torch.sqrt(sum(torch.sum(t.float() * t.float()).to(home)
                          for t in tensors))


def _cosine_factor(count: int, decay_steps: int) -> np.float32:
    """`cosine_decay_schedule`'s decayed factor at alpha 0, in f32."""
    c = min(_F32(count), _F32(decay_steps))
    return _F32(0.5) * (_F32(1) + np.cos(_F32(math.pi) * c
                                         / _F32(decay_steps)))


def scheduled_rate(cfg, total_steps: int, count: int, base):
    """The config's learning rate at the pre-increment `count` over the
    base rate `base`: an f32 numpy scalar (the config's rate), or a
    tensor (the population sweep's per-member rates, one member's under
    `torch.func.vmap`).  optax's f32 algebra: `constant` is the base,
    `cosine` the base x the decayed factor, `warmup_cosine` (0 - base) x
    (1 - count / warmup) + base during the warmup, then the cosine over
    the remaining steps."""
    if cfg.lr_schedule == "constant":
        return base
    if cfg.lr_schedule == "cosine":
        return base * _cosine_factor(count, max(total_steps, 1))
    if cfg.lr_schedule == "warmup_cosine":
        warmup = cfg.warmup_steps
        if count < warmup:
            frac = _F32(1) - _F32(count) / _F32(warmup)
            return (-base) * frac + base
        return base * _cosine_factor(
            count - warmup, max(total_steps, warmup + 1) - warmup)
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule}")


def clip_by_global_norm(updates: list, max_norm: float) -> list:
    g_norm = global_norm(updates)
    out = []
    for u in updates:
        norm = g_norm.to(u.device)
        out.append(torch.where(norm < max_norm, u, (u / norm) * max_norm))
    return out


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
        self.cfg, self.total_steps = cfg, total_steps
        scheduled_rate(cfg, total_steps, 0, _F32(1))  # an unknown one raises
        self.momentum = cfg.momentum
        self.weight_decay = cfg.weight_decay
        self.clip: Optional[float] = cfg.gradient_clip_norm or None

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        zeros = lambda: [torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
                         for p in params]
        state: dict = {"count": 0, "layout": chain_layout(
            self.kind, bool(self.clip), bool(self.weight_decay),
            self.cfg.lr_schedule != "constant")}
        if self.kind in ("adam", "adamw"):
            state["mu"], state["nu"] = zeros(), zeros()
        elif self.kind == "momentum":
            state["trace"] = zeros()
        return state

    def step_size(self, count: int) -> float:
        """-learning rate at the pre-increment `count`."""
        return -float(scheduled_rate(self.cfg, self.total_steps, count,
                                     _F32(self.cfg.learning_rate)))

    def updates(self, grads: Sequence[torch.Tensor], state: dict,
                params: Sequence[torch.Tensor], lr=None) -> list:
        """The chain's updates for `grads` (not applied; the count is not
        advanced; the moment lists in `state` are replaced).  `lr` is a
        tensor base rate in place of the config's (the population sweep's
        per-member rate); the config's schedule still applies to it."""
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
        step = (self.step_size(count) if lr is None else
                -scheduled_rate(self.cfg, self.total_steps, count, lr))
        return [x * step for x in u]

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: dict,
               params: Sequence[torch.Tensor],
               return_updates: bool = False) -> Optional[list]:
        """One optax update, applied in place to `params`; with
        `return_updates` also returns the applied updates (the numerics
        probe's update-to-weight ratios)."""
        params = list(params)
        applied = self.updates(grads, state, params)
        for p, x in zip(params, applied):
            p.add_(x)
        state["count"] += 1
        return applied if return_updates else None


# ---------------------------------------------------------------------------
# optax's state tree
# ---------------------------------------------------------------------------

_ADAM = {"count": "count", "mu": "mu", "nu": "nu"}


def _chain(*parts) -> dict:
    return {str(i): part for i, part in enumerate(parts)}


def chain_layout(kind: str, clip: bool, decay: bool,
                 scheduled: bool) -> dict:
    """The skeleton of optax's state for `build_optimizer`'s chain
    (`mmlspark_tpu/train/trainer.py:122-154`): each leaf names the state
    entry it holds ("count", "mu", "nu", "trace")."""
    lr = {"count": "count"} if scheduled else {}
    if kind == "sgd":
        tree = _chain({}, lr)
    elif kind == "momentum":
        tree = _chain({"trace": "trace"}, lr)
    elif kind == "adam":
        tree = _chain(dict(_ADAM), lr)
    elif kind == "adamw":
        tree = _chain(dict(_ADAM), {}, lr)
    else:
        raise ValueError(f"unknown optimizer {kind!r}")
    if kind != "adamw" and decay:
        tree = _chain({}, tree)
    if clip:
        tree = _chain({}, tree)
    return tree


_LEAF_OF = {"numpy": lambda v: v.float().cpu().numpy().copy(),
            "device": lambda v: v.float().clone(
                memory_format=torch.contiguous_format),
            "view": lambda v: v}


def nest(flat: dict) -> dict:
    """{"a.b.c": leaf} -> {"a": {"b": {"c": leaf}}}."""
    tree: dict = {}
    for name, leaf in flat.items():
        parent = tree
        *path, last = name.split(".")
        for key in path:
            parent = parent.setdefault(key, {})
        parent[last] = leaf
    return tree


def named_tree(names: Sequence[str], tensors: Sequence[torch.Tensor],
               to: str = "numpy") -> dict:
    """Named f32 parameters in the flax tree, by the node rules of
    `models/bundle.py::variables_to_jax`: `scale`/`bias` a LayerNorm or a
    BatchNorm's params, a rank-4 `weight` a Conv (OIHW -> `kernel` HWIO,
    bias optional), `weight` and `bias` a Dense (weight (out, in) ->
    `kernel` (in, out); the pipeline's stacked (L, out, in) -> (L, in,
    out)), `weight` alone an embedding, anything else (a MoE block's
    expert stacks, the pipeline's raw leaves) as it is.  Leaves: `to="numpy"`
    host copies; `"device"` fresh contiguous copies on the tensors' device
    (later in-place updates leave them alone); `"view"` the tensors
    themselves (shapes only: a restore's template)."""
    nodes: dict = {}
    for name, t in zip(names, tensors):
        prefix, _, leaf = name.rpartition(".")
        nodes.setdefault(prefix, {})[leaf] = t.detach()
    leaf_of = _LEAF_OF[to]
    flat: dict = {}
    for prefix, leaves in nodes.items():
        if "scale" in leaves:
            node = {"scale": leaves["scale"], "bias": leaves["bias"]}
        elif "weight" not in leaves:
            node = dict(leaves)
        elif leaves["weight"].dim() == 4:
            node = {"kernel": leaves["weight"].permute(2, 3, 1, 0)}
        elif "bias" in leaves:
            node = {"kernel": leaves["weight"].transpose(-2, -1)}
        else:
            node = {"embedding": leaves["weight"]}
        if "kernel" in node and "bias" in leaves:
            node["bias"] = leaves["bias"]
        flat.update({f"{prefix}.{k}" if prefix else k: leaf_of(v)
                     for k, v in node.items()})
    return nest(flat)


def stats_tree(names: Sequence[str], tensors: Sequence[torch.Tensor],
               to: str = "numpy") -> dict:
    """Named BatchNorm buffers (`<layer>.mean`, `<layer>.var`) as flax's
    `batch_stats` tree, leaves as `named_tree`'s `to` says."""
    return nest({name: _LEAF_OF[to](t.detach())
                 for name, t in zip(names, tensors)})


def _named_from_tree(tree: dict, names: Sequence[str]) -> list:
    from mmlspark_tpu_torch.models.bundle import params_from_jax
    named = params_from_jax(tree)
    if set(named) != set(names):
        raise ValueError(f"optimizer state tree names {sorted(named)} do "
                         f"not match the parameters {sorted(names)}")
    return [named[n] for n in names]


def opt_state_to_jax(state: dict, names: Sequence[str],
                     to: str = "numpy") -> dict:
    """The port's optimizer state -> optax's state tree in flax's
    state-dict form.  Each count is an int32 0-d array, each moment tree
    mirrors the parameters' (`named_tree`, whose `to` picks numpy
    leaves, device copies for an async checkpoint's snapshot, or
    views)."""
    def fill(node):
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        if node == "count":
            return np.asarray(state["count"], np.int32)
        return named_tree(names, state[node], to=to)
    return fill(state["layout"])


def opt_state_from_jax(tree: dict, names: Sequence[str],
                       device=None) -> dict:
    """optax's state tree of any `build_optimizer` chain (flax state-dict
    form, numpy leaves) -> the port's optimizer state over the parameters
    `names` (in the order of the port's parameter list), f32 tensors on
    `device`.  A chain with no count (sgd or momentum at a constant rate)
    gives count 0, which such a chain never reads."""
    state: dict = {}
    counts = []

    def walk(node):
        if not isinstance(node, dict):
            raise ValueError(f"unexpected optimizer state leaf {node!r}")
        keys = set(node)
        if keys and all(k.isdigit() for k in keys):
            return {k: walk(node[k]) for k in sorted(node, key=int)}
        if keys == {"count", "mu", "nu"}:
            counts.append(int(np.asarray(node["count"])))
            for key in ("mu", "nu"):
                state[key] = [t.to(device) for t in
                              _named_from_tree(node[key], names)]
            return dict(_ADAM)
        if keys == {"trace"}:
            state["trace"] = [t.to(device) for t in
                              _named_from_tree(node["trace"], names)]
            return {"trace": "trace"}
        if keys == {"count"}:
            counts.append(int(np.asarray(node["count"])))
            return {"count": "count"}
        if not keys:
            return {}
        raise ValueError(f"unknown optax state node with keys "
                         f"{sorted(keys)}")

    state["layout"] = walk(tree)
    if len(set(counts)) > 1:
        raise ValueError(f"optax state counts disagree: {counts}")
    state["count"] = counts[0] if counts else 0
    return state
