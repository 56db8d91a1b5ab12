"""Plain optimizer updates for the training references: optax's algebra
(the order of its operations), written out on a dict of tensors.

  * `adam`: optional decayed weights first, then `scale_by_adam` (b1,
    b2, eps outside the square root, bias correction at the incremented
    count), then the learning rate;
  * `momentum`: decayed weights first, then `trace` (no dampening), then
    the learning rate: torch's SGD with momentum, written as optax does.
"""

from __future__ import annotations

import torch


def init(params: dict, recipe: dict) -> dict:
    zeros = {n: torch.zeros_like(p) for n, p in params.items()}
    if recipe["optimizer"] == "adam":
        return {"count": 0, "mu": zeros,
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}
    if recipe["optimizer"] == "momentum":
        return {"count": 0, "trace": zeros}
    raise ValueError(f"unknown optimizer {recipe['optimizer']!r}")


@torch.no_grad()
def update(params: dict, grads: dict, state: dict, recipe: dict) -> None:
    """One step applied in place to `params` (a dict of leaf tensors)."""
    lr = float(recipe["learning_rate"])
    wd = float(recipe.get("weight_decay", 0))
    state["count"] += 1
    t = state["count"]
    for n, p in params.items():
        u = grads[n].float()
        if wd:
            u = u + wd * p
        if recipe["optimizer"] == "adam":
            b1, b2 = recipe.get("b1", 0.9), recipe.get("b2", 0.999)
            eps = recipe.get("eps", 1e-8)
            m = state["mu"][n] = (1 - b1) * u + b1 * state["mu"][n]
            v = state["nu"][n] = (1 - b2) * (u * u) + b2 * state["nu"][n]
            bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
            bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t
            step = (m / bc1.item()) / (torch.sqrt(v / bc2.item()) + eps)
        else:
            trace = state["trace"]
            step = trace[n] = u + recipe["momentum"] * trace[n]
        p.add_(step * -lr)
