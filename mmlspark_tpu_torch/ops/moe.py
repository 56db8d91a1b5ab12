"""Mixture-of-experts MLP as torch ops: the port of
`mmlspark_tpu/ops/moe.py` (`topk_dispatch` :51, `top1_dispatch` :105,
`_group_size` :112, `MoEMLP` :122, `is_expert_stack` :183) on one card.

The JAX package leaves this op to XLA (einsums, no Pallas kernel), so the
port runs it as plain torch ops, the expert products as batched matmuls
(cuBLAS on the card).  Routing is the Switch / GShard recipe of the JAX
module, kept exactly:

  * tokens split into groups of `_group_size(T, group_size)` (the largest
    divisor of T at or below the target), each routing on its own with
    per-expert capacity `max(1, int(np.ceil(gs / e * capacity_factor *
    k)))`, in that Python float order;
  * the router is a Dense layer with bias computed in f32 on an f32 input
    whatever the model dtype, TF32 off on the card (`exact_f32`);
  * choice j is the argmax of the probabilities with the earlier choices
    multiplied by (1 - onehot) (ties to the first index); the j-th choices
    queue behind every (j-1)-th choice in an expert's buffer, in token
    order within a choice; a slot at or past capacity is dropped;
  * gates are the raw probability at k = 1 and normalized by their sum
    plus 1e-9 at k > 1; experts are relu with no bias;
  * sown: `moe_aux_loss` = e * sum(f * p) with f the choice-1 frequencies,
    averaged over groups; `moe_z_loss` pre-scaled by `z_loss_weight`;
    `moe_overflow_fraction` = 1 - the mean kept fraction.

Dispatch and combine are gathers, not the JAX package's one-hot einsums.
Each capacity slot holds at most one token, so the slot tensor is the
token rows themselves (`x[slot_token]`) and a token's output is the sum
over its k kept choices of gate x its slot's expert output: the same
values as the einsums, whose other terms are exact zeros
(`tests/test_torch_moe.py` pins the dense `topk_dispatch` against the JAX
one and the module's output against `MoEMLP.apply`).  The einsum form
costs O(T x E x C) per product; the gathers O(T x k).  The gathers'
backward is `index_add_`; at k <= 2 it is bit-repeatable on the card
even with atomic adds: a real row receives at most two contributions,
and a + b is b + a (the empty and dropped slots all add into pad rows
that are thrown away).

Under a data-parallel step (`parallel/ring.py` `active_data_shard`) the
JAX step's jit sees the whole batch, so the group size is `_group_size`
over the GLOBAL token count (shard tokens x shards), and each shard routes
its own tokens in groups of that size; a shard whose token count that
size does not divide would need a group straddling two shards, and
raises `ValueError` (a port difference).  Each shard's sown values are
means over its own groups; the shards have equal group counts, so the
Trainer averages them over the shards.

Expert parallelism: over a mesh with a model axis the expert stacks are
placed by the partition rules (`expert_parallel_rules`, or the Trainer's
`parallel/partition.py` `param_sharding_rule`).  `moe_apply` then takes
each stack as a `ModelShards` list and routes exactly as on one device
(the same groups, capacity and sown values, on the home replica): the
(E, G C, D) slot tensor is cut by expert over the model group
(`parallel/ring.py` `all_to_all`, the home the one sender), model shard m
runs experts [m E/mp, (m+1) E/mp) with its own (E/mp, D, H) and (E/mp, H,
D) stacks, and the outputs come back to the home in expert order, where
the combine's gather (and its `index_add_` backward) runs as on one
device.  A stack split on a trailing dim instead (`expert_parallel=False`,
or an expert count mp does not divide) computes its output columns per
shard, joined before the next product.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmlspark_tpu_torch.core.device import exact_f32, resolve_device
from mmlspark_tpu_torch.parallel.partition import ModelShards
from mmlspark_tpu_torch.parallel.ring import (active_data_shard, all_to_all,
                                              reduce_to_home, unshard)


def _group_size(t: int, target: int) -> int:
    """Largest divisor of t that is <= target."""
    target = max(1, min(t, target))
    for g in range(target, 0, -1):
        if t % g == 0:
            return g
    return 1


def capacity_of(group: int, n_experts: int, capacity_factor: float,
                k: int) -> int:
    """Per-expert slots of one routing group (the JAX module's float
    order)."""
    return max(1, int(np.ceil(group / n_experts * capacity_factor * k)))


def route(logits: torch.Tensor, capacity: int, k: int = 1) -> dict:
    """Top-k routing of G groups at once: logits (G, T, E) -> a dict of
    `expert`, `slot` (k, G, T) long (the choice's expert and its position
    in that expert's buffer), `kept` (k, G, T) bool, `gate` (k, G, T) f32
    (normalized at k > 1, not masked), and per group (G,) f32 `aux`, `z`
    and `kept_fraction`.  f32 throughout."""
    g, t, e = logits.shape
    logits32 = logits.float()
    probs = torch.softmax(logits32, dim=-1)
    remaining = probs
    counts = logits32.new_zeros((g, 1, e))
    # the one-hot as a comparison with arange(e): `F.one_hot` reads the
    # largest index back to the host, which `torch.func.vmap` refuses
    ids = torch.arange(e, device=logits.device)
    experts, gates, positions, onehots = [], [], [], []
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)                     # (G, T)
        onehot = (idx[..., None] == ids).to(torch.float32)
        gates.append(torch.gather(probs, -1, idx[..., None])[..., 0])
        pos = torch.cumsum(onehot, dim=1) - 1.0 + counts
        positions.append((pos * onehot).sum(-1))
        experts.append(idx)
        onehots.append(onehot)
        counts = counts + onehot.sum(1, keepdim=True)
        remaining = remaining * (1.0 - onehot)
    if k > 1:
        denom = sum(gates) + 1e-9
        gates = [gt / denom for gt in gates]
    pos = torch.stack(positions)
    kept = (pos < capacity) & (pos >= 0)
    f = onehots[0].mean(dim=1)
    p = probs.mean(dim=1)
    return {
        "expert": torch.stack(experts), "slot": pos.long(), "kept": kept,
        "gate": torch.stack(gates),
        "aux": e * torch.sum(f * p, dim=-1),
        "z": torch.mean(torch.logsumexp(logits32, dim=-1) ** 2, dim=-1),
        "kept_fraction": kept.float().sum((0, 2)) / float(t * k)}


def topk_dispatch(router_logits: torch.Tensor, capacity: int,
                  k: int = 1) -> tuple:
    """(dispatch (T, E, C), combine (T, E, C), aux_loss, z_loss,
    kept_fraction) of one group's router logits (T, E): the JAX
    function's dense one-hot tensors, built from `route` (the module runs
    the gathers instead)."""
    t, e = router_logits.shape
    r = route(router_logits[None], capacity, k)
    dispatch = torch.zeros((t, e, capacity), dtype=torch.float32,
                           device=router_logits.device)
    combine = torch.zeros_like(dispatch)
    rows = torch.arange(t, device=router_logits.device)
    for j in range(k):
        keep = r["kept"][j, 0]
        at = (rows[keep], r["expert"][j, 0][keep], r["slot"][j, 0][keep])
        dispatch[at] = 1.0
        combine[at] = r["gate"][j, 0][keep]
    return dispatch, combine, r["aux"][0], r["z"][0], r["kept_fraction"][0]


def top1_dispatch(router_logits: torch.Tensor, capacity: int) -> tuple:
    """(dispatch, combine, aux_loss): the Switch top-1 case of
    `topk_dispatch`."""
    dispatch, combine, aux, _, _ = topk_dispatch(router_logits, capacity, 1)
    return dispatch, combine, aux


def moe_apply(x: torch.Tensor, router_weight: torch.Tensor,
              router_bias: torch.Tensor, w_in: torch.Tensor,
              w_out: torch.Tensor, *, router_k: int = 1,
              group_size: int = 512, capacity_factor: float = 1.25,
              z_loss_weight: float = 1e-3, shards: int = 1) -> tuple:
    """The MoE MLP over x (B, S, D): (y (B, S, D) in x's dtype, sown).

    `router_weight` (E, D) and `router_bias` (E,) are f32; `w_in` (E, D,
    H) and `w_out` (E, H, D) are in the compute dtype (the module casts
    its f32 masters per call, the serving weights once).  `sown` holds
    {"losses": {"moe_aux_loss", "moe_z_loss"}, "metrics":
    {"moe_overflow_fraction"}}, 0-d f32 tensors, the values the flax
    module sows.  `shards`: x is one of that many equal data shards of
    the batch, routed with the group size of the whole batch (module
    docstring)."""
    b, s, d = x.shape
    t = b * s
    e = w_in.shape[0]
    gs = _group_size(t * shards, group_size)
    if t % gs:
        raise ValueError(
            f"a data shard's {t} tokens do not split into routing groups "
            f"of {gs} (the group size of the global batch of {t * shards} "
            f"tokens): a group would straddle two shards")
    g = t // gs
    capacity = capacity_of(gs, e, capacity_factor, router_k)
    xf = x.reshape(t, d)
    with exact_f32():
        logits = F.linear(xf.float(), router_weight.float(),
                          router_bias.float())
    r = route(logits.reshape(g, gs, e), capacity, router_k)
    # flat slot index into the (E, G, C) slot tensor; dropped choices
    # point at the zero row past its end
    groups = torch.arange(g, device=x.device)[:, None]
    n_slots = e * g * capacity
    flat = torch.where(r["kept"],
                       (r["expert"] * g + groups) * capacity + r["slot"],
                       n_slots)
    tokens = torch.arange(t, device=x.device).reshape(g, gs)
    slot_token = torch.full((n_slots + 1,), t, dtype=torch.long,
                            device=x.device)
    # out of place, so that a population's vmap gives each member its own
    # slot table (every kept slot is written once; the dropped choices all
    # land on the pad entry cut below)
    for j in range(router_k):
        slot_token = slot_token.scatter(0, flat[j].reshape(-1),
                                        tokens.reshape(-1))
    slot_token = slot_token[:n_slots]
    dt = w_in.dtype
    xpad = torch.cat([xf.to(dt), xf.new_zeros((1, d), dtype=dt)])
    # index_select, not x[idx]: its backward is index_add_, which adds
    # the many empty slots' rows into the pad row in parallel, where the
    # indexing backward sorts the indices and walks each duplicate run
    # serially (0.70 of the card's step time at LM_CONFIG's width)
    slots = torch.index_select(xpad, 0, slot_token).reshape(
        e, g * capacity, d)
    out = _experts(slots, w_in, w_out).float().reshape(n_slots, d)
    outpad = torch.cat([out, out.new_zeros((1, d))])
    weight = r["gate"] * r["kept"].float()
    y = weight[0].reshape(t, 1) * torch.index_select(
        outpad, 0, flat[0].reshape(t))
    for j in range(1, router_k):
        y = y + weight[j].reshape(t, 1) * torch.index_select(
            outpad, 0, flat[j].reshape(t))
    sown = {"losses": {"moe_aux_loss": r["aux"].mean(),
                       "moe_z_loss": z_loss_weight * r["z"].mean()},
            "metrics": {"moe_overflow_fraction":
                        1.0 - r["kept_fraction"].mean()}}
    return y.to(x.dtype).reshape(b, s, d), sown


def _experts(slots: torch.Tensor, w_in, w_out) -> torch.Tensor:
    """relu(slots @ w_in) @ w_out per expert: (E, N, D) -> (E, N, D) on
    the slots' device.  Stacks split by expert run on their shards
    (module docstring); other splits go product by product
    (`_stack_product`)."""
    if (isinstance(w_in, ModelShards) and isinstance(w_out, ModelShards)
            and w_in.dim == 0 and w_out.dim == 0):
        parts = all_to_all([slots], [t.device for t in w_in], 0, 0)
        return unshard([torch.bmm(F.relu(torch.bmm(p, wi)), wo)
                        for p, wi, wo in zip(parts, w_in, w_out)], 0,
                       slots.device)
    return _stack_product(F.relu(_stack_product(slots, w_in)), w_out)


def _stack_product(x: torch.Tensor, w) -> torch.Tensor:
    """x (E, N, K) @ w (E, K, M) per expert, w a tensor or a `ModelShards`
    stack split on its expert (0), input (1) or output (2) dim, the
    result on x's device."""
    if not isinstance(w, ModelShards):
        return torch.bmm(x, w)
    devices = [t.device for t in w]
    if w.dim == 2:
        return unshard([torch.bmm(x.to(dev), t)
                        for dev, t in zip(devices, w)], -1, x.device)
    parts = all_to_all([x], devices, 0 if w.dim == 0 else 2,
                       0 if w.dim == 0 else 2)
    outs = [torch.bmm(p, t) for p, t in zip(parts, w)]
    if w.dim == 0:
        return unshard(outs, 0, x.device)
    return reduce_to_home(outs).to(x.device)


def _stack_of(module: nn.Module, name: str, dtype):
    """A MoE stack in the compute dtype: the module's own leaf, or on a
    home replica over a model group the peers' slices as a `ModelShards`."""
    split = (getattr(module, "model_split", None) or {}).get(name)
    if split is None:
        return getattr(module, name).to(dtype)
    return ModelShards([getattr(p, name).to(dtype)
                        for p in module.model_peers], split[0], split[1],
                       tuple(getattr(module, name).shape))


class MoEMLP(nn.Module):
    """Drop-in MLP replacement: router -> top-k experts -> combine, with
    the flax module's parameters as f32 masters: `router.{weight, bias}`
    (the Dense layer's (E, D) weight and bias), `w_in` (E, D, H) and
    `w_out` (E, H, D), on the card unless `device` says otherwise.
    `forward(x)` returns (y, sown) (`moe_apply`).  `expert_axis` names
    the mesh axis the stacks split over; the placement (module docstring)
    decides it."""

    def __init__(self, d_model: int, n_experts: int = 8,
                 mlp_ratio: int = 4, capacity_factor: float = 1.25,
                 dtype=torch.bfloat16, expert_axis: Optional[str] = None,
                 group_size: int = 512, router_k: int = 1,
                 z_loss_weight: float = 1e-3, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.expert_axis = expert_axis
        h = mlp_ratio * d_model
        self.dtype = dtype
        self.n_experts, self.router_k = n_experts, router_k
        self.group_size, self.capacity_factor = group_size, capacity_factor
        self.z_loss_weight = z_loss_weight
        self.router = nn.Linear(d_model, n_experts, device=device)
        self.w_in = nn.Parameter(torch.zeros((n_experts, d_model, h),
                                             device=device))
        self.w_out = nn.Parameter(torch.zeros((n_experts, h, d_model),
                                              device=device))

    def forward(self, x: torch.Tensor) -> tuple:
        shard = active_data_shard()
        router = self.router
        if (getattr(router, "model_split", None) or {}).get("weight"):
            weight, bias = (torch.cat([getattr(p, leaf).to(x.device)
                                       for p in router.model_peers])
                            for leaf in ("weight", "bias"))
        else:
            weight, bias = router.weight, router.bias
        return moe_apply(x, weight, bias, _stack_of(self, "w_in", self.dtype),
                         _stack_of(self, "w_out", self.dtype),
                         router_k=self.router_k, group_size=self.group_size,
                         capacity_factor=self.capacity_factor,
                         z_loss_weight=self.z_loss_weight,
                         shards=1 if shard is None else shard.count)


def is_expert_stack(path, shape, axis_size: int = 1) -> bool:
    """True when a parameter-tree leaf at `path` with `shape` is a stacked
    expert tensor whose leading (expert) dim can shard over an axis of
    `axis_size` devices: rank 3, named `w_in` / `w_out`, under a module
    whose name contains "moe", and an expert count the axis divides."""
    keys = [p.key if hasattr(p, "key") else str(p) for p in path]
    return (len(shape) == 3
            and bool(keys) and keys[-1] in ("w_in", "w_out")
            and any("moe" in k.lower() for k in keys[:-1])
            and axis_size > 0 and shape[0] % axis_size == 0)


def expert_parallel_rules(params: dict, mesh, axis: str = "model") -> dict:
    """The placement of a flax parameter tree holding MoE experts (the JAX
    function, moe.py:202-220): a tree of `parallel/mesh.py`
    `ModelSharding`s, an (E, ...) expert stack's leading dim over `axis`
    (where `is_expert_stack` holds: an expert count the axis does not
    divide replicates), every other leaf replicated."""
    from mmlspark_tpu_torch.parallel.mesh import model_sharding
    size = mesh.shape.get(axis, 1)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        spec = ((axis, None, None) if is_expert_stack(path, np.shape(node),
                                                      size) else ())
        return model_sharding(mesh, spec)

    return walk(params, ())
