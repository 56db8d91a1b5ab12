"""Single-controller collectives, sequence-parallel attention and the
seq-parallel LM train step: the port's counterparts of what `shard_map`
gives the JAX code (`mmlspark_tpu/parallel/ring.py`,
`mmlspark_tpu/ops/attention.py` :219-434).

A sharded tensor is a list of per-shard tensors, shard i on its own
device.  The collectives are explicit tensor moves between those devices:

  * `shard` / `unshard` / `reshard` — cut a tensor into per-device slabs
    along one axis, put them back together, or move slab boundaries;
  * `pmax` / `psum` — reduce on a home device (shard 0's) and return the
    result to every shard's device, as `lax.pmax` / `lax.psum` replicate
    it;
  * `ppermute` — the ring rotation i -> i + 1 of `_ring_fold_loop`.

On shards that share one device each move is a no-op, so a mesh of one
card costs no copies.  `seq_parallel_attention` is the JAX entry point of
the same name over a `Mesh`: batch over 'data', sequence over 'seq'.

`make_seq_parallel_lm_step` is the JAX step of the same name: a
`TransformerLM` with `attn_impl` ring | ring_flash | ulysses and
`seq_axis="seq"` runs its attention sequence-sharded over the mesh set by
`use_seq_mesh` (the counterpart of the axis name a `shard_map` region
puts in scope), the token-wise layers unsharded on the mesh's first
device (`models/definitions.py`).  The loss is the masked mean over both
axes; the parameters and the optimizer state are one replicated copy.
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
from typing import Callable, Iterator, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from mmlspark_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS

IMPLS = ("ring", "ring_flash", "ulysses", "dense")

_seq_mesh: contextvars.ContextVar = contextvars.ContextVar(
    "mmlspark_tpu_torch_seq_mesh", default=None)


@contextlib.contextmanager
def use_seq_mesh(mesh) -> Iterator:
    """The mesh a seq-sharded `TransformerLM` runs its attention over
    inside this block (what the JAX model reads from the `shard_map`
    region's axis names)."""
    token = _seq_mesh.set(mesh)
    try:
        yield mesh
    finally:
        _seq_mesh.reset(token)


def active_seq_mesh():
    """The mesh of the innermost `use_seq_mesh` block, or None."""
    return _seq_mesh.get()


def shard(x: torch.Tensor, devices: Sequence, dim: int) -> list:
    """`x` cut into len(devices) equal contiguous slabs along `dim`, slab i
    on devices[i]."""
    n = len(devices)
    if x.shape[dim] % n:
        raise ValueError(f"axis {dim} of length {x.shape[dim]} does not "
                         f"split over {n} shards")
    return [part.to(dev).contiguous()
            for part, dev in zip(x.chunk(n, dim=dim), devices)]


def unshard(parts: Sequence, dim: int, device) -> torch.Tensor:
    """The slabs of `parts` joined along `dim` on `device`."""
    return torch.cat([p.to(device) for p in parts], dim=dim)


def reshard(parts: Sequence, length: int, devices: Sequence,
            dim: int) -> list:
    """Move slab boundaries: `parts` cover positions 0..sum-1 of axis `dim`
    in order; the result is len(devices) equal slabs covering 0..length-1,
    slab j on devices[j], with positions past the old end zero.  Each
    destination takes only the pieces that overlap it."""
    n = len(devices)
    if length % n:
        raise ValueError(f"length {length} does not split over {n} shards")
    width = length // n
    starts, pos = [], 0
    for p in parts:
        starts.append(pos)
        pos += p.shape[dim]
    if pos > length:
        raise ValueError(f"reshard cannot shrink {pos} positions to {length}")
    out = []
    for j, dev in enumerate(devices):
        lo, hi = j * width, (j + 1) * width
        pieces = []
        for p, s0 in zip(parts, starts):
            a, b = max(lo, s0), min(hi, s0 + p.shape[dim])
            if a < b:
                pieces.append(p.narrow(dim, a - s0, b - a).to(dev))
        have = sum(t.shape[dim] for t in pieces)
        if have < width:
            shape = list(parts[0].shape)
            shape[dim] = width - have
            pieces.append(torch.zeros(shape, dtype=parts[0].dtype,
                                      device=dev))
        out.append(torch.cat(pieces, dim=dim).contiguous())
    return out


def _reduce(parts: Sequence, op) -> list:
    home = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = op(total, p.to(home))
    return [total.to(p.device) for p in parts]


def pmax(parts: Sequence) -> list:
    """Elementwise max over the shards, on every shard's device."""
    return _reduce(parts, torch.maximum)


def psum(parts: Sequence) -> list:
    """Elementwise sum over the shards (in shard order), on every shard's
    device."""
    return _reduce(parts, torch.add)


def ppermute(parts: Sequence) -> list:
    """The ring rotation: shard i + 1 receives what shard i held."""
    n = len(parts)
    return [parts[(i - 1) % n].to(parts[i].device) for i in range(n)]


def seq_parallel_attention(mesh, q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool = False,
                           impl: str = "ring") -> torch.Tensor:
    """Attention over (B, S, H, D) tensors with B split over the mesh's
    'data' axis and S over its 'seq' axis (model 1).  Each data group runs
    its own seq ring; the result is joined on q's device.  The cuts and
    joins are differentiable, so gradients flow back to q, k and v.

    impl "ring": `ops/attention.ring_attention` (the flash forward with
    lse per (shard, block) without gradients; the dense online-softmax
    fold under autograd).  "ring_flash": `ring_flash_attention` (the
    flash forward with lse per block, the dQ and dK/dV kernels per block
    in the backward).  "ulysses": `ulysses_attention` (heads all-to-all,
    dense attention).  "dense": each shard gathers the whole K/V and
    attends with its global query offset (the correctness yardstick)."""
    from mmlspark_tpu_torch.ops.attention import (attention, ring_attention,
                                                  ring_flash_attention,
                                                  ulysses_attention)
    if impl not in IMPLS:
        raise ValueError(f"unknown seq-parallel impl '{impl}'")
    if mesh.shape[MODEL_AXIS] != 1:
        raise ValueError("seq_parallel_attention runs over a model-1 mesh")
    rings = mesh.seq_rings()
    rows = []
    by_group = zip(*(shard(t, [t.device] * len(rings), 0)
                     for t in (q, k, v)))
    for (qg, kg, vg), devs in zip(by_group, rings):
        qs, ks, vs = (shard(t, devs, 1) for t in (qg, kg, vg))
        if impl == "ring":
            outs = ring_attention(qs, ks, vs, causal=causal)
        elif impl == "ring_flash":
            outs = ring_flash_attention(qs, ks, vs, causal=causal)
        elif impl == "ulysses":
            outs = ulysses_attention(qs, ks, vs, causal=causal)
        else:
            kf, vf = unshard(ks, 1, devs[0]), unshard(vs, 1, devs[0])
            s_l = qs[0].shape[1]
            outs = [attention(qi, kf.to(qi.device), vf.to(qi.device),
                              causal=causal, q_offset=i * s_l)
                    for i, qi in enumerate(qs)]
        rows.append(unshard(outs, 1, q.device))
    return torch.cat(rows, dim=0)


def shard_tokens(tokens, mesh, data_axis: str = DATA_AXIS,
                 seq_axis: str = SEQ_AXIS) -> torch.Tensor:
    """(B, S) token, target or mask arrays for the seq-parallel step: B
    must split over `data_axis` and S over `seq_axis`.  The token-wise
    layers run on the mesh's first device, so the array lands there
    whole; the attention cuts it per shard."""
    t = torch.as_tensor(np.asarray(tokens))
    b, s = t.shape[:2]
    if b % mesh.shape[data_axis] or s % mesh.shape[seq_axis]:
        raise ValueError(
            f"tokens {tuple(t.shape)} do not split over the mesh "
            f"{mesh.shape} (batch over '{data_axis}', sequence over "
            f"'{seq_axis}')")
    return t.to(mesh.devices.flat[0])


def make_seq_parallel_lm_step(module, tx, mesh, remat: bool = False
                              ) -> Callable:
    """The seq-parallel LM train step over `mesh` (batch over 'data',
    sequence over 'seq'): `step(params, opt_state, tokens, targets, mask)
    -> (params, opt_state, loss)`, as the JAX step returns them.

    `module` is a `TransformerLM` with attn_impl ring | ring_flash |
    ulysses and `seq_axis="seq"`; `params` is `list(module.parameters())`
    (the replicated f32 masters, updated in place) and `tx` the port's
    `Optimizer` with `opt_state = tx.init(params)`.  The loss is the
    masked mean of the per-token cross-entropy over both axes.
    `remat=True` steps a copy of `module` that shares its parameters and
    recomputes each block in the backward (the reference's
    `module.clone(remat=True)`); `module` itself is left as it is."""
    # here, not at the top: the train package imports the models, whose
    # attention imports this module
    from mmlspark_tpu_torch.train.optim import backward_and_update
    if remat and not module.remat:
        module = copy.copy(module)
        module.remat = True

    def loss_of(tokens, targets, mask):
        with use_seq_mesh(mesh):
            logits = module(tokens)
        ll = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                             targets.reshape(-1).long(),
                             reduction="none").reshape(targets.shape)
        mask = mask.float()
        return (ll * mask).sum() / torch.clamp(mask.sum(), min=1.0), None

    def step(params, opt_state, tokens, targets, mask):
        loss = backward_and_update(
            tx, params, opt_state,
            lambda: loss_of(tokens, targets, mask))[0]
        return params, opt_state, loss.detach()

    return step
