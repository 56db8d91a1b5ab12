"""Single-controller collectives and sequence-parallel attention: the
port's counterparts of what `shard_map` gives the JAX code
(`mmlspark_tpu/parallel/ring.py`, `mmlspark_tpu/ops/attention.py`
:219-234).

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
"""

from __future__ import annotations

from typing import Sequence

import torch

from mmlspark_tpu_torch.parallel.mesh import MODEL_AXIS


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
    its own seq ring; the result is joined on q's device.

    impl "ring": `ops/attention.ring_attention` (the flash forward with
    lse per (shard, block), K/V rotating).  impl "dense": each shard
    gathers the whole K/V and attends with its global query offset (the
    correctness yardstick).  Forward only."""
    from mmlspark_tpu_torch.ops.attention import attention, ring_attention
    if impl in ("ulysses", "ring_flash"):
        raise NotImplementedError(
            f"seq-parallel impl '{impl}' is not ported: all-to-all Ulysses "
            "and the differentiable ring flash come with seq-parallel "
            "training, a later slice (ROADMAP A10)")
    if impl not in ("ring", "dense"):
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
        else:
            kf, vf = unshard(ks, 1, devs[0]), unshard(vs, 1, devs[0])
            s_l = qs[0].shape[1]
            outs = [attention(qi, kf.to(qi.device), vf.to(qi.device),
                              causal=causal, q_offset=i * s_l)
                    for i, qi in enumerate(qs)]
        rows.append(unshard(outs, 1, q.device))
    return torch.cat(rows, dim=0)
