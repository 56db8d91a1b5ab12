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
  * `ppermute` — the ring rotation i -> i + 1 of `_ring_fold_loop`;
  * over a data row's model group (`parallel/mesh.py` `model_group`,
    index 0 its home): `psum` sums row-parallel partial outputs in model
    order and hands the sum to every shard, `reduce_to_home` keeps it on
    the home (where the port's residual stream lives); `all_gather` joins
    column-parallel outputs (the MLP hidden, the vocab logits) along a
    dim in model order; `all_to_all` exchanges expert slabs (the home
    holds every token of its row, so expert parallelism's exchange is
    the home's slot tensor cut by expert to the shards and their outputs
    joined back: `all_to_all` with one sender).  Every one is plain
    differentiable tensor moves: the backward of a `.to(device)` copy is
    the copy back, and autograd sums the gradients of a tensor that
    several shards read (Megatron's f / g pair).

On shards that share one device each move is a no-op, so a mesh of one
card costs no copies.  `seq_parallel_attention` is the JAX entry point of
the same name over a `Mesh`: batch over 'data', sequence over 'seq'.

`make_seq_parallel_lm_step` is the JAX step of the same name: the whole
loss runs per (data, seq) shard, as the JAX step's `shard_map` body does.
Each shard embeds its own (b/data, s/seq) slab at its global positions
and runs its norms, Dense layers, MLP, head and per-token loss on its own
device, with its own replica of the parameters
(`parallel/bridge.py` `ShardReplicas`); only the attention crosses
shards, through the ring or Ulysses exchanges (`seq_group_attention`).
The loss is the masked sum psum'd over both axes over the psum of the
mask.  A whole-array forward under `use_seq_mesh` (the counterpart of the
axis name a `shard_map` region puts in scope) still runs the attention
sharded and the rest on the tokens' device.

Data parallelism (`ShardGroup`, `data_shard`): a data-parallel step runs
one function per shard of the 'data' axis.  Inside it `active_data_shard`
names the shard, its index and the shard count, which the layers read
where the JAX step's jit sees the whole batch: BatchNorm in training
takes its statistics over the global batch through `ShardGroup.all_sum`
(the shards then run in lockstep on threads of their own, since each
waits for the others' sums), and the MoE routes with the global group
size.  `reduce_to_home` is the gradient reduce: the sum on the home
device (shard 0's), in shard order.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import threading
from typing import Callable, Iterator, Optional, Sequence

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


def _reduce_home(parts: Sequence, op) -> torch.Tensor:
    home = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = op(total, p.to(home))
    return total


def _reduce(parts: Sequence, op) -> list:
    total = _reduce_home(parts, op)
    return [total.to(p.device) for p in parts]


def reduce_to_home(parts: Sequence) -> torch.Tensor:
    """The elementwise sum over the shards on the home device (shard 0's),
    in shard order: the gradient reduce, whose result one optimizer
    consumes."""
    return _reduce_home(parts, torch.add)


def pmax(parts: Sequence) -> list:
    """Elementwise max over the shards, on every shard's device."""
    return _reduce(parts, torch.maximum)


def psum(parts: Sequence) -> list:
    """Elementwise sum over the shards (in shard order), on every shard's
    device."""
    return _reduce(parts, torch.add)


def all_gather(parts: Sequence, dim: int) -> list:
    """The shards' parts joined along `dim` in shard order, on every
    shard's device (a joined tensor is made once per distinct device)."""
    joined: dict = {}
    out = []
    for p in parts:
        if p.device not in joined:
            joined[p.device] = unshard(parts, dim, p.device)
        out.append(joined[p.device])
    return out


def all_to_all(parts: Sequence, devices: Sequence, split_dim: int,
               concat_dim: int) -> list:
    """Sender i's tensor cut into len(devices) equal slabs along
    `split_dim`; receiver j gets slab j of every sender, joined along
    `concat_dim` in sender order, on devices[j].  Where shards share a
    device the slabs are views, not copies."""
    n = len(devices)
    cut = [p.chunk(n, dim=split_dim) for p in parts]
    return [torch.cat([c[j].to(dev) for c in cut], dim=concat_dim)
            if len(cut) > 1 else cut[0][j].to(dev)
            for j, dev in enumerate(devices)]


def ppermute(parts: Sequence) -> list:
    """The ring rotation: shard i + 1 receives what shard i held."""
    n = len(parts)
    return [parts[(i - 1) % n].to(parts[i].device) for i in range(n)]


def seq_group_attention(impl: str, q: list, k: list, v: list,
                        causal: bool = False) -> list:
    """One data group's attention over its seq shards' slabs (lists of
    (B, S_l, H, D), shard i on its own device): impl "ring"
    (`ops/attention.ring_attention`: the flash forward with lse per
    (shard, block) without gradients, the dense online-softmax fold under
    autograd), "ring_flash" (`ring_flash_attention`: the flash forward
    with lse per block, the dQ and dK/dV kernels per block in the
    backward), "ulysses" (`ulysses_attention`: heads all-to-all, dense
    attention), "dense" (each shard gathers the whole K/V and attends with
    its global query offset: the correctness yardstick)."""
    from mmlspark_tpu_torch.ops.attention import (attention, ring_attention,
                                                  ring_flash_attention,
                                                  ulysses_attention)
    if impl not in IMPLS:
        raise ValueError(f"unknown seq-parallel impl '{impl}'")
    if impl == "ring":
        return ring_attention(q, k, v, causal=causal)
    if impl == "ring_flash":
        return ring_flash_attention(q, k, v, causal=causal)
    if impl == "ulysses":
        return ulysses_attention(q, k, v, causal=causal)
    home = q[0].device
    kf, vf = unshard(k, 1, home), unshard(v, 1, home)
    s_l = q[0].shape[1]
    return [attention(qi, kf.to(qi.device), vf.to(qi.device), causal=causal,
                      q_offset=i * s_l) for i, qi in enumerate(q)]


def seq_parallel_attention(mesh, q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool = False,
                           impl: str = "ring") -> torch.Tensor:
    """Attention over (B, S, H, D) tensors with B split over the mesh's
    'data' axis and S over its 'seq' axis (model 1).  Each data group runs
    its own seq ring (`seq_group_attention`); the result is joined on q's
    device.  The cuts and joins are differentiable, so gradients flow
    back to q, k and v."""
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
        rows.append(unshard(seq_group_attention(impl, qs, ks, vs, causal),
                            1, q.device))
    return torch.cat(rows, dim=0)


def seq_shard_devices(mesh) -> list:
    """The devices of the (data, seq) shards of a model-1 mesh, in shard
    order: shard g * seq + j is data group g's seq index j."""
    if mesh.shape[MODEL_AXIS] != 1:
        raise ValueError("the seq-parallel step runs over a model-1 mesh")
    return [d for group in mesh.seq_rings() for d in group]


def shard_tokens(tokens, mesh, data_axis: str = DATA_AXIS,
                 seq_axis: str = SEQ_AXIS) -> list:
    """(B, S) token, target or mask arrays for the seq-parallel step, cut
    with B over `data_axis` and S over `seq_axis`: the (B/data, S/seq)
    slab of each (data, seq) shard on its own device, in shard order."""
    t = torch.as_tensor(np.asarray(tokens))
    b, s = t.shape[:2]
    n_data, n_seq = mesh.shape[data_axis], mesh.shape[seq_axis]
    if b % n_data or s % n_seq:
        raise ValueError(
            f"tokens {tuple(t.shape)} do not split over the mesh "
            f"{mesh.shape} (batch over '{data_axis}', sequence over "
            f"'{seq_axis}')")
    b_l, s_l = b // n_data, s // n_seq
    devices = seq_shard_devices(mesh)
    return [t[g * b_l:(g + 1) * b_l, j * s_l:(j + 1) * s_l]
            .contiguous().to(devices[g * n_seq + j])
            for g in range(n_data) for j in range(n_seq)]


def make_seq_parallel_lm_step(module, tx, mesh, remat: bool = False
                              ) -> Callable:
    """The seq-parallel LM train step over `mesh` (batch over 'data',
    sequence over 'seq'): `step(params, opt_state, tokens, targets, mask)
    -> (params, opt_state, loss)`, as the JAX step returns them; tokens,
    targets and mask are `shard_tokens` slabs.

    `module` is a `TransformerLM` with attn_impl ring | ring_flash |
    ulysses and `seq_axis="seq"`; `params` is `list(module.parameters())`
    (the replicated f32 masters, updated in place) and `tx` the port's
    `Optimizer` with `opt_state = tx.init(params)`.  Each shard runs the
    model on its slab (`TransformerLM.forward_seq_shards`) with its own
    parameter leaves; the loss is the masked sum of the per-token
    cross-entropy psum'd over both axes over the psum of the mask; the
    gradients are reduced to the masters (`reduce_to_home`), the
    optimizer runs once, and the new values reach every other distinct
    device.  `remat=True` recomputes each block in the backward (the
    reference's `module.clone(remat=True)`); `module` itself is left as
    it is."""
    # here, not at the top: the bridge's replicas import this module
    from mmlspark_tpu_torch.parallel.bridge import ShardReplicas
    replicas = ShardReplicas(module, seq_shard_devices(mesh))
    n_seq = mesh.shape[SEQ_AXIS]

    def step(params, opt_state, tokens, targets, mask):
        replicas.zero_grad()
        denom = torch.clamp(reduce_to_home([m.float().sum() for m in mask]),
                            min=1.0)
        logits = module.forward_seq_shards(replicas.shards, tokens, n_seq,
                                           remat=remat or module.remat)
        parts = []
        for lg, tg, mk in zip(logits, targets, mask):
            ll = F.cross_entropy(lg.float().reshape(-1, lg.shape[-1]),
                                 tg.reshape(-1).long(),
                                 reduction="none").reshape(tg.shape)
            parts.append((ll * mk.float()).sum())
        loss = reduce_to_home(parts) / denom
        loss.backward()
        tx.update(replicas.reduced_grads(), opt_state, params)
        replicas.broadcast()
        return params, opt_state, loss.detach()

    return step


# --------------------------------------------------------------------------
# data parallelism: one function per shard of the 'data' axis
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DataShard:
    """Shard `index` of `count` shards of a data-parallel step."""

    index: int
    count: int
    group: "ShardGroup"


_data_shard: contextvars.ContextVar = contextvars.ContextVar(
    "mmlspark_tpu_torch_data_shard", default=None)


def active_data_shard() -> Optional[DataShard]:
    """The data shard the calling code runs as, or None outside a
    data-parallel step."""
    return _data_shard.get()


@contextlib.contextmanager
def data_shard(shard: DataShard) -> Iterator:
    token = _data_shard.set(shard)
    try:
        yield shard
    finally:
        _data_shard.reset(token)


class ShardGroup:
    """Runs one function per shard of `count` shards of a data axis
    (`run`) and gives them `all_sum`, the psum of a data-parallel
    forward.

    Without a collective the shards run one after another on the calling
    thread.  With `lockstep=True` each shard runs on a thread of its own:
    `all_sum` waits until every shard has handed in its tensors, one of
    them takes the sums (`psum`: on the home device, in shard order, back
    to every shard's device), and each goes on with its own copy.  The
    sums are plain differentiable ops, so one backward over the shards'
    joint graph carries each shard's share of the cross-shard terms."""

    def __init__(self, count: int):
        self.count = count
        self._barrier = threading.Barrier(self.count)
        self._parts: list = [None] * self.count
        self._sums: list = []
        self._lockstep = False

    def run(self, fn: Callable[[int], object], lockstep: bool = False
            ) -> list:
        """[fn(i) for each shard i], each call inside `data_shard`."""
        if not lockstep or self.count == 1:
            out = []
            for i in range(self.count):
                with data_shard(DataShard(i, self.count, self)):
                    out.append(fn(i))
            return out
        results: list = [None] * self.count
        errors: list = [None] * self.count
        grad = torch.is_grad_enabled()

        def body(i):
            try:
                with torch.set_grad_enabled(grad), \
                        data_shard(DataShard(i, self.count, self)):
                    results[i] = fn(i)
            except BaseException as err:   # every shard's wait must end
                errors[i] = err
                self._barrier.abort()

        self._barrier.reset()
        self._lockstep = True
        threads = [threading.Thread(
            target=contextvars.copy_context().run, args=(body, i),
            name=f"data-shard-{i}", daemon=True) for i in range(self.count)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            self._lockstep = False
        raised = [e for e in errors if e is not None]
        if raised:
            # the failing shard's own error, not the broken waits it
            # caused in the others
            raise next((e for e in raised if not isinstance(
                e, threading.BrokenBarrierError)), raised[0])
        return results

    def all_sum(self, index: int, tensors: Sequence) -> list:
        """Each of `tensors` summed over the shards, on this shard's
        device (called by every shard of a lockstep `run`), then over
        the processes where there are several (`process_sum`, after the
        local shard sum: the order of the Trainer's gradient sum).  Under
        `torch.func.vmap` (a population's members) the sum runs through
        `_MemberAllSum`, whose rule hands it the members' plain stacked
        tensors: a functorch wrapper is bound to its own thread's
        transform and cannot meet the other shards' threads."""
        if any(_batched(t) for t in tensors):
            return list(_MemberAllSum.apply(self, index, *tensors))
        return self._all_sum(index, list(tensors))

    def _all_sum(self, index: int, tensors: list) -> list:
        if self.count == 1:
            return process_sum(tensors)
        if not self._lockstep:
            raise RuntimeError(
                "a cross-shard sum needs the shards in lockstep "
                "(ShardGroup.run(..., lockstep=True))")
        self._parts[index] = tensors
        if self._barrier.wait() == 0:
            # `psum`, with one collective over the processes on the
            # home's sums before they go back to every shard's device
            cols = list(zip(*self._parts))
            home = process_sum([reduce_to_home(list(c)) for c in cols])
            self._sums = [[t.to(p.device) for p in col]
                          for t, col in zip(home, cols)]
        self._barrier.wait()
        return [col[index] for col in self._sums]


def _batched(t) -> bool:
    """`t` is a tensor wrapped by `torch.func.vmap`."""
    return isinstance(t, torch.Tensor) and \
        torch._C._functorch.is_batchedtensor(t)


class _MemberAllSum(torch.autograd.Function):
    """`ShardGroup.all_sum` of vmapped tensors.  Its vmap rule moves each
    tensor's member axis first and sums the plain (N, ...) tensors across
    the shards' threads; those sums are plain differentiable ops, so the
    population's one backward over the shards' joint graph
    (`train/sweep.py`, lockstep) carries each shard's share.  There is
    nothing to run outside vmap, and no gradient transform of its own: a
    `torch.func.grad` inside the vmap would meet other threads'
    wrappers."""

    generate_vmap_rule = False

    @staticmethod
    def forward(group, index, *tensors):
        raise RuntimeError("_MemberAllSum runs under torch.func.vmap only")

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            "a population's cross-shard sum takes ordinary autograd over "
            "its vmapped forward, not torch.func.grad")

    @staticmethod
    def vmap(info, in_dims, group, index, *tensors):
        dims = in_dims[2:]
        plain = [t if d is None else t.movedim(d, 0)
                 for t, d in zip(tensors, dims)]
        out = group._all_sum(index, plain)
        return tuple(out), tuple(None if d is None else 0 for d in dims)


class _ProcessSum(torch.autograd.Function):
    """The differentiable all-reduce over the processes: forward each
    tensor summed over them (`parallel/distributed.py` `all_reduce_sum`),
    backward the same of the gradients, each inside `run_collective`'s
    bounded wait.  Every process calls it in the same order: BatchNorm
    layers in forward order, and the backward in the reverse."""

    @staticmethod
    def forward(ctx, *tensors):
        from mmlspark_tpu_torch.parallel.distributed import (
            all_reduce_sum, run_collective)
        out = [t.detach().clone() for t in tensors]
        run_collective("batch_stats.sum", lambda: all_reduce_sum(out))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        from mmlspark_tpu_torch.parallel.distributed import (
            all_reduce_sum, run_collective)
        out = [g.detach().clone() for g in grads]
        run_collective("batch_stats.grad", lambda: all_reduce_sum(out))
        return tuple(out)


def process_sum(tensors: Sequence) -> list:
    """Each tensor summed over the processes, differentiably
    (`_ProcessSum`); with one process the tensors themselves."""
    from mmlspark_tpu_torch.parallel.distributed import process_count
    if process_count() == 1:
        return list(tensors)
    return list(_ProcessSum.apply(*tensors))
