"""Host table <-> device tensor bridge (the port of
`mmlspark_tpu/parallel/bridge.py`).

`pad_to_multiple` zero-pads a host batch to a fixed row count, so every
batch of a scoring pass has one shape.  `DeviceFeed` stages fixed-shape
batches onto one device and fetches results back:

  * **to the card**: the host rows are written (stacked and zero-padded)
    into a pinned host buffer, then copied with `non_blocking=True` on a
    side stream; an event marks the copy.  The consumer's stream waits on
    that event before it reads the batch (`ready`), and the batch tensor,
    allocated on the side stream, is `record_stream`-ed onto the consumer's
    stream, so the allocator does not hand its memory back to the side
    stream before the consumer has used it.
  * **back to the host**: `fetch` copies an output into a pinned buffer
    with `non_blocking=True` on the current stream and records an event;
    `take` waits for that event and copies the rows out.
  * **pinned buffers** come from a pool keyed by (shape, dtype).  A buffer
    goes back to the pool with the event of the copy that reads or writes
    it, and is reused only after that event has completed.

On a CPU device there are no streams or pinned buffers: batches are host
tensors and `take` reads the output directly.

`stack_trees` / `unstack_member` stack structurally identical trees on a
leading population axis and slice one member back out (train/sweep.py).

Over a `Mesh` (single controller, `parallel/mesh.py`) a batch sharded
along 'data' is a list of per-shard tensors: `shard_batch`,
`shard_table_columns` and `put_batch_parts` cut host rows into `data`
contiguous slabs (padded to a multiple by `pad_to_multiple`, as
`P("data")` cuts them), slab i on the mesh's data row i.
`gather_replicated` / `gather_to_host` join the slabs back in row order;
`put_tree` / `snapshot_tree` place or copy a tree of tensors, a list of
per-shard tensors keeping one entry per shard.  `replicate_module` gives
each shard a module whose parameters are leaves of their own, sharing
storage with one copy per distinct device (the weights replicated,
`P()`).  `replicate_tree` puts a tree on every distinct device of a mesh;
`put_tree_like` restores a full host tree onto a live tree's placements
(a checkpoint's gathered leaves back onto whatever mesh is live).

With a model axis, a batch is still cut along 'data' only: slab i lands
on data row i's home (model index 0) and is replicated over the row's
model shards by the layers that read it.  `ModelShardReplicas` holds the
parameters of a (data, model) mesh: per data row a home replica of the
module, with the replicated leaves, and one replica per model index with
that index's slices of the sharded leaves (`parallel/partition.py`
`port_splits`).
"""

from __future__ import annotations

import copy
import threading
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from mmlspark_tpu_torch.parallel.mesh import (AXES, DATA_AXIS, MODEL_AXIS,
                                              batch_devices, distinct_devices,
                                              model_group)


def pad_to_multiple(arr: np.ndarray, multiple: int,
                    axis: int = 0) -> tuple[np.ndarray, int]:
    """Zero-pad `arr` along `axis` to a multiple; returns (padded,
    valid_count)."""
    n = arr.shape[axis]
    rem = n % multiple
    if rem == 0:
        return arr, n
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, multiple - rem)
    return np.pad(arr, widths), n


def _slabs(arr: np.ndarray, devices: Sequence) -> list:
    """`arr` (rows a multiple of len(devices)) as contiguous row slabs,
    slab i a tensor on devices[i]."""
    n = len(devices)
    step = arr.shape[0] // n
    return [torch.as_tensor(np.ascontiguousarray(arr[i * step:(i + 1) * step]),
                            device=dev) for i, dev in enumerate(devices)]


def shard_batch(arr: np.ndarray, mesh, *, axis: str = DATA_AXIS) -> list:
    """A host batch on the mesh, cut along its leading dim over `axis`
    (zero-padded to a multiple): one slab per shard, in row order, slab j
    on the device at index j of `axis` (index 0 of the others: along
    'data', each row's home)."""
    padded, _ = pad_to_multiple(np.asarray(arr), mesh.shape[axis])
    if axis == DATA_AXIS:
        return _slabs(padded, batch_devices(mesh))
    at = AXES.index(axis)
    devices = [mesh.devices[tuple(j if a == at else 0 for a in range(3))]
               for j in range(mesh.shape[axis])]
    return _slabs(padded, devices)


def shard_table_columns(table, columns: Sequence[str], mesh, *,
                        axis: str = DATA_AXIS, dtype=None) -> tuple:
    """Table columns as sharded device slabs: ({column: [slab, ...]},
    valid row count); rows past the count are padding."""
    out: dict = {}
    valid = table.num_rows
    for c in columns:
        col = table[c]
        if col.dtype == object:
            raise TypeError(
                f"column '{c}' is an object column; tensorize it first")
        arr = col.astype(dtype) if dtype is not None else col
        out[c] = shard_batch(arr, mesh, axis=axis)
    return out, valid


def put_batch_parts(mesh, *arrays: np.ndarray,
                    axis: str = DATA_AXIS) -> tuple:
    """Several row-aligned host arrays cut over `axis`, one list of slabs
    each.  Leading dims must already divide (the caller pads with its own
    pad values)."""
    for a in arrays:
        if a.shape[0] % mesh.shape[axis]:
            raise ValueError(
                f"leading dim {a.shape[0]} not divisible by the mesh "
                f"'{axis}' axis ({mesh.shape[axis]}); pad rows first "
                f"(pad_to_multiple)")
    return tuple(shard_batch(a, mesh, axis=axis) for a in arrays)


def put_sharded(local: np.ndarray, mesh) -> list:
    """This process's rows on its own block of the mesh: `local` (rows a
    multiple of the block's data rows) cut into contiguous slabs, slab i
    on the block's data row i.  Under several processes each process puts
    only its own rows (`bs / process_count` of a global batch) and no
    process holds the global batch, as the JAX `put_sharded` assembles a
    global array from each process's local data; with one process it is
    `shard_batch` without padding."""
    local = np.asarray(local)
    devices = batch_devices(mesh)
    if local.shape[0] % len(devices):
        raise ValueError(
            f"local rows {local.shape[0]} not divisible by this process's "
            f"{len(devices)} data rows of the mesh")
    return _slabs(local, devices)


def gather_replicated(tree: Any, mesh) -> Any:
    """Every sharded leaf (a list of slabs) joined in row order on the
    mesh's first device; a tensor leaf moved there.

    Under several processes the JAX function is a collective that
    all-gathers the leaves other processes hold.  The port needs none:
    the Trainer all-reduces the gradients over the processes and runs one
    identical update in each (`train/trainer.py`), so after every step
    each process holds the whole masters and nothing has to cross.  The
    Trainer still enters its checkpoint gather under a named, spanned
    collective (`checkpoint.gather`) where the JAX Trainer does."""
    home = mesh.devices.flat[0]
    if isinstance(tree, dict):
        return {k: gather_replicated(v, mesh) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(gather_replicated(v, mesh) for v in tree)
    if isinstance(tree, list):
        return torch.cat([t.to(home) for t in tree])
    if isinstance(tree, torch.Tensor):
        return tree.to(home)
    return tree


def gather_to_host(tree: Any, mesh) -> Any:
    """`gather_replicated` on the host: numpy arrays (every process holds
    the whole tree: see `gather_replicated`)."""
    def host(leaf):
        if isinstance(leaf, torch.Tensor):
            return leaf.detach().cpu().numpy()
        return leaf
    gathered = gather_replicated(tree, mesh)
    return _map(host, gathered)


def _map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def put_tree(tree: Any, devices: Any) -> Any:
    """Every leaf of `tree` on its device: `devices` is one device for the
    whole tree, or a tree of the same structure (a list of per-shard
    tensors takes a list of devices)."""
    if not isinstance(devices, (dict, list, tuple)):
        return _map(lambda t: torch.as_tensor(t, device=devices), tree)
    if isinstance(tree, dict):
        return {k: put_tree(v, devices[k]) for k, v in tree.items()}
    return type(tree)(put_tree(v, d) for v, d in zip(tree, devices))


def replicate_tree(tree: Any, mesh) -> Any:
    """Every tensor (or numpy) leaf of `tree` on every device of the mesh,
    in the mesh's flat order: a list a leaf, one tensor object per
    distinct device (the weights replicated, `P()`)."""
    devices = list(mesh.devices.flat)

    def rep(leaf):
        t = torch.as_tensor(leaf)
        copies = {d: t.to(d) for d in distinct_devices(devices)}
        return [copies[d] for d in devices]
    return _map(rep, tree) if not isinstance(tree, list) else \
        [rep(leaf) for leaf in tree]


def put_tree_like(new_tree: Any, like_tree: Any, mesh=None) -> Any:
    """Reshard-on-restore: a host tree of full leaves placed as the live
    tree `like_tree` is (a checkpoint's gathered leaves onto the current
    mesh): a `ModelShards` leaf takes its slices over its own devices, a
    list of per-device tensors a copy on each, a tensor its device and
    dtype.  `mesh` replicates a single-device leaf over the mesh."""
    from mmlspark_tpu_torch.parallel.partition import ModelShards, place
    if isinstance(like_tree, dict):
        return {k: put_tree_like(new_tree[k], v, mesh)
                for k, v in like_tree.items()}
    new = torch.as_tensor(np.asarray(new_tree))
    if isinstance(like_tree, ModelShards):
        return place(new.to(like_tree.dtype),
                     [t.device for t in like_tree], like_tree.dim,
                     like_tree.groups)
    if isinstance(like_tree, (list, tuple)):
        copies = {t.device: new.to(t.device, t.dtype) for t in like_tree}
        return [copies[t.device] for t in like_tree]
    if mesh is not None:
        return replicate_tree(new.to(like_tree.dtype), mesh)
    return new.to(like_tree.device, like_tree.dtype)


def snapshot_tree(tree: Any) -> Any:
    """A copy of every tensor leaf on its own device (the asynchronous
    checkpoint's snapshot: later in-place updates do not reach it)."""
    return _map(lambda t: t.detach().clone()
                if isinstance(t, torch.Tensor) else t, tree)


def replicate_module(module: nn.Module, device: torch.device,
                     leaf_of: Callable,
                     buffer_of: Optional[Callable] = None) -> nn.Module:
    """A replica of `module` for one shard on `device`: the module tree
    copied shallowly (configuration, hooks and code shared), each
    parameter replaced by `leaf_of(name, parameter)` (a leaf of the
    shard's own), each buffer by `buffer_of(name, buffer)`, by default
    the module's own where it lives on `device`, else a copy there."""
    if buffer_of is None:
        def buffer_of(_name, b):
            return b if b.device == device else b.to(device)

    def walk(mod: nn.Module, prefix: str) -> nn.Module:
        rep = copy.copy(mod)
        rep._parameters = {
            n: None if p is None else leaf_of(prefix + n, p)
            for n, p in mod._parameters.items()}
        rep._buffers = {
            n: None if b is None else buffer_of(prefix + n, b)
            for n, b in mod._buffers.items()}
        rep._modules = {n: None if m is None else walk(m, f"{prefix}{n}.")
                        for n, m in mod._modules.items()}
        return rep
    return walk(module, "")


class ShardReplicas:
    """One replica of a module per shard (`devices[i]` holds shard i):
    the module's own parameters are the f32 masters on the home device
    (`devices[0]`); each other distinct device keeps one copy of them.
    Every shard's replica has parameter leaves of its own (so each
    shard's gradients stay apart until `reduced_grads`) sharing storage
    with its device's copy: where shards share a device, no copy is
    made."""

    def __init__(self, module: nn.Module, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        self.home = self.devices[0]
        masters = dict(module.named_parameters())
        self.names = list(masters)
        self.copies = {self.home: masters}
        for dev in distinct_devices(self.devices)[1:]:
            self.copies[dev] = {n: p.detach().to(dev)
                                for n, p in masters.items()}
        self.leaves: list = []
        self.shards: list = []
        for dev in self.devices:
            own: dict = {}

            def leaf_of(name, _p, dev=dev, own=own):
                own[name] = nn.Parameter(self.copies[dev][name].detach())
                return own[name]
            self.shards.append(replicate_module(module, dev, leaf_of))
            self.leaves.append([own[n] for n in self.names])

    def zero_grad(self) -> None:
        for leaves in self.leaves:
            for p in leaves:
                p.grad = None

    def reduced_grads(self) -> list:
        """Each parameter's gradient summed over the shards on the home
        device, in shard order (`parallel/ring.py` `reduce_to_home`); a
        shard the loss did not reach adds zeros."""
        from mmlspark_tpu_torch.parallel.ring import reduce_to_home
        return [reduce_to_home([
            leaves[j].grad if leaves[j].grad is not None
            else torch.zeros_like(leaves[j]) for leaves in self.leaves])
            for j in range(len(self.names))]

    @torch.no_grad()
    def broadcast(self) -> None:
        """The masters' values to every other distinct device's copy (after
        an update or a restore)."""
        masters = self.copies[self.home]
        for dev, copies in self.copies.items():
            if dev != self.home:
                for n, t in copies.items():
                    t.copy_(masters[n])


def column_biases(module: nn.Module, splits: dict) -> dict:
    """{bias name: (0, groups)} of every layer whose weight `splits` cuts
    on its output axis (port dim 0): the bias is replicated (rank 1, as
    JAX places it), and each model shard computes with its slice of it."""
    params = dict(module.named_parameters())
    params.update(module.named_buffers())
    out = {}
    for name, (dim, groups) in splits.items():
        prefix, _, leaf = name.rpartition(".")
        bias = f"{prefix}.bias" if prefix else "bias"
        if (leaf == "weight" and dim == 0 and bias not in splits
                and params.get(bias) is not None):
            out[bias] = (0, groups)
    return out


class ModelShardReplicas:
    """A module's parameters over a (data, model) mesh (single controller,
    `parallel/mesh.py`).  Per data row i (`rows[i]`, a (home, shards)
    pair):

      * `home`, a replica on the row's home (model index 0's device) that
        holds every replicated leaf once (a leaf of its own, sharing
        storage with its device's copy of the masters, as `ShardReplicas`
        does), and each sharded leaf as the `ModelShards` list of its
        slices;
      * `shards[m]`, a replica on model index m's device whose sharded
        leaves are m's slices (`parallel/partition.py` `take_slice`, the
        layout `splits` names: {name: (port dim, groups)}), leaves of its
        own; a column-parallel layer's replicated bias is sliced with its
        weight (`column_biases`); every other leaf is the home's.

    Every submodule of a home replica gets `model_peers`, the same
    submodule of each model index's replica, and `model_split`, the split
    leaves it owns: the layers of `models/definitions.py` run over the
    group through them.  The masters are the module's own parameters
    (on the mesh's first device); `reduced_grads` joins each leaf's
    gradient there, `broadcast` hands the masters back out.  With
    `trainable=False` (scoring, decoding) the replicas hold plain
    tensors, parameters and buffers placed alike."""

    def __init__(self, module: nn.Module, mesh, splits: dict,
                 trainable: bool = True):
        from mmlspark_tpu_torch.parallel.partition import (ModelShards,
                                                           take_slice)
        self.mesh = mesh
        self.mp = mesh.shape[MODEL_AXIS]
        self.splits = dict(splits)
        self.splits.update(column_biases(module, self.splits))
        masters = dict(module.named_parameters())
        self.names = list(masters)
        self.home = mesh.devices.flat[0]
        self.trainable = trainable
        n_data = mesh.shape[DATA_AXIS]
        groups = [model_group(mesh, i) for i in range(n_data)]
        # one copy of the replicated masters per distinct row home
        self.copies = {self.home: masters}
        for dev in distinct_devices([g[0] for g in groups])[1:]:
            self.copies[dev] = {n: p.detach().to(dev)
                                for n, p in masters.items()
                                if n not in self.splits}
        self.rows: list = []
        # (leaf, name, model index) of every sliced leaf: `broadcast`
        self._sliced: list = []
        # per row, {name: [leaf per model index]} / {name: home leaf}
        self._shard_leaves: list = []
        self._home_leaves: list = []

        def wrap(t):
            return nn.Parameter(t) if trainable else t

        for row, devices in enumerate(groups):
            home_dev = devices[0]
            own: dict = {}
            sliced: dict = {}

            def sliced_of(name, t, m, dev):
                dim, grp = self.splits[name]
                part = wrap(take_slice(t.detach(), dim, m, self.mp, grp)
                            .to(dev).contiguous().clone())
                sliced.setdefault(name, [None] * self.mp)[m] = part
                if trainable:
                    self._sliced.append((part, name, m))
                return part

            shards = []
            for m, dev in enumerate(devices):
                def leaf_of(name, p, m=m, dev=dev):
                    if name in self.splits:
                        return sliced_of(name, p, m, dev)
                    if name not in own:
                        base = self.copies[home_dev][name] if trainable \
                            else p.detach().to(home_dev)
                        own[name] = wrap(base.detach())
                    return own[name]

                def buffer_of(name, b, m=m, dev=dev):
                    if name in self.splits:
                        dim, grp = self.splits[name]
                        return take_slice(b, dim, m, self.mp, grp).to(
                            dev).contiguous()
                    return b if b.device == home_dev else b.to(home_dev)
                shards.append(replicate_module(module, dev, leaf_of,
                                               buffer_of))

            def home_leaf(name, p):
                if name in self.splits and name in sliced:
                    dim, grp = self.splits[name]
                    return ModelShards(sliced[name], dim, grp,
                                       tuple(p.shape))
                return own[name] if name in own else leaf_of(name, p, 0,
                                                             home_dev)

            def home_buffer(name, b):
                if name in self.splits:
                    dim, grp = self.splits[name]
                    return ModelShards([s.get_buffer(name) for s in shards],
                                       dim, grp, tuple(b.shape))
                return b if b.device == home_dev else b.to(home_dev)
            home = replicate_module(module, home_dev, home_leaf, home_buffer)
            for path, sub in home.named_modules():
                peers = [s.get_submodule(path) for s in shards]
                split = {leaf: self.splits[f"{path}.{leaf}" if path
                                           else leaf]
                         for leaf in list(sub._parameters)
                         + list(sub._buffers)
                         if (f"{path}.{leaf}" if path else leaf)
                         in self.splits}
                object.__setattr__(sub, "model_peers", peers)
                object.__setattr__(sub, "model_split", split)
            self.rows.append((home, shards))
            self._shard_leaves.append(sliced)
            self._home_leaves.append(own)

    @property
    def shards(self) -> list:
        """Each data row's home replica, in row order: the module a data
        shard's forward calls (`ShardReplicas.shards`'s counterpart)."""
        return [home for home, _ in self.rows]

    def zero_grad(self) -> None:
        for own, sliced in zip(self._home_leaves, self._shard_leaves):
            for p in list(own.values()) + [t for parts in sliced.values()
                                           for t in parts]:
                p.grad = None

    def reduced_grads(self) -> list:
        """Each parameter's full gradient on the masters' device: a
        replicated leaf's summed over the data rows in row order
        (`reduce_to_home`), a sharded leaf's slices each summed over the
        rows in row order, then joined in model order (`join_slices`).
        A leaf the loss did not reach adds zeros."""
        from mmlspark_tpu_torch.parallel.partition import join_slices
        from mmlspark_tpu_torch.parallel.ring import reduce_to_home

        def grad(p):
            return p.grad if p.grad is not None else torch.zeros_like(p)
        out = []
        for name in self.names:
            if name in self.splits:
                dim, grp = self.splits[name]
                parts = [reduce_to_home([grad(s[name][m])
                                         for s in self._shard_leaves])
                         .to(self.home) for m in range(self.mp)]
                out.append(join_slices(parts, dim, grp))
            else:
                out.append(reduce_to_home(
                    [grad(own[name]) for own in self._home_leaves]))
        return out

    @torch.no_grad()
    def broadcast(self) -> None:
        """The masters' values to every other row home's copy and into
        every model index's slices (after an update or a restore)."""
        from mmlspark_tpu_torch.parallel.partition import take_slice
        masters = self.copies[self.home]
        for dev, copies in self.copies.items():
            if dev != self.home:
                for n, t in copies.items():
                    t.copy_(masters[n])
        for leaf, name, m in self._sliced:
            dim, grp = self.splits[name]
            leaf.copy_(take_slice(masters[name], dim, m, self.mp, grp))


def stack_trees(trees: Sequence[Any]) -> Any:
    """Stack N structurally identical trees (dicts, lists, tuples) on a new
    leading population axis: numpy leaves with `np.stack`, tensor leaves
    with `torch.stack` (train/sweep.py: member trees become one tree
    whose leaves carry shape (N, ...))."""
    if not trees:
        raise ValueError("stack_trees needs at least one tree")
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_trees([t[i] for t in trees])
                           for i in range(len(first)))
    if isinstance(first, torch.Tensor):
        return torch.stack(list(trees))
    return np.stack([np.asarray(leaf) for leaf in trees])


def unstack_member(tree: Any, k: int) -> Any:
    """Member `k` of a population-stacked tree as host numpy arrays of the
    member's own shapes (the sweep winner's tree, ready for a
    ModelBundle)."""
    if isinstance(tree, dict):
        return {key: unstack_member(v, k) for key, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(unstack_member(v, k) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree[k].detach().cpu().numpy().copy()
    return np.asarray(tree)[k]


class DeviceFeed:
    """Pinned, stream-ordered staging of fixed-shape batches onto one
    device (module docstring).  `stage` and `put` may run on any thread;
    `ready`, `fetch` and `take` run on the consumer's thread."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.copy_stream = (torch.cuda.Stream(device) if self.cuda
                            else None)
        self._free: dict[tuple, list] = {}
        self._lock = threading.Lock()
        # bytes `put` has sent to the device (copied on a card)
        self.put_bytes = 0

    # -- the pinned pool -------------------------------------------------
    def _acquire(self, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        with self._lock:
            free = self._free.get((shape, dtype))
            buf, event = free.pop() if free else (None, None)
        if buf is None:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        if event is not None:
            event.synchronize()  # its last copy has finished with it
        return buf

    def _release(self, buf: torch.Tensor,
                 event: Optional[torch.cuda.Event]) -> None:
        with self._lock:
            self._free.setdefault((tuple(buf.shape), buf.dtype),
                                  []).append((buf, event))

    # -- host -> device --------------------------------------------------
    def stage(self, rows: np.ndarray, batch: int) -> torch.Tensor:
        """`rows` zero-padded to `batch` rows in a host buffer (pinned,
        from the pool, on a card)."""
        rows = np.ascontiguousarray(rows)
        shape = (batch,) + rows.shape[1:]
        dtype = torch.from_numpy(rows[:0]).dtype
        host = (self._acquire(shape, dtype) if self.cuda
                else torch.empty(shape, dtype=dtype))
        view = host.numpy()
        view[:len(rows)] = rows
        view[len(rows):] = 0
        return host

    def put(self, host: torch.Tensor) -> tuple:
        """A staged host buffer on the device: returns (tensor, event),
        the event None on the CPU.  The buffer goes back to the pool with
        the copy's event."""
        with self._lock:
            self.put_bytes += host.numel() * host.element_size()
        if not self.cuda:
            return host, None
        with torch.cuda.stream(self.copy_stream):
            dev = torch.empty(host.shape, dtype=host.dtype,
                              device=self.device)
            dev.copy_(host, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.copy_stream)
        self._release(host, event)
        return dev, event

    def ready(self, dev: torch.Tensor,
              event: Optional[torch.cuda.Event]) -> torch.Tensor:
        """Order the current stream after `dev`'s copy and keep its memory
        from the side stream's reuse until the current stream is done."""
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            dev.record_stream(stream)
        return dev

    # -- device -> host --------------------------------------------------
    def fetch(self, out: torch.Tensor) -> tuple:
        """Start the copy of `out` to the host: returns a handle for
        `take`."""
        if not self.cuda:
            return out, None
        host = self._acquire(tuple(out.shape), out.dtype)
        host.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return host, event

    def take(self, handle: tuple, valid: int) -> np.ndarray:
        """The first `valid` rows of a fetched output, as a numpy array
        of its own."""
        host, event = handle
        if event is None:
            return host[:valid].numpy().copy()
        event.synchronize()
        rows = host[:valid].numpy().copy()
        self._release(host, None)
        return rows
