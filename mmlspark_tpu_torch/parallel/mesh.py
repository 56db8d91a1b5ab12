"""Device meshes: the port of `mmlspark_tpu/parallel/mesh.py` (`MeshSpec`
:56-78, `make_mesh` :81-93) for a single controller.

The JAX package's API is single-controller: one `generate` call runs over
a `jax.sharding.Mesh` of devices, and `shard_map` places the collectives.
The port keeps that API.  A `Mesh` here is a numpy object array of
`torch.device`s shaped (data, model, seq); the code that runs over it
moves tensors between those devices explicitly (`parallel/ring.py`).

A device may repeat: its shards then share one card (or the host), the
way the JAX tests put 8 virtual devices on one CPU.  Every layout, slot
ownership and cross-shard merge still runs; only the traffic between
cards does not.

Several processes (`parallel/distributed.py`): `make_process_mesh` builds
a mesh whose data axis counts every process's devices, in contiguous
blocks in rank order, as the JAX `make_mesh` over `jax.devices()` spans
every process.  Each process holds only its own block: `devices` and
`shape` are this process's, `process_count` says how many processes the
mesh spans (the port's `{d.process_index for d in mesh.devices.flat}`)
and `global_shape` is the JAX mesh's shape.  The model and seq axes stay
inside one process.  `best_mesh` and `default_mesh` stay local, as the
JAX ones take `jax.local_devices()` under several processes.

The default meshes (`mesh_spec_from_config`, `default_mesh`, `best_mesh`,
:31-52 and :96-140) read the JAX package's knobs MMLSPARK_TPU_MESH_DATA,
_MODEL and _SEQ from the port's registry.  They span the visible cards,
or `[torch.device("cpu")] * n` when asked for the host.  The placements
are plain functions: `batch_devices` names the device of each slab of a
batch cut along 'data' (`P("data")`: contiguous row slabs, slab i on the
mesh's i-th data row), `distinct_devices` the devices a replicated weight
lives on once each (`P()`).

The model axis: `model_group(mesh, i)` is data row i's model group, the
devices `mesh.devices[i, :, 0]` in model order, its first (model index 0)
the row's home, where the row's batch slab, its replicated weights and
the activations between its model-parallel layers live
(`models/definitions.py`).  `model_sharding(mesh, spec)` names a weight
layout over that axis (the JAX function of the same name);
`parallel/partition.py` places leaves by it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from mmlspark_tpu_torch import config
from mmlspark_tpu_torch.core.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
AXES = (DATA_AXIS, MODEL_AXIS, SEQ_AXIS)

MESH_DATA = config.register(
    "MMLSPARK_TPU_MESH_DATA", default=-1, ptype=int,
    doc="Data-parallel mesh width for the default dp x mp mesh "
        "(mesh_spec_from_config); -1 = all devices left over after the "
        "model axis.")

MESH_MODEL = config.register(
    "MMLSPARK_TPU_MESH_MODEL", default=1, ptype=int,
    doc="Tensor/model-parallel mesh width for the default dp x mp mesh: "
        "weights matched by the partition rules (parallel/partition.py) "
        "shard over this many chips. 1 (default) keeps every path "
        "data-parallel-only.")

MESH_SEQ = config.register(
    "MMLSPARK_TPU_MESH_SEQ", default=1, ptype=int,
    doc="Sequence-parallel mesh width for the default mesh: long-context "
        "decode shards the KV-cache window over this many chips "
        "(blockwise ring prefill + cross-chip softmax-stats merge, "
        "models/generate.py). Composes with MESH_DATA; mutually "
        "exclusive with MESH_MODEL>1 on the decode path. 1 (default) "
        "keeps the single-chip window.")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape; -1 means "all remaining devices"."""

    data: int = -1
    model: int = 1
    seq: int = 1

    def resolve(self, n_devices: Optional[int] = None) -> dict:
        """{axis: size} over `n_devices` (default 1: one card)."""
        n = 1 if n_devices is None else n_devices
        sizes = {DATA_AXIS: self.data, MODEL_AXIS: self.model,
                 SEQ_AXIS: self.seq}
        fixed = int(np.prod([s for s in sizes.values() if s > 0]))
        free = [k for k, s in sizes.items() if s <= 0]
        if len(free) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {free}")
        if free:
            if n % fixed:
                raise ValueError(
                    f"{n} devices not divisible by fixed axes product {fixed}")
            sizes[free[0]] = n // fixed
        total = int(np.prod(list(sizes.values())))
        if total != n:
            raise ValueError(f"mesh {sizes} wants {total} devices, have {n}")
        return sizes


class Mesh:
    """`torch.device`s laid out over the (data, model, seq) axes.

    `devices` is the numpy object array of shape (data, model, seq) and
    `shape` maps each axis name to its size, as `jax.sharding.Mesh` does.
    Devices may repeat (shards sharing one card); they must all be of one
    type.  A mesh over several processes (`make_process_mesh`) holds
    this process's block of data rows (module docstring)."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray, process_count: int = 1):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(AXES):
            raise ValueError(f"a mesh's device array is (data, model, seq), "
                             f"got shape {devices.shape}")
        flat = [torch.device(d) for d in devices.flat]
        if not flat:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in flat}
        if len(kinds) > 1:
            raise ValueError(f"a mesh's devices are of one type, got "
                             f"{sorted(kinds)}")
        self.devices = np.empty(devices.shape, dtype=object)
        for i, d in enumerate(flat):
            self.devices.flat[i] = d
        self.shape = dict(zip(AXES, devices.shape))
        self.process_count = int(process_count)

    @property
    def global_shape(self) -> dict:
        """{axis: size} over every process the mesh spans: the data axis
        counts each process's rows."""
        return {**self.shape,
                DATA_AXIS: self.shape[DATA_AXIS] * self.process_count}

    def seq_rings(self) -> list:
        """One list of devices per data group (model index 0): the group's
        seq shards in ring order, shard 0 first."""
        return [list(group[0]) for group in self.devices]

    def __repr__(self) -> str:
        procs = (f", over {self.process_count} processes"
                 if self.process_count > 1 else "")
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]}{procs})")


def make_mesh(spec: Optional[MeshSpec] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A Mesh over `devices` (default: every visible card; raises without
    one).  Pass `[torch.device("cpu")] * n` for a host mesh of n shards, or
    repeat a card to put several shards on it."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    sizes = (spec or MeshSpec()).resolve(len(devices))
    array = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        array[i] = d
    return Mesh(array.reshape(tuple(sizes[a] for a in AXES)))


def make_process_mesh(spec: Optional[MeshSpec] = None,
                      devices: Optional[Sequence] = None) -> Mesh:
    """A mesh whose data axis spans every process of the process group
    (module docstring): `devices` are this process's own (default every
    visible card), every process passing as many; `spec` is resolved over
    all of them.  Process p holds data rows [p * d, (p + 1) * d) of the
    global axis, d = data / process count.  With one process this is
    `make_mesh`."""
    from mmlspark_tpu_torch.parallel.distributed import process_count
    nproc = process_count()
    if devices is None:
        devices = _visible("cuda")
    devices = [torch.device(d) for d in devices]
    if nproc == 1:
        return make_mesh(spec, devices)
    sizes = (spec or MeshSpec()).resolve(len(devices) * nproc)
    if sizes[DATA_AXIS] % nproc:
        raise ValueError(
            f"multi-host training needs the data axis ({sizes[DATA_AXIS]}) "
            f"to be a multiple of the process count ({nproc}); keep "
            "tensor/sequence parallelism within a host (over ICI) and "
            "scale data parallelism across hosts (over DCN)")
    local = (sizes[DATA_AXIS] // nproc, sizes[MODEL_AXIS], sizes[SEQ_AXIS])
    array = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        array[i] = d
    return Mesh(array.reshape(local), process_count=nproc)


def _visible(device_type: str) -> list:
    """The devices a default mesh spans: every visible card (raises
    without one), or the host once."""
    if device_type == "cpu":
        return [torch.device("cpu")]
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def mesh_spec_from_config() -> MeshSpec:
    """The MeshSpec the MMLSPARK_TPU_MESH_* knobs declare (dp x mp)."""
    return MeshSpec(data=int(MESH_DATA.current()),
                    model=int(MESH_MODEL.current()),
                    seq=int(MESH_SEQ.current()))


def best_mesh(n_data: Optional[int] = None, device="cuda") -> Mesh:
    """The default 1-D data-parallel mesh (the CNTKModel scoring
    topology): every visible card of `device`'s type, or the first
    `n_data` of them.  On the host there is one device, repeated
    `n_data` times when asked."""
    kind = torch.device(device).type
    local = _visible(kind)
    if n_data is None:
        return make_mesh(MeshSpec(), local)
    if kind == "cpu":
        local = local * n_data
    return make_mesh(MeshSpec(data=n_data), local[:n_data])


def default_mesh(device="cuda") -> Mesh:
    """The mesh scoring and training paths get when none is passed: with
    the MESH knobs at their defaults `best_mesh()`, else the dp x mp x
    seq mesh they declare over the visible cards of `device`'s type (on
    the host, `[cpu] * n`)."""
    spec = mesh_spec_from_config()
    kind = torch.device(device).type
    if spec.model <= 1 and spec.seq <= 1 and spec.data <= 0:
        return best_mesh(device=kind)
    local = _visible(kind)
    if spec.data <= 0:
        sizes = spec.resolve(len(local))
    else:
        sizes = {DATA_AXIS: spec.data, MODEL_AXIS: max(spec.model, 1),
                 SEQ_AXIS: max(spec.seq, 1)}
    n = sizes[DATA_AXIS] * sizes[MODEL_AXIS] * sizes[SEQ_AXIS]
    if kind == "cpu":
        local = local * n
    if n > len(local):
        raise ValueError(
            f"MMLSPARK_TPU_MESH_DATA x MODEL x SEQ wants {n} devices, "
            f"have {len(local)}")
    return make_mesh(MeshSpec(**sizes), local[:n])


def mesh_for_spec(spec: MeshSpec, device="cuda") -> Optional[Mesh]:
    """The mesh a config's MeshSpec asks for on `device`'s type, or None
    where it asks for one device (data -1 or 1, model and seq 1): the
    caller then runs on `device` itself.  Under several processes the
    mesh spans them all (`make_process_mesh`): each process contributes
    its visible cards, or on the host its share of the data axis (one
    shard at data -1)."""
    from mmlspark_tpu_torch.parallel.distributed import process_count
    spec.resolve(max(1, spec.data) * spec.model * spec.seq)  # malformed
    kind = torch.device(device).type
    nproc = process_count()
    if nproc > 1:
        if kind == "cuda":
            return make_process_mesh(spec, _visible(kind))
        per_process = spec.model * spec.seq
        if spec.data > 0:
            per_process = max(1, spec.data // nproc) * per_process
        return make_process_mesh(spec, [torch.device("cpu")] * per_process)
    if spec.data in (-1, 1) and spec.model == 1 and spec.seq == 1:
        return None
    n = max(1, spec.data) * spec.model * spec.seq
    local = _visible(kind) * (n if kind == "cpu" else 1)
    return make_mesh(spec, local[:n] if kind == "cpu" else local)


def batch_devices(mesh: Mesh) -> list:
    """The device of each slab of a batch cut along 'data' (slab i on the
    mesh's data row i; model and seq index 0)."""
    return [mesh.devices[i, 0, 0] for i in range(mesh.shape[DATA_AXIS])]


def model_group(mesh: Mesh, row: int = 0) -> list:
    """Data row `row`'s model group: its devices in model order (seq index
    0), model index 0 the row's home."""
    return list(mesh.devices[row, :, 0])


@dataclasses.dataclass(frozen=True)
class ModelSharding:
    """A weight layout over a mesh (the JAX `NamedSharding` a
    `model_sharding` call returns): `spec` names the axis of each dim."""

    mesh: Mesh
    spec: tuple

    def place(self, x, row: int = 0):
        """`x` over data row `row`'s model group under this spec
        (`parallel/partition.py` `place`, after `compatible_spec`)."""
        from mmlspark_tpu_torch.parallel.partition import (compatible_spec,
                                                           model_dim, place)
        spec = compatible_spec(self.spec, tuple(x.shape), self.mesh)
        return place(x, model_group(self.mesh, row), model_dim(spec))


def model_sharding(mesh: Mesh, spec) -> ModelSharding:
    """A tensor-parallel weight layout (the JAX `model_sharding`)."""
    return ModelSharding(mesh, tuple(spec))


def distinct_devices(devices) -> list:
    """`devices` once each, in first-seen order (shard 0's first): where a
    replicated weight lives."""
    out: list = []
    for d in devices:
        if d not in out:
            out.append(d)
    return out
