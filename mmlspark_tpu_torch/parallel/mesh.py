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
cards does not.  A multi-process mesh over `torch.distributed` (several
hosts) is later work.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from mmlspark_tpu_torch.core.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
AXES = (DATA_AXIS, MODEL_AXIS, SEQ_AXIS)


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
    type."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray):
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

    def seq_rings(self) -> list:
        """One list of devices per data group (model index 0): the group's
        seq shards in ring order, shard 0 first."""
        return [list(group[0]) for group in self.devices]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


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
