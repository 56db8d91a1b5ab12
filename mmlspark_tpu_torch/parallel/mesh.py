"""The mesh declaration of `mmlspark_tpu/parallel/mesh.py` (`MeshSpec`,
:56-78), against one card.

The port runs on a single GPU so far: a spec resolves to size 1 on every
axis (-1 means "all remaining devices", here the one card), and one that
wants more than one device raises `NotImplementedError`.  Sharding over
several cards with `torch.distributed` is later work.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape; -1 means "all remaining devices"."""

    data: int = -1
    model: int = 1
    seq: int = 1

    def resolve(self, n_devices: Optional[int] = None) -> dict:
        """{axis: size} over `n_devices` (default: the one card)."""
        n = 1 if n_devices is None else n_devices
        sizes = {"data": self.data, "model": self.model, "seq": self.seq}
        if n > 1 or any(s > 1 for s in sizes.values()):
            raise NotImplementedError(
                f"mesh {sizes} over {n} device(s): multi-device meshes are "
                "not ported (one card)")
        free = [k for k, s in sizes.items() if s <= 0]
        if len(free) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {free}")
        return {axis: 1 for axis in sizes}
