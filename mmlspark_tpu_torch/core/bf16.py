"""bfloat16 on the host.  numpy has no bfloat16, and the JAX package's
quantized bundles hold bfloat16 leaves (`ml_dtypes.bfloat16`, a JAX
dependency the port does not take): `BF16Array` carries their raw 16-bit
payload, so a bundle loaded and saved again keeps its bytes."""

from __future__ import annotations

import numpy as np
import torch


class BF16Array:
    """A host bfloat16 array: its raw 16-bit payload (`bits`, uint16, the
    bytes the JAX package writes for the same values).  `np.asarray`
    widens it exactly to f32; `from_f32` rounds to nearest even, as
    `ml_dtypes` and XLA do."""

    __slots__ = ("bits",)
    dtype_name = "bfloat16"

    def __init__(self, bits: np.ndarray):
        bits = np.asarray(bits)
        if bits.dtype != np.uint16:
            raise TypeError(f"bfloat16 payload must be uint16, got "
                            f"{bits.dtype}")
        self.bits = bits

    @staticmethod
    def from_f32(x) -> "BF16Array":
        t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        return BF16Array(t.to(torch.bfloat16).view(torch.int16).numpy()
                         .view(np.uint16))

    @property
    def shape(self) -> tuple:
        return self.bits.shape

    @property
    def ndim(self) -> int:
        return self.bits.ndim

    def __array__(self, dtype=None, copy=None):
        wide = (self.bits.astype(np.uint32) << 16).view(np.float32)
        return wide if dtype is None else wide.astype(dtype)

    def torch(self) -> torch.Tensor:
        """The values as a torch.bfloat16 tensor (a copy)."""
        return torch.from_numpy(self.bits.view(np.int16).copy()).view(
            torch.bfloat16)

    def __repr__(self) -> str:
        return f"BF16Array(shape={self.shape})"
