"""Lower precision for the controls of `correct` (plain PyTorch).

A configuration computed in bfloat16 has fp8 as the next precision below
it: `fp8` rounds a tensor to float8 e4m3 with one scale for the tensor
(its largest magnitude mapped to 448, e4m3's largest finite value) and
back, as an fp8 GEMM reads its operands.  The rounding is straight-through:
the backward sees the identity, so gradients flow as an fp8 forward's
would.  `operand(t, quant)` applies it where `quant` asks for it.
"""

from __future__ import annotations

from typing import Optional

import torch

E4M3_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8 e4m3 under one per-tensor scale, in t's dtype."""
    x = t.detach()
    scale = E4M3_MAX / x.abs().amax().clamp(min=1e-30)
    q = (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return t + (q - x)


def operand(t: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """A GEMM or convolution operand as the precision `quant` reads it
    (None: as it is)."""
    if quant is None:
        return t
    if quant == "fp8":
        return fp8(t)
    raise ValueError(f"unknown precision {quant!r}")
