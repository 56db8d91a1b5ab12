"""KV-cache quantization (the port of `quantize_kv` in
`mmlspark_tpu/quant/quantize.py`).

Per-head symmetric int8 with one f32 scale per (row, slot, head): the
granularity the decode step writes (one new token's K/V per step) and the
cache read dequantizes at no extra bandwidth (the scale array is 1/D the
payload).  `torch.round` rounds half to even, as `jnp.round` does, so the
int8 bytes equal the JAX package's for the same input.
"""

from __future__ import annotations

import torch

INT8_MAX = 127.0


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., H, D) -> (int8 values (..., H, D), f32 scale (..., H)).

    All-zero vectors (never-written cache slots) get scale 0, so the
    dequant reproduces exact zeros."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    scale = amax / INT8_MAX
    nonzero = amax > 0
    inv = torch.where(nonzero, INT8_MAX / torch.where(nonzero, amax, 1.0),
                      0.0)
    q = torch.clamp(torch.round(x32 * inv[..., None]), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale
