"""Int8-weight forwards of Dense and Conv layers (the port of
`mmlspark_tpu/quant/modules.py`'s `quant_dense_apply` and
`quant_conv_apply`).

The weights stay int8 on the device and are cast to the compute dtype
inside the call (int8 -> bfloat16 is exact: |q| <= 127 fits bf16's
mantissa); the per-output-channel scale is applied after the product,
which is linear per output channel, then the bias, both in f32, then the
cast back to the compute dtype.  `models/definitions.py` `Int8Dense` and
`Int8Conv` hold such layers; `ModelBundle.module` builds them for the int8
nodes of a `quantize_bundle(..., "int8")` tree.

One rounding differs from the JAX package: torch returns a bf16 product
of bf16 operands (accumulated in f32 by cuBLAS / cuDNN and the CPU
kernels, then rounded once to bf16), where XLA keeps the f32 accumulator
(`preferred_element_type`) for the scale.  The difference is at most one
bf16 rounding of the pre-scale product; `tests/test_torch_vision_models.py`
pins it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _epilogue(y: torch.Tensor, scale: torch.Tensor,
              bias: Optional[torch.Tensor], dtype: torch.dtype,
              channel_dim: int) -> torch.Tensor:
    shape = [1] * y.dim()
    shape[channel_dim] = -1
    y = y.float() * scale.reshape(shape)
    if bias is not None:
        y = y + bias.float().reshape(shape)
    return y.to(dtype)


def quant_dense_apply(x: torch.Tensor, weight: torch.Tensor,
                      scale: torch.Tensor, bias: Optional[torch.Tensor],
                      dtype: torch.dtype) -> torch.Tensor:
    """Dense with an int8 weight (out, in): the product of `dtype`
    operands, then `* scale + bias` in f32, then the cast to `dtype`."""
    return _epilogue(F.linear(x.to(dtype), weight.to(dtype)), scale, bias,
                     dtype, -1)


def quant_conv_apply(x: torch.Tensor, weight: torch.Tensor,
                     scale: torch.Tensor, bias: Optional[torch.Tensor],
                     stride: tuple, padding: tuple,
                     dtype: torch.dtype) -> torch.Tensor:
    """2-D conv (NCHW, channels-last memory) with an int8 weight (out, in,
    kh, kw): the conv of `dtype` operands, then the per-output-channel
    scale and the bias in f32, then the cast to `dtype`."""
    w = weight.to(dtype, memory_format=torch.channels_last)
    y = F.conv2d(x.to(dtype), w, None, stride, padding)
    return _epilogue(y, scale, bias, dtype, 1)
