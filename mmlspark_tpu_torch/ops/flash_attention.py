"""Flash attention forward: a hand-written CUDA kernel for Hopper
(`csrc/flash_attention.cu`) and its plain PyTorch version.

The kernel replaces the Pallas `_flash_kernel` / `_flash_forward` of
`mmlspark_tpu/ops/flash_attention.py` (the `pallas_call` at :148), forward
only, without the log-sum-exp output or the q/k position offsets that only
the ring variants use.  Semantics are the JAX kernel's: inputs (B, S, H, D),
causal or not, f32 running max / normalizer / accumulator, scale D^-0.5 by
default, output in q's dtype.  Unlike the JAX wrapper it takes any S: the
kernel masks the ragged last tile itself, so there is no dense fallback.

`flash_attention` runs the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.  `flash_attention.launches`
counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from mmlspark_tpu_torch.ops import native
from mmlspark_tpu_torch.ops.attention import NEG_INF

# dtype codes of the C entry point
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the JAX flash kernel's
    algebra on one block (q scaled in f32 before QK^T, fully masked rows
    give zeros), output in q's dtype."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if causal:
        rows = torch.arange(s.shape[-2], device=s.device)[:, None]
        cols = torch.arange(s.shape[-1], device=s.device)[None, :]
        s = torch.where(rows >= cols, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    safe_m = torch.where(m == NEG_INF, 0.0, m)
    p = torch.where(s == NEG_INF, 0.0, torch.exp(s - safe_m))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    l_safe = torch.where(l == 0.0, 1.0, l).permute(0, 2, 1, 3)
    return (acc / l_safe).to(q.dtype)


def _check_inputs(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes (B, S, H, D) tensors")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or \
            k.shape[2:] != q.shape[2:]:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention kernel takes float32 or bfloat16 q/k/v of one "
            f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(
            f"flash_attention kernel takes head dim {_HEAD_DIMS}, got "
            f"{q.shape[-1]}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel takes contiguous tensors")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must be on one device")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash_attention is forward-only here: its backward kernels "
            "are not ported yet")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Fused attention forward: q (B, Sq, H, D), k/v (B, Sk, H, D) ->
    (B, Sq, H, D) in q's dtype."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_inputs(q, k, v)
    b, sq, h, _ = q.shape
    out = torch.empty_like(q)
    lib = native.library("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mmlspark_flash_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, sq, k.shape[1], d, float(scale), int(causal),
            _DTYPES[q.dtype], stream)
    native.check(code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
