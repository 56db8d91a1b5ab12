"""Fused single-query attention, the decode step's cache read: a
hand-written CUDA kernel for Hopper (`csrc/decode_attention.cu`) and its
plain PyTorch version.

The kernel replaces the Pallas `_sqa_kernel` / `_fused_forward` of
`mmlspark_tpu/ops/decode_attention.py` (the `pallas_call` at :245), its
normalized output.  Contract: q (B, H, D) in the model dtype; caches
(B, L, H, D) in the model dtype, or int8 with per-(row, slot, head) f32
dequant scales (B, L, H); per-row visibility (B, L) bool; (B, H, D) f32
out.  K's scale multiplies the score after QK^T and V's folds into the
softmax weight before PV, so the read streams only the int8 bytes.  A row
whose every slot is masked returns zeros, like the Pallas kernel.

The kernel splits the window into `SPLIT`-slot spans, one CTA per (row,
head, span), and merges the spans' online-softmax triples in a second
small kernel (flash-decoding).  Any window length works: the last span is
masked.

`fused_single_query_attention` runs the plain version for CPU tensors only;
for CUDA tensors it launches the kernel or raises.
`fused_single_query_attention.launches` counts launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from mmlspark_tpu_torch.ops import native
from mmlspark_tpu_torch.ops.attention import single_query_attention_stats

SPLIT = 64  # cache slots per CTA

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CACHE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (64, 128)


def fused_single_query_attention_plain(
        q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
        visible: torch.Tensor, scale: Optional[float] = None,
        k_scale: Optional[torch.Tensor] = None,
        v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the f32 online-softmax
    statistics of the whole window, normalized (acc / l, zeros where every
    slot is masked)."""
    acc, _, l = single_query_attention_stats(q, k_cache, v_cache, visible,
                                             scale, k_scale, v_scale)
    return acc / torch.where(l == 0.0, 1.0, l)[..., None]


def _check_inputs(q, k_cache, v_cache, visible, k_scale, v_scale) -> None:
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError("q must be (B, H, D) and caches (B, L, H, D)")
    b, h, d = q.shape
    l = k_cache.shape[1]
    if k_cache.shape != (b, l, h, d) or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"cache shapes {tuple(k_cache.shape)}/{tuple(v_cache.shape)} do "
            f"not match q {tuple(q.shape)}")
    if visible.shape != (b, l) or visible.dtype != torch.bool:
        raise ValueError(f"visible must be a (B, L) bool mask, got "
                         f"{tuple(visible.shape)} {visible.dtype}")
    if q.dtype not in _Q_DTYPES:
        raise ValueError(f"q dtype {q.dtype} not in {list(_Q_DTYPES)}")
    if k_cache.dtype not in _CACHE_DTYPES or v_cache.dtype != k_cache.dtype:
        raise ValueError(f"cache dtypes {k_cache.dtype}/{v_cache.dtype} not "
                         f"one of {list(_CACHE_DTYPES)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {_HEAD_DIMS}")
    quantized = k_cache.dtype == torch.int8
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale go together")
    if quantized != (k_scale is not None):
        raise ValueError("an int8 cache needs k_scale and v_scale, and only "
                         "an int8 cache takes them")
    tensors = [q, k_cache, v_cache, visible]
    if quantized:
        for s in (k_scale, v_scale):
            if s.shape != (b, l, h) or s.dtype != torch.float32:
                raise ValueError(f"scales must be (B, L, H) float32, got "
                                 f"{tuple(s.shape)} {s.dtype}")
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != q.device:
            raise ValueError("all inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("caches must be 16-byte aligned")


def fused_single_query_attention(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor, visible: torch.Tensor,
                                 scale: Optional[float] = None,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """One decode step's query against a cache window: (B, H, D) f32."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    if q.device.type == "cpu":
        return fused_single_query_attention_plain(
            q, k_cache, v_cache, visible, scale, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(
            f"fused_single_query_attention: unsupported device {q.device}")
    _check_inputs(q, k_cache, v_cache, visible, k_scale, v_scale)
    b, h, _ = q.shape
    l = k_cache.shape[1]
    n_splits = -(-l // SPLIT)
    partials = torch.empty((b, h, n_splits, d + 2), dtype=torch.float32,
                           device=q.device)
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    lib = native.library("decode_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mmlspark_sqa_forward(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            visible.data_ptr(),
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            partials.data_ptr(), out.data_ptr(), b, l, h, d, SPLIT,
            float(scale), _Q_DTYPES[q.dtype], _CACHE_DTYPES[k_cache.dtype],
            stream)
    native.check(code, "fused_single_query_attention")
    fused_single_query_attention.launches += 1
    return out


fused_single_query_attention.launches = 0
