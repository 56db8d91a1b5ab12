"""Fused single-query attention, the decode step's cache read: a
hand-written CUDA kernel for Hopper (`csrc/decode_attention.cu`) and its
plain PyTorch versions.

The kernel replaces the Pallas `_sqa_kernel` / `_fused_forward` of
`mmlspark_tpu/ops/decode_attention.py` (the `pallas_call` at :245) in both
its entry points: `fused_single_query_attention` (the normalized output)
and `fused_single_query_attention_stats` (:326, `emit_stats`: the raw
f32 triple acc (B, H, D), m (B, H), l (B, H) that a seq-sharded cache read
merges across shards with `ops/attention.merge_attention_stats`; a fully
masked row gives m = NEG_INF, l = 0, acc = 0).  Contract: q (B, H, D) in
the model dtype; caches
(B, L, H, D) in the model dtype, or int8 with per-(row, slot, head) f32
dequant scales (B, L, H); per-row visibility (B, L) bool; (B, H, D) f32
out.  K's scale multiplies the score after QK^T and V's folds into the
softmax weight before PV, so the read streams only the int8 bytes.  A row
whose every slot is masked returns zeros, like the Pallas kernel.  Head
dims 8, 16, 32, 64 and 128; any other head dim on a CUDA tensor raises
ValueError naming the set, before any launch.

The kernel cuts the window into spans, one CTA per (row, head, span),
and merges the spans' online-softmax triples in the same launch: the CTA
that finishes last for a (row, head) merges them in span order
(flash-decoding in one kernel).  `_span_plan` sizes the spans from the
window and the card's SM count; any window length works (the last span
is short).  The merge's scratch: per-call partials, and per-(row, head)
arrival counters that the kernel leaves zero, held once per (device,
stream) so that launches that may overlap never share them.

Both wrappers run their plain version for CPU tensors only; for CUDA
tensors they launch the kernel or raise.  Each counts its own launches
(`fused_single_query_attention.launches`,
`fused_single_query_attention_stats.launches`).
"""

from __future__ import annotations

from typing import Optional

import torch

from mmlspark_tpu_torch.ops import native
from mmlspark_tpu_torch.ops.attention import single_query_attention_stats

SPLIT = 64        # slot step: every span is a multiple of it
MAX_SPANS = 64    # spans per (row, head) at most: the merge reads them all
CTAS_PER_SM = 2   # the kernel's occupancy (__launch_bounds__(256, 2))

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CACHE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (8, 16, 32, 64, 128)


def _span_plan(length: int, rows_x_heads: int, sm_count: int) -> tuple:
    """(span, n_spans) of a window of `length` slots read for
    `rows_x_heads` (row, head) pairs on a card of `sm_count` SMs: enough
    spans that the rows_x_heads * n_spans CTAs fill every SM about
    CTAS_PER_SM times, at most MAX_SPANS and at most one per SPLIT slots.
    The span is a multiple of SPLIT; spans [i * span, (i + 1) * span)
    cover [0, length) exactly once, the last one cut at `length`."""
    want = max(1, CTAS_PER_SM * sm_count // max(1, rows_x_heads))
    want = min(want, MAX_SPANS, -(-length // SPLIT))
    span = -(-length // (want * SPLIT)) * SPLIT
    return span, -(-length // span)


_sm_counts: dict = {}
_counters: dict = {}


def _sm_count(device: torch.device) -> int:
    count = _sm_counts.get(device.index)
    if count is None:
        count = torch.cuda.get_device_properties(
            device).multi_processor_count
        _sm_counts[device.index] = count
    return count


def _arrival_counters(device: torch.device, stream: int,
                      n: int) -> torch.Tensor:
    """At least `n` int32 arrival counters for launches on `stream`: zero
    when made, and zero again after every launch (the merging CTA resets
    its own).  Launches on one stream run in order and share a buffer;
    another stream gets its own, since its launches may overlap."""
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(1024, 1 << (n - 1).bit_length()),
                          dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


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
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {_HEAD_DIMS}")
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
    if l < 1:
        raise ValueError("the cache window holds no slot")
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


def fused_single_query_attention_stats_plain(
        q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
        visible: torch.Tensor, scale: Optional[float] = None,
        k_scale: Optional[torch.Tensor] = None,
        v_scale: Optional[torch.Tensor] = None) -> tuple:
    """The stats entry's function in plain PyTorch: the unnormalized f32
    (acc, m, l) of the whole window."""
    return single_query_attention_stats(q, k_cache, v_cache, visible, scale,
                                        k_scale, v_scale)


def _launch(q, k_cache, v_cache, visible, scale, k_scale, v_scale,
            stats: bool):
    """Run the kernel on the current stream: the normalized (B, H, D) out,
    or with `stats` the (acc, m, l) triple."""
    _check_inputs(q, k_cache, v_cache, visible, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"single-query attention kernel: unsupported "
                         f"device {q.device}")
    b, h, d = q.shape
    l = k_cache.shape[1]
    dev = q.device
    span, n_spans = _span_plan(l, b * h, _sm_count(dev))
    out = torch.empty((b, h, d), dtype=torch.float32, device=dev)
    m_out = l_out = None
    if stats:
        m_out, l_out = (torch.empty((b, h), dtype=torch.float32,
                                    device=dev) for _ in range(2))
    lib = native.library("decode_attention")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        partials = counters = None
        if n_spans > 1:
            partials = torch.empty((b, h, n_spans, d + 2),
                                   dtype=torch.float32, device=dev)
            counters = _arrival_counters(dev, stream, b * h)
        code = lib.mmlspark_sqa_forward(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            visible.data_ptr(),
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            partials.data_ptr() if partials is not None else None,
            counters.data_ptr() if counters is not None else None,
            out.data_ptr(), m_out.data_ptr() if stats else None,
            l_out.data_ptr() if stats else None, b, l, h, d, span,
            float(scale), _Q_DTYPES[q.dtype], _CACHE_DTYPES[k_cache.dtype],
            stream)
    native.check(code, "single-query attention")
    return (out, m_out, l_out) if stats else out


def fused_single_query_attention(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor, visible: torch.Tensor,
                                 scale: Optional[float] = None,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """One decode step's query against a cache window: (B, H, D) f32."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return fused_single_query_attention_plain(
            q, k_cache, v_cache, visible, scale, k_scale, v_scale)
    out = _launch(q, k_cache, v_cache, visible, scale, k_scale, v_scale,
                  stats=False)
    fused_single_query_attention.launches += 1
    return out


def fused_single_query_attention_stats(
        q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
        visible: torch.Tensor, scale: Optional[float] = None,
        k_scale: Optional[torch.Tensor] = None,
        v_scale: Optional[torch.Tensor] = None) -> tuple:
    """One decode step's query against one shard's cache slab, stopped
    before the normalize: f32 (acc (B, H, D), m (B, H), l (B, H))."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return fused_single_query_attention_stats_plain(
            q, k_cache, v_cache, visible, scale, k_scale, v_scale)
    triple = _launch(q, k_cache, v_cache, visible, scale, k_scale, v_scale,
                     stats=True)
    fused_single_query_attention_stats.launches += 1
    return triple


fused_single_query_attention.launches = 0
fused_single_query_attention_stats.launches = 0
