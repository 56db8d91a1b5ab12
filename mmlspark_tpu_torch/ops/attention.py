"""Plain attention in PyTorch (the port of `mmlspark_tpu/ops/attention.py`
:40-169, single-device forms only).

  * `attention` — dense multi-head attention, the TransformerLM forward's
    op: scores in the input dtype, softmax statistics in f32.
  * `single_query_attention` — one decode step's query against a KV-cache
    window under a per-row visibility mask, optional int8 K/V with the
    dequant hoisted (k_scale after QK^T, v_scale folded into the weights
    before PV); f32 out.
  * `single_query_attention_stats` — the same read stopped before the
    normalize: the (acc, m, l) triple a split cache read merges.

These are the algebra the hand-written kernels (ops/flash_attention.py,
ops/decode_attention.py) are held against.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False, scale: Optional[float] = None,
              q_offset: int = 0) -> torch.Tensor:
    """Dense multi-head attention: q, k, v (B, S, H, D) -> (B, S, H, D).

    Softmax statistics stay in f32; `q_offset` shifts the queries' global
    positions for causal masking."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        q_pos = q_offset + torch.arange(s.shape[-2], device=s.device)
        k_pos = torch.arange(s.shape[-1], device=s.device)
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _cache_scores(q, k_cache, visible, scale, k_scale):
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("bhd,blhd->bhl", q.float(), k_cache.float()) * scale
    if k_scale is not None:
        s = s * k_scale.float().transpose(1, 2)
    return torch.where(visible[:, None, :], s, NEG_INF)


def single_query_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, visible: torch.Tensor,
                           scale: Optional[float] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """q (B, H, D) against caches (B, L, H, D) under `visible` (B, L) bool.

    k_scale, v_scale: (B, L, H) f32 dequant scales of an int8 cache, or
    None.  Returns (B, H, D) f32."""
    s = _cache_scores(q, k_cache, visible, scale, k_scale)
    w = torch.softmax(s, dim=-1)
    if v_scale is not None:
        w = w * v_scale.float().transpose(1, 2)
    return torch.einsum("bhl,blhd->bhd", w, v_cache.float())


def single_query_attention_stats(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor,
                                 visible: torch.Tensor,
                                 scale: Optional[float] = None,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None
                                 ) -> tuple:
    """`single_query_attention` stopped before the normalize: f32
    (acc (B, H, D), m (B, H), l (B, H)).  A window whose every slot is
    masked reports m = NEG_INF, l = 0, acc = 0 — the merge identity."""
    s = _cache_scores(q, k_cache, visible, scale, k_scale)
    m = s.amax(dim=-1)
    safe_m = torch.where(m == NEG_INF, 0.0, m)
    p = torch.exp(s - safe_m[..., None])
    p = torch.where(s == NEG_INF, 0.0, p)
    l = p.sum(dim=-1)
    if v_scale is not None:
        p = p * v_scale.float().transpose(1, 2)
    acc = torch.einsum("bhl,blhd->bhd", p, v_cache.float())
    return acc, m, l

