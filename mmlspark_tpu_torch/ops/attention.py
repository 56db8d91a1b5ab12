"""Attention in PyTorch: the port of `mmlspark_tpu/ops/attention.py`
:40-324 (the dense, cache-read, merge and ring forms).

  * `attention` — dense multi-head attention, the TransformerLM forward's
    op: scores in the input dtype, softmax statistics in f32.
  * `single_query_attention` — one decode step's query against a KV-cache
    window under a per-row visibility mask, optional int8 K/V with the
    dequant hoisted (k_scale after QK^T, v_scale folded into the weights
    before PV); f32 out.
  * `single_query_attention_stats` — the same read stopped before the
    normalize: the (acc, m, l) triple a split cache read merges.
  * `merge_attention_stats` — the cross-shard epilogue of a seq-sharded
    decode step: pmax, then a psum pair, over per-shard triples.
  * `ring_attention` — causal or full attention over a sequence cut into
    per-shard slabs, K/V rotating around the ring, each (shard, block)
    pair through the flash forward with lse.

The first three are the algebra the hand-written kernels
(ops/flash_attention.py, ops/decode_attention.py) are held against; the
last two are plain tensor code around the kernels, as in JAX they are
XLA around the Pallas calls.
"""

from __future__ import annotations

from typing import Optional

import torch

from mmlspark_tpu_torch.parallel.ring import pmax, ppermute, psum

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



def merge_attention_stats(acc, m, l) -> torch.Tensor:
    """Rescale each shard's (acc, m, l) to the global running max and sum:
    one pmax plus one psum pair of (B, H)-sized exchanges (the JAX
    `merge_attention_stats` with an axis).  `acc`, `m`, `l` are lists of
    per-shard tensors (B, H, D), (B, H), (B, H); a fully masked shard
    (m = NEG_INF) gets weight exactly 0.  Plain tensors (one shard) take
    the no-axis form acc / l.  Returns (B, H, D) f32 on shard 0's device,
    zeros where no shard sees a slot."""
    if isinstance(m, (list, tuple)):
        m_g = pmax(m)
        corr = [torch.where(mi == NEG_INF, 0.0,
                            torch.exp(mi - torch.where(gi == NEG_INF, 0.0,
                                                       gi)))
                for mi, gi in zip(m, m_g)]
        l = psum([li * ci for li, ci in zip(l, corr)])[0]
        acc = psum([ai * ci[..., None] for ai, ci in zip(acc, corr)])[0]
    return acc / torch.where(l == 0.0, 1.0, l)[..., None]


def ring_attention(q: list, k: list, v: list, causal: bool = False,
                   scale: Optional[float] = None) -> list:
    """Attention over a sequence held as per-shard slabs: q, k, v are lists
    of (B, S_l, H, D), shard i holding global positions i*S_l..(i+1)*S_l-1
    on its own device.  Returns the per-shard outputs in q's dtype.

    Computed as the JAX `_ring_flash_forward` does it: at ring step t
    shard i holds the K/V block of shard (i - t) mod n, runs
    `flash_attention_with_lse` against it with q_offset i*S_l and k_offset
    at the block's origin, and folds the normalized block output into its
    accumulator with the guarded logaddexp of the lse; then K/V rotate
    one hop (`ppermute`).  Under the causal mask a block whose first key
    lies past the shard's last query adds exactly nothing, so it is
    skipped: n(n+1)/2 flash launches instead of n^2.  Forward only (the
    differentiable ring comes with seq-parallel training)."""
    from mmlspark_tpu_torch.ops.flash_attention import \
        flash_attention_with_lse
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (*q, *k, *v)):
        raise NotImplementedError(
            "ring_attention is forward only: its backward comes with "
            "seq-parallel training (ROADMAP A10)")
    n = len(q)
    s_l = q[0].shape[1]
    acc = [torch.zeros(qi.shape, dtype=torch.float32, device=qi.device)
           for qi in q]
    lse = [torch.full(qi.shape[:3], NEG_INF, dtype=torch.float32,
                      device=qi.device) for qi in q]
    for t in range(n):
        for i in range(n):
            src = (i - t) % n
            if causal and src > i:
                continue
            o_b, lse_b = flash_attention_with_lse(
                q[i], k[i], v[i], causal, scale, q_offset=i * s_l,
                k_offset=src * s_l)
            new = torch.logaddexp(lse[i], lse_b)
            w_old = torch.where(lse[i] <= NEG_INF, 0.0,
                                torch.exp(lse[i] - new))
            w_new = torch.where(lse_b <= NEG_INF, 0.0, torch.exp(lse_b - new))
            acc[i] = acc[i] * w_old[..., None] + o_b.float() * w_new[..., None]
            lse[i] = new
        if t < n - 1:
            k, v = ppermute(k), ppermute(v)
    return [a.to(qi.dtype) for a, qi in zip(acc, q)]
