"""Attention in PyTorch: the port of `mmlspark_tpu/ops/attention.py`
(the dense, cache-read, merge, ring, ring-flash and Ulysses forms).

  * `attention` — dense multi-head attention, the TransformerLM forward's
    op: scores in the input dtype, softmax statistics in f32.
  * `single_query_attention` — one decode step's query against a KV-cache
    window under a per-row visibility mask, optional int8 K/V with the
    dequant hoisted (k_scale after QK^T, v_scale folded into the weights
    before PV); f32 out.
  * `single_query_attention_stats` — the same read stopped before the
    normalize: the (acc, m, l) triple a split cache read merges.
  * `segment_cache_attention` — S queries a row against a cache window
    under per-query visibility: the speculative verify forward's read;
    at S = 1 elementwise the math of `single_query_attention`.
  * `merge_attention_stats` — the cross-shard epilogue of a seq-sharded
    decode step: pmax, then a psum pair, over per-shard triples.
  * `ring_attention` — attention over a sequence held as per-shard slabs,
    K/V rotating around the ring.  Without gradients (decode prefill)
    each (shard, block) pair runs through the flash forward with lse;
    with gradients it is the JAX package's dense online-softmax fold in
    plain torch ops, differentiated by autograd.
  * `ring_flash_attention` — the differentiable ring flash (the JAX
    `ring_flash_attention` custom VJP): the flash forward with lse per
    (shard, block) pair, merged by lse; the backward a second ring of
    `flash_block_grads` (dQ and dK/dV kernels) against the global lse and
    delta, each dK/dV accumulator travelling with its K/V shard.
  * `ulysses_attention` — all-to-all sequence parallelism: heads
    scattered over the shards, dense attention over the whole sequence,
    then back.

The first three are the algebra the hand-written kernels
(ops/flash_attention.py, ops/decode_attention.py) are held against; the
rest are tensor code around the kernels, as in JAX they are XLA around
the Pallas calls.

Ring and ring-flash fold rule: under the causal mask a block whose first
key lies past the shard's last query (source shard > query shard) adds
exactly nothing to the output (its lse is NEG_INF, its weight exactly
0) and exactly zero to every gradient, so the kernels skip it: n(n+1)/2
flash forward launches per data group over an n-shard ring, and as many
dQ and dK/dV launches in the backward (n^2 each without the mask).  The
dense fold computes every block, as the reference does.
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


def segment_cache_attention(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, visible: torch.Tensor,
                            scale: Optional[float] = None,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """A short segment's queries q (B, S, H, D) against caches (B, L, H,
    D) that already hold the segment's own K/V, under per-query
    visibility `visible` (B, S, L) bool.  int8 dequant scales (B, L, H)
    hoisted as in `single_query_attention`: K's after QK^T, V's into the
    softmax weights.  f32 statistics; returns (B, S, H, D) f32."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("bshd,blhd->bhsl", q.float(), k_cache.float()) * scale
    if k_scale is not None:
        s = s * k_scale.float().transpose(1, 2)[:, :, None, :]
    s = torch.where(visible[:, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    if v_scale is not None:
        w = w * v_scale.float().transpose(1, 2)[:, :, None, :]
    return torch.einsum("bhsl,blhd->bshd", w, v_cache.float())


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


def _needs_grad(*slabs) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in slabs)


def _ring_flash_forward(q: list, k: list, v: list, causal: bool,
                        scale: Optional[float]) -> tuple:
    """The ring flash forward (the JAX `_ring_flash_forward`): at ring
    step t shard i holds the K/V block of shard (i - t) mod n, runs
    `flash_attention_with_lse` against it at q offset i*S_l and k offset
    at the block's origin, and folds the normalized block output into its
    accumulator with the guarded logaddexp of the lse; then K/V rotate one
    hop (`ppermute`).  Returns (outputs in q's dtype, full-sequence lse
    f32 (B, S_l, H)), per shard."""
    from mmlspark_tpu_torch.ops.flash_attention import \
        flash_attention_with_lse
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
                continue   # wholly above the diagonal: adds exactly 0
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
    return [a.to(qi.dtype) for a, qi in zip(acc, q)], lse


def _ring_dense_fold(q: list, k: list, v: list, causal: bool,
                     scale: Optional[float]) -> list:
    """The JAX `ring_attention`: every (shard, block) pair's scores in the
    input dtype, folded into online-softmax accumulators (running max m,
    normalizer l, weighted sum acc, f32), K/V rotating one hop a step.
    Plain torch ops: autograd differentiates it."""
    n = len(q)
    b, s_l, h, d = q[0].shape
    scale = scale if scale is not None else d ** -0.5
    acc = [torch.zeros(qi.shape, dtype=torch.float32, device=qi.device)
           for qi in q]
    m = [torch.full((b, h, s_l), NEG_INF, dtype=torch.float32,
                    device=qi.device) for qi in q]
    l = [torch.zeros((b, h, s_l), dtype=torch.float32, device=qi.device)
         for qi in q]
    for t in range(n):
        for i in range(n):
            src = (i - t) % n
            s = torch.einsum("bqhd,bkhd->bhqk", q[i], k[i]).float() * scale
            if causal:
                q_pos = i * s_l + torch.arange(s_l, device=s.device)
                k_pos = src * s_l + torch.arange(s_l, device=s.device)
                s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                                NEG_INF)
            m_new = torch.maximum(m[i], s.amax(dim=-1))
            safe_m = torch.where(m_new == NEG_INF, 0.0, m_new)
            p = torch.exp(s - safe_m[..., None])
            p = torch.where(s == NEG_INF, 0.0, p)
            corr = torch.where(m[i] == NEG_INF, 0.0,
                               torch.exp(m[i] - safe_m))
            l[i] = l[i] * corr + p.sum(dim=-1)
            pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v[i].dtype),
                              v[i]).float()
            acc[i] = acc[i] * corr.transpose(1, 2)[..., None] + pv
            m[i] = m_new
        if t < n - 1:
            k, v = ppermute(k), ppermute(v)
    out = []
    for a, li, qi in zip(acc, l, q):
        l_safe = torch.where(li == 0.0, 1.0, li)
        out.append((a / l_safe.transpose(1, 2)[..., None]).to(qi.dtype))
    return out


def ring_attention(q: list, k: list, v: list, causal: bool = False,
                   scale: Optional[float] = None) -> list:
    """Attention over a sequence held as per-shard slabs: q, k, v are lists
    of (B, S_l, H, D), shard i holding global positions i*S_l..(i+1)*S_l-1
    on its own device.  Returns the per-shard outputs in q's dtype.

    Without gradients: the flash forward with lse per (shard, block) pair
    (`_ring_flash_forward`; n(n+1)/2 launches under the causal mask), the
    seq decode engine's ring prefill.  When gradients are needed: the
    JAX package's dense fold (`_ring_dense_fold`) under autograd, the
    `attn_impl="ring"` training path."""
    if _needs_grad(*q, *k, *v):
        return _ring_dense_fold(q, k, v, causal, scale)
    return _ring_flash_forward(q, k, v, causal, scale)[0]


class _RingFlashAttention(torch.autograd.Function):
    """The JAX `ring_flash_attention` custom VJP over per-shard slabs
    (passed flat: n q slabs, then n k, then n v).  The forward saves
    (q, k, v, out, lse) per shard and no scores; the backward computes
    delta = rowsum(dO * O) in f32, then runs a second ring: shard i folds
    `flash_block_grads` (K2 then K3) of the block it holds against its
    global lse and delta, dQ accumulating (f32) on shard i while each
    dK/dV accumulator travels with its K/V block; after the last fold
    the accumulators take one more hop, which lands each on the shard
    that owns its block."""

    @staticmethod
    def forward(ctx, causal, scale, n, *slabs):
        q, k, v = list(slabs[:n]), list(slabs[n:2 * n]), list(slabs[2 * n:])
        out, lse = _ring_flash_forward(q, k, v, causal, scale)
        ctx.save_for_backward(*q, *k, *v, *out, *lse)
        ctx.causal, ctx.scale, ctx.n = causal, scale, n
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        from mmlspark_tpu_torch.ops.flash_attention import flash_block_grads
        n, causal = ctx.n, ctx.causal
        saved = ctx.saved_tensors
        q, k, v, out, lse = (list(saved[j * n:(j + 1) * n])
                             for j in range(5))
        s_l, d = q[0].shape[1], q[0].shape[-1]
        scale = ctx.scale if ctx.scale is not None else d ** -0.5
        g = [gi.contiguous() for gi in grads]
        delta = [(gi.float() * oi.float()).sum(-1).contiguous()
                 for gi, oi in zip(g, out)]
        dq = [torch.zeros(qi.shape, dtype=torch.float32, device=qi.device)
              for qi in q]
        dk = [torch.zeros(ki.shape, dtype=torch.float32, device=ki.device)
              for ki in k]
        dv = [torch.zeros(vi.shape, dtype=torch.float32, device=vi.device)
              for vi in v]
        k_cur, v_cur = k, v
        for t in range(n):
            for i in range(n):
                src = (i - t) % n
                if causal and src > i:
                    continue   # every gradient of the block is exactly 0
                dq_c, dk_c, dv_c = flash_block_grads(
                    q[i], k_cur[i], v_cur[i], g[i], lse[i], delta[i],
                    causal, scale, q_offset=i * s_l, k_offset=src * s_l)
                dq[i] = dq[i] + dq_c.float()
                dk[i] = dk[i] + dk_c.float()
                dv[i] = dv[i] + dv_c.float()
            if t < n - 1:
                k_cur, v_cur = ppermute(k_cur), ppermute(v_cur)
            dk, dv = ppermute(dk), ppermute(dv)
        return (None, None, None,
                *(a.to(x.dtype) for a, x in zip(dq, q)),
                *(a.to(x.dtype) for a, x in zip(dk, k)),
                *(a.to(x.dtype) for a, x in zip(dv, v)))


def ring_flash_attention(q: list, k: list, v: list, causal: bool = False,
                         scale: Optional[float] = None) -> list:
    """Ring attention with the flash kernels as the local block op, over
    per-shard slabs as `ring_attention` takes them.  Differentiable: with
    gradients it runs `_RingFlashAttention` (K1[lse] folds forward, K2
    and K3 folds backward); without, the same forward alone."""
    if _needs_grad(*q, *k, *v):
        return list(_RingFlashAttention.apply(causal, scale, len(q),
                                              *q, *k, *v))
    return _ring_flash_forward(q, k, v, causal, scale)[0]


def ulysses_attention(q: list, k: list, v: list, causal: bool = False,
                      scale: Optional[float] = None) -> list:
    """All-to-all sequence parallelism (DeepSpeed-Ulysses) over per-shard
    slabs (B, S_l, H, D): shard j gathers head slice j of every shard's
    slab (B, S, H/n, D), attends densely over the whole sequence, and the
    second all-to-all returns each shard its rows with every head.  Heads
    must divide the number of shards."""
    n = len(q)
    h = q[0].shape[2]
    if h % n != 0:
        raise ValueError(
            f"ulysses needs heads ({h}) divisible by axis size ({n})")
    hl, s_l = h // n, q[0].shape[1]

    def scatter_heads(parts):
        return [torch.cat([p[:, :, j * hl:(j + 1) * hl].to(parts[j].device)
                           for p in parts], dim=1) for j in range(n)]

    outs = [attention(qj, kj, vj, causal=causal, scale=scale)
            for qj, kj, vj in zip(scatter_heads(q), scatter_heads(k),
                                  scatter_heads(v))]
    return [torch.cat([o[:, i * s_l:(i + 1) * s_l].to(q[i].device)
                       for o in outs], dim=2) for i in range(n)]
