"""The decode read's span plan and its two-level algorithm, on the CPU.

The kernel (`csrc/decode_attention.cu`) cuts each (row, head)'s window
into the spans of `_span_plan`, computes each span's online-softmax triple
(acc, m, l), and merges the triples in span order.  Here `_two_level` is
that algorithm in plain PyTorch, on the plan's spans, and is held against
the port's whole-window `single_query_attention_stats` and the JAX
package's `fused_single_query_attention_stats(..., interpret=True)` (the
Pallas kernel through its interpreter), on the same numpy-seeded inputs:
a window that is no multiple of the span, a fully masked span in the
middle, a fully masked row, and an int8 cache with its scales.

Tolerance: f32 on both sides, summed in another order: each output within
1e-5 of max|ref| of that output (m on the rows that see a slot); a fully
masked row is exactly the merge identity m = NEG_INF, l = 0, acc = 0.
The kernel itself is held against the plain version on the card
(tests/test_torch_package.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.ops.decode_attention import (
    fused_single_query_attention_stats as jax_fused_stats)
from mmlspark_tpu_torch.ops.attention import (NEG_INF,
                                              single_query_attention_stats)
from mmlspark_tpu_torch.ops.decode_attention import (
    CTAS_PER_SM, MAX_SPANS, SPLIT, _check_inputs, _span_plan,
    fused_single_query_attention_stats)
from mmlspark_tpu_torch.quant.quantize import quantize_kv

THREADS = 256   # the kernel's CTA: the merge sums spans in THREADS // D groups


@pytest.mark.parametrize("length", [1, 63, 64, 65, 129, 1000, 4224, 8448])
@pytest.mark.parametrize("rows_x_heads,sm_count", [
    (16, 132), (64, 132), (1, 132), (512, 132), (16, 8), (3, 1)])
def test_span_plan_covers_the_window_once(length, rows_x_heads, sm_count):
    span, n_spans = _span_plan(length, rows_x_heads, sm_count)
    assert span % SPLIT == 0 and 1 <= n_spans <= MAX_SPANS
    cover = np.zeros(length, np.int64)
    for i in range(n_spans):
        cover[i * span:min(length, (i + 1) * span)] += 1
    assert (cover == 1).all()
    # every span holds a slot, and no more CTAs than fill the card
    # CTAS_PER_SM times, unless one span per (row, head) already does
    assert (n_spans - 1) * span < length
    assert (rows_x_heads * n_spans <= CTAS_PER_SM * sm_count
            or n_spans == 1)


def test_span_plan_fills_the_card():
    """The chip_smoke shapes on a 132-SM card: 224-256 CTAs, spans of
    several pipeline stages."""
    assert _span_plan(8448, 16, 132) == (576, 15)
    assert _span_plan(4224, 16, 132) == (320, 14)
    assert _span_plan(1152, 64, 132) == (320, 4)
    assert _span_plan(100_000, 1, 132) == (1600, 63)


def _span_triples(q, k, v, visible, scale, k_scale, v_scale):
    """One span's (acc, m, l), in f32, as a CTA computes it."""
    s = torch.einsum("bhd,blhd->bhl", q.float(), k.float()) * scale
    if k_scale is not None:
        s = s * k_scale.permute(0, 2, 1)
    s = torch.where(visible[:, None, :], s, NEG_INF)
    m = s.max(dim=-1).values if s.shape[-1] else torch.full(
        s.shape[:2], NEG_INF)
    safe = torch.where(m == NEG_INF, 0.0, m)
    p = torch.where(s == NEG_INF, 0.0, torch.exp(s - safe[..., None]))
    w = p * v_scale.permute(0, 2, 1) if v_scale is not None else p
    return torch.einsum("bhl,blhd->bhd", w, v.float()), m, p.sum(-1)


def _two_level(q, k, v, visible, scale, k_scale=None, v_scale=None,
               sm_count=132):
    """The kernel's algorithm: the plan's spans, then the merge in span
    order (the global max, the weights, THREADS // D groups of spans by
    index mod the group count, the groups summed in order)."""
    b, h, d = q.shape
    length = k.shape[1]
    span, n_spans = _span_plan(length, b * h, sm_count)
    parts = []
    for i in range(n_spans):
        sl = slice(i * span, min(length, (i + 1) * span))
        parts.append(_span_triples(
            q, k[:, sl], v[:, sl], visible[:, sl], scale,
            None if k_scale is None else k_scale[:, sl],
            None if v_scale is None else v_scale[:, sl]))
    acc_s = torch.stack([p[0] for p in parts])
    m_s = torch.stack([p[1] for p in parts])
    l_s = torch.stack([p[2] for p in parts])
    m = m_s.max(dim=0).values
    safe = torch.where(m == NEG_INF, 0.0, m)
    c = torch.where(m_s == NEG_INF, 0.0, torch.exp(m_s - safe))
    groups = THREADS // d
    acc = torch.zeros_like(acc_s[0])
    l = torch.zeros_like(l_s[0])
    for grp in range(groups):
        g_acc = torch.zeros_like(acc)
        g_l = torch.zeros_like(l)
        for i in range(grp, n_spans, groups):
            g_acc = g_acc + acc_s[i] * c[i][..., None]
            g_l = g_l + l_s[i] * c[i]
        acc, l = acc + g_acc, l + g_l
    return acc, m, l, n_spans


def _inputs(length, d, kind, seed):
    rng = np.random.default_rng(seed)
    b, h = 3, 4
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, length, h, d)).astype(np.float32)
            for _ in range(2))
    visible = rng.random((b, length)) < 0.8
    visible[:, 64:128] = False      # a fully masked span in the middle
    visible[-1] = False             # a fully masked row
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    kw = {}
    if kind == "int8":
        (tk, ks), (tv, vs) = quantize_kv(tk), quantize_kv(tv)
        kw = dict(k_scale=ks, v_scale=vs)
    return tq, tk, tv, torch.from_numpy(visible), kw


@pytest.mark.parametrize("length,d,kind,sm_count", [
    (200, 64, "float32", 132), (200, 128, "int8", 132),
    (320, 64, "int8", 24), (1000, 128, "float32", 64)])
def test_two_level_matches_whole_window_and_jax(length, d, kind, sm_count):
    q, k, v, visible, kw = _inputs(length, d, kind, seed=length + d)
    scale = d ** -0.5
    acc, m, l, n_spans = _two_level(q, k, v, visible, scale,
                                    sm_count=sm_count, **kw)
    assert n_spans > 1
    whole = single_query_attention_stats(q, k, v, visible, scale,
                                         kw.get("k_scale"),
                                         kw.get("v_scale"))
    jax_kw = {name: jnp.asarray(t.numpy()) for name, t in kw.items()}
    jax_out = jax_fused_stats(
        *(jnp.asarray(t.numpy()) for t in (q, k, v, visible)), scale,
        block_k=length // 5 if length % 5 == 0 else length,
        interpret=True, **jax_kw)
    refs = {"port": whole, "jax": [torch.from_numpy(np.array(x))
                                   for x in jax_out]}
    for name, (r_acc, r_m, r_l) in refs.items():
        for got, ref in ((acc, r_acc), (l, r_l)):
            assert (got - ref).abs().max() <= 1e-5 * ref.abs().max(), name
        seen = visible.any(dim=1)
        assert ((m[seen] - r_m[seen]).abs().max()
                <= 1e-5 * r_m[seen].abs().max()), name
    assert (m[-1] == NEG_INF).all() and (l[-1] == 0).all()
    assert torch.count_nonzero(acc[-1]) == 0


def test_stats_wrapper_runs_the_plain_version_on_the_cpu():
    """On CPU tensors the stats entry is the whole-window plain version
    and counts no launch."""
    q, k, v, visible, kw = _inputs(200, 64, "int8", seed=3)
    before = fused_single_query_attention_stats.launches
    got = fused_single_query_attention_stats(q, k, v, visible, **kw)
    ref = single_query_attention_stats(q, k, v, visible, 64 ** -0.5,
                                       kw["k_scale"], kw["v_scale"])
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert fused_single_query_attention_stats.launches == before


def test_kernel_checks_refuse_an_empty_window():
    """A window of no slot has no span plan: the kernel's input checks
    raise before any launch."""
    q = torch.zeros((1, 2, 64))
    k = v = torch.zeros((1, 0, 2, 64))
    with pytest.raises(ValueError, match="no slot"):
        _check_inputs(q, k, v, torch.zeros((1, 0), dtype=torch.bool), None,
                      None)
