"""Head dims 8 and 16 in the port's decode kernels K4 and K4[stats], on
the CPU.

The LM example (head dim 8) and `TransformerLM`'s default widths (head
dim 16) run K4 at every decode step on the card; tests/test_torch_package.py
holds those instances against their plain versions there.  Here the plain
versions are held, at head dims 8 and 16, against the JAX package's
`fused_single_query_attention` and `_stats` run in interpret mode on the
same numpy inputs, with f32, bf16 and int8 caches (the int8 cache at head
dim 8 is the kernel's one 8-byte row load), the engine's mask layout and a
fully masked row.  The module fixture `jax_refs` computes every case's JAX
side up front on 4 threads.  The flash kernels at these head dims are in
tests/test_torch_head_dims.py.

Tolerance: f32 statistics differ in summation order only (2e-5; the
triple within 1e-5 of its largest entry).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.ops.decode_attention import (
    fused_single_query_attention as jax_fused,
    fused_single_query_attention_stats as jax_fused_stats)
from mmlspark_tpu.quant.quantize import quantize_kv as jax_quantize_kv
from mmlspark_tpu_torch.ops.attention import NEG_INF
from mmlspark_tpu_torch.ops.decode_attention import (
    fused_single_query_attention, fused_single_query_attention_stats)
from mmlspark_tpu_torch.quant.quantize import quantize_kv

HEAD_DIMS = (8, 16)
CACHES = ("float32", "bfloat16", "int8")
F32_TOL = dict(rtol=2e-5, atol=2e-5)

_jax_fused = jax.jit(jax_fused, static_argnames=("block_k", "interpret"))
_jax_fused_stats = jax.jit(jax_fused_stats,
                           static_argnames=("block_k", "interpret"))

def _decode_inputs(d, seed, b=4, length=192):
    """The engine's mask layout: per-row prompt slots, the pad hole up to
    the bucket, decode slots after it; the last row fully masked."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 8, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, length, 8, d)).astype(np.float32)
            for _ in range(2))
    bucket = length - 64
    true_len = rng.integers(1, bucket + 1, size=b)
    slots = np.arange(length)[None]
    visible = (slots < true_len[:, None]) | (slots >= bucket)
    visible[-1] = False
    return q, k, v, visible


def _decode_pair(cache, q, k, v, visible):
    """(JAX args, JAX kwargs, port args, port kwargs) for one cache kind."""
    jvis, tvis = jnp.asarray(visible), torch.from_numpy(visible)
    if cache == "int8":
        jk, jks = jax_quantize_kv(jnp.asarray(k))
        jv, jvs = jax_quantize_kv(jnp.asarray(v))
        (tk, tks), (tv, tvs) = (quantize_kv(torch.from_numpy(x))
                                for x in (k, v))
        return ((jnp.asarray(q), jk, jv, jvis), dict(k_scale=jks, v_scale=jvs),
                (torch.from_numpy(q), tk, tv, tvis),
                dict(k_scale=tks, v_scale=tvs))
    jdt = jnp.bfloat16 if cache == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if cache == "bfloat16" else torch.float32
    return (tuple(jnp.asarray(x, jdt) for x in (q, k, v)) + (jvis,), {},
            tuple(torch.from_numpy(x).to(tdt) for x in (q, k, v)) + (tvis,),
            {})


def _jax_decode(d, cache):
    jargs, jkw, _, _ = _decode_pair(cache, *_decode_inputs(d, seed=d))
    out = _jax_fused(*jargs, block_k=64, interpret=True, **jkw)
    stats = _jax_fused_stats(*jargs, block_k=64, interpret=True, **jkw)
    return np.asarray(out), [np.asarray(x) for x in stats]


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX side of every case, by head dim and cache."""
    with ThreadPoolExecutor(4) as pool:
        futures = {("decode", d, c): pool.submit(_jax_decode, d, c)
                   for d in HEAD_DIMS for c in CACHES}
        return {key: f.result() for key, f in futures.items()}


@pytest.mark.parametrize("cache", CACHES)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_decode_at_small_head_dims_matches_jax(jax_refs, d, cache):
    """K4 and K4[stats]'s functions against the JAX kernel's two entries:
    the normalized output (zeros on the masked row) and the unnormalized
    triple (the merge identity on the masked row)."""
    q, k, v, visible = _decode_inputs(d, seed=d)
    _, _, targs, tkw = _decode_pair(cache, q, k, v, visible)
    ref, (r_acc, r_m, r_l) = jax_refs["decode", d, cache]
    got = fused_single_query_attention(*targs, **tkw)
    assert got.dtype == torch.float32 and got.shape == (4, 8, d)
    np.testing.assert_allclose(got.numpy(), ref, **F32_TOL)
    assert torch.count_nonzero(got[-1]) == 0
    acc, m, l = (x.numpy() for x in fused_single_query_attention_stats(
        *targs, **tkw))
    assert np.abs(acc - r_acc).max() <= 1e-5 * np.abs(r_acc).max()
    assert np.abs(l - r_l).max() <= 1e-5 * np.abs(r_l).max()
    seen = visible.any(axis=1)
    assert np.abs(m[seen] - r_m[seen]).max() <= 1e-5 * np.abs(r_m[seen]).max()
    assert (m[-1] == NEG_INF).all() and (l[-1] == 0).all()
    assert np.count_nonzero(acc[-1]) == 0
