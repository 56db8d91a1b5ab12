"""The port's attention ops against the JAX package, on the CPU.

The port's kernel wrappers run their plain PyTorch versions on CPU
tensors; those are held here against the JAX package's Pallas kernels run
the way the JAX package's own tests run them (`interpret=True`), on the
same numpy inputs.  The kernels themselves are held against these plain
versions on the card (tests/test_torch_package.py, chip_smoke.py).

Tolerances: f32 paths differ only in summation order (2e-5); a bf16 output
is one bf16 rounding apart at most (2e-2 on O(1) values).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.ops.attention import (
    single_query_attention as jax_single_query_attention)
from mmlspark_tpu.ops.decode_attention import (
    fused_single_query_attention as jax_fused_single_query_attention)
from mmlspark_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
    flash_attention_with_lse as jax_flash_attention_with_lse)
from mmlspark_tpu.quant.quantize import quantize_kv as jax_quantize_kv
from mmlspark_tpu_torch.ops.attention import single_query_attention
from mmlspark_tpu_torch.ops.decode_attention import (
    fused_single_query_attention, fused_single_query_attention_plain)
from mmlspark_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_plain, flash_attention_with_lse)
from mmlspark_tpu_torch.quant.quantize import quantize_kv

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _torch(x, dtype=None):
    t = torch.from_numpy(np.asarray(x))
    return t if dtype is None else t.to(dtype)


def _bf16_to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


# ---------------------------------------------------------------- K1 ---

def _qkv(b=2, s=128, h=4, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_jax_flash(causal, dtype):
    """64-row blocks over S=128: the JAX kernel folds two K/V blocks per
    query block through its online softmax; the port's plain version
    computes the same function in one pass."""
    q, k, v = _qkv(seed=1 if causal else 0)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = jax_flash_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                              causal=causal, block_q=64, block_k=64,
                              interpret=True)
    got = flash_attention(*(_torch(x, tdt) for x in (q, k, v)),
                          causal=causal)
    assert got.dtype == tdt and got.shape == tuple(ref.shape)
    np.testing.assert_allclose(_bf16_to_numpy(got),
                               np.asarray(ref, np.float32),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


def test_flash_plain_takes_ragged_lengths():
    """S=100 does not tile the JAX kernel's blocks (its wrapper computes it
    densely); the port computes the same function at any S."""
    q, k, v = _qkv(s=100, seed=2)
    ref = jax_flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                              causal=True, block_q=64, block_k=64,
                              interpret=True)
    got = flash_attention(*(_torch(x) for x in (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)


# The edges of the card kernel's tiles (128 query rows, 128 keys): one row
# and one key past a tile, a single query deep in the sequence, fewer keys
# than a tile, B = 3, and one K/V tile at head dim 128.  With 64-row blocks
# the JAX wrappers compute the ragged ones densely and the rest through
# the interpreted kernel.  (B, Sq, Sk, causal, q_offset, D)
TILE_EDGES = [(2, 129, 129, True, 0, 128), (2, 1, 640, True, 500, 128),
              (2, 300, 37, False, 0, 64), (3, 200, 200, True, 0, 64),
              (2, 128, 128, True, 0, 128), (2, 128, 100, False, 0, 128)]


def _edge_qkv(b, sq, sk, d):
    rng = np.random.default_rng(sq + sk + d)
    q = rng.standard_normal((b, sq, 2, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, sk, 2, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("b,sq,sk,causal,q_off,d", TILE_EDGES)
def test_flash_lse_plain_matches_jax_at_tile_edges(b, sq, sk, causal, q_off,
                                                   d):
    q, k, v = _edge_qkv(b, sq, sk, d)
    ref_out, ref_lse = jax_flash_attention_with_lse(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal, q_offset=q_off,
        block_q=64, block_k=64, interpret=True)
    out, lse = flash_attention_with_lse(*(_torch(x) for x in (q, k, v)),
                                        causal, None, q_off)
    assert out.shape == (b, sq, 2, d) and lse.shape == (b, sq, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **F32_TOL)


@pytest.mark.parametrize("b,sq,sk,causal,q_off,d", TILE_EDGES)
def test_flash_plain_matches_jax_at_tile_edges(b, sq, sk, causal, q_off, d):
    """The same shapes without lse (and so without offsets)."""
    q, k, v = _edge_qkv(b, sq, sk, d)
    ref = jax_flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                              causal=causal, block_q=64, block_k=64,
                              interpret=True)
    got = flash_attention(*(_torch(x) for x in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)


def test_flash_wrapper_uses_plain_only_on_cpu():
    q, k, v = (_torch(x) for x in _qkv(s=16))
    before = flash_attention.launches
    torch.testing.assert_close(flash_attention(q, k, v, causal=True),
                               flash_attention_plain(q, k, v, causal=True))
    assert flash_attention.launches == before  # no kernel on the CPU
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


# ---------------------------------------------------------------- K4 ---

def _decode_case(b=3, l=128, h=4, d=32, seed=0):
    """A decode-step read in the engine's layout: per-row prompt slots
    [0, true_len), a pad hole, decode slots [l // 2, frontier]; the last row
    is fully masked (the merge identity: zeros out)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, l, h, d)).astype(np.float32)
    v = rng.standard_normal((b, l, h, d)).astype(np.float32)
    true_len = rng.integers(1, l // 2, size=b)
    slots = np.arange(l)[None, :]
    visible = (slots < true_len[:, None]) | (
        (slots >= l // 2) & (slots <= l // 2 + 5))
    visible[-1] = False
    return q, k, v, visible


@pytest.mark.parametrize("cache", ["float32", "bfloat16", "int8"])
def test_decode_plain_matches_jax_fused(cache):
    q, k, v, visible = _decode_case(seed={"float32": 0, "bfloat16": 1,
                                          "int8": 2}[cache])
    jvis, tvis = jnp.asarray(visible), _torch(visible)
    if cache == "int8":
        jk, jks = jax_quantize_kv(jnp.asarray(k))
        jv, jvs = jax_quantize_kv(jnp.asarray(v))
        tk, tks = quantize_kv(_torch(k))
        tv, tvs = quantize_kv(_torch(v))
        jq, tq = jnp.asarray(q), _torch(q)
        ref = jax_fused_single_query_attention(
            jq, jk, jv, jvis, k_scale=jks, v_scale=jvs, block_k=64,
            interpret=True)
        got = fused_single_query_attention(tq, tk, tv, tvis, k_scale=tks,
                                           v_scale=tvs)
    else:
        jdt = jnp.bfloat16 if cache == "bfloat16" else jnp.float32
        tdt = torch.bfloat16 if cache == "bfloat16" else torch.float32
        ref = jax_fused_single_query_attention(
            *(jnp.asarray(x, jdt) for x in (q, k, v)), jvis, block_k=64,
            interpret=True)
        got = fused_single_query_attention(
            *(_torch(x, tdt) for x in (q, k, v)), tvis)
    assert got.dtype == torch.float32 and got.shape == tuple(ref.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)
    np.testing.assert_array_equal(got[-1].numpy(), 0.0)


def test_decode_plain_matches_softmax_reference_on_visible_rows():
    """The normalized statistics equal the softmax-form cache read (the
    JAX engine's CPU path) wherever a row sees at least one slot."""
    q, k, v, visible = _decode_case(seed=3)
    ref = jax_single_query_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                     jnp.asarray(visible))
    got = fused_single_query_attention_plain(
        *(_torch(x) for x in (q, k, v)), _torch(visible))
    np.testing.assert_allclose(got[:-1].numpy(), np.asarray(ref)[:-1],
                               **F32_TOL)
    np.testing.assert_allclose(
        single_query_attention(*(_torch(x) for x in (q, k, v)),
                               _torch(visible)).numpy(),
        np.asarray(ref), **F32_TOL)


def test_quantize_kv_bytes_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 4, 32)).astype(np.float32) * 3
    x[0, 3, 1] = 0.0                       # a never-written slot: scale 0
    x[1, 5, 2, :4] = [0.5, -0.5, 1.5, 127.0 / 254]  # rounding ties
    jq, js = jax_quantize_kv(jnp.asarray(x))
    tq, ts = quantize_kv(_torch(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=1e-7)
    assert ts[0, 3, 1] == 0 and (tq[0, 3, 1] == 0).all()
