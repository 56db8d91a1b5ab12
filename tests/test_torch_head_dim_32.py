"""Head dim 32 in the port's attention kernels, on the CPU.

K1 / K1[lse], K2 / K3 and K4 / K4[stats] have head-dim-32 instances on
the card (tests/test_torch_package.py holds them against their plain
versions there); here the plain versions those kernels are held to are
held, at head dim 32, against the JAX package's Pallas kernels run in
interpret mode on the same numpy inputs, at the edges of the card
kernels' tiles (64 query rows and 64 keys for bf16 K1, K2 and K3; K4's
2-, 4- and 8-lane slot groups).  A head dim that no kernel takes (24,
256) is refused before any launch, naming the supported set.  Head dims
8 and 16 are in tests/test_torch_head_dims.py.

The JAX side is jitted once per shape, its offsets traced, and the module
fixture `jax_refs` computes every case's JAX side up front, a few
programs compiling at once on threads (XLA compiles outside the GIL), as
tests/test_torch_flash_backward.py does.

Tolerances are those of the head-dim-64/128 cases
(tests/test_torch_attention.py, tests/test_torch_flash_backward.py): f32
differs in summation order only (2e-5; 1e-4 absolute for block
gradients, whose entries reach |x| ~ 10); a bf16 output is one bf16
rounding apart at most (2e-2).
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.ops.decode_attention import (
    fused_single_query_attention as jax_fused,
    fused_single_query_attention_stats as jax_fused_stats)
from mmlspark_tpu.ops.flash_attention import _flash_backward
from mmlspark_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
    flash_attention_with_lse as jax_flash_attention_with_lse)
from mmlspark_tpu.quant.quantize import quantize_kv as jax_quantize_kv
from mmlspark_tpu_torch.ops.attention import NEG_INF
from mmlspark_tpu_torch.ops.decode_attention import (
    fused_single_query_attention, fused_single_query_attention_stats)
from mmlspark_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_with_lse, flash_block_grads,
    flash_bwd_dkv, flash_bwd_dq)
from mmlspark_tpu_torch.quant.quantize import quantize_kv

D = 32
# the JAX side jitted once per shape (eager JAX compiles every primitive
# of every call), the offsets traced
_FLASH = ("causal", "block_q", "block_k", "interpret")
jax_flash_attention = jax.jit(jax_flash_attention, static_argnames=_FLASH)
jax_flash_attention_with_lse = jax.jit(jax_flash_attention_with_lse,
                                       static_argnames=_FLASH)
jax_fused = jax.jit(jax_fused, static_argnames=("block_k", "interpret"))
jax_fused_stats = jax.jit(jax_fused_stats,
                          static_argnames=("block_k", "interpret"))
jax_quantize_kv = jax.jit(jax_quantize_kv)
# positional (q, k, v, do, lse, delta, causal, scale, block_q, block_k,
# interpret, q_offset, k_offset): static from `causal` to `interpret`, the
# offsets traced (one program per causal flag)
jax_flash_backward = jax.jit(_flash_backward, static_argnums=(6, 7, 8, 9, 10))
F32_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

# (B, Sq, Sk, causal, q_offset, k_offset): a row and a key past a 64-row
# tile, one query deep in the sequence, fewer keys than a tile, and rows
# that see no key (k_offset > q_offset) over two whole 64-blocks of the
# JAX kernel proper
FLASH_CASES = [(2, 129, 129, True, 0, 0), (2, 1, 640, True, 500, 0),
               (2, 300, 37, False, 0, 0), (2, 128, 128, True, 0, 40)]


def _qkv(b, sq, sk, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, 4, D)).astype(np.float32)
    k, v = (rng.standard_normal((b, sk, 4, D)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _lse_qkv(b, sq, sk, q_off, k_off):
    return _qkv(b, sq, sk, seed=sq + sk + q_off + k_off)


def _jax_lse_ref(b, sq, sk, causal, q_off, k_off, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    out = jax_flash_attention_with_lse(
        *(jnp.asarray(x, jdt) for x in _lse_qkv(b, sq, sk, q_off, k_off)),
        causal=causal, q_offset=q_off, k_offset=k_off, block_q=64,
        block_k=64, interpret=True)
    return [np.asarray(x, np.float32) for x in out]


def _jax_flash_ref(b, sq, sk, causal):
    q, k, v = _qkv(b, sq, sk, seed=7 * sq + sk)
    return np.asarray(jax_flash_attention(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal, block_q=64,
        block_k=64, interpret=True))


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX side of every case, by test and parameters."""
    jobs = {("lse", *c, dtype): functools.partial(_jax_lse_ref, *c, dtype)
            for c in FLASH_CASES for dtype in ("float32", "bfloat16")}
    jobs.update({("flash", *c[:4]): functools.partial(_jax_flash_ref, *c[:4])
                 for c in FLASH_CASES if c[4] == c[5] == 0})
    for cache in ("float32", "bfloat16", "int8"):
        jobs[("decode", cache)] = functools.partial(_jax_decode_ref, cache)
        jobs[("stats", cache)] = functools.partial(_jax_stats_ref, cache)
    jobs.update({("grads", *c): functools.partial(_jax_grads_ref, *c)
                 for c in GRAD_CASES})
    with ThreadPoolExecutor(4) as pool:
        futures = {key: pool.submit(job) for key, job in jobs.items()}
        return {key: f.result() for key, f in futures.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,causal,q_off,k_off", FLASH_CASES)
def test_flash_with_lse_at_head_dim_32_matches_jax(jax_refs, b, sq, sk,
                                                   causal, q_off, k_off,
                                                   dtype):
    q, k, v = _lse_qkv(b, sq, sk, q_off, k_off)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref_out, ref_lse = jax_refs[("lse", b, sq, sk, causal, q_off, k_off,
                                 dtype)]
    out, lse = flash_attention_with_lse(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), causal, None,
        q_off, k_off)
    assert out.dtype == tdt and out.shape == (b, sq, 4, D)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(out.float().numpy(), ref_out, **tol)
    # lse is f32 in both packages; at bf16 the inputs' one rounding
    # moves it by the output's limit at most
    np.testing.assert_allclose(lse.numpy(), ref_lse, **tol)
    if k_off > q_off:
        assert (lse[:, :k_off - q_off] == NEG_INF).all()
        assert torch.count_nonzero(out[:, :k_off - q_off]) == 0


@pytest.mark.parametrize("b,sq,sk,causal,q_off,k_off",
                         [c for c in FLASH_CASES if c[4] == c[5] == 0])
def test_flash_at_head_dim_32_matches_jax(jax_refs, b, sq, sk, causal, q_off,
                                          k_off):
    q, k, v = _qkv(b, sq, sk, seed=7 * sq + sk)
    ref = jax_refs[("flash", b, sq, sk, causal)]
    got = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                          causal=causal)
    np.testing.assert_allclose(got.numpy(), ref, **F32_TOL)


def _decode_inputs(b, length, seed):
    """The engine's mask layout at head dim 32: per-row prompt slots, the
    pad hole up to the bucket, decode slots after it; the last row fully
    masked."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 8, D)).astype(np.float32)
    k, v = (rng.standard_normal((b, length, 8, D)).astype(np.float32)
            for _ in range(2))
    bucket = length - 64
    true_len = rng.integers(1, bucket + 1, size=b)
    slots = np.arange(length)[None]
    visible = (slots < true_len[:, None]) | (slots >= bucket)
    visible[-1] = False
    return q, k, v, visible


def _jax_decode_args(cache, q, k, v, visible):
    """(JAX args, JAX kwargs) for one cache layout."""
    jvis = jnp.asarray(visible)
    if cache == "int8":
        jk, jks = jax_quantize_kv(jnp.asarray(k))
        jv, jvs = jax_quantize_kv(jnp.asarray(v))
        return (jnp.asarray(q), jk, jv, jvis), dict(k_scale=jks, v_scale=jvs)
    jdt = jnp.bfloat16 if cache == "bfloat16" else jnp.float32
    return tuple(jnp.asarray(x, jdt) for x in (q, k, v)) + (jvis,), {}


def _torch_decode_args(cache, q, k, v, visible):
    """(port args, port kwargs) for one cache layout."""
    tvis = torch.from_numpy(visible)
    if cache == "int8":
        (tk, tks), (tv, tvs) = (quantize_kv(torch.from_numpy(x))
                                for x in (k, v))
        return ((torch.from_numpy(q), tk, tv, tvis),
                dict(k_scale=tks, v_scale=tvs))
    tdt = torch.bfloat16 if cache == "bfloat16" else torch.float32
    return (tuple(torch.from_numpy(x).to(tdt) for x in (q, k, v)) + (tvis,),
            {})


def _jax_decode_ref(cache, b=4, length=192):
    jargs, jkw = _jax_decode_args(cache, *_decode_inputs(b, length,
                                                         seed=length + b))
    return np.asarray(jax_fused(*jargs, block_k=64, interpret=True, **jkw))


def _jax_stats_ref(cache):
    jargs, jkw = _jax_decode_args(cache, *_decode_inputs(3, 192, seed=11))
    return [np.array(x) for x in jax_fused_stats(
        *jargs, block_k=64, interpret=True, **jkw)]


@pytest.mark.parametrize("cache", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("b,length", [(4, 192)])
def test_decode_at_head_dim_32_matches_jax(jax_refs, b, length, cache):
    q, k, v, visible = _decode_inputs(b, length, seed=length + b)
    targs, tkw = _torch_decode_args(cache, q, k, v, visible)
    ref = jax_refs[("decode", cache)]
    got = fused_single_query_attention(*targs, **tkw)
    assert got.dtype == torch.float32 and got.shape == (b, 8, D)
    np.testing.assert_allclose(got.numpy(), ref, **F32_TOL)
    assert torch.count_nonzero(got[-1]) == 0


@pytest.mark.parametrize("cache", ["float32", "bfloat16", "int8"])
def test_decode_stats_at_head_dim_32_matches_jax(jax_refs, cache):
    q, k, v, visible = _decode_inputs(3, 192, seed=11)
    targs, tkw = _torch_decode_args(cache, q, k, v, visible)
    ref = [torch.from_numpy(x) for x in jax_refs[("stats", cache)]]
    acc, m, l = fused_single_query_attention_stats(*targs, **tkw)
    r_acc, r_m, r_l = ref
    assert (acc - r_acc).abs().max() <= 1e-5 * r_acc.abs().max()
    assert (l - r_l).abs().max() <= 1e-5 * r_l.abs().max()
    seen = torch.from_numpy(visible).any(dim=1)
    assert (m[seen] - r_m[seen]).abs().max() <= 1e-5 * r_m[seen].abs().max()
    assert (m[-1] == NEG_INF).all() and (l[-1] == 0).all()
    assert torch.count_nonzero(acc[-1]) == 0


# (causal, q_offset, k_offset): one 64-block diagonal, a q/k shift, rows
# that see no key
GRAD_CASES = [(True, 0, 0), (True, 64, 0), (False, 0, 0), (True, 0, 40)]


def block_grad_inputs(d, seed, b=2, sq=128, sk=128, h=4):
    """q, k, v, dout and the forward's lse and delta (the port's plain
    forward) at head dim d, from numpy."""
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, sq, h, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, sk, h, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def _grad_stats(causal, q_off, k_off):
    """The inputs of a GRAD_CASES case as tensors, and the lse and delta
    of the port's plain forward."""
    q, k, v, do = block_grad_inputs(D, seed=q_off + k_off + causal)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = flash_attention_with_lse(tq, tk, tv, causal, None, q_off,
                                        k_off)
    return (tq, tk, tv, tdo), lse, (tdo * out).sum(-1)


def _jax_grads_ref(causal, q_off, k_off):
    inputs, lse, delta = _grad_stats(causal, q_off, k_off)
    ref = jax_flash_backward(*(jnp.asarray(x.numpy()) for x in inputs),
                             jnp.asarray(lse.numpy()),
                             jnp.asarray(delta.numpy()), causal, D ** -0.5,
                             64, 64, True, q_off, k_off)
    return [np.asarray(r) for r in ref]


@pytest.mark.parametrize("causal,q_off,k_off", GRAD_CASES)
def test_block_grads_at_head_dim_32_match_jax_backward(jax_refs, causal,
                                                       q_off, k_off):
    """K2 and K3's function (`flash_block_grads`, the plain version on CPU
    tensors) against the JAX `_flash_backward`, whose dQ and dK/dV Pallas
    kernels run in interpret mode, from the same lse and delta."""
    (tq, tk, tv, tdo), lse, delta = _grad_stats(causal, q_off, k_off)
    scale = D ** -0.5
    got = flash_block_grads(tq, tk, tv, tdo, lse, delta, causal, scale,
                            q_off, k_off)
    ref = jax_refs[("grads", causal, q_off, k_off)]
    for g, r in zip(got, ref):
        assert g.shape == (2, 128, 4, D)
        np.testing.assert_allclose(g.numpy(), r, **GRAD_TOL)
    if k_off > q_off:
        assert torch.count_nonzero(got[0][:, :k_off - q_off]) == 0


@pytest.mark.parametrize("d", [24, 256])
def test_kernels_refuse_an_unsupported_head_dim_naming_the_set(d):
    """Every kernel wrapper raises ValueError naming the head dims it
    takes, on any tensor that is not on the CPU (here `meta` tensors),
    before a launch is counted; on CPU tensors the plain versions take
    any head dim as before."""
    shape = (1, 64, 2, d)
    q, k, v, do = (torch.empty(shape, device="meta") for _ in range(4))
    lse, delta = (torch.empty((1, 64, 2), device="meta") for _ in range(2))
    cache = torch.empty((1, 64, 2, d), device="meta")
    visible = torch.empty((1, 64), dtype=torch.bool, device="meta")
    counted = (flash_attention, flash_attention_with_lse, flash_bwd_dq,
               flash_bwd_dkv, fused_single_query_attention,
               fused_single_query_attention_stats)
    before = [fn.launches for fn in counted]
    calls = [lambda: flash_attention(q, k, v, causal=True),
             lambda: flash_attention_with_lse(q, k, v, True),
             lambda: flash_block_grads(q, k, v, do, lse, delta, True, 0.1)]
    calls += [lambda fn=fn: fn(q, k, v, do, lse, delta, True, 0.1)
              for fn in (flash_bwd_dq, flash_bwd_dkv)]
    calls += [lambda fn=fn: fn(q[:, 0], cache, cache, visible)
              for fn in (fused_single_query_attention,
                         fused_single_query_attention_stats)]
    for call in calls:
        with pytest.raises(ValueError, match=r"\(8, 16, 32, 64, 128\)"):
            call()
    assert [fn.launches for fn in counted] == before
    cpu = [torch.randn(shape) for _ in range(4)]
    stats = [torch.zeros((1, 64, 2)) for _ in range(2)]
    dq = flash_bwd_dq(*cpu, *stats, True, d ** -0.5)
    assert dq.shape == shape and torch.isfinite(dq).all()
