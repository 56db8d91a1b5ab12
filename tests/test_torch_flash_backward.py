"""The port's flash-attention backward and log-sum-exp forward against the
JAX package, on the CPU.

The JAX side runs as its own tests run it (tests/test_flash_attention.py):
`jax.grad` through `flash_attention(..., interpret=True, block_q=64,
block_k=64)`, which reaches the Pallas dQ and dK/dV kernels in interpret
mode, and `flash_attention_with_lse` / `flash_block_grads` with
`interpret=True`.  Each JAX function is jitted once, with the offsets as
traced arguments, so the cases of one shape share one compiled program;
the module fixture `jax_refs` computes every case's JAX side up front,
a few programs compiling at once on threads (XLA compiles outside the
GIL).  The port's wrappers run their plain versions on CPU
tensors, through the same `torch.autograd.Function` the card uses.  Inputs
are numpy arrays from a seeded generator, handed to both.

Tolerances: f32 paths differ only in summation order (atol 1e-5; 1e-4
for the block gradients at head dims 64 and 128, whose dot products sum
2-4x more terms and whose entries reach |x| ~ 10, so the round-off of
another order reaches 5e-5); bf16 gradients are one bf16 rounding of O(1)
values apart (2e-2).  The kernels
themselves are held against the plain versions on the card
(tests/test_torch_package.py, chip_smoke.py).
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
    flash_attention_with_lse as jax_flash_attention_with_lse,
    flash_block_grads as jax_flash_block_grads)
from mmlspark_tpu_torch.ops.attention import NEG_INF
from mmlspark_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_with_lse, flash_block_grads,
    flash_bwd_dkv, flash_bwd_dq)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
WIDE_F32_TOL = dict(rtol=1e-5, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
BLOCKS = dict(block_q=64, block_k=64, interpret=True)

AUTOGRAD_CASES = [(True, 128, 128, "float32"), (False, 128, 192, "float32"),
                  (True, 128, 128, "bfloat16"),
                  (False, 128, 192, "bfloat16")]
LSE_CASES = [(0, 0), (64, 0), (0, 40)]
BLOCK_CASES = [
    (True, 128, 0, 2, 128, 128, 32), (True, 64, 64, 2, 128, 128, 32),
    (False, 0, 0, 2, 128, 128, 32),
    # the card kernels' head dims: JAX through the Pallas kernels
    (True, 0, 100, 2, 128, 128, 64), (False, 0, 0, 1, 128, 192, 64),
    (True, 64, 0, 1, 128, 128, 128), (True, 0, 100, 1, 128, 128, 128),
    # lengths off the 64-row blocks: JAX through its dense fallback
    (True, 0, 0, 2, 129, 129, 128), (False, 0, 0, 1, 300, 37, 64),
    (True, 0, 0, 3, 200, 200, 64), (True, 500, 0, 1, 1, 640, 128)]
RAGGED_CASES = [True, False]


def _arrays(shape_q, shape_k, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape_q).astype(np.float32)
    k, v = (rng.standard_normal(shape_k).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal(shape_q).astype(np.float32)
    return q, k, v, g


def _autograd_arrays(sq, sk):
    return _arrays((1, sq, 2, 32), (1, sk, 2, 32), seed=sq + sk)


def _lse_arrays():
    return _arrays((2, 128, 4, 32), (2, 128, 4, 32), seed=5)[:3]


def _block_arrays(b, sq, sk, d):
    q, k, v, g = _arrays((b, sq, 4, d), (b, sk, 4, d), seed=9)
    rng = np.random.default_rng(10)
    lse = rng.standard_normal((b, sq, 4)).astype(np.float32) + 3.0
    if sq > 5:
        lse[:, 5] = NEG_INF      # a row that saw no key anywhere
    delta = rng.standard_normal((b, sq, 4)).astype(np.float32)
    return q, k, v, g, lse, delta


def _ragged_arrays():
    return _arrays((1, 200, 2, 32), (1, 200, 2, 32), seed=11)


@functools.partial(jax.jit, static_argnames=("causal",))
def _jax_grad_fn(q, k, v, g, causal):
    def loss(q_, k_, v_):
        out = jax_flash_attention(q_, k_, v_, causal=causal, **BLOCKS)
        return jnp.sum(out.astype(jnp.float32) * g.astype(jnp.float32))
    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


_jax_with_lse = jax.jit(jax_flash_attention_with_lse,
                        static_argnames=("causal", "block_q", "block_k",
                                         "interpret"))
_jax_block_grads = jax.jit(jax_flash_block_grads, static_argnums=(6, 7),
                           static_argnames=("block_q", "block_k",
                                            "interpret"))


def _jax_grads(q, k, v, g, causal, dtype):
    args = [jnp.asarray(a, dtype) for a in (q, k, v, g)]
    return [np.asarray(x, np.float32)
            for x in _jax_grad_fn(*args, causal=causal)]


def _jax_lse_ref(q_off, k_off):
    out = _jax_with_lse(*(jnp.asarray(a) for a in _lse_arrays()),
                        causal=True, q_offset=q_off, k_offset=k_off,
                        **BLOCKS)
    return [np.asarray(x) for x in out]


def _jax_block_ref(causal, q_off, k_off, b, sq, sk, d):
    out = _jax_block_grads(
        *(jnp.asarray(a) for a in _block_arrays(b, sq, sk, d)), causal,
        d ** -0.5, q_offset=q_off, k_offset=k_off, **BLOCKS)
    return [np.asarray(x) for x in out]


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX side of every case, by test and parameters."""
    jobs = {("autograd", *c): functools.partial(
        _jax_grads, *_autograd_arrays(c[1], c[2]), c[0],
        jnp.bfloat16 if c[3] == "bfloat16" else jnp.float32)
        for c in AUTOGRAD_CASES}
    jobs.update({("lse", *c): functools.partial(_jax_lse_ref, *c)
                 for c in LSE_CASES})
    jobs.update({("block", *c): functools.partial(_jax_block_ref, *c)
                 for c in BLOCK_CASES})
    jobs.update({("ragged", c): functools.partial(
        _jax_grads, *_ragged_arrays(), c, jnp.float32) for c in RAGGED_CASES})
    with ThreadPoolExecutor(4) as pool:
        futures = {key: pool.submit(job) for key, job in jobs.items()}
        return {key: f.result() for key, f in futures.items()}


def _torch_grads(q, k, v, g, causal, dtype):
    args = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*args, causal=causal)
    grads = torch.autograd.grad(out, args, torch.from_numpy(g).to(dtype))
    assert all(t.dtype == dtype for t in grads)
    return [t.float().numpy() for t in grads]


@pytest.mark.parametrize("causal,sq,sk,dtype", AUTOGRAD_CASES)
def test_autograd_matches_jax_flash_grads(jax_refs, causal, sq, sk, dtype):
    """Gradients through the port's `_FlashAttention` equal `jax.grad`
    through the Pallas backward (dQ, dK/dV kernels in interpret mode)."""
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = jax_refs["autograd", causal, sq, sk, dtype]
    got = _torch_grads(*_autograd_arrays(sq, sk), causal, tdt)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(
            a, b, **(BF16_TOL if dtype == "bfloat16" else F32_TOL))


@pytest.mark.parametrize("q_off,k_off", LSE_CASES)
def test_with_lse_matches_jax_with_offsets(jax_refs, q_off, k_off):
    """out and lse with global offsets; with k_off > q_off the first
    k_off - q_off rows see no key: zero output and lse NEG_INF."""
    ref_out, ref_lse = jax_refs["lse", q_off, k_off]
    out, lse = flash_attention_with_lse(
        *(torch.from_numpy(a) for a in _lse_arrays()), causal=True,
        q_offset=q_off, k_offset=k_off)
    assert lse.shape == (2, 128, 4) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref_out, **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse, **F32_TOL)
    if k_off > q_off:
        masked = k_off - q_off
        assert (lse[:, :masked] == NEG_INF).all()
        assert torch.count_nonzero(out[:, :masked]) == 0


@pytest.mark.parametrize("causal,q_off,k_off,b,sq,sk,d", BLOCK_CASES)
def test_block_grads_match_jax_with_offsets(jax_refs, causal, q_off, k_off,
                                            b, sq, sk, d):
    """(dq, dk, dv) of one K/V block against global lse/delta: the ring
    backward's building block."""
    ref = jax_refs["block", causal, q_off, k_off, b, sq, sk, d]
    scale = d ** -0.5
    tensors = [torch.from_numpy(a) for a in _block_arrays(b, sq, sk, d)]
    got = flash_block_grads(*tensors, causal, scale, q_off, k_off)
    tol = F32_TOL if d == 32 else WIDE_F32_TOL
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b, **tol)
    if sq > 5:
        assert torch.count_nonzero(got[0][:, 5]) == 0
    # the K2 / K3 wrappers split the same function on the CPU
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    np.testing.assert_array_equal(
        flash_bwd_dq(*tensors, causal, scale, q_off, k_off).numpy(),
        got[0].numpy())
    for a, b in zip(flash_bwd_dkv(*tensors, causal, scale, q_off, k_off),
                    got[1:]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == before


@pytest.mark.parametrize("causal", RAGGED_CASES)
def test_ragged_length_matches_jax_dense_fallback(jax_refs, causal):
    """S = 200 does not tile 64-row blocks: the JAX wrapper falls back to
    the dense VJP, the port's plain path computes the same function (its
    kernels mask the ragged tile on the card)."""
    ref = jax_refs["ragged", causal]
    got = _torch_grads(*_ragged_arrays(), causal, torch.float32)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, **F32_TOL)
