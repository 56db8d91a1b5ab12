"""Head dims 8 and 16 in the port's flash kernels (K1, K1[lse], K2, K3),
on the CPU.

The repo's own small LMs use these head dims: the LM example
(examples/example_401_lm_generation.py, d_model 32 over 4 heads: 8) and
`TransformerLM`'s default widths (d_model 128 over 8 heads: 16).  K1 /
K1[lse] and K2 / K3 have instances at both on the card
(tests/test_torch_package.py holds them against their plain versions
there); here the plain versions those kernels are held to are held, at
head dims 8 and 16, against the JAX package's Pallas kernels run in
interpret mode on the same numpy inputs: K1 at the edges of the card
kernels' 64-row and 64-key tiles and with q/k offsets, and K2 and K3
(`flash_block_grads`) against the JAX `_flash_backward`.  Each JAX
function is jitted once per shape (offsets traced) and the module
fixture `jax_refs` computes every case's JAX side up front on 4 threads.
K4 and K4[stats] at these head dims are in
tests/test_torch_head_dims_decode.py, the models that run them in
tests/test_torch_head_dims_models.py.

Tolerances are those of the head-dim-32/64/128 cases: f32 differs in
summation order only (2e-5; 1e-4 absolute for block gradients, whose
entries reach |x| ~ 10); a bf16 output is one bf16 rounding apart at most
(2e-2).
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.ops.flash_attention import _flash_backward
from mmlspark_tpu.ops.flash_attention import (
    flash_attention_with_lse as jax_flash_attention_with_lse)
from mmlspark_tpu_torch.ops.attention import NEG_INF
from mmlspark_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_with_lse, flash_block_grads,
    flash_bwd_dkv, flash_bwd_dq)

HEAD_DIMS = (8, 16)
F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
GRAD_TOL = dict(rtol=1e-5, atol=1e-4)

_jax_with_lse = jax.jit(jax_flash_attention_with_lse,
                        static_argnames=("causal", "block_q", "block_k",
                                         "interpret"))
# positional (q, k, v, do, lse, delta, causal, scale, block_q, block_k,
# interpret, q_offset, k_offset): static from `causal` to `interpret`
_jax_backward = jax.jit(_flash_backward, static_argnums=(6, 7, 8, 9, 10))

# (B, Sq, Sk, causal, q_offset, k_offset): a row and a key past a 64-row
# tile, one query deep in the sequence, fewer keys than a tile, and rows
# that see no key (k_offset > q_offset) over two whole 64-blocks of the
# JAX kernel proper
FLASH_CASES = [(2, 129, 129, True, 0, 0), (2, 1, 640, True, 500, 0),
               (2, 300, 37, False, 0, 0), (2, 128, 128, True, 0, 40)]
DTYPES = ("float32", "bfloat16")
# (causal, q_offset, k_offset) of the block gradients
GRAD_CASES = [(True, 0, 0), (True, 64, 0), (False, 0, 0), (True, 0, 40)]


def _qkv(d, b, sq, sk, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, 4, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, sk, 4, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _grad_inputs(d, causal, q_off, k_off):
    """q, k, v, dout (numpy) and the forward's lse and delta (the port's
    plain forward)."""
    rng = np.random.default_rng(d + 3 * q_off + k_off + causal)
    q, k, v, do = (rng.standard_normal((2, 128, 4, d)).astype(np.float32)
                   for _ in range(4))
    out, lse = flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, None, q_off, k_off)
    delta = (torch.from_numpy(do) * out).sum(-1)
    return q, k, v, do, lse.numpy(), delta.numpy()


def _jax_flash(d, case, dtype):
    b, sq, sk, causal, q_off, k_off = case
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    out, lse = _jax_with_lse(
        *(jnp.asarray(x, jdt) for x in _qkv(d, b, sq, sk, seed=sq + sk + d)),
        causal=causal, q_offset=q_off, k_offset=k_off, block_q=64,
        block_k=64, interpret=True)
    return np.asarray(out, np.float32), np.asarray(lse)


def _jax_grads(d, causal, q_off, k_off):
    q, k, v, do, lse, delta = _grad_inputs(d, causal, q_off, k_off)
    out = _jax_backward(*(jnp.asarray(x) for x in (q, k, v, do, lse, delta)),
                        causal, d ** -0.5, 64, 64, True, q_off, k_off)
    return [np.asarray(x) for x in out]


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX side of every case, by test and parameters."""
    jobs = {("flash", d, c, dt): functools.partial(_jax_flash, d, c, dt)
            for d in HEAD_DIMS for c in FLASH_CASES for dt in DTYPES}
    jobs.update({("grads", d, *c): functools.partial(_jax_grads, d, *c)
                 for d in HEAD_DIMS for c in GRAD_CASES})
    with ThreadPoolExecutor(4) as pool:
        futures = {key: pool.submit(job) for key, job in jobs.items()}
        return {key: f.result() for key, f in futures.items()}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_at_small_head_dims_matches_jax(jax_refs, d, case, dtype):
    """K1[lse]'s function (out and lse) against the JAX kernel, and K1's
    (no lse, no offsets) equal to its first output."""
    b, sq, sk, causal, q_off, k_off = case
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tensors = [torch.from_numpy(x).to(tdt)
               for x in _qkv(d, b, sq, sk, seed=sq + sk + d)]
    out, lse = flash_attention_with_lse(*tensors, causal, None, q_off, k_off)
    ref_out, ref_lse = jax_refs["flash", d, case, dtype]
    assert out.dtype == tdt and out.shape == (b, sq, 4, d)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(out.float().numpy(), ref_out, **tol)
    np.testing.assert_allclose(lse.numpy(), ref_lse, **tol)
    if k_off > q_off:
        assert (lse[:, :k_off - q_off] == NEG_INF).all()
        assert torch.count_nonzero(out[:, :k_off - q_off]) == 0
    if q_off == k_off == 0:
        assert torch.equal(flash_attention(*tensors, causal=causal), out)




@pytest.mark.parametrize("causal,q_off,k_off", GRAD_CASES)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_block_grads_at_small_head_dims_match_jax(jax_refs, d, causal, q_off,
                                                  k_off):
    """K2 and K3's function (`flash_block_grads`; `flash_bwd_dq` and
    `flash_bwd_dkv` split it on the CPU) against the JAX `_flash_backward`,
    whose dQ and dK/dV Pallas kernels run in interpret mode."""
    arrays = _grad_inputs(d, causal, q_off, k_off)
    tensors = [torch.from_numpy(x) for x in arrays]
    scale = d ** -0.5
    got = flash_block_grads(*tensors, causal, scale, q_off, k_off)
    for g, r in zip(got, jax_refs["grads", d, causal, q_off, k_off]):
        assert g.shape == (2, 128, 4, d)
        np.testing.assert_allclose(g.numpy(), r, **GRAD_TOL)
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    assert torch.equal(flash_bwd_dq(*tensors, causal, scale, q_off, k_off),
                       got[0])
    assert all(torch.equal(a, b) for a, b in zip(
        flash_bwd_dkv(*tensors, causal, scale, q_off, k_off), got[1:]))
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == before
    if k_off > q_off:
        assert torch.count_nonzero(got[0][:, :k_off - q_off]) == 0
