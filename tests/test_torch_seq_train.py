"""Seq-parallel training on the CPU against the JAX package: the cases of
tests/test_seq_parallel.py on the port (same shapes, seeds and numpy
inputs, a data 2 x seq 4 mesh of host shards, f32).

  * `seq_parallel_attention` forward for ring, ring_flash, ulysses and
    dense, and the q/k/v gradients of ring_flash (the custom backward:
    the dQ and dK/dV block grads against the global lse and delta), ring
    (autograd through the dense fold) and ulysses, against the JAX dense
    attention's: atol 2e-5 (measured gaps 1e-6 to 4e-6; the JAX test
    holds its own ring to 2e-3).
  * `make_seq_parallel_lm_step` with each impl against the JAX step
    (its dense ring fold, the cheapest to compile; the JAX test holds its
    impls to one another) on the same weights, batch and adam: the
    losses of 4 steps to rtol 1e-5 and the weights after them to atol
    1e-5 (the key third of each qkv bias held apart, as
    tests/test_torch_train.py does: its true gradient is zero and Adam
    scales round-off there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmlspark_tpu.models.definitions import build_model as jax_build_model
from mmlspark_tpu.ops.attention import attention as jax_attention
from mmlspark_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from mmlspark_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mmlspark_tpu.parallel.ring import \
    make_seq_parallel_lm_step as jax_make_step
from mmlspark_tpu.parallel.ring import shard_tokens as jax_shard_tokens
from mmlspark_tpu_torch import TrainerConfig
from mmlspark_tpu_torch.models.bundle import params_from_jax
from mmlspark_tpu_torch.models.definitions import (TransformerLM,
                                                   init_transformer_lm_params)
from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from mmlspark_tpu_torch.parallel.ring import (make_seq_parallel_lm_step,
                                              seq_parallel_attention,
                                              shard_tokens, use_seq_mesh)
from mmlspark_tpu_torch.train.optim import Optimizer

B, S, H, D = 2, 32, 4, 8
ATOL = 2e-5
LM = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=1, max_len=S,
          dtype="float32")
STEPS = 4


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    return tuple(rng.normal(size=(B, S, H, D)).astype(np.float32)
                 for _ in range(3))


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(MeshSpec(data=2, model=1, seq=4),
                     [torch.device("cpu")] * 8)


@pytest.fixture(scope="module")
def dense_grads(qkv):
    """The JAX dense attention's output and q/k/v gradients of
    sum(out ** 2), causal and not."""
    out = {}
    for causal in (False, True):
        def loss(q_, k_, v_, causal=causal):
            return (jax_attention(q_, k_, v_, causal=causal) ** 2).sum()
        fwd = jax.jit(lambda q_, k_, v_, c=causal: jax_attention(
            q_, k_, v_, causal=c))
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*qkv)
        out[causal] = (np.asarray(fwd(*qkv)),
                       [np.asarray(g) for g in grads])
    return out


@pytest.mark.parametrize("impl", ["ring", "ring_flash", "ulysses", "dense"])
@pytest.mark.parametrize("causal", [False, True])
def test_seq_parallel_matches_dense(qkv, mesh, dense_grads, impl, causal):
    expected, _ = dense_grads[causal]
    got = seq_parallel_attention(mesh, *(torch.from_numpy(a) for a in qkv),
                                 causal=causal, impl=impl)
    np.testing.assert_allclose(got.numpy(), expected, rtol=0, atol=ATOL)


@pytest.mark.parametrize("impl", ["ring_flash", "ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_seq_parallel_gradients_match(qkv, mesh, dense_grads, impl,
                                      causal):
    """q/k/v gradients of sum(out ** 2) through each impl against the JAX
    dense attention's."""
    _, expected = dense_grads[causal]
    leaves = [torch.from_numpy(a).requires_grad_() for a in qkv]
    out = seq_parallel_attention(mesh, *leaves, causal=causal, impl=impl)
    (out ** 2).sum().backward()
    for leaf, ref in zip(leaves, expected):
        np.testing.assert_allclose(leaf.grad.numpy(), ref, rtol=0,
                                   atol=ATOL)


def test_transformer_lm_seq_parallel_forward_matches_dense(mesh):
    """Same weights: the dense forward equals the ring-flash forward
    under `use_seq_mesh`; without a mesh the seq model refuses."""
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, 32, size=(B, S)))
    dense = TransformerLM(**LM, device="cpu")
    ring = TransformerLM(**LM, attn_impl="ring_flash", seq_axis="seq",
                         device="cpu")
    ring.load_state_dict(dense.state_dict())
    with torch.no_grad(), use_seq_mesh(mesh):
        got = ring(tokens)
    torch.testing.assert_close(got, dense(tokens).detach(), rtol=0,
                               atol=5e-5)
    with pytest.raises(ValueError, match="use_seq_mesh"):
        ring(tokens)
    with pytest.raises(ValueError, match="seq_axis"):
        TransformerLM(**LM, attn_impl="ring", device="cpu")


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX seq-parallel step (ring, adam 1e-2) for STEPS steps on
    tests/test_seq_parallel.py's batch from the port's seeded init: its
    losses, its final params and its initial params."""
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 32, size=(B, S)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[:, -1] = 0.0
    jmesh = jax_make_mesh(JaxMeshSpec(data=2, model=1, seq=4))
    lm = jax_build_model("TransformerLM", {**LM, "attn_impl": "ring",
                                           "seq_axis": "seq"})
    init = init_transformer_lm_params(LM, seed=0)
    params = jax.tree_util.tree_map(jnp.asarray, init)
    tx = optax.adam(1e-2)
    opt_state = tx.init(params)
    step = jax_make_step(lm, tx, jmesh)
    args = [jax_shard_tokens(a, jmesh) for a in (tokens, targets, mask)]
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, *args)
        losses.append(float(loss))
    return (tokens, targets, mask), init, losses, jax.device_get(params)


@pytest.mark.parametrize("impl", ["ring_flash", "ring", "ulysses"])
def test_seq_parallel_lm_train_step(mesh, jax_steps, impl):
    """The port's step over the same weights and batch: the JAX step's
    losses, falling, and its weights."""
    (tokens, targets, mask), init, ref_losses, ref_params = jax_steps
    module = TransformerLM(**LM, attn_impl=impl, seq_axis="seq",
                           device="cpu")
    module.load_state_dict(params_from_jax(init["params"]))
    params = list(module.parameters())
    tx = Optimizer(TrainerConfig(optimizer="adam", learning_rate=1e-2), 1)
    opt_state = tx.init(params)
    step = make_seq_parallel_lm_step(module, tx, mesh)
    args = [shard_tokens(a, mesh) for a in (tokens, targets, mask)]
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, *args)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    want = params_from_jax(ref_params["params"])
    d = LM["d_model"]
    for name, p in module.named_parameters():
        got, ref = p.detach().numpy(), want[name].numpy()
        if name.endswith("qkv.bias"):
            got, ref = np.delete(got, np.s_[d:2 * d]), np.delete(
                ref, np.s_[d:2 * d])
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5,
                                   err_msg=name)
