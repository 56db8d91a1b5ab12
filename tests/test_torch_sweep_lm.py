"""LM populations of the port (`mmlspark_tpu_torch/train/sweep.py`) on the
CPU: the flash operator under `torch.func` (`ops/flash_attention.py`,
K1[lse], K2 and K3 folded over the members) and a population of the
TransformerLM with flash attention, held to the JAX package's
`PopulationTrainer` from the same member inits (the port's, carried
into the JAX population) (the MoE population:
tests/test_torch_sweep_moe.py, which imports this file's helpers).

The JAX references run with dense attention: the JAX flash kernel
computes the same function (its own tests hold it to the dense one) and
its interpret mode costs ~10 s a fit on the CPU; the port's flash
population is also held to its own dense population.

Bounds (f32, 2 layers, d_model 32, 4 heads, 2 Adam steps a member):

  * the flash operator under `vmap(grad_and_value(...))` equals a loop
    over the members, values and gradients, bit for bit; the members
    reach the kernels' functions once a call (the fold);
  * member losses within 1e-5 relative of the JAX population's; in
    every leaf all but 0.1% of the weights within 1e-4 of its max |w|,
    none further than 2 x lr, and the leaf within 1e-4 in Frobenius norm
    (Adam scales f32 round-off in a near-zero gradient to part of a step:
    one entry of 4096 of a `mlp_down` kernel parts by 1.7e-4 of the
    leaf's max at rate 0.001; the key third of each qkv bias, whose true
    gradient is zero, left out);
  * the flash population within 1e-6 of the port's dense one; its
    state scored through K1 (no grad, folded) within 1e-5 of the same
    state scored densely.
"""

import importlib

import jax
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from mmlspark_tpu.parallel.bridge import unstack_member as jax_unstack
from mmlspark_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from mmlspark_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mmlspark_tpu.train import PopulationTrainer as JaxPopulationTrainer
from mmlspark_tpu.train import TrainerConfig as JaxTrainerConfig
from mmlspark_tpu_torch.train import PopulationTrainer, TrainerConfig

fa = importlib.import_module("mmlspark_tpu_torch.ops.flash_attention")

LM = {"vocab_size": 64, "d_model": 32, "n_heads": 4, "n_layers": 2,
      "max_len": 16, "dtype": "float32"}
RATES = (0.01, 0.003, 0.001)
FIT = dict(architecture="TransformerLM", optimizer="adam",
           learning_rate=0.01, epochs=1, batch_size=4, seed=0,
           numerics_cadence=0, aux_loss_weight=0.01)


def _members(rates):
    return [{"learning_rate": r} for r in rates]


def _tokens(n=8, seq=16, seed=5):
    toks = np.random.default_rng(seed).integers(0, 64, (n, seq)).astype(
        np.int32)
    return toks, np.roll(toks, -1, axis=1)


def port_inits(model_config, rates) -> list:
    """The port's seeded init of each member (numpy, no flax init)."""
    pt = PopulationTrainer(TrainerConfig(model_config=dict(model_config),
                                         **FIT), _members(rates),
                           device="cpu")
    return [pt.member_init_variables(k, (1, 16))
            for k in range(len(rates))]


def jax_population(model_config, rates, mesh_spec=None):
    """The members' inits (`port_inits`) and the JAX population's (member
    losses, each member's parameters) from them: the JAX trainer's own
    init of member k is replaced by the port's."""
    mesh_spec = mesh_spec or JaxMeshSpec(data=1)
    n = mesh_spec.data * mesh_spec.model
    inits = port_inits(model_config, rates)
    pt = JaxPopulationTrainer(JaxTrainerConfig(
        model_config=dict(model_config), **FIT), _members(rates),
        mesh=jax_make_mesh(mesh_spec, devices=jax.devices()[:n]))
    pt.member_init_variables = lambda k, *_, **__: inits[k]
    result = pt.fit_arrays(*_tokens())
    return inits, result.member_loss, [
        jax.tree_util.tree_map(np.asarray, jax_unstack(
            result.state.params, k)) for k in range(len(rates))]


@pytest.fixture(scope="module")
def jax_ref():
    return jax_population(LM, RATES)


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def check_leaves(got, want):
    """Each leaf of `got` against `want` (module docstring's bounds)."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    d = LM["d_model"]
    for name, w in want.items():
        g = got[name]
        if name.endswith("qkv/bias"):
            g, w = np.delete(g, np.s_[d:2 * d]), np.delete(w, np.s_[d:2 * d])
        diff = np.abs(g - w)
        assert diff.max() <= 2 * FIT["learning_rate"], name
        assert (diff > 1e-4 * np.abs(w).max()).mean() <= 1e-3, name
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w), name


# ------------------------------------------------ the operator, folded ---

def _qkv(n=3, b=2, s=12, h=2, d=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((n, b, s, h, d), generator=g) for _ in range(4)]


def test_flash_operator_under_vmap_of_grad_equals_a_member_loop(
        monkeypatch):
    """vmap(grad_and_value) over 3 members: each member's loss and
    gradients equal its own call's bit for bit, and the forward and
    backward each run once for all members, at the folded shape."""
    q, k, v, w = _qkv()
    calls = {"fwd": [], "bwd": []}
    fwd, bwd = fa.flash_attention_with_lse, fa.flash_block_grads

    def count_fwd(q_, *a, **kw):
        calls["fwd"].append(tuple(q_.shape))
        return fwd(q_, *a, **kw)

    def count_bwd(q_, *a, **kw):
        calls["bwd"].append(tuple(q_.shape))
        return bwd(q_, *a, **kw)

    def loss(q, k, v, w):
        return (fa.flash_attention(q, k, v, causal=True) * w).sum()

    monkeypatch.setattr(fa, "flash_attention_with_lse", count_fwd)
    monkeypatch.setattr(fa, "flash_block_grads", count_bwd)
    grads, values = vmap(grad_and_value(loss, argnums=(0, 1, 2)))(q, k, v,
                                                                   w)
    assert calls == {"fwd": [(6, 12, 2, 8)], "bwd": [(6, 12, 2, 8)]}
    monkeypatch.setattr(fa, "flash_attention_with_lse", fwd)
    monkeypatch.setattr(fa, "flash_block_grads", bwd)
    for m in range(q.shape[0]):
        leaves = [t[m].clone().requires_grad_() for t in (q, k, v)]
        value = loss(*leaves, w[m])
        value.backward()
        assert torch.equal(values[m], value.detach())
        for got, leaf in zip(grads, leaves):
            assert torch.equal(got[m], leaf.grad)


def test_flash_forward_without_grad_folds_the_members(monkeypatch):
    """The no-grad forward (K1 alone) under vmap: one call at the folded
    shape, each member's output as its own call's."""
    q, k, v, _ = _qkv(n=2, seed=1)
    seen = []
    plain = fa.flash_attention_plain

    def count(q_, *a, **kw):
        seen.append(tuple(q_.shape))
        return plain(q_, *a, **kw)

    monkeypatch.setattr(fa, "flash_attention_plain", count)
    with torch.no_grad():
        out = vmap(lambda a, b, c: fa.flash_attention(a, b, c, causal=True)
                   )(q, k, v)
    assert seen == [(4, 12, 2, 8)]
    monkeypatch.setattr(fa, "flash_attention_plain", plain)
    for m in range(2):
        assert torch.equal(out[m], fa.flash_attention(q[m], k[m], v[m],
                                                      causal=True))


# -------------------------------------------------------- populations ---

def port_population(model_config, rates, inits, **kw):
    pt = PopulationTrainer(TrainerConfig(model_config=dict(model_config),
                                         **FIT), _members(rates),
                           device="cpu", **kw)
    x, y = _tokens()
    return pt, pt.fit_arrays(x, y, member_variables=inits)


def test_flash_population_matches_the_jax_population(jax_ref):
    inits, jloss, jparams = jax_ref
    pt, result = port_population({**LM, "attn_impl": "flash"}, RATES,
                                 inits)
    np.testing.assert_allclose(result.member_loss, jloss, rtol=1e-5)
    for k in range(len(RATES)):
        check_leaves(pt.member_variables(result.state, k)["params"],
                     jparams[k])
    dense_pt, dense = port_population(LM, RATES, inits)
    np.testing.assert_allclose(result.member_loss, dense.member_loss,
                               rtol=1e-6)
    x, _ = _tokens()
    # the same state scored through K1 alone and densely
    np.testing.assert_allclose(pt.score_population(result.state, x),
                               dense_pt.score_population(result.state, x),
                               rtol=0, atol=1e-5)
