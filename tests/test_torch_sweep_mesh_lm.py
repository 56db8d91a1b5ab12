"""A TransformerLM population over data 2 x model 2 on the CPU
(`mmlspark_tpu_torch/train/sweep.py`): the members' vmap over each data
row's model group, the Megatron split inside the vmapped forward, the
flash operator once per (data row, model shard, layer) for every member
at the folded shape.  Held to the JAX package's `PopulationTrainer` on
its (2, 2) mesh of virtual devices (dense attention: the JAX flash
kernel's interpret mode costs ~10 s a fit; tests/test_torch_sweep_lm.py)
and to the port's one-device population.

Bounds: member losses within 1e-5 relative of the JAX population's and
within 1e-6 of the one-device population's; leaves as
`test_torch_sweep_lm.check_leaves` holds them; scores within 1e-5 of the
one-device population's."""

import importlib

import numpy as np
import pytest

from mmlspark_tpu_torch.train import PopulationTrainer, TrainerConfig
from test_torch_sweep_lm import LM, check_leaves
from test_torch_sweep_mesh import (RATES, host_mesh, jax_population,
                                   members, port_inits)

LM_FIT = dict(architecture="TransformerLM", model_config=dict(LM),
              optimizer="adam", learning_rate=0.01, epochs=1, batch_size=4,
              seed=0, numerics_cadence=0)
LM_INITS = port_inits(LM_FIT, RATES[:2], (1, 16))


def lm_data(n=8, seq=16, seed=5):
    toks = np.random.default_rng(seed).integers(0, 64, (n, seq)).astype(
        np.int32)
    return toks, np.roll(toks, -1, axis=1)


@pytest.fixture(scope="module")
def jax_lm():
    return jax_population(LM_FIT, RATES[:2], LM_INITS, 2, 2, *lm_data())


def test_lm_population_over_data_and_model(jax_lm, monkeypatch):
    """Flash attention per model shard on its heads: the operator runs
    once per (data row, model index, layer) for both members; the
    members' losses and leaves as the JAX population's on its (2, 2)
    mesh and as the port's one-device population's."""
    fa = importlib.import_module("mmlspark_tpu_torch.ops.flash_attention")
    jloss, _, jvars = jax_lm
    x, y = lm_data()
    fit = dict(LM_FIT, model_config={**LM, "attn_impl": "flash"})
    shapes = []
    fwd = fa.flash_attention_with_lse

    def count(q, *a, **kw):
        shapes.append(tuple(q.shape))
        return fwd(q, *a, **kw)

    monkeypatch.setattr(fa, "flash_attention_with_lse", count)
    pt = PopulationTrainer(TrainerConfig(**fit), members(RATES[:2]),
                           mesh=host_mesh(2, 2))
    result = pt.fit_arrays(x, y, member_variables=LM_INITS)
    monkeypatch.setattr(fa, "flash_attention_with_lse", fwd)
    # 2 steps x 2 data rows x 2 model shards x 2 layers, each at the
    # folded shape: 2 members x 2 rows, 16 positions, 2 of the 4 heads
    assert shapes == [(4, 16, 2, 8)] * 16
    one = PopulationTrainer(TrainerConfig(**fit), members(RATES[:2]),
                            device="cpu").fit_arrays(
        x, y, member_variables=LM_INITS)
    np.testing.assert_allclose(result.member_loss, jloss, rtol=1e-5)
    np.testing.assert_allclose(result.member_loss, one.member_loss,
                               rtol=1e-6)
    for k in range(2):
        check_leaves(pt.member_variables(result.state, k)["params"],
                     jvars[k]["params"])
    np.testing.assert_allclose(pt.score_population(result.state, x),
                               one._trainer.score_population(one.state, x),
                               rtol=0, atol=1e-5)
