"""Populations over the rest of the mesh (`mmlspark_tpu_torch/train/sweep.py`)
on the CPU, against the JAX package's `PopulationTrainer` on its own mesh
of virtual devices, from the same member inits (the port's, carried into
the JAX population):

  * an MLP population over data 2 x model 2: each member's stacked
    leaves split by the Trainer's placement behind the population axis,
    the members' vmap run over each data row's model group (the
    TransformerLM's, with K1[lse], K2 and K3 per model shard:
    tests/test_torch_sweep_mesh_lm.py);
  * a ResNet population with training BatchNorm over data 2 (the repo's
    ConvNet has no BatchNorm layer): the shards' vmapped forwards in
    lockstep, their statistics the global batch's
    (tests/test_torch_sweep_bn.py);
  * a culled member frozen byte for byte on the mesh; a population of 1
    equal to the port's plain Trainer on the same mesh.

Bounds: member losses within 1e-5 relative of the JAX population's and
within 1e-6 of the port's one-device population's; leaves within 1e-4
of each leaf's max |w| of the JAX population's, in the reference's
shapes (the whole leaves; the bundle records the mesh); scores within
1e-5 of the one-device population's."""

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.parallel.bridge import unstack_member as jax_unstack
from mmlspark_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from mmlspark_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mmlspark_tpu.train import PopulationTrainer as JaxPopulationTrainer
from mmlspark_tpu.train import TrainerConfig as JaxTrainerConfig
from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from mmlspark_tpu_torch.train import (PopulationTrainer, Trainer,
                                      TrainerConfig)

RATES = (0.02, 0.005, 0.001)
MLP_FIT = dict(architecture="MLPClassifier",
               model_config={"hidden_sizes": [16], "num_classes": 3,
                             "dtype": "float32"},
               optimizer="adam", learning_rate=0.01, epochs=2,
               batch_size=16, loss="softmax_xent", seed=7,
               shuffle_each_epoch=True, numerics_cadence=0)


def members(rates=RATES):
    return [{"learning_rate": r} for r in rates]


def mlp_data(n=48, d=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, 3)).astype(np.float32)
    return x, np.argmax(x @ w, axis=1).astype(np.int32)


def host_mesh(data, model=1):
    return make_mesh(MeshSpec(data=data, model=model),
                     [torch.device("cpu")] * (data * model))


def port_inits(fit, rates, shape) -> list:
    pt = PopulationTrainer(TrainerConfig(**fit), members(rates),
                           device="cpu")
    return [pt.member_init_variables(k, shape) for k in range(len(rates))]


def jax_population(fit, rates, inits, data, model, x, y, **kw):
    """The JAX population on a (data, model) mesh of virtual devices, its
    members started from `inits`: (member losses, active mask, each
    member's variables)."""
    pt = JaxPopulationTrainer(
        JaxTrainerConfig(**fit), members(rates),
        mesh=jax_make_mesh(JaxMeshSpec(data=data, model=model),
                           devices=jax.devices()[:data * model]), **kw)
    pt.member_init_variables = lambda k, *_, **__: inits[k]
    result = pt.fit_arrays(x, y)
    variables = [{"params": jax_unstack(result.state.params, k)}
                 for k in range(len(rates))]
    if result.state.batch_stats:
        for k, v in enumerate(variables):
            v["batch_stats"] = jax_unstack(result.state.batch_stats, k)
    return result.member_loss, result.active, [
        jax.tree_util.tree_map(np.asarray, v) for v in variables]


MLP_INITS = port_inits(MLP_FIT, RATES, (1, 8))


@pytest.fixture(scope="module")
def jax_mlp():
    return jax_population(MLP_FIT, RATES, MLP_INITS, 2, 2, *mlp_data())


def _flat(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_mlp_population_over_data_and_model(jax_mlp):
    jloss, _, jvars = jax_mlp
    x, y = mlp_data()
    pt = PopulationTrainer(TrainerConfig(**MLP_FIT), members(),
                           mesh=host_mesh(2, 2))
    result = pt.fit_arrays(x, y, member_variables=MLP_INITS)
    # the placement splits the hidden layer's kernel over the model axis
    assert pt.param_splits == {"dense0.weight": (0, 1)}
    one = PopulationTrainer(TrainerConfig(**MLP_FIT), members(),
                            device="cpu").fit_arrays(
        x, y, member_variables=MLP_INITS)
    np.testing.assert_allclose(result.member_loss, jloss, rtol=1e-5)
    np.testing.assert_allclose(result.member_loss, one.member_loss,
                               rtol=1e-6)
    for k in range(len(RATES)):
        got = dict(_flat(pt.member_variables(result.state, k)["params"]))
        for name, w in _flat(jvars[k]["params"]):
            assert got[name].shape == w.shape, name
            assert np.abs(got[name] - w).max() <= \
                1e-4 * np.abs(w).max(), name
    bundle = result.member_bundle(1)
    assert bundle.metadata["partition"]["mesh"] == {"data": 2, "model": 2}
    np.testing.assert_allclose(pt.score_population(result.state, x),
                               one._trainer.score_population(one.state, x),
                               rtol=0, atol=1e-5)


def test_a_culled_member_is_frozen_on_the_mesh():
    """A rung over the (2, 2) mesh culls the trailing members; their
    parameters and moments keep their bytes from the rung on."""
    x, y = mlp_data()
    rates = (0.02, 0.01, 1e-5, 1e-6)
    inits = port_inits(MLP_FIT, rates, (1, 8))
    fit = dict(MLP_FIT, epochs=4)
    pt = PopulationTrainer(TrainerConfig(**fit), members(rates),
                           mesh=host_mesh(2, 2), halving_rungs=1,
                           cull_fraction=0.5)
    result = pt.fit_arrays(x, y, member_variables=inits)
    at_rung = PopulationTrainer(TrainerConfig(**MLP_FIT), members(rates),
                                mesh=host_mesh(2, 2)).fit_arrays(
        x, y, member_variables=inits)
    culled = [k for k in range(4) if result.active[k] == 0.0]
    assert len(culled) == 2
    for k in range(4):
        now = dict(_flat(pt.member_variables(result.state, k)))
        then = dict(_flat(pt.member_variables(at_rung.state, k)))
        same = all(np.array_equal(now[n], then[n]) for n in now)
        assert same == (k in culled), k
    for moment in ("mu", "nu"):
        for now, then in zip(result.state.opt_state[moment],
                             at_rung.state.opt_state[moment]):
            for k in culled:
                assert torch.equal(now[k], then[k])


def test_population_of_one_equals_the_plain_trainer_on_the_mesh():
    """One member over the (2, 2) mesh: the port's plain Trainer on the
    same mesh from the member's init (the same placement and reduce
    order), losses and leaves within 1e-6 of each leaf's max |w|."""
    x, y = mlp_data()
    cfg = TrainerConfig(**MLP_FIT)
    pt = PopulationTrainer(cfg, 1, mesh=host_mesh(2, 2))
    init = pt.member_init_bundle(0, (1, 8))
    result = pt.fit_arrays(x, y)
    trainer = Trainer(cfg, mesh=host_mesh(2, 2))
    bundle = trainer.fit_arrays(x, y, initial_bundle=init)
    np.testing.assert_allclose([h["member_loss"][0] for h in pt.history],
                               [h["loss"] for h in trainer.history],
                               rtol=1e-6)
    got = dict(_flat(pt.member_variables(result.state, 0)["params"]))
    for name, w in _flat(bundle.variables["params"]):
        assert np.abs(got[name] - w).max() <= 1e-6 * np.abs(w).max(), name
