"""Populations over a mesh with a seq axis
(`mmlspark_tpu_torch/train/sweep.py`) on the CPU, against the JAX
package's `PopulationTrainer` over a mesh of the same shape of virtual
devices, from the same member inits (the port's, carried into the JAX
population).  The JAX sweep cuts the batch
along 'data' only (`mmlspark_tpu/train/sweep.py:357`); the port runs each
data row once, at seq index 0:

  * an MLP population over data 2 x seq 2 and data 2 x model 2 x seq 2
    (the members' stacked leaves split behind the population axis over
    the model axis);
  * a ResNet population with training BatchNorm over data 2 x seq 2
    (tests/test_torch_seq_axis_sweep_bn.py, with these helpers): the
    lockstep counts the data shards, each member's statistics the global
    batch's (the seq replicas add nothing to the sums);
  * a flash TransformerLM population over data 2 x seq 2 (the JAX
    population attends densely: its flash kernel's interpret mode costs
    ~10 s a fit), the flash operator once per (data shard, layer) a step
    at the folded shape, and a population of 1 equal to the port's plain
    Trainer over the same mesh byte for byte
    (tests/test_torch_seq_axis_sweep_lm.py).

Bounds: member losses within 1e-5 relative of the JAX population's,
leaves within 1e-4 of each leaf's max |w| (the LM's as
tests/test_torch_sweep_lm.py holds them); against the port's population
over the mesh without its seq axis, bit for bit.  The JAX populations run on
two threads in a module fixture."""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from mmlspark_tpu.parallel.bridge import unstack_member as jax_unstack
from mmlspark_tpu.train import PopulationTrainer as JaxPopulationTrainer
from mmlspark_tpu.train import TrainerConfig as JaxTrainerConfig
from mmlspark_tpu_torch.train import PopulationTrainer, TrainerConfig
from test_torch_seq_axis_train import jax_mesh, port_mesh
from test_torch_sweep_bn import FIT as BN_FIT
from test_torch_sweep_bn import INITS as BN_INITS
from test_torch_sweep_bn import RATES as BN_RATES
from test_torch_sweep_bn import images
from test_torch_sweep_lm import LM, check_leaves
from test_torch_sweep_mesh import (MLP_FIT, MLP_INITS, RATES, members,
                                   mlp_data)
from test_torch_sweep_mesh_lm import LM_FIT, LM_INITS, lm_data

FLASH_FIT = dict(LM_FIT, model_config={**LM, "attn_impl": "flash"})
# name: (the port's fit settings, the JAX population's, rates, inits, data)
CASES = {
    "mlp": (MLP_FIT, MLP_FIT, RATES, MLP_INITS, mlp_data()),
    "bn": (BN_FIT, BN_FIT, BN_RATES, BN_INITS, images()),
    "lm": (FLASH_FIT, LM_FIT, RATES[:2], LM_INITS, lm_data()),
}
# the BatchNorm population: tests/test_torch_seq_axis_sweep_bn.py; the
# LM's: tests/test_torch_seq_axis_sweep_lm.py
RUNS = [("mlp", (2, 1, 2)), ("mlp", (2, 2, 2))]


def jax_population(run):
    """The JAX population of `run` over its mesh: (member losses, each
    member's variables as numpy trees)."""
    name, shape = run
    _, fit, rates, inits, (x, y) = CASES[name]
    pt = JaxPopulationTrainer(JaxTrainerConfig(**fit), members(rates),
                              mesh=jax_mesh(shape))
    pt.member_init_variables = lambda k, *_, **__: inits[k]
    result = pt.fit_arrays(x, y)
    variables = [{"params": jax_unstack(result.state.params, k)}
                 for k in range(len(rates))]
    if result.state.batch_stats:
        for k, v in enumerate(variables):
            v["batch_stats"] = jax_unstack(result.state.batch_stats, k)
    return result.member_loss, [jax.tree_util.tree_map(np.asarray, v)
                                for v in variables]


@pytest.fixture(scope="module")
def jax_populations():
    with ThreadPoolExecutor(2) as pool:
        return dict(zip(RUNS, pool.map(jax_population, RUNS)))


def port_population(name, shape):
    fit, _, rates, inits, (x, y) = CASES[name]
    pt = PopulationTrainer(TrainerConfig(**fit), members(rates),
                           mesh=port_mesh(shape))
    return pt, pt.fit_arrays(x, y, member_variables=inits)


def _flat(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def check_population(name, shape, jloss, jvars) -> None:
    """The port's population of `name` over `shape` against the JAX
    population's (losses, variables), and bit for bit against the port's
    over the mesh without its seq axis (module docstring)."""
    pt, result = port_population(name, shape)
    d, m, _ = shape
    assert (len(pt.shard_devices), pt.model_size) == (d, m)
    assert pt._lockstep == (name == "bn")
    np.testing.assert_allclose(result.member_loss, jloss, rtol=1e-5)
    for k in range(len(jvars)):
        got = pt.member_variables(result.state, k)
        if name == "lm":
            check_leaves(got["params"], jvars[k]["params"])
            continue
        got = dict(_flat(got))
        want = dict(_flat(jvars[k]))
        assert set(got) == set(want)
        for key, w in want.items():
            assert got[key].shape == w.shape, key
            assert np.abs(got[key] - w).max() <= \
                1e-4 * max(np.abs(w).max(), 1e-3), key
    assert result.member_bundle(0).metadata["partition"]["mesh"] == {
        "data": d, "model": m}
    other, again = port_population(name, (d, m, 1))
    np.testing.assert_array_equal(result.member_loss, again.member_loss)
    for k in range(len(jvars)):
        for (key, a), (_, b) in zip(
                _flat(pt.member_variables(result.state, k)),
                _flat(other.member_variables(again.state, k))):
            np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("name,shape", RUNS)
def test_population_over_a_seq_mesh_matches_the_jax_population(
        jax_populations, name, shape):
    check_population(name, shape, *jax_populations[name, shape])
