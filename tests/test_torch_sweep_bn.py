"""A population with training BatchNorm over data 2 on the CPU
(`mmlspark_tpu_torch/train/sweep.py`, lockstep): a basic ResNet (the
repo's ConvNet has no BatchNorm layer), each member's statistics over the
global batch.  The shards' vmapped forwards run in lockstep on threads,
`ShardGroup.all_sum` sees the members' plain (N, C) sums through its vmap
rule (`parallel/ring.py` `_MemberAllSum`), and one backward over the
joint graph gives each member its gradient.

Bounds: member losses within 1e-5 relative of the JAX population's over
its data-2 mesh and within 1e-6 of the port's one-device population at
the same global batch; parameters and statistics within 1e-4 of each
leaf's max |w| of the JAX population's (momentum); a member culled by a
rung keeps its statistics' bytes; per-shard statistics (the lockstep
planted away) part from the one-device population."""

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.models import definitions
from mmlspark_tpu_torch.train import PopulationTrainer, TrainerConfig
from test_torch_sweep_mesh import (host_mesh, jax_population, members,
                                   port_inits)

RATES = (0.05, 0.02, 0.005)
FIT = dict(architecture="ResNet",
           model_config={"stage_sizes": [1], "widths": [4],
                         "num_classes": 3, "dtype": "float32"},
           optimizer="momentum", learning_rate=0.05, epochs=2, batch_size=8,
           loss="softmax_xent", seed=0, shuffle_each_epoch=True,
           numerics_cadence=0)
INITS = port_inits(FIT, RATES, (1, 8, 8, 3))


def images(n=16, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 8, 8, 3)).astype(np.float32),
            rng.integers(0, 3, n).astype(np.int32))


def _flat(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.fixture(scope="module")
def jax_ref():
    return jax_population(FIT, RATES, INITS, 2, 1, *images())


def _fit(mesh=None, **kw):
    pt = PopulationTrainer(TrainerConfig(**FIT), members(RATES), mesh=mesh,
                           device="cpu", **kw)
    return pt, pt.fit_arrays(*images(), member_variables=INITS)


def test_batchnorm_population_over_data_two(jax_ref):
    jloss, _, jvars = jax_ref
    pt, result = _fit(host_mesh(2))
    _, one = _fit()
    np.testing.assert_allclose(result.member_loss, jloss, rtol=1e-5)
    np.testing.assert_allclose(result.member_loss, one.member_loss,
                               rtol=1e-6)
    for k in range(len(RATES)):
        got = dict(_flat(pt.member_variables(result.state, k)))
        want = dict(_flat(jvars[k]))
        assert set(got) == set(want)
        for name, w in want.items():
            assert np.abs(got[name] - w).max() <= \
                1e-4 * max(np.abs(w).max(), 1e-3), name
    assert result.member_bundle(0).metadata["partition"]["mesh"] == {
        "data": 2, "model": 1}


def test_per_shard_statistics_part_from_the_global_batch(monkeypatch):
    """The planted fault: with no data shard in view each shard's
    BatchNorm takes its own slab's statistics, and the population parts
    from the one-device one."""
    _, one = _fit()
    monkeypatch.setattr(definitions, "active_data_shard", lambda: None)
    _, fault = _fit(host_mesh(2))
    assert np.abs(fault.member_loss - one.member_loss).max() > 1e-4


def test_a_culled_member_keeps_its_statistics():
    """A rung at data 2 culls the trailing members: their statistics (and
    parameters) keep their bytes from the rung on."""
    pt, result = _fit(host_mesh(2), halving_rungs=1, cull_fraction=0.5)
    at_rung = PopulationTrainer(
        TrainerConfig(**dict(FIT, epochs=1)), members(RATES),
        mesh=host_mesh(2)).fit_arrays(*images(), member_variables=INITS)
    culled = [k for k in range(len(RATES)) if result.active[k] == 0.0]
    assert len(culled) == 1
    for now, then in zip(result.state.batch_stats,
                         at_rung.state.batch_stats):
        for k in range(len(RATES)):
            assert torch.equal(now[k], then[k]) == (k in culled)
