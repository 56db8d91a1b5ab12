"""A population with training BatchNorm over data 2 x seq 2 on the CPU
(`mmlspark_tpu_torch/train/sweep.py`, lockstep): tests/test_torch_sweep_bn.py's
basic ResNet and members against the JAX package's `PopulationTrainer`
over a data 2 x seq 2 mesh of virtual devices.  The lockstep counts the
data shards (2 threads, not 4), and each member's statistics are the
global batch's: the seq replicas add nothing to the sums.  Bounds and
helpers: tests/test_torch_seq_axis_sweep.py's (losses rel 1e-5 of the JAX
population's, parameters and statistics within 1e-4 of each leaf's max
|w|, bit for bit the port's population over data 2)."""

import pytest

from test_torch_seq_axis_sweep import check_population, jax_population

RUN = ("bn", (2, 1, 2))


@pytest.fixture(scope="module")
def jax_ref():
    return jax_population(RUN)


def test_batchnorm_population_over_a_seq_mesh(jax_ref):
    check_population(*RUN, *jax_ref)
