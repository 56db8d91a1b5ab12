"""The port's tensor-parallel Trainer over a basic ResNet with BatchNorm
at (data 2, model 2) against the JAX Trainer on the same mesh, on the CPU
(tests/test_torch_tp_train.py holds the helpers and the tolerances): the
fallback splits the wide kernels on their output channels, each shard
computing its channels, joined before the BatchNorm, which then takes the
global batch's statistics over every channel as in the data-parallel
step; its `batch_stats` are held to the JAX Trainer's like the
parameters.
"""

import pytest

from test_torch_tp_train import check_fit, jax_fit


@pytest.fixture(scope="module")
def jax_resnet_fit():
    return jax_fit(("resnet", 2, 2))


def test_tensor_parallel_resnet_fit_matches_the_jax_trainer(jax_resnet_fit):
    check_fit("resnet", 2, 2, *jax_resnet_fit)
