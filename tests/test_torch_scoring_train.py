"""`Trainer.fit_arrays` in the port against the JAX Trainer, on the CPU,
for the MLP (momentum), the linear model (mse under sgd, sigmoid_xent
under adam) and the bottleneck ResNets (two identity blocks under adam,
a projection block under momentum): the cases, data and checks of
tests/test_torch_vision_train.py (its docstring gives the tolerances and
why each bottleneck case has its optimizer), in a file of their own so
that each file's JAX compiles stay short.
"""

import pytest

from test_torch_vision_train import check_fit, fit_both

HERE = ("mlp_momentum", "linear_mse", "linear_sigmoid", "resnet_bottleneck",
        "resnet_bottleneck_projection")


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    return fit_both(HERE, tmp_path_factory.mktemp("scoring_fits"))


@pytest.mark.parametrize("name", HERE)
def test_fit_matches_jax(fits, name):
    check_fit(name, fits[name])
