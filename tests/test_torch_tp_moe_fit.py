"""An expert-parallel fit of the port's Trainer against the JAX Trainer's
on the same (data 2, model 2) mesh, on the CPU, with
tests/test_torch_tp_moe.py's `EP_MODEL` (8 experts over 'model': 4 a
shard): 2 epochs at aux_loss_weight 0.01; the history's loss rel 1e-5
and overflow fraction abs 1e-6; every leaf as
tests/test_torch_moe_train.py holds a MoE fit (all but 0.1% of the
entries within 1e-4 of max |w|, the leaf within 1e-4 in Frobenius norm:
Adam scales round-off in a rarely routed expert's hidden unit to
lr-sized steps; the key third of each qkv bias left out).  The routing
group is 24 tokens (`moe_group_size`), so that each data shard's 48
tokens hold whole groups (ROADMAP queue C: a group straddling two data
shards raises in the port).
"""

import numpy as np
import pytest

from mmlspark_tpu.train import Trainer as JaxTrainer
from mmlspark_tpu.train import TrainerConfig as JaxTrainerConfig
from mmlspark_tpu_torch import Trainer, TrainerConfig
from test_torch_dp_train import leaves
from test_torch_tp_moe import (EP_MODEL, TGTS, TOKS, fit_config, initial,
                               jax_init)
from test_torch_tp_train import host_mesh, jax_mesh


@pytest.fixture(scope="module")
def jax_ep_fit():
    trainer = JaxTrainer(JaxTrainerConfig(**fit_config()),
                         mesh=jax_mesh(2, 2))
    bundle = trainer.fit_arrays(TOKS, TGTS, initial_bundle=jax_init())
    return trainer.history, bundle


def test_expert_parallel_fit_matches_the_jax_trainer(jax_ep_fit):
    jax_history, jax_bundle = jax_ep_fit
    trainer = Trainer(TrainerConfig(**fit_config()), mesh=host_mesh(2, 2))
    bundle = trainer.fit_arrays(TOKS, TGTS, initial_bundle=initial())
    assert trainer.param_splits["block0_w.moe.w_in"] == (0, 1)
    assert bundle.metadata == jax_bundle.metadata
    assert len(trainer.history) == len(jax_history)
    for got, ref in zip(trainer.history, jax_history):
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        assert got["moe_overflow_fraction"] == pytest.approx(
            ref["moe_overflow_fraction"], abs=1e-6)
    d = EP_MODEL["d_model"]
    for (path, g), (_, w) in zip(leaves(bundle.variables),
                                 leaves(jax_bundle.variables)):
        if "qkv" in path and w.ndim == 1:
            g, w = np.delete(g, np.s_[d:2 * d]), np.delete(w, np.s_[d:2 * d])
        diff = np.abs(g - w)
        assert (diff > 1e-4 * np.abs(w).max()).mean() <= 1e-3, path
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w), path


