"""The port's Trainer with pipeline stages over a mesh with a seq axis, on
the CPU: tests/test_torch_pp_trainer.py's `PP_MODEL` (2 stages on the
model axis, 2 microbatches, dense blocks) over data 2 x model 2 x seq 2,
against the JAX Trainer's pipelined fit over the same mesh, both
warm-started from the port's seeded init (an ordinary TransformerLM
bundle, which both Trainers stack).  The stages sit on the model axis at
seq index 0 (`parallel/mesh.py` `model_group`); the seq axis replicates
the batch in both packages.

Bounds: per-epoch losses rel 1e-5, the unstacked bundle's leaves atol
1e-5 (the key third of each qkv bias left out: its true gradient is zero
and Adam scales round-off there) and its metadata equal; against the
port's own pipelined fit over data 2 x model 2, bit for bit.
"""

import numpy as np
import pytest

from mmlspark_tpu.models import ModelBundle as JaxModelBundle
from mmlspark_tpu.train import Trainer as JaxTrainer
from mmlspark_tpu.train import TrainerConfig as JaxTrainerConfig
from mmlspark_tpu_torch import Trainer, TrainerConfig
from mmlspark_tpu_torch.models.bundle import ModelBundle
from test_torch_dp_train import leaves
from test_torch_pp_trainer import FIT, PP_MODEL, TGTS, TOKS
from test_torch_seq_axis_train import assert_same_fit, jax_mesh, port_mesh

CFG = dict(FIT, model_config=dict(PP_MODEL), numerics_cadence=0)
INIT = ModelBundle.init("TransformerLM", PP_MODEL, seed=0)


def port_fit(shape):
    trainer = Trainer(TrainerConfig(**CFG), mesh=port_mesh(shape))
    return trainer, trainer.fit_arrays(TOKS, TGTS, initial_bundle=INIT)


@pytest.fixture(scope="module")
def jax_fit():
    trainer = JaxTrainer(JaxTrainerConfig(**CFG), mesh=jax_mesh((2, 2, 2)))
    bundle = trainer.fit_arrays(TOKS, TGTS, initial_bundle=JaxModelBundle(
        INIT.architecture, INIT.config, INIT.variables))
    return trainer.history, bundle


def test_pipelined_fit_over_a_seq_mesh_matches_the_jax_trainer(jax_fit):
    jax_history, jax_bundle = jax_fit
    trainer, bundle = port_fit((2, 2, 2))
    assert (trainer.data_size, trainer.model_size) == (2, 2)
    assert bundle.metadata == jax_bundle.metadata
    assert bundle.metadata["steps"] == 4
    np.testing.assert_allclose([h["loss"] for h in trainer.history],
                               [h["loss"] for h in jax_history], rtol=1e-5)
    d = PP_MODEL["d_model"]
    got, want = leaves(bundle.variables), leaves(jax_bundle.variables)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape
        if "qkv" in path and w.ndim == 1:
            g, w = np.delete(g, np.s_[d:2 * d]), np.delete(w, np.s_[d:2 * d])
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=path)


def test_pipelined_fit_over_a_seq_mesh_equals_the_mesh_without_it():
    """The stage ring over data 2 x model 2 x seq 2 computes what it does
    over data 2 x model 2: each stage's stacked leaves on its device of
    the row's model group at seq index 0, the same losses and weights bit
    for bit."""
    trainer, bundle = port_fit((2, 2, 2))
    mesh = trainer.mesh
    stacked = trainer._pp_params["blocks.qkv.weight"]
    assert [t.device for t in stacked] == list(mesh.devices[0, :, 0])
    assert_same_fit((trainer, bundle), port_fit((2, 2, 1)))
