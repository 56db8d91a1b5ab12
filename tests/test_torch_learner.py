"""The port's `TPULearner` against the JAX package's, on the CPU: the
cases of the JAX package's tests/test_train.py as parity cases (the
estimator contract, null labels dropped, a warm start at learning rate 0
keeping the weights, the global step resumed across fits), the fitted
`TPUModel`'s scores against the JAX learner's within 1e-5, and a learner
and a fitted model saved by either package loading in the other.

Both learners get the same table (seeded numpy) and the same initial
bundle (the port's seeded init); the JAX learner trains on a one-device
mesh, as the port does, in a module fixture.
"""

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.pipeline import load_stage as jax_load_stage
from mmlspark_tpu.core.table import DataTable as JaxDataTable
from mmlspark_tpu.models import ModelBundle as JaxModelBundle
from mmlspark_tpu.models import TPUModel as JaxTPUModel
from mmlspark_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from mmlspark_tpu.parallel.mesh import make_mesh
from mmlspark_tpu.train import TPULearner as JaxTPULearner
from mmlspark_tpu.train import TrainerConfig as JaxTrainerConfig
from mmlspark_tpu_torch import (DataTable, ModelBundle, TPULearner,
                                TPUModel, TrainerConfig)
from mmlspark_tpu_torch.core.pipeline import load_stage
from mmlspark_tpu_torch.parallel.mesh import MeshSpec as PortMeshSpec
from mmlspark_tpu_torch.parallel.mesh import make_mesh as port_make_mesh

MLP = {"hidden_sizes": [16], "num_classes": 2, "dtype": "float32"}


def two_blob_data(n=128, seed=0):
    rng = np.random.default_rng(seed)
    half = n // 2
    x = np.concatenate([rng.normal(loc=-2.0, size=(half, 4)),
                        rng.normal(loc=+2.0, size=(n - half, 4))])
    y = np.concatenate([np.zeros(half, np.int32), np.ones(n - half, np.int32)])
    perm = rng.permutation(n)
    return x[perm].astype(np.float32), y[perm]


def mlp_config(**kw) -> dict:
    return {**dict(architecture="MLPClassifier", model_config=dict(MLP),
                   optimizer="momentum", learning_rate=0.05, epochs=4,
                   batch_size=48, loss="softmax_xent", seed=0,
                   numerics_cadence=0), **kw}


def initial() -> ModelBundle:
    return ModelBundle.init("MLPClassifier", MLP, seed=7, input_shape=(1, 4))


@pytest.fixture(scope="module")
def fitted():
    """Both learners fitted on 128 rows (batch 48: a partial last batch)
    from the same initial bundle."""
    x, y = two_blob_data()
    init = initial()
    jax_learner = JaxTPULearner(JaxTrainerConfig(**mlp_config()))
    jax_learner.set_mesh(make_mesh(JaxMeshSpec(data=1),
                                   devices=jax.devices()[:1]))
    jax_learner.set_initial_bundle(JaxModelBundle(
        "MLPClassifier", init.config, init.variables))
    jax_model = jax_learner.fit(JaxDataTable({"features": x, "label": y}))
    learner = TPULearner(TrainerConfig(**mlp_config()), device="cpu")
    model = learner.set_initial_bundle(init).fit(
        DataTable({"features": x, "label": y}))
    return x, y, jax_model, learner, model


def test_learner_estimator_contract(fitted):
    """fit -> a TPUModel on the learner's device that scores the table;
    its batch size, history and training match the JAX learner's (the
    epoch losses fall to ~5e-3, where a log-sum-exp's f32 round-off is
    ~5e-8: rel 1e-5 or 1e-7 absolute)."""
    x, y, jax_model, learner, model = fitted
    assert isinstance(model, TPUModel) and model.device.type == "cpu"
    assert model.miniBatchSize == jax_model.miniBatchSize == 48
    assert model.inputCol == "features" and model.outputCol == "output"
    assert len(model._history) == len(jax_model._history) == 4
    for got, ref in zip(model._history, jax_model._history):
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5,
                                   atol=1e-7)
    assert model.bundle.metadata == jax_model.bundle.metadata
    out = model.transform(DataTable({"features": x}))
    assert float((out["output"].argmax(-1) == y).mean()) > 0.9


def test_fitted_scores_match_the_jax_learner(fitted):
    """The two fitted models score the same rows within 1e-5."""
    x, _, jax_model, _, model = fitted
    got = model.transform(DataTable({"features": x}))["output"]
    ref = np.asarray(jax_model.transform(
        JaxDataTable({"features": x}))["output"])
    assert got.shape == ref.shape == (len(x), 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_learner_drops_null_labels():
    """NaN labels are dropped before training: 28 of 32 rows remain, two
    steps of 16 an epoch; an object label column raises TypeError."""
    x = np.random.default_rng(0).normal(size=(32, 4)).astype(np.float32)
    y = np.zeros(32, np.float64)
    y[::7] = np.nan
    learner = TPULearner(TrainerConfig(**mlp_config(epochs=1,
                                                    batch_size=16)),
                         device="cpu")
    model = learner.fit(DataTable({"features": x, "label": y}))
    assert model.bundle.metadata["steps"] == 2
    assert np.isfinite(model._history[0]["loss"])
    labels = np.empty(32, object)
    labels[:] = "a"
    with pytest.raises(TypeError, match="numeric"):
        learner.fit(DataTable({"features": x, "label": labels}))


def test_fine_tune_warm_start_at_lr_zero_keeps_the_weights():
    x, y = two_blob_data()
    pre = initial()
    model = TPULearner(TrainerConfig(**mlp_config(epochs=1,
                                                  learning_rate=0.0)),
                       device="cpu").set_initial_bundle(pre).fit(
        DataTable({"features": x, "label": y}))
    for key in ("dense0", "out"):
        np.testing.assert_array_equal(
            model.bundle.variables["params"][key]["kernel"],
            pre.variables["params"][key]["kernel"])


def test_warm_start_resumes_global_step():
    """Continued training resumes the global step the bundle records."""
    x, y = two_blob_data()
    t = DataTable({"features": x, "label": y})
    cfg = TrainerConfig(**mlp_config(epochs=2, batch_size=64))
    first = TPULearner(cfg, device="cpu").fit(t)
    assert first.bundle.metadata["steps"] == 4
    cont = TPULearner(cfg, device="cpu").set_initial_bundle(
        first.bundle).fit(t)
    assert cont.bundle.metadata["steps"] == 8


def test_set_mesh_raises_for_a_mesh():
    """A model axis is taken and a seq axis too (the Trainer runs both:
    the seq axis replicates the batch, so the fitted model scores over
    one data shard); tests/test_torch_seq_axis_train.py holds the
    fits."""
    learner = TPULearner(device="cpu")
    assert learner.set_mesh(None) is learner
    assert learner.set_mesh(port_make_mesh(
        PortMeshSpec(data=1, model=2), [torch.device("cpu")] * 2)) is learner
    mesh = port_make_mesh(PortMeshSpec(data=1, seq=2),
                          [torch.device("cpu")] * 2)
    learner = TPULearner(TrainerConfig(**mlp_config(epochs=1)),
                         device="cpu")
    assert learner.set_mesh(mesh) is learner
    x, y = two_blob_data(n=32)
    model = learner.fit(DataTable({"features": x, "label": y}))
    assert model._mesh is mesh
    assert model.shard_devices() == [torch.device("cpu")]


def test_learner_and_model_load_across_packages(fitted, tmp_path):
    """A learner with an initial bundle saved by the port loads in the JAX
    package and the reverse, Params and bundle equal; the fitted models
    likewise, scoring alike."""
    x, _, jax_model, learner, model = fitted
    learner.save(str(tmp_path / "port_learner"))
    jax_learner = jax_load_stage(str(tmp_path / "port_learner"))
    assert isinstance(jax_learner, JaxTPULearner)
    assert jax_learner.config == learner.config
    assert jax_learner.trainer_config().to_json() == \
        learner.trainer_config().to_json()
    for a, b in zip(jax.tree_util.tree_leaves(
            jax_learner._initial_bundle.variables),
            jax.tree_util.tree_leaves(learner._initial_bundle.variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jax_learner.save(str(tmp_path / "jax_learner"))
    back = load_stage(str(tmp_path / "jax_learner"), device="cpu")
    assert isinstance(back, TPULearner) and back.device.type == "cpu"
    assert back.param_values() == learner.param_values()
    assert back._initial_bundle.config == learner._initial_bundle.config

    model.save(str(tmp_path / "port_model"))
    jax_back = jax_load_stage(str(tmp_path / "port_model"))
    assert isinstance(jax_back, JaxTPUModel)
    jax_model.save(str(tmp_path / "jax_model"))
    port_back = load_stage(str(tmp_path / "jax_model"), device="cpu")
    assert isinstance(port_back, TPUModel)
    rows = x[:16]
    np.testing.assert_allclose(
        np.asarray(jax_back.transform(JaxDataTable({"features": rows}))[
            "output"]),
        model.transform(DataTable({"features": rows}))["output"],
        rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        port_back.transform(DataTable({"features": rows}))["output"],
        np.asarray(jax_model.transform(JaxDataTable({"features": rows}))[
            "output"]), rtol=0, atol=1e-5)
