"""The consumers of a data axis besides the Trainer, on the CPU over host
shards `[torch.device("cpu")] * n`: `TPUModel.set_mesh`, `CheckpointData`
over a mesh, `TPULearner.set_mesh`, `PopulationTrainer` over a data mesh
and `TrainClassifier(populationSize=..., mesh=...)`, against the port on
one device and against the JAX package on `jax.devices()[:n]` (its
stages and trainers jitted once, on threads, in a module fixture).

Tolerances (f32): scores within 1e-5 of max |output| of the JAX stage's
and of the port's one-device scores (a shard scores its slab in a
smaller batch, which may reorder a reduction); the learner's history rel
1e-5 and its weights atol 1e-5; the population's per-step member losses
rel 1e-5 and its parameters within 1e-4 of each leaf's max |w| of the
JAX population's (tests/test_torch_sweep.py's bounds), and within 1e-6
of the port's one-device population's.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.table import DataTable as JaxDataTable
from mmlspark_tpu.models import ModelBundle as JaxModelBundle
from mmlspark_tpu.models import TPUModel as JaxTPUModel
from mmlspark_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from mmlspark_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mmlspark_tpu.train import PopulationTrainer as JaxPopulationTrainer
from mmlspark_tpu.train import TPULearner as JaxTPULearner
from mmlspark_tpu.train import TrainerConfig as JaxTrainerConfig
from mmlspark_tpu.parallel.bridge import unstack_member as jax_unstack
from mmlspark_tpu_torch import (DataTable, ModelBundle, TPULearner, TPUModel,
                                TrainerConfig)
from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from mmlspark_tpu_torch.stages import CheckpointData
from mmlspark_tpu_torch.train import PopulationTrainer

CPU = torch.device("cpu")
N_ROWS, BATCH = 37, 16      # a ragged last batch of 5 rows
SCORERS = {
    "convnet": ("ConvNetCIFAR10", {"widths": [4, 8, 8], "dense_width": 16,
                                   "dtype": "float32"}, (16, 16, 3)),
    "resnet": ("ResNet", {"stage_sizes": [1, 1], "widths": [4, 8],
                          "num_classes": 5, "block_kind": "bottleneck",
                          "dtype": "float32"}, (19, 19, 3)),
}
MLP = {"hidden_sizes": [16], "num_classes": 3, "dtype": "float32"}
RATES = (0.02, 0.005, 0.001, 0.0003)


def host_mesh(n):
    return make_mesh(MeshSpec(data=n), [CPU] * n)


def jax_mesh(n):
    return jax_make_mesh(JaxMeshSpec(data=n), jax.devices()[:n])


def scorer_bundle(name):
    arch, cfg, shape = SCORERS[name]
    b = ModelBundle.init(arch, cfg, seed=1, input_shape=(1,) + shape)
    rng = np.random.default_rng(2)

    def stats(tree):   # non-trivial BatchNorm statistics
        if not isinstance(tree, dict):
            return tree
        return {k: (rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                    if k == "var" else rng.normal(0, 0.2, v.shape).astype(
                        np.float32) if k == "mean" else stats(v))
                for k, v in tree.items()}
    return ModelBundle(arch, b.config, stats(b.variables))


def images(name):
    return np.random.default_rng(3).uniform(
        0, 2, (N_ROWS,) + SCORERS[name][2]).astype(np.float32)


def table_data(n=96, d=8, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.argmax(x @ rng.normal(size=(d, classes)), axis=1).astype(np.int32)
    return x, y


def fit_kw(**kw):
    return {**dict(architecture="MLPClassifier", model_config=dict(MLP),
                   optimizer="adam", learning_rate=0.01, epochs=2,
                   batch_size=20, loss="softmax_xent", seed=7,
                   numerics_cadence=0), **kw}


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package at data 2: each scorer's scores, a TPULearner fit
    and the 4-rate population (with its member inits)."""
    x, y = table_data()

    def score(name):
        b = scorer_bundle(name)
        model = JaxTPUModel(JaxModelBundle(b.architecture, dict(b.config),
                                           b.variables),
                            inputCol="x", outputCol="y", miniBatchSize=BATCH)
        model.set_mesh(jax_mesh(2))
        return np.asarray(model.transform(JaxDataTable(
            {"x": images(name)}))["y"])

    def learner():
        init = ModelBundle.init("MLPClassifier", MLP, seed=5,
                                input_shape=(1, 8))
        lrn = JaxTPULearner(JaxTrainerConfig(**fit_kw()))
        lrn.set_mesh(jax_mesh(2)).set_initial_bundle(JaxModelBundle(
            "MLPClassifier", init.config, init.variables))
        model = lrn.fit(JaxDataTable({"features": x, "label": y}))
        return model._history, model.bundle

    def population():
        pt = JaxPopulationTrainer(JaxTrainerConfig(**fit_kw()),
                                  [{"learning_rate": r} for r in RATES],
                                  mesh=jax_mesh(2))
        inits = [pt.member_init_variables(k, (1, x.shape[1]))
                 for k in range(len(RATES))]
        result = pt.fit_arrays(x, y)
        return inits, result.member_loss, [
            jax.tree_util.tree_map(np.asarray, jax_unstack(
                result.state.params, k)) for k in range(len(RATES))]

    jobs = {"convnet": lambda: score("convnet"),
            "resnet": lambda: score("resnet"), "learner": learner,
            "population": population}
    with ThreadPoolExecutor(2) as pool:
        futures = {k: pool.submit(job) for k, job in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


def close(got, want, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


# ------------------------------------------------------------- TPUModel ---

@pytest.mark.parametrize("name,dp", [("convnet", 2), ("resnet", 2),
                                     ("resnet", 4)])
def test_tpu_model_over_a_data_mesh(jax_refs, name, dp):
    """Each minibatch padded to a multiple of the data axis, cut into
    slabs and scored shard by shard (one module per distinct device), the
    results joined in row order: the JAX stage's scores at data 2 and the
    port's one-device scores."""
    table = DataTable({"x": images(name)})
    one = TPUModel(scorer_bundle(name), device="cpu", inputCol="x",
                   outputCol="y", miniBatchSize=BATCH).transform(table)["y"]
    model = TPUModel(scorer_bundle(name), device="cpu", inputCol="x",
                     outputCol="y", miniBatchSize=BATCH).set_mesh(
        host_mesh(dp))
    assert model.shard_devices() == [CPU] * dp
    calls = []
    module = model._scoring_module()
    module.register_forward_pre_hook(
        lambda mod, args: calls.append(tuple(args[0].shape[:1])))
    got = model.transform(table)["y"]
    assert len(model._modules) == 1          # the shards share the host
    assert calls == [(BATCH // dp,)] * (dp * -(-N_ROWS // BATCH))
    assert got.shape == one.shape == (N_ROWS, 5 if name == "resnet" else 10)
    close(got, one)
    close(got, jax_refs[name])


def test_tpu_model_defaults_to_the_knobs_mesh():
    """With no mesh set the stage scores over `default_mesh`: one shard
    under the default knobs, MMLSPARK_TPU_MESH_DATA shards otherwise."""
    from mmlspark_tpu_torch import config
    model = TPUModel(scorer_bundle("convnet"), device="cpu", inputCol="x")
    assert model.shard_devices() == [CPU]
    config.set("MMLSPARK_TPU_MESH_DATA", 2)
    try:
        model = TPUModel(scorer_bundle("convnet"), device="cpu",
                         inputCol="x")
        assert model.shard_devices() == [CPU] * 2
    finally:
        config.set("MMLSPARK_TPU_MESH_DATA", None)


def test_checkpoint_data_over_a_mesh_feeds_the_same_scores():
    """CheckpointData over the mesh caches each numeric column as padded
    per-device slabs; TPUModel over the same mesh scores them shard by
    shard with no host->device copy, the host path's scores; a stage on
    another layout refuses the cache."""
    mesh = host_mesh(2)
    table = DataTable({"x": images("resnet"), "tag": [str(i) for i in
                                                      range(N_ROWS)]})
    cached = CheckpointData(device="cpu", mesh=mesh).transform(table)
    slabs = CheckpointData.get_device_cache(cached)["x"]
    assert [t.shape[0] for t in slabs] == [19, 19] and "tag" not in \
        CheckpointData.get_device_cache(cached)
    model = TPUModel(scorer_bundle("resnet"), device="cpu", inputCol="x",
                     outputCol="y", miniBatchSize=BATCH).set_mesh(mesh)
    host = model.transform(table)["y"]
    before = model._get_feed().put_bytes
    got = model.transform(cached)["y"]
    assert model._get_feed().put_bytes == before
    np.testing.assert_array_equal(got, host)
    with pytest.raises(ValueError, match="cached on"):
        TPUModel(scorer_bundle("resnet"), device="cpu", inputCol="x",
                 miniBatchSize=BATCH).transform(cached)


# ------------------------------------------------------------ TPULearner ---

def test_tpu_learner_over_a_data_mesh(jax_refs):
    """`set_mesh` passes the mesh to the Trainer (data 2) and the fitted
    model scores over it: the JAX learner's history, weights and
    scores."""
    x, y = table_data()
    init = ModelBundle.init("MLPClassifier", MLP, seed=5, input_shape=(1, 8))
    model = TPULearner(TrainerConfig(**fit_kw()), device="cpu").set_mesh(
        host_mesh(2)).set_initial_bundle(init).fit(
        DataTable({"features": x, "label": y}))
    history, jbundle = jax_refs["learner"]
    assert model.shard_devices() == [CPU] * 2
    assert model.bundle.metadata == jbundle.metadata
    for got, ref in zip(model._history, history):
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    for g, w in zip(jax.tree_util.tree_leaves(model.bundle.variables),
                    jax.tree_util.tree_leaves(jbundle.variables)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0,
                                   atol=1e-5)


# ----------------------------------------------------- PopulationTrainer ---

def test_population_over_a_data_mesh(jax_refs):
    """The 4-rate sweep at data 2 from the JAX members' inits: the JAX
    population's member losses and parameters at data 2, and the port's
    one-device population's; a BatchNorm population over the data axis
    trains on the global batch's statistics, as the one-device one."""
    inits, jloss, jparams = jax_refs["population"]
    x, y = table_data()
    members = [{"learning_rate": r} for r in RATES]
    pt = PopulationTrainer(TrainerConfig(**fit_kw()), members,
                           mesh=host_mesh(2))
    result = pt.fit_arrays(x, y, member_variables=inits)
    one = PopulationTrainer(TrainerConfig(**fit_kw()), members,
                            device="cpu").fit_arrays(
        x, y, member_variables=inits)
    np.testing.assert_allclose(result.member_loss, jloss, rtol=1e-5)
    np.testing.assert_allclose(result.member_loss, one.member_loss,
                               rtol=1e-6)
    for k in range(len(RATES)):
        got = jax.tree_util.tree_leaves(
            pt.member_variables(result.state, k)["params"])
        ref = jax.tree_util.tree_leaves(
            one._trainer.member_variables(one.state, k)["params"])
        for g, w, r in zip(got, jax.tree_util.tree_leaves(jparams[k]), ref):
            close(g, w, 1e-4)
            close(g, r, 1e-6)
    assert result.member_bundle(0).metadata["partition"]["mesh"] == {
        "data": 2, "model": 1}
    close(pt.score_population(result.state, x),
          one._trainer.score_population(one.state, x))
    resnet = TrainerConfig(**fit_kw(architecture="ResNet", model_config={
        "stage_sizes": [1], "widths": [4], "num_classes": 3,
        "dtype": "float32"}))
    rng = np.random.default_rng(4)
    xi = rng.normal(size=(16, 8, 8, 3)).astype(np.float32)
    yi = rng.integers(0, 3, 16).astype(np.int32)
    bn = PopulationTrainer(resnet, 2, mesh=host_mesh(2))
    bn_inits = [bn.member_init_variables(k, (1, 8, 8, 3)) for k in range(2)]
    meshed = bn.fit_arrays(xi, yi, member_variables=bn_inits)
    alone = PopulationTrainer(resnet, 2, device="cpu").fit_arrays(
        xi, yi, member_variables=bn_inits)
    np.testing.assert_allclose(meshed.member_loss, alone.member_loss,
                               rtol=1e-6)
    for a, b in zip(meshed.state.batch_stats, alone.state.batch_stats):
        close(a.numpy(), b.numpy())


def test_train_classifier_population_over_a_mesh():
    """TrainClassifier(populationSize=4, mesh=...) trains the MLP
    population over the data axis: the one-device sweep's metrics."""
    from mmlspark_tpu_torch.ml import (MultilayerPerceptronClassifier,
                                       TrainClassifier)
    rng = np.random.default_rng(3)
    x0, x1 = rng.normal(size=(120,)), rng.normal(size=(120,))
    t = DataTable({"f0": x0, "f1": x1,
                   "label": (x0 + 0.5 * x1 > 0).astype(np.int64)})
    mlp = MultilayerPerceptronClassifier(layers=[-1, 16, -1], maxIter=8,
                                         stepSize=0.01, seed=1, device="cpu")
    sweeps = [TrainClassifier(mlp, populationSize=4, mesh=mesh).fit(
        t).sweep_metrics for mesh in (None, host_mesh(2))]
    np.testing.assert_allclose(sweeps[1]["final_loss"],
                               sweeps[0]["final_loss"], rtol=1e-5)
    np.testing.assert_array_equal(sweeps[1]["accuracy"],
                                  sweeps[0]["accuracy"])
