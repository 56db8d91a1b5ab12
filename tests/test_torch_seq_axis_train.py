"""The port's Trainer and `TPULearner` over a mesh with a seq axis, on the
CPU, against the JAX package over a mesh of the same shape (the port's
shards `[torch.device("cpu")] * n`, the JAX package's `jax.devices()[:n]`).

The JAX Trainer cuts the batch along 'data' only
(`mmlspark_tpu/train/trainer.py:622`), so every seq index holds and
computes the same replicated batch; the port computes each (data, model)
group once, at seq index 0.  Cases (tests/test_torch_dp_train.py's data
and fit settings: 20 rows at batch 8, 2 epochs, 6 steps, f32): the MLP
over data 2 x seq 2 and data 2 x model 2 x seq 2, a basic ResNet with
BatchNorm over data 2 x seq 2; `TPULearner.set_mesh` and the fitted
`TPUModel`'s scores; the checkpoints (the sidecar's topology as the JAX
Trainer writes it, restores across the packages byte for byte, a resume
across seq widths 2 -> 1 -> 2); the sequence-sharded model, which both
packages refuse.  tests/test_torch_seq_axis_lm.py holds the LMs and the
pipeline, tests/test_torch_seq_axis_sweep.py the populations.

Bounds: against the JAX Trainer those of the data- and model-axis parity
files (loss and grad_norm rel 1e-5, leaves atol 1e-5, the bundle's
metadata equal); against the port's own fit over the mesh without its
seq axis, bit for bit.  The JAX fits run jitted once each, on two
threads, in a module fixture.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.table import DataTable as JaxDataTable
from mmlspark_tpu.models import ModelBundle as JaxModelBundle
from mmlspark_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from mmlspark_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mmlspark_tpu.train import TPULearner as JaxTPULearner
from mmlspark_tpu.train import Trainer as JaxTrainer
from mmlspark_tpu.train import TrainerConfig as JaxTrainerConfig
from mmlspark_tpu_torch import DataTable, TPULearner, Trainer, TrainerConfig
from mmlspark_tpu_torch.models.definitions import Dense
from mmlspark_tpu_torch.observe.metrics import get_counter
from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from mmlspark_tpu_torch.resilience.checkpoints import (checkpoint_meta,
                                                       latest_valid_checkpoint)
from mmlspark_tpu_torch.resilience.ckpt_writer import serialize_tree
from mmlspark_tpu_torch.train import PopulationTrainer
from test_torch_data_parallel import blobs, mlp_config, payload
from test_torch_dp_train import data, fit_config, initial, leaves

CPU = torch.device("cpu")
RUNS = [("mlp", (2, 1, 2)), ("mlp", (2, 2, 2)), ("resnet", (2, 1, 2))]
RING = {"vocab_size": 32, "d_model": 16, "n_heads": 2, "n_layers": 1,
        "max_len": 8, "dtype": "float32", "attn_impl": "ring_flash",
        "seq_axis": "seq"}


def port_mesh(shape):
    d, m, s = shape
    return make_mesh(MeshSpec(data=d, model=m, seq=s), [CPU] * (d * m * s))


def jax_mesh(shape):
    d, m, s = shape
    return jax_make_mesh(JaxMeshSpec(data=d, model=m, seq=s),
                         jax.devices()[:d * m * s])


def port_fit(name, shape, **kw):
    trainer = Trainer(TrainerConfig(**{**fit_config(name), **kw}),
                      mesh=port_mesh(shape))
    return trainer, trainer.fit_arrays(*data(name),
                                       initial_bundle=initial(name))


def jax_fit(run):
    name, shape = run
    init = initial(name)
    trainer = JaxTrainer(JaxTrainerConfig(**fit_config(name)),
                         mesh=jax_mesh(shape))
    bundle = trainer.fit_arrays(*data(name), initial_bundle=JaxModelBundle(
        init.architecture, init.config, init.variables))
    return trainer.history, bundle


def jax_learner_scores():
    """The JAX learner's scores of the MLP case over data 2 x seq 2."""
    x, y = data("mlp")
    init = initial("mlp")
    learner = JaxTPULearner(JaxTrainerConfig(**fit_config("mlp")))
    learner.set_mesh(jax_mesh((2, 1, 2)))
    learner.set_initial_bundle(JaxModelBundle(
        init.architecture, init.config, init.variables))
    model = learner.fit(JaxDataTable({"features": x, "label": y}))
    return np.asarray(model.transform(JaxDataTable(
        {"features": x}))["output"])


def jax_checkpointed(ckpt):
    """The JAX Trainer's checkpointed MLP fit over data 2 x seq 2."""
    trainer = JaxTrainer(JaxTrainerConfig(**mlp_config()),
                         mesh=jax_mesh((2, 1, 2)))
    return trainer, trainer.fit_arrays(*blobs(), ckpt_dir=ckpt)


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """Every JAX reference of this file, on three threads: {run: (history,
    bundle)} of RUNS, "learner": scores, "ckpt": (directory, (trainer,
    bundle))."""
    ckpt = str(tmp_path_factory.mktemp("seq_jax_ckpt"))
    with ThreadPoolExecutor(3) as pool:
        fits = [pool.submit(jax_fit, run) for run in RUNS]
        learner = pool.submit(jax_learner_scores)
        checkpointed = pool.submit(jax_checkpointed, ckpt)
        out = {run: f.result() for run, f in zip(RUNS, fits)}
        out["learner"] = learner.result()
        out["ckpt"] = ckpt, checkpointed.result()
    return out


def assert_same_fit(a, b) -> None:
    """Two port fits (trainer, bundle) equal bit for bit: history,
    metadata and every variable."""
    (ta, ba), (tb, bb) = a, b
    assert [{k: v for k, v in r.items() if k != "wall_s"}
            for r in ta.history] == \
        [{k: v for k, v in r.items() if k != "wall_s"} for r in tb.history]
    assert ba.metadata == bb.metadata
    for (pa, ga), (pb, gb) in zip(leaves(ba.variables), leaves(bb.variables)):
        assert pa == pb
        np.testing.assert_array_equal(ga, gb, err_msg=pa)


@pytest.mark.parametrize("name,shape", RUNS)
def test_seq_axis_fit_matches_the_jax_trainer(jax_refs, name, shape):
    """The port over data x (model x) seq against the JAX Trainer over
    the same mesh, and bit for bit against the port over the mesh
    without its seq axis."""
    jax_history, jax_bundle = jax_refs[name, shape]
    trainer, bundle = port_fit(name, shape)
    d, m, _ = shape
    assert (trainer.data_size, trainer.model_size) == (d, m)
    assert bundle.metadata == jax_bundle.metadata
    assert bundle.metadata["partition"]["mesh"] == {"data": d, "model": m}
    assert len(trainer.history) == len(jax_history)
    for got, ref in zip(trainer.history, jax_history):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-5)
    got, want = leaves(bundle.variables), leaves(jax_bundle.variables)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=path)
    assert ("batch_stats" in bundle.variables) == (name == "resnet")
    assert_same_fit((trainer, bundle), port_fit(name, (d, m, 1)))


def test_the_seq_replicas_compute_nothing():
    """Over data 2 x model 2 x seq 2 the Trainer keeps one replica row a
    data index (at seq index 0), and every Dense call of a step runs at
    the data shard's batch, as many as over data 2 x model 2."""
    calls = {}
    for shape in ((2, 2, 2), (2, 2, 1)):
        trainer = Trainer(TrainerConfig(**{**fit_config("mlp"),
                                           "epochs": 1}),
                          mesh=port_mesh(shape))
        seen = calls[shape] = []
        for mod in trainer.module.modules():
            if isinstance(mod, Dense):
                mod.register_forward_hook(
                    lambda m, args, out, seen=seen: seen.append(
                        tuple(args[0].shape)))
        trainer.fit_arrays(*data("mlp"), initial_bundle=initial("mlp"))
        assert trainer.shard_devices == [CPU, CPU]
        assert len(trainer._replicas.rows) == 2
    assert calls[2, 2, 2] == calls[2, 2, 1]
    assert {s[0] for s in calls[2, 2, 2]} == {4}


def test_learner_over_a_seq_mesh_scores_as_the_jax_learner(jax_refs):
    """`TPULearner.set_mesh` over data 2 x seq 2: the fitted model scores
    over the same mesh, bit for bit as the learner over data 2, within
    1e-5 of the JAX learner over its data 2 x seq 2 mesh."""
    x, y = data("mlp")
    table = DataTable({"features": x, "label": y})
    scores = {}
    for shape in ((2, 1, 2), (2, 1, 1)):
        learner = TPULearner(TrainerConfig(**fit_config("mlp")),
                             device="cpu")
        model = learner.set_initial_bundle(initial("mlp")).set_mesh(
            port_mesh(shape)).fit(table)
        assert model._mesh.shape["seq"] == shape[2]
        assert model.shard_devices() == [CPU, CPU]
        scores[shape] = np.asarray(model.transform(table)["output"])
    np.testing.assert_array_equal(scores[2, 1, 2], scores[2, 1, 1])
    np.testing.assert_allclose(scores[2, 1, 2], jax_refs["learner"], rtol=0,
                               atol=1e-5)


def mlp_fit(shape, ckpt, resume=False, **kw):
    trainer = Trainer(TrainerConfig(**mlp_config(**kw)),
                      mesh=port_mesh(shape))
    return trainer, trainer.fit_arrays(*blobs(), ckpt_dir=ckpt,
                                       resume=resume)


def test_checkpoints_over_a_seq_mesh_as_the_jax_trainer(jax_refs, tmp_path):
    """Data 2 x seq 2: the sidecar records data_devices 2 and
    model_devices 1 as the JAX Trainer's at the same mesh; the port's
    checkpoint restores in the JAX Trainer over that mesh, which writes
    it back byte for byte, and the JAX Trainer's restores in the port,
    whose state tree serializes to the file's bytes."""
    port_ckpt = str(tmp_path / "port")
    _, bundle = mlp_fit((2, 1, 2), port_ckpt)
    jax_ckpt, (jtrainer, jbundle) = jax_refs["ckpt"]
    meta = checkpoint_meta(latest_valid_checkpoint(port_ckpt))
    jmeta = checkpoint_meta(latest_valid_checkpoint(jax_ckpt))
    for key in ("data_devices", "model_devices", "process_count",
                "effective_batch_size", "step"):
        assert meta[key] == jmeta[key], key
    assert (meta["data_devices"], meta["model_devices"]) == (2, 1)
    assert bundle.metadata == jbundle.metadata
    jstate = jtrainer.restore_checkpoint(
        jtrainer.init_state((1, 4), total_steps=1), port_ckpt)
    jtrainer.save_checkpoint(jstate, str(tmp_path / "again"), sync=True)
    jtrainer._close_writers()
    assert payload(str(tmp_path / "again")) == payload(port_ckpt)
    trainer = Trainer(TrainerConfig(**mlp_config()), mesh=port_mesh((2, 1, 2)))
    state = trainer.restore_checkpoint(trainer.init_state((1, 4), 1),
                                       jax_ckpt)
    assert serialize_tree(trainer.state_tree(state)) == payload(jax_ckpt)


def test_a_resume_across_seq_widths_is_an_ordinary_resume(tmp_path):
    """A fit over data 2 x seq 2 checkpointed after its first epoch,
    resumed over data 2 for the second and over data 2 x seq 2 for the
    third: no elastic resume (the data axis stays 2, every sidecar says
    so) and the uninterrupted fit's weights bit for bit."""
    ckpt = str(tmp_path / "ckpt")
    kw = dict(checkpoint_every_steps=1)
    before = get_counter("train.elastic_resumes")
    mlp_fit((2, 1, 2), ckpt, epochs=1, **kw)
    assert checkpoint_meta(latest_valid_checkpoint(ckpt))["step"] == 2
    mlp_fit((2, 1, 1), ckpt, epochs=2, resume=True, **kw)
    assert checkpoint_meta(latest_valid_checkpoint(ckpt))["data_devices"] \
        == 2
    trainer, resumed = mlp_fit((2, 1, 2), ckpt, epochs=3, resume=True, **kw)
    assert get_counter("train.elastic_resumes") == before
    assert resumed.metadata["steps"] == 6
    assert checkpoint_meta(latest_valid_checkpoint(ckpt))["data_devices"] \
        == 2
    _, clean = mlp_fit((2, 1, 2), None, epochs=3)
    for (path, g), (_, w) in zip(leaves(resumed.variables),
                                 leaves(clean.variables)):
        np.testing.assert_array_equal(g, w, err_msg=path)


def test_a_sequence_sharded_model_is_refused_by_both_packages():
    """A ring_flash model with seq_axis "seq": the port's Trainer,
    `TPULearner` and `PopulationTrainer` raise ValueError naming
    `make_seq_parallel_lm_step` before any step, whatever the mesh; the
    JAX Trainer raises NameError at its first step (an unbound 'seq'
    axis outside any shard_map)."""
    cfg = dict(architecture="TransformerLM", model_config=dict(RING),
               optimizer="adam", learning_rate=1e-2, batch_size=4,
               numerics_cadence=0)
    for mesh in (None, port_mesh((2, 1, 2)), port_mesh((1, 1, 2))):
        with pytest.raises(ValueError, match="make_seq_parallel_lm_step"):
            Trainer(TrainerConfig(**cfg), mesh=mesh, device="cpu")
        with pytest.raises(ValueError, match="make_seq_parallel_lm_step"):
            PopulationTrainer(TrainerConfig(**cfg), 2, mesh=mesh,
                              device="cpu")
    toks = np.zeros((4, RING["max_len"]), np.int32)
    with pytest.raises(ValueError, match="make_seq_parallel_lm_step"):
        TPULearner(TrainerConfig(**cfg), device="cpu").set_mesh(
            port_mesh((2, 1, 2))).fit(DataTable({"features": toks,
                                                 "label": toks}))
    jtrainer = JaxTrainer(JaxTrainerConfig(**cfg), mesh=jax_mesh((2, 1, 2)))
    with pytest.raises(NameError, match="unbound axis name: seq"):
        jtrainer.fit_arrays(toks, toks)
