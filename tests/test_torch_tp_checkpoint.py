"""Checkpoints, elastic resume and `TPULearner` over a (data, model) mesh
(tests/test_partition.py:248-325 and the JAX learner's `set_mesh`), on
the CPU with tests/test_torch_tp_train.py's helpers: a (2, 2) fit records
`data_devices` 2 and `model_devices` 2 and its bundle the partition mesh
{"data": 2, "model": 2}, as the JAX Trainer writes them; the saved
payload is the gathered full tree, so restores cross dp <-> dp x mp byte
for byte, within the port and across the packages both ways (the qkv
head-aligned slices reassemble the reference's layout); a data-2 run
resumes onto (2, 2) continuing its step count; `TPULearner.set_mesh`
hands the model axis to its Trainer.
"""

import jax
import numpy as np
import torch

from mmlspark_tpu.core.table import DataTable as JaxDataTable
from mmlspark_tpu.models import ModelBundle as JaxModelBundle
from mmlspark_tpu.train import TPULearner as JaxTPULearner
from mmlspark_tpu.train import Trainer as JaxTrainer
from mmlspark_tpu.train import TrainerConfig as JaxTrainerConfig
from mmlspark_tpu_torch import DataTable, TPULearner, Trainer, TrainerConfig
from mmlspark_tpu_torch.resilience.checkpoints import (
    checkpoint_meta, latest_valid_checkpoint)
from test_torch_dp_train import data, fit_config, leaves
from test_torch_tp_train import (check_leaves, host_mesh, initial,
                                 jax_config, jax_mesh)


def _lm_fit(ckpt, dp, mp, epochs=1, resume=False):
    trainer = Trainer(TrainerConfig(**{**fit_config("lm"), "epochs": epochs,
                                       "checkpoint_every_steps": 1}),
                      mesh=host_mesh(dp, mp) if dp * mp > 1 else None,
                      device="cpu")
    trainer.fit_arrays(*data("lm"), initial_bundle=initial("lm"),
                       ckpt_dir=ckpt, resume=resume)
    return trainer


def _params_bytes(trainer) -> list:
    return [t.detach().numpy().tobytes()
            for t in trainer._last_state.params]


def test_checkpoints_cross_dp_and_dp_x_mp_byte_identically(tmp_path):
    """A (2, 2) fit records its topology; its newest checkpoint restores
    onto data 2, onto one device and onto (4, 2) with the same bytes (the
    model shards' slices included), and a data-2 checkpoint onto (2,
    2)."""
    ckpt = str(tmp_path / "mp")
    src = _lm_fit(ckpt, 2, 2)
    meta = checkpoint_meta(latest_valid_checkpoint(ckpt))
    assert (meta["data_devices"], meta["model_devices"]) == (2, 2)
    want = _params_bytes(src)
    for dp, mp in ((2, 1), (1, 1), (4, 2)):
        t = Trainer(TrainerConfig(**fit_config("lm")),
                    mesh=host_mesh(dp, mp) if dp * mp > 1 else None,
                    device="cpu")
        state = t.init_state((1, 16), 1, initial_bundle=initial("lm"))
        t._last_state = t.restore_checkpoint(state, ckpt)
        assert int(t._last_state.step) == int(src._last_state.step)
        assert _params_bytes(t) == want
        if mp > 1:
            _, shards = t._replicas.rows[-1]
            name = "block0_w.mlp_up.weight"
            dim, _ = t.param_splits[name]
            full = t._last_state.params[t._names.index(name)]
            assert torch.equal(shards[1].get_parameter(name),
                               full.chunk(mp, dim)[1])
    ckpt2 = str(tmp_path / "dp")
    src2 = _lm_fit(ckpt2, 2, 1)
    t = Trainer(TrainerConfig(**fit_config("lm")), mesh=host_mesh(2, 2))
    state = t.init_state((1, 16), 1, initial_bundle=initial("lm"))
    t._last_state = t.restore_checkpoint(state, ckpt2)
    assert _params_bytes(t) == _params_bytes(src2)


def test_checkpoints_cross_the_packages_both_ways(tmp_path):
    """A port (2, 2) checkpoint restores into the JAX Trainer on its (2,
    2) mesh with the same bytes, and one the JAX Trainer writes there
    into the port's (2, 2) Trainer."""
    ckpt = str(tmp_path / "port")
    src = _lm_fit(ckpt, 2, 2)
    init = initial("lm")
    jax_init = JaxModelBundle(init.architecture, init.config, init.variables)
    jt = JaxTrainer(JaxTrainerConfig(**jax_config("lm")),
                    mesh=jax_mesh(2, 2))
    jstate = jt.init_state((1, 16), 1, initial_bundle=jax_init,
                           input_dtype=np.int32)
    jrestored = jt.restore_checkpoint(jstate, ckpt)
    assert int(jrestored.step) == int(src._last_state.step)
    port_tree = src.state_tree(src._last_state)["params"]
    for (path, a), (_, b) in zip(leaves(port_tree),
                                 leaves(jrestored.params)):
        assert a.tobytes() == np.asarray(b).tobytes(), path
    ckpt2 = str(tmp_path / "jax")
    jt.save_checkpoint(jrestored, ckpt2)
    t = Trainer(TrainerConfig(**fit_config("lm")), mesh=host_mesh(2, 2))
    state = t.restore_checkpoint(
        t.init_state((1, 16), 1, initial_bundle=init), ckpt2)
    for (path, a), (_, b) in zip(leaves(t.state_tree(state)["params"]),
                                 leaves(jrestored.params)):
        assert a.tobytes() == np.asarray(b).tobytes(), path


def test_elastic_resume_onto_dp_x_mp_continues_the_steps(tmp_path):
    """A data-2 run's checkpoints resume onto (2, 2) for a second epoch:
    the step count continues and the resumed fit equals an uninterrupted
    (2, 2) fit to the parity tolerance."""
    ckpt = str(tmp_path / "elastic")
    first = _lm_fit(ckpt, 2, 1, epochs=1)
    steps = int(first._last_state.step)
    resumed = _lm_fit(ckpt, 2, 2, epochs=2, resume=True)
    assert int(resumed._last_state.step) == 2 * steps
    assert checkpoint_meta(latest_valid_checkpoint(ckpt))[
        "model_devices"] == 2
    whole = _lm_fit(str(tmp_path / "whole"), 2, 2, epochs=2)
    check_leaves("lm", resumed.state_tree(resumed._last_state)["params"],
                 whole.state_tree(whole._last_state)["params"])


def test_learner_over_a_model_axis_fits_what_the_jax_learner_fits():
    """`TPULearner.set_mesh` at (2, 2) hands the mesh to its Trainer: the
    learned weights are the JAX learner's on its (2, 2) mesh, and the
    model scores over the same mesh."""
    x, y = data("mlp")
    init = initial("mlp")
    cfg = {**fit_config("mlp"), "epochs": 1}
    model = TPULearner(TrainerConfig(**cfg), device="cpu").set_mesh(
        host_mesh(2, 2)).set_initial_bundle(init).fit(
        DataTable({"features": x, "label": y}))
    jl = JaxTPULearner(JaxTrainerConfig(**cfg)).set_mesh(jax_mesh(2, 2))
    jl.set_initial_bundle(JaxModelBundle(init.architecture, init.config,
                                         init.variables))
    jmodel = jl.fit(JaxDataTable({"features": x, "label": y}))
    check_leaves("mlp", model.bundle.variables, jmodel.bundle.variables)
    assert model.bundle.metadata == jmodel.bundle.metadata
    scores = model.transform(DataTable({"features": x}))[model.outputCol]
    jscores = np.asarray(jmodel.transform(JaxDataTable({"features": x}))[
        jmodel.outputCol])
    np.testing.assert_allclose(scores, jscores, rtol=0, atol=1e-4)
    assert jax.devices()   # the JAX side ran on its virtual CPU mesh
