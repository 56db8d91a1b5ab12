"""The port's Trainer over the mixture-of-experts LMs on a mesh with a
seq axis, on the CPU, against the JAX Trainer over a mesh of the same
shape (tests/test_torch_seq_axis_train.py holds the helpers): the MoE LM
of tests/test_torch_dp_train.py over data 2 x seq 2 (its sown losses in
the objective, each data shard's tokens routed in the global batch's
group size), and the expert-parallel LM of tests/test_torch_tp_moe.py
(8 experts over 'model') over data 2 x model 2 x seq 2.  The routing
groups are cut by the data shards alone (`moe_apply(shards=2)`): the seq
axis replicates the batch in both packages, and the port computes each
(data, model) group once, at seq index 0.

Bounds: the MoE parity files' (loss rel 1e-5, overflow fraction abs 1e-6,
all but 0.1% of each leaf's entries within 1e-4 of its max |w| and the
leaf within 1e-4 in Frobenius norm, the key third of each qkv bias left
out); against the port's own fit over the mesh without its seq axis,
bit for bit.  The JAX fits run jitted once each, on two threads, in a
module fixture.
"""

import importlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import test_torch_dp_train as dpt
import test_torch_tp_moe as tpm
from mmlspark_tpu.models import ModelBundle as JaxModelBundle
from mmlspark_tpu.train import Trainer as JaxTrainer
from mmlspark_tpu.train import TrainerConfig as JaxTrainerConfig
from mmlspark_tpu_torch import Trainer, TrainerConfig
from test_torch_dp_train import leaves
from test_torch_seq_axis_train import assert_same_fit, jax_mesh, port_mesh

# name: (fit settings, data, the port's init, model config)
CASES = {
    "moe": (dpt.fit_config("moe"), dpt.data("moe"), dpt.initial("moe"),
            dpt.MOE),
    "ep": (tpm.fit_config(), (tpm.TOKS, tpm.TGTS), tpm.initial(),
           tpm.EP_MODEL),
}
RUNS = [("moe", (2, 1, 2)), ("ep", (2, 2, 2))]


def port_fit(name, shape):
    cfg, xy, init, _ = CASES[name]
    trainer = Trainer(TrainerConfig(**cfg), mesh=port_mesh(shape))
    return trainer, trainer.fit_arrays(*xy, initial_bundle=init)


def jax_fit(run):
    name, shape = run
    cfg, xy, init, _ = CASES[name]
    trainer = JaxTrainer(JaxTrainerConfig(**cfg), mesh=jax_mesh(shape))
    bundle = trainer.fit_arrays(*xy, initial_bundle=JaxModelBundle(
        init.architecture, init.config, init.variables))
    return trainer.history, bundle


@pytest.fixture(scope="module")
def jax_fits():
    with ThreadPoolExecutor(2) as pool:
        return dict(zip(RUNS, pool.map(jax_fit, RUNS)))


@pytest.mark.parametrize("name,shape", RUNS)
def test_seq_axis_moe_fit_matches_the_jax_trainer(jax_fits, name, shape):
    jax_history, jax_bundle = jax_fits[name, shape]
    trainer, bundle = port_fit(name, shape)
    d, m, _ = shape
    assert (trainer.data_size, trainer.model_size) == (d, m)
    if m > 1:
        assert trainer.param_splits["block0_w.moe.w_in"] == (0, 1)
    assert bundle.metadata == jax_bundle.metadata
    assert len(trainer.history) == len(jax_history)
    for got, ref in zip(trainer.history, jax_history):
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        assert got["moe_overflow_fraction"] == pytest.approx(
            ref["moe_overflow_fraction"], abs=1e-6)
    d_model = CASES[name][3]["d_model"]
    for (path, g), (_, w) in zip(leaves(bundle.variables),
                                 leaves(jax_bundle.variables)):
        if "qkv" in path and w.ndim == 1:
            g = np.delete(g, np.s_[d_model:2 * d_model])
            w = np.delete(w, np.s_[d_model:2 * d_model])
        diff = np.abs(g - w)
        assert (diff > 1e-4 * np.abs(w).max()).mean() <= 1e-3, path
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w), path
    assert_same_fit((trainer, bundle), port_fit(name, (d, m, 1)))


@pytest.mark.parametrize("name,shape", RUNS)
def test_moe_groups_count_the_data_shards_only(monkeypatch, name, shape):
    """Each MoE call routes its data shard's tokens as one of the data
    axis's 2 shards (`moe_apply(shards=2)`), as over the mesh without
    its seq axis."""
    moe = importlib.import_module("mmlspark_tpu_torch.ops.moe")
    real = moe.moe_apply
    shards = []
    monkeypatch.setattr(moe, "moe_apply", lambda *a, **k: shards.append(
        k.get("shards", 1)) or real(*a, **k))
    port_fit(name, shape)
    monkeypatch.setattr(moe, "moe_apply", real)
    assert shards and set(shards) == {shape[0]}
