"""The port's Trainer over the LMs on a mesh with a seq axis, on the CPU,
against the JAX Trainer over a mesh of the same shape
(tests/test_torch_seq_axis_train.py holds the scoring models and the
helpers, tests/test_torch_seq_axis_moe.py the mixture-of-experts LMs,
tests/test_torch_seq_axis_pipeline.py the pipeline): a dense
`TransformerLM` with `attn_impl="flash"` (head dim 8: the port's plain
K1[lse], K2 and K3 on the CPU) over data 2 x seq 2 and data 2 x model 2 x
seq 2, the JAX fits attending densely (the same function at f32; the JAX
flash kernel's interpret mode costs seconds a fit, as in
tests/test_torch_tp_lm.py).  The seq axis replicates the batch in both
packages (the JAX Trainer's `P('data')`), so the port computes each
(data, model) group once, at seq index 0: the flash attention runs once a
layer a step per data shard (per model shard on its heads), as over the
mesh without its seq axis.

Bounds: tests/test_torch_dp_train.py's and tests/test_torch_tp_train.py's
(loss and grad_norm rel 1e-5, leaves atol 1e-5 with the key third of each
qkv bias left out); against the port's own fit over the mesh without its
seq axis, bit for bit.  The JAX fits run jitted once each, on two
threads, in a module fixture.
"""

import importlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import test_torch_dp_train as dpt
import test_torch_tp_train as tpt
from mmlspark_tpu.models import ModelBundle as JaxModelBundle
from mmlspark_tpu.train import Trainer as JaxTrainer
from mmlspark_tpu.train import TrainerConfig as JaxTrainerConfig
from mmlspark_tpu_torch import Trainer, TrainerConfig
from test_torch_dp_train import data, leaves
from test_torch_seq_axis_train import assert_same_fit, jax_mesh, port_mesh

RUNS = [("lm", (2, 1, 2)), ("lm", (2, 2, 2))]


def helpers(shape):
    """The data-axis file's helpers, or over a model axis the
    model-axis file's (its init's biases all nonzero)."""
    return dpt if shape[1] == 1 else tpt


def initial(name, shape):
    return helpers(shape).initial(name)


def port_fit(name, shape):
    trainer = Trainer(TrainerConfig(**helpers(shape).fit_config(name)),
                      mesh=port_mesh(shape))
    return trainer, trainer.fit_arrays(*data(name),
                                       initial_bundle=initial(name, shape))


def jax_fit(run):
    """The JAX Trainer's fit of `run` (an LM attending densely)."""
    name, shape = run
    cfg = tpt.jax_config(name)
    init = initial(name, shape)
    trainer = JaxTrainer(JaxTrainerConfig(**cfg), mesh=jax_mesh(shape))
    bundle = trainer.fit_arrays(*data(name), initial_bundle=JaxModelBundle(
        init.architecture, init.config, init.variables))
    return trainer.history, bundle


@pytest.fixture(scope="module")
def jax_fits():
    with ThreadPoolExecutor(2) as pool:
        return dict(zip(RUNS, pool.map(jax_fit, RUNS)))


@pytest.mark.parametrize("name,shape", RUNS)
def test_seq_axis_lm_fit_matches_the_jax_trainer(jax_fits, name, shape):
    jax_history, jax_bundle = jax_fits[name, shape]
    trainer, bundle = port_fit(name, shape)
    d, m, _ = shape
    assert (trainer.data_size, trainer.model_size) == (d, m)
    assert bundle.metadata == jax_bundle.metadata
    assert bundle.metadata["partition"]["mesh"] == {"data": d, "model": m}
    assert len(trainer.history) == len(jax_history)
    for got, ref in zip(trainer.history, jax_history):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-5)
    d_model = dpt.CASES[name][1]["d_model"]
    got, want = leaves(bundle.variables), leaves(jax_bundle.variables)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        if "qkv" in path and w.ndim == 1:
            g = np.delete(g, np.s_[d_model:2 * d_model])
            w = np.delete(w, np.s_[d_model:2 * d_model])
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=path)
    assert_same_fit((trainer, bundle), port_fit(name, (d, m, 1)))


@pytest.mark.parametrize("shape", [(2, 1, 2), (2, 2, 2)])
def test_flash_runs_once_a_layer_a_step_per_data_shard(monkeypatch, shape):
    """K1[lse] (and with it K2 and K3 in the backward) is called once per
    (step, data shard, model shard, layer) at the shard's batch and
    heads, exactly as over the mesh without its seq axis: the seq
    replicas launch nothing."""
    fa = importlib.import_module("mmlspark_tpu_torch.ops.flash_attention")
    real = fa.flash_attention_with_lse
    seen = {}
    for seq in (2, 1):
        calls = seen[seq] = []
        monkeypatch.setattr(fa, "flash_attention_with_lse",
                            lambda q, *a, calls=calls, **k: calls.append(
                                tuple(q.shape)) or real(q, *a, **k))
        port_fit("lm", shape[:2] + (seq,))
    monkeypatch.setattr(fa, "flash_attention_with_lse", real)
    mc = dpt.LM
    steps = 6   # 20 rows at batch 8, 2 epochs
    want = (dpt.BATCH // shape[0], mc["max_len"], mc["n_heads"] // shape[1],
            mc["d_model"] // mc["n_heads"])
    n = steps * shape[0] * shape[1] * mc["n_layers"]
    assert seen[2] == seen[1] == [want] * n
