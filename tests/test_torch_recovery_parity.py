"""Fault-tolerant training across the two packages, on the CPU: a fit the
JAX Trainer preempts resumes in the port from the JAX checkpoint and
ends at the JAX fault-free run's step count and weights; and the
numerics probe's health dict carries the JAX package's keys and values.
The supervisors' timelines: tests/test_torch_supervisor_parity.py.
"""

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.models import ModelBundle as JaxModelBundle
from mmlspark_tpu.observe.numerics import tree_health as jax_tree_health
from mmlspark_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from mmlspark_tpu.parallel.mesh import make_mesh
from mmlspark_tpu.resilience import ChaosInjector as JaxChaosInjector
from mmlspark_tpu.resilience import Fault as JaxFault
from mmlspark_tpu.resilience import Preempted as JaxPreempted
from mmlspark_tpu.resilience import reset_chaos as jax_reset_chaos
from mmlspark_tpu.resilience import set_injector as jax_set_injector
from mmlspark_tpu.train import Trainer as JaxTrainer
from mmlspark_tpu.train import TrainerConfig as JaxTrainerConfig
from mmlspark_tpu_torch import ModelBundle, Trainer, TrainerConfig
from mmlspark_tpu_torch.models.bundle import params_from_jax
from mmlspark_tpu_torch.models.definitions import init_transformer_lm_params
from mmlspark_tpu_torch.observe.numerics import fetch_health, tree_health
from mmlspark_tpu_torch.resilience.chaos import reset_chaos

LM = {"vocab_size": 32, "d_model": 16, "n_heads": 2, "n_layers": 1,
      "max_len": 8, "dtype": "float32", "attn_impl": "dense"}
FIT = dict(architecture="TransformerLM", model_config=dict(LM),
           optimizer="adam", learning_rate=1e-2, lr_schedule="cosine",
           gradient_clip_norm=1.0, batch_size=16, epochs=2, seed=4,
           shuffle_each_epoch=True, numerics_cadence=0,
           checkpoint_every_steps=2)


@pytest.fixture(autouse=True)
def _clean_chaos():
    reset_chaos()
    jax_reset_chaos()
    yield
    reset_chaos()
    jax_reset_chaos()


def lm_data(n=64, seq=8, seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, LM["vocab_size"], (n, seq + 1)).astype(np.int32)
    return rows[:, :-1], rows[:, 1:]


def one_device():
    return make_mesh(JaxMeshSpec(data=1), devices=jax.devices()[:1])


def test_a_fit_the_jax_trainer_preempts_resumes_in_the_port(tmp_path):
    """The JAX Trainer is preempted at step 3 (chaos SIGTERM; emergency
    checkpoint at 4); the port resumes from that checkpoint with flash
    attention and finishes with the JAX fault-free run's step count and,
    at f32, its weights within atol 1e-5 (the key third of each qkv bias
    held apart, as tests/test_torch_train.py does: its true gradient is
    zero and Adam scales either package's round-off there)."""
    x, y = lm_data()
    init = ModelBundle.init("TransformerLM", LM, seed=0)
    jax_init = JaxModelBundle("TransformerLM", dict(LM), init.variables)
    ref = JaxTrainer(JaxTrainerConfig(**FIT), mesh=one_device()).fit_arrays(
        x, y, initial_bundle=jax_init)
    ckpt = str(tmp_path / "ckpt")
    previous = jax_set_injector(JaxChaosInjector(
        script=[JaxFault("sigterm", step=3)]))
    try:
        with pytest.raises(JaxPreempted) as ei:
            JaxTrainer(JaxTrainerConfig(**FIT), mesh=one_device()
                       ).fit_arrays(x, y, initial_bundle=jax_init,
                                    ckpt_dir=ckpt)
    finally:
        jax_set_injector(previous)
    assert ei.value.step == 4
    port_cfg = dict(FIT, model_config={**LM, "attn_impl": "flash"})
    port = Trainer(TrainerConfig(**port_cfg), device="cpu")
    got = port.fit_arrays(x, y, initial_bundle=init, ckpt_dir=ckpt,
                          resume=True)
    assert got.metadata == ref.metadata
    assert got.metadata["steps"] == 8
    d = LM["d_model"]
    ref_l = jax.tree_util.tree_leaves_with_path(ref.variables)
    got_l = jax.tree_util.tree_leaves_with_path(got.variables)
    assert [p for p, _ in ref_l] == [p for p, _ in got_l]
    for (path, a), (_, b) in zip(ref_l, got_l):
        a, b = np.asarray(a), np.asarray(b)
        if "qkv" in jax.tree_util.keystr(path) and a.ndim == 1:
            a, b = np.delete(a, np.s_[d:2 * d]), np.delete(b, np.s_[d:2 * d])
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


def test_health_probe_matches_the_reference():
    """`tree_health` over the same parameters, gradients, updates and
    logits: the JAX package's keys, fetched in its (sorted) order, and
    its values to f32 rounding."""
    rng = np.random.default_rng(3)
    trees = [init_transformer_lm_params({**LM, "n_layers": 2}, seed=s)
             ["params"] for s in (0, 1, 2)]
    trees[1]["lm_head"]["bias"][3] = np.nan
    acts = rng.standard_normal((2, 8, 32)).astype(np.float32)
    acts[0, 0, 0] = np.inf
    ref = jax.device_get(jax.jit(jax_tree_health)(*trees, acts=acts))
    named = [params_from_jax(t) for t in trees]
    got = tree_health(*named, acts=torch.from_numpy(acts))
    assert list(fetch_health(got)) == list(ref)
    for key in ref:
        np.testing.assert_allclose(float(got[key]), float(ref[key]),
                                   rtol=1e-5, err_msg=key)
