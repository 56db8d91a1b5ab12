"""The recovery supervisors of both packages under the same chaos
script, on the CPU: a NaN poisons one step of a small TransformerLM fit
with a probe and a checkpoint every step; both roll back, skip the same
window and complete, recording the same timeline.
"""

import jax
import numpy as np
import pytest

from mmlspark_tpu.models import ModelBundle as JaxModelBundle
from mmlspark_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from mmlspark_tpu.parallel.mesh import make_mesh
from mmlspark_tpu.resilience import ChaosInjector as JaxChaosInjector
from mmlspark_tpu.resilience import Fault as JaxFault
from mmlspark_tpu.resilience import reset_chaos as jax_reset_chaos
from mmlspark_tpu.resilience import set_injector as jax_set_injector
from mmlspark_tpu.train import RecoveryPolicy as JaxRecoveryPolicy
from mmlspark_tpu.train import RecoverySupervisor as JaxRecoverySupervisor
from mmlspark_tpu.train import TrainerConfig as JaxTrainerConfig
from mmlspark_tpu_torch import ModelBundle, TrainerConfig
from mmlspark_tpu_torch.resilience.chaos import (ChaosInjector, Fault,
                                                 reset_chaos, set_injector)
from mmlspark_tpu_torch.train import RecoveryPolicy, RecoverySupervisor

LM = {"vocab_size": 32, "d_model": 16, "n_heads": 2, "n_layers": 1,
      "max_len": 8, "dtype": "float32", "attn_impl": "dense"}
FIT = dict(architecture="TransformerLM", model_config=dict(LM),
           optimizer="sgd", learning_rate=1e-2, batch_size=16,
           epochs=1, seed=4, shuffle_each_epoch=False, numerics_cadence=1,
           halt_on_nonfinite=True, checkpoint_every_steps=1)


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


def test_supervisor_timelines_agree(tmp_path):
    """A NaN at step 2 of 4 under each package's supervisor
    (learning-rate backoff, refolded data order): the same events,
    kinds, steps, restore points, skip windows, rate scales and folds,
    and the same failure text but for the directory."""
    x, y = lm_data()
    init = ModelBundle.init("TransformerLM", LM, seed=0)
    cfg = dict(FIT)
    policy = dict(max_recoveries=2, lr_backoff=0.5)
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    one_device = make_mesh(JaxMeshSpec(data=1), devices=jax.devices()[:1])
    previous = jax_set_injector(JaxChaosInjector(
        script=[JaxFault("nan", step=2)]))
    try:
        jax_sup = JaxRecoverySupervisor(JaxTrainerConfig(**cfg),
                                        JaxRecoveryPolicy(**policy),
                                        mesh=one_device)
        jax_bundle = jax_sup.fit_arrays(
            x, y, ckpt_dir=jax_dir, initial_bundle=JaxModelBundle(
                "TransformerLM", dict(LM), init.variables))
    finally:
        jax_set_injector(previous)
    previous = set_injector(ChaosInjector(script=[Fault("nan", step=2)]))
    try:
        sup = RecoverySupervisor(TrainerConfig(**cfg),
                                 RecoveryPolicy(**policy), device="cpu")
        bundle = sup.fit_arrays(x, y, ckpt_dir=port_dir, initial_bundle=init)
    finally:
        set_injector(previous)

    def plain(timeline, d):
        return [{k: (v.replace(d, "<dir>") if isinstance(v, str) else v)
                 for k, v in e.items()} for e in timeline]

    assert plain(sup.timeline, port_dir) == plain(jax_sup.timeline,
                                                  jax_dir)
    assert [e["event"] for e in sup.timeline] == \
        ["failure", "recover", "completed"]
    assert bundle.metadata["steps"] == jax_bundle.metadata["steps"] == 4
    assert sup.timeline[1]["skip_window"] == [2, 2]
