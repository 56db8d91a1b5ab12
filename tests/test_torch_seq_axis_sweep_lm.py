"""A flash TransformerLM population over data 2 x seq 2 on the CPU
(`mmlspark_tpu_torch/train/sweep.py`), with
tests/test_torch_seq_axis_sweep.py's helpers and bounds: the members'
losses and leaves against the JAX package's `PopulationTrainer` over a
data 2 x seq 2 mesh (attending densely: its flash kernel's interpret
mode costs ~10 s a fit) and bit for bit the port's population over data
2; the flash operator once per
(step, data shard, layer) for both members at the folded shape; a
population of 1 against the port's plain Trainer over the same mesh."""

import importlib

import numpy as np
import pytest

from mmlspark_tpu_torch.models.bundle import ModelBundle
from mmlspark_tpu_torch.models.definitions import model_config
from mmlspark_tpu_torch.train import (PopulationTrainer, Trainer,
                                      TrainerConfig)
from test_torch_seq_axis_sweep import (CASES, _flat, check_population,
                                       jax_population, port_mesh,
                                       port_population)

RUN = ("lm", (2, 1, 2))


@pytest.fixture(scope="module")
def jax_ref():
    return jax_population(RUN)


def test_lm_population_over_a_seq_mesh(jax_ref):
    check_population(*RUN, *jax_ref)


def test_flash_population_folds_once_per_data_shard(monkeypatch):
    """Over data 2 x seq 2 the flash operator runs once per (step, data
    shard, layer) for both members at the folded shape (2 members x 2
    rows), as over data 2: the seq replicas launch nothing."""
    fa = importlib.import_module("mmlspark_tpu_torch.ops.flash_attention")
    real = fa.flash_attention_with_lse
    seen = {}
    for seq in (2, 1):
        calls = seen[seq] = []
        monkeypatch.setattr(fa, "flash_attention_with_lse",
                            lambda q, *a, calls=calls, **k: calls.append(
                                tuple(q.shape)) or real(q, *a, **k))
        port_population("lm", (2, 1, seq))
    monkeypatch.setattr(fa, "flash_attention_with_lse", real)
    # 2 steps x 2 data shards x 2 layers, 4 heads of 8 at 16 positions
    assert seen[2] == seen[1] == [(4, 16, 4, 8)] * 8


@pytest.mark.parametrize("name", ["lm", "mlp"])
def test_population_of_one_equals_the_plain_trainer_over_a_seq_mesh(name):
    """One member over data 2 x seq 2 from its init against the plain
    Trainer over the same mesh: the flash LM's losses and leaves byte for
    byte; the MLP's within 1e-6 (tests/test_torch_sweep_mesh.py's bound:
    its epoch losses average in another order, and over a data axis its
    vmapped products at the shard's batch round apart by an ulp)."""
    fit, _, _, inits, (x, y) = CASES[name]
    cfg = TrainerConfig(**fit)
    pt = PopulationTrainer(cfg, 1, mesh=port_mesh((2, 1, 2)))
    result = pt.fit_arrays(x, y, member_variables=inits[:1])
    trainer = Trainer(cfg, mesh=port_mesh((2, 1, 2)))
    bundle = trainer.fit_arrays(x, y, initial_bundle=ModelBundle(
        cfg.architecture, model_config(pt.module), inits[0]))
    losses = ([h["member_loss"][0] for h in pt.history],
              [h["loss"] for h in trainer.history])
    got = dict(_flat(pt.member_variables(result.state, 0)["params"]))
    if name == "lm":
        np.testing.assert_array_equal(*losses)
        for key, w in _flat(bundle.variables["params"]):
            assert got[key].tobytes() == w.tobytes(), key
        return
    np.testing.assert_allclose(*losses, rtol=1e-6)
    for key, w in _flat(bundle.variables["params"]):
        assert np.abs(got[key] - w).max() <= 1e-6 * np.abs(w).max(), key
