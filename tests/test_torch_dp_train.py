"""The port's data-parallel Trainer against the JAX Trainer on a mesh of
the same data width, on the CPU: the port's shards are host shards
`[torch.device("cpu")] * n`, the JAX Trainer's `jax.devices()[:n]`.

Cases (f32, a partial last batch: 20 rows at batch 8, 2 epochs, 6 steps):
an MLP (momentum) and a basic ResNet with BatchNorm (Adam) at data 2 and
4, a ConvNet (Adam, clipped, cosine) at data 2.  tests/test_torch_dp_lm.py
holds a dense `TransformerLM` with `attn_impl="flash"` (the port's plain
kernel versions on the CPU) at data 2 and 4 and a mixture-of-experts LM
with its sown losses in the objective at data 2, with this file's
helpers.  Both Trainers start from the same `initial_bundle` (the port's
seeded init).  Tolerances:

  * the history's loss and grad_norm rel 1e-5 (the MoE LM's loss rel
    1e-5, its overflow fraction abs 1e-6);
  * the final parameters and `batch_stats` atol 1e-5: the ResNet's
    statistics are the GLOBAL batch's in both packages (per-shard
    statistics part by more than 1e-3 here, the planted case below);
    the key third of each qkv bias is left out (its true gradient is
    zero and Adam scales round-off there, tests/test_torch_train.py);
    the MoE LM's leaves as tests/test_torch_moe_train.py holds them (all
    but 0.1% within 1e-4 of max |w|);
  * the bundle's metadata equal, its partition mesh {"data": n,
    "model": 1}.

The summation order of the gradient reduce (shard order on the home
device) is not XLA's all-reduce, so trained values agree to these
tolerances, not bit for bit.  The JAX fits are jitted once each, on two
threads, in a module fixture.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.models import ModelBundle as JaxModelBundle
from mmlspark_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from mmlspark_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mmlspark_tpu.train import Trainer as JaxTrainer
from mmlspark_tpu.train import TrainerConfig as JaxTrainerConfig
from mmlspark_tpu_torch import ModelBundle, Trainer, TrainerConfig
from mmlspark_tpu_torch.models import definitions
from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh

N_ROWS, BATCH = 20, 8
LM = {"vocab_size": 64, "d_model": 32, "n_heads": 4, "n_layers": 1,
      "max_len": 16, "dtype": "float32", "attn_impl": "flash"}
MOE = {**LM, "attn_impl": "dense", "mlp_impl": "moe",
       "n_experts": 4, "moe_router_k": 2, "moe_group_size": 8}
# name: (architecture, model config, optimizer settings, loss, input)
CASES = {
    "mlp": ("MLPClassifier", {"hidden_sizes": [16, 8], "num_classes": 3,
                              "dtype": "float32"},
            dict(optimizer="momentum", learning_rate=0.05),
            "softmax_xent", "table"),
    "resnet": ("ResNet", {"stage_sizes": [1, 1], "widths": [8, 8],
                          "num_classes": 4, "block_kind": "basic",
                          "dtype": "float32"},
               dict(optimizer="adam", learning_rate=1e-3),
               "softmax_xent", "unit"),
    "convnet": ("ConvNetCIFAR10", {"num_classes": 5, "widths": [4, 8, 8],
                                   "dense_width": 16, "dtype": "float32"},
                dict(optimizer="adam", learning_rate=1e-3,
                     lr_schedule="cosine", gradient_clip_norm=1.0),
                "softmax_xent", "uint8"),
    # tests/test_torch_train.py's LM fit settings
    "lm": ("TransformerLM", LM, dict(optimizer="adam", learning_rate=1e-2,
                                     lr_schedule="warmup_cosine",
                                     warmup_steps=2, gradient_clip_norm=1.0),
           "softmax_xent", "tokens"),
    "moe": ("TransformerLM", MOE, dict(optimizer="adam", learning_rate=1e-2,
                                       aux_loss_weight=0.05),
            "softmax_xent", "tokens"),
}
RUNS = [("mlp", 2), ("mlp", 4), ("resnet", 2), ("resnet", 4),
        ("convnet", 2)]


def data(name):
    arch, mc, _, _, kind = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    if kind == "tokens":
        rows = (rng.integers(0, mc["vocab_size"], (N_ROWS, 1))
                + np.arange(mc["max_len"] + 1)) % mc["vocab_size"]
        return rows[:, :-1].astype(np.int32), rows[:, 1:].astype(np.int32)
    if kind == "table":
        x = rng.standard_normal((N_ROWS, 6)).astype(np.float32)
    else:
        x = rng.integers(0, 256, (N_ROWS, 16, 16, 3)).astype(np.uint8)
        if kind == "unit":
            x = (x / np.float32(255)).astype(np.float32)
    return x, rng.integers(0, mc["num_classes"], N_ROWS).astype(np.int32)


def fit_config(name):
    arch, mc, opt, loss, _ = CASES[name]
    return dict(architecture=arch, model_config=dict(mc), loss=loss,
                batch_size=BATCH, epochs=2, seed=3, shuffle_each_epoch=True,
                numerics_cadence=0, **opt)


def initial(name):
    arch, mc, *_ = CASES[name]
    x, _ = data(name)
    return ModelBundle.init(arch, mc, seed=1, input_shape=(1,) + x.shape[1:])


def port_fit(name, dp, **kw):
    trainer = Trainer(TrainerConfig(**fit_config(name)),
                      mesh=make_mesh(MeshSpec(data=dp),
                                     [torch.device("cpu")] * dp),
                      **kw)
    return trainer, trainer.fit_arrays(*data(name),
                                       initial_bundle=initial(name))


def jax_fit_all(runs) -> dict:
    """Each (case, data width) fitted by the JAX Trainer on a mesh of
    that width, jitted, on two threads: {run: (history, bundle)}."""
    def fit(run):
        name, dp = run
        init = initial(name)
        trainer = JaxTrainer(JaxTrainerConfig(**fit_config(name)),
                             mesh=jax_make_mesh(JaxMeshSpec(data=dp),
                                                jax.devices()[:dp]))
        bundle = trainer.fit_arrays(*data(name), initial_bundle=JaxModelBundle(
            init.architecture, init.config, init.variables))
        return trainer.history, bundle

    with ThreadPoolExecutor(2) as pool:
        return dict(zip(runs, pool.map(fit, runs)))


@pytest.fixture(scope="module")
def jax_fits():
    return jax_fit_all(RUNS)


def leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)]


def check_fit(name, dp, jax_history, jax_bundle) -> None:
    """The port's fit of `name` at data `dp` against the JAX Trainer's
    (module docstring)."""
    trainer, bundle = port_fit(name, dp)
    assert trainer.data_size == dp
    assert bundle.metadata == jax_bundle.metadata
    assert bundle.metadata["partition"]["mesh"] == {"data": dp, "model": 1}
    assert len(trainer.history) == len(jax_history)
    for got, ref in zip(trainer.history, jax_history):
        keys = ("loss",) if name == "moe" else ("loss", "grad_norm")
        for key in keys:
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-5)
        if name == "moe":
            assert got["moe_overflow_fraction"] == pytest.approx(
                ref["moe_overflow_fraction"], abs=1e-6)
    got, want = leaves(bundle.variables), leaves(jax_bundle.variables)
    assert [p for p, _ in got] == [p for p, _ in want]
    d = CASES[name][1].get("d_model", 0)
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        if "qkv" in path and w.ndim == 1:
            g, w = np.delete(g, np.s_[d:2 * d]), np.delete(w, np.s_[d:2 * d])
        if name == "moe":
            diff = np.abs(g - w)
            assert (diff > 1e-4 * np.abs(w).max()).mean() <= 1e-3, path
            assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w), path
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5,
                                       err_msg=path)
    assert ("batch_stats" in bundle.variables) == (name == "resnet")


@pytest.mark.parametrize("name,dp", RUNS)
def test_data_parallel_fit_matches_the_jax_trainer(jax_fits, name, dp):
    check_fit(name, dp, *jax_fits[name, dp])


def test_per_shard_batch_statistics_would_fail_the_parity(jax_fits,
                                                          monkeypatch):
    """The planted fault: a BatchNorm that takes each shard's own
    statistics (no cross-shard sum) parts from the JAX Trainer's global
    statistics by far more than the tolerance above."""
    real = definitions.active_data_shard
    monkeypatch.setattr(definitions, "active_data_shard", lambda: None)
    try:
        _, bundle = port_fit("resnet", 2)
    finally:
        monkeypatch.setattr(definitions, "active_data_shard", real)
    _, jax_bundle = jax_fits["resnet", 2]
    gaps = [np.abs(g - w).max() for (_, g), (_, w) in zip(
        leaves(bundle.variables["batch_stats"]),
        leaves(jax_bundle.variables["batch_stats"]))]
    assert max(gaps) > 1e-3
