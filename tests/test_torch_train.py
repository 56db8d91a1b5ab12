"""The port's Trainer against the JAX package, on the CPU: `fit_arrays`
end to end at f32, and the port's flash and dense attention giving the
same gradients.

Both packages get the same inputs (numpy arrays from seeded generators)
and the same `initial_bundle` (the port's seeded init).  The JAX Trainer
runs on a one-device mesh, as the port does; its run is shared through a
module-scoped fixture.  The optimizers, losses, data order and config are
in tests/test_torch_optim.py; bf16 training and trained bundles in the
JAX package in tests/test_torch_train_bundle.py.
"""

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.models import ModelBundle as JaxModelBundle
from mmlspark_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from mmlspark_tpu.parallel.mesh import make_mesh
from mmlspark_tpu.train import Trainer as JaxTrainer
from mmlspark_tpu.train import TrainerConfig as JaxTrainerConfig
from mmlspark_tpu_torch import ModelBundle, Trainer, TrainerConfig
from mmlspark_tpu_torch.models.bundle import params_from_jax
from mmlspark_tpu_torch.train.trainer import make_loss

LM = {"vocab_size": 64, "d_model": 32, "n_heads": 4, "n_layers": 2,
      "max_len": 32, "dtype": "float32", "attn_impl": "flash"}
FIT = dict(architecture="TransformerLM", optimizer="adam",
           learning_rate=1e-2, lr_schedule="warmup_cosine", warmup_steps=2,
           gradient_clip_norm=1.0, batch_size=8, epochs=2, seed=3,
           shuffle_each_epoch=True, numerics_cadence=0)


def corpus(n_rows=20, seq=32, vocab=64, seed=41):
    """Example 401's learnable corpus: rows cycle the vocabulary from a
    random phase; inputs and targets are slices."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, vocab, size=(n_rows, 1))
    rows = ((starts + np.arange(seq + 1)) % vocab).astype(np.int32)
    return rows[:, :-1], rows[:, 1:]


def jax_fit(model_config, x, y, init):
    """The JAX Trainer on a one-device mesh from `init`'s weights."""
    trainer = JaxTrainer(
        JaxTrainerConfig(model_config=dict(model_config), **FIT),
        mesh=make_mesh(JaxMeshSpec(data=1), devices=jax.devices()[:1]))
    bundle = trainer.fit_arrays(x, y, initial_bundle=JaxModelBundle(
        "TransformerLM", dict(model_config), init.variables))
    return trainer, bundle


# ------------------------------------------------------- fit_arrays ---

@pytest.fixture(scope="module")
def fits():
    """20 rows at batch 8 (a partial last batch with 4 masked pad rows),
    shuffled, 2 epochs: 6 adam steps with warmup-cosine and clipping."""
    x, y = corpus()
    init = ModelBundle.init("TransformerLM", LM, seed=0)
    jax_trainer, jax_bundle = jax_fit(LM, x, y, init)
    port = Trainer(TrainerConfig(model_config=dict(LM), **FIT), device="cpu")
    bundle = port.fit_arrays(x, y, initial_bundle=init)
    return jax_trainer, jax_bundle, port, bundle


def test_fit_history_matches_jax(fits):
    jax_trainer, _, port, _ = fits
    assert len(port.history) == len(jax_trainer.history) == 2
    for got, ref in zip(port.history, jax_trainer.history):
        assert got["epoch"] == ref["epoch"]
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-5)
    assert port.history[1]["loss"] < port.history[0]["loss"]


def test_fit_final_params_match_jax(fits):
    """Final parameters within atol 1e-5 (measured gap 4.8e-7 on the CPU).

    The key third of each `qkv` bias is held apart: softmax is invariant to
    a per-query constant, so its true gradient is zero and both packages
    feed Adam f32 round-off there, which Adam scales to lr-sized steps of
    either sign.  The port's own gradient of it is checked to be round-off
    instead."""
    _, jax_bundle, port, bundle = fits
    d = LM["d_model"]
    ref_leaves = jax.tree_util.tree_leaves_with_path(jax_bundle.variables)
    got_leaves = jax.tree_util.tree_leaves_with_path(bundle.variables)
    assert [p for p, _ in ref_leaves] == [p for p, _ in got_leaves]
    for (path, ref), (_, got) in zip(ref_leaves, got_leaves):
        ref, got = np.asarray(ref), np.asarray(got)
        assert got.dtype == np.float32 and got.shape == ref.shape
        if "qkv" in jax.tree_util.keystr(path) and ref.ndim == 1:
            ref, got = np.delete(ref, np.s_[d:2 * d]), np.delete(
                got, np.s_[d:2 * d])
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    # the key bias's gradient is round-off next to the query bias's
    x, y = corpus()
    module = port.module
    module.load_state_dict(params_from_jax(bundle.variables["params"]))
    module.zero_grad()
    logits = module(torch.from_numpy(x[:8]).long())
    make_loss("softmax_xent")(logits, torch.from_numpy(y[:8]).long(),
                              torch.ones(8)).backward()
    grad = module.block0_w.qkv.bias.grad
    assert grad[d:2 * d].abs().max() < 1e-4 * grad[:d].abs().max()


def test_fit_metadata_matches_jax(fits):
    _, jax_bundle, _, bundle = fits
    assert bundle.metadata == jax_bundle.metadata
    assert bundle.metadata["steps"] == 6
    assert bundle.config == jax_bundle.config


def test_flash_and_dense_attention_give_the_same_gradients():
    x, y = corpus()
    init = ModelBundle.init("TransformerLM", LM, seed=2)
    grads = {}
    for impl in ("flash", "dense"):
        module = ModelBundle("TransformerLM", {**LM, "attn_impl": impl},
                             init.variables).module("cpu").train()
        loss = make_loss("softmax_xent")(module(torch.from_numpy(x).long()),
                                         torch.from_numpy(y).long(),
                                         torch.ones(len(x)))
        loss.backward()
        grads[impl] = {n: p.grad for n, p in module.named_parameters()}
    for name, g in grads["flash"].items():
        torch.testing.assert_close(g, grads["dense"][name], rtol=1e-5,
                                   atol=1e-5)


def test_unported_trainer_options_raise():
    for kw in ({"pipeline_stages": 2}, {"step_timeout_s": 1.0},
               {"halt_on_nonfinite": True}, {"halt_on_divergence": True},
               {"mesh": {"data": 2}}, {"architecture": "MLPClassifier"}):
        cfg = TrainerConfig(**{**dict(FIT, model_config=dict(LM)), **kw})
        with pytest.raises(NotImplementedError):
            Trainer(cfg, device="cpu")
    trainer = Trainer(TrainerConfig(model_config=dict(LM), **FIT),
                      device="cpu")
    x, y = corpus()
    for kw in ({"ckpt_dir": "ckpt"}, {"resume": True},
               {"skip_data_windows": [(0, 1)]}):
        with pytest.raises(NotImplementedError):
            trainer.fit_arrays(x, y, **kw)
    with pytest.raises(NotImplementedError, match="save_attention"):
        ModelBundle("TransformerLM", {**LM, "remat": True,
                                      "remat_policy": "save_attention"},
                    {}).module("cpu")
