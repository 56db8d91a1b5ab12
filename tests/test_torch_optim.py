"""The port's training pieces against the JAX package, on the CPU: each
optax chain of `build_optimizer`, the four losses, the numpy data order,
and `TrainerConfig`'s JSON form across packages.

Both packages get the same inputs: numpy arrays from seeded generators.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmlspark_tpu.train import TrainerConfig as JaxTrainerConfig
from mmlspark_tpu.train.trainer import _epoch_order as jax_epoch_order
from mmlspark_tpu.train.trainer import _make_loss as jax_make_loss
from mmlspark_tpu.train.trainer import build_optimizer as jax_build_optimizer
from mmlspark_tpu_torch import TrainerConfig
from mmlspark_tpu_torch.train.optim import Optimizer
from mmlspark_tpu_torch.train.trainer import epoch_order, make_loss

LM = {"vocab_size": 64, "d_model": 32, "n_heads": 4, "n_layers": 2,
      "max_len": 32, "dtype": "float32", "attn_impl": "flash"}


# --------------------------------------------------------- optimizers ---

@pytest.mark.parametrize("optimizer,schedule,clip,weight_decay",
                         itertools.product(
                             ["sgd", "momentum", "adam", "adamw"],
                             ["constant", "cosine", "warmup_cosine"],
                             [None, 0.5], [0.0, 1e-2]))
def test_optimizer_chain_matches_optax(optimizer, schedule, clip,
                                       weight_decay):
    """5 updates of a random parameter tree with the same gradients."""
    kw = dict(optimizer=optimizer, lr_schedule=schedule, warmup_steps=2,
              gradient_clip_norm=clip, weight_decay=weight_decay,
              learning_rate=0.1)
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (5,), (2, 2, 2)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    tx = jax_build_optimizer(JaxTrainerConfig(**kw), 5)
    ref = [jnp.asarray(p) for p in init]
    opt_state = tx.init(ref)
    port = Optimizer(TrainerConfig(**kw), 5)
    got = [torch.from_numpy(p.copy()) for p in init]
    state = port.init(got)
    for g in grads:
        updates, opt_state = tx.update([jnp.asarray(x) for x in g],
                                       opt_state, ref)
        ref = optax.apply_updates(ref, updates)
        port.update([torch.from_numpy(x) for x in g], state, got)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


# ------------------------------------------------------ losses, order ---

@pytest.mark.parametrize("kind", ["softmax_xent", "sigmoid_xent", "mse",
                                  "mae"])
def test_losses_match_jax_with_partial_mask(kind):
    rng = np.random.default_rng(1)
    if kind == "softmax_xent":
        logits = rng.standard_normal((4, 6, 10)).astype(np.float32)
        labels = rng.integers(0, 10, (4, 6)).astype(np.int32)
    elif kind == "sigmoid_xent":
        logits = rng.standard_normal((4, 1)).astype(np.float32)
        labels = rng.integers(0, 2, (4,)).astype(np.float32)
    else:
        logits = rng.standard_normal((4, 1)).astype(np.float32)
        labels = rng.standard_normal((4,)).astype(np.float32)
    mask = np.array([1, 1, 1, 0], np.float32)
    ref = jax_make_loss(kind)(jnp.asarray(logits), jnp.asarray(labels),
                              jnp.asarray(mask))
    got = make_loss(kind)(*(torch.from_numpy(a)
                            for a in (logits, labels, mask)))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)


@pytest.mark.parametrize("shuffle,n,n_local,rng_seed", [
    (True, 20, 20, 3), (True, 16, 20, [3, 1]), (False, 20, 20, 0),
    (False, 16, 20, 0)])
def test_epoch_order_is_byte_identical(shuffle, n, n_local, rng_seed):
    a = np.random.default_rng(rng_seed)
    b = np.random.default_rng(rng_seed)
    for epoch in range(3):
        ref = jax_epoch_order(a, epoch, n, n_local, shuffle)
        got = epoch_order(b, epoch, n, n_local, shuffle)
        assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()


def test_trainer_config_json_round_trips_across_packages(tmp_path):
    kw = dict(architecture="TransformerLM", model_config=dict(LM),
              optimizer="adamw", weight_decay=0.1, lr_schedule="cosine",
              gradient_clip_norm=2.0, epochs=3,
              partition_rules=[["qkv/kernel$", [None, "model"]],
                               ["x$", [["data", "model"]]], [".*", []]])
    jax_cfg = JaxTrainerConfig(**kw)
    jax_cfg.save(str(tmp_path / "jax.json"))
    port_cfg = TrainerConfig.load(str(tmp_path / "jax.json"))
    assert port_cfg.to_json() == jax_cfg.to_json()
    port_cfg.save(str(tmp_path / "port.json"))
    again = JaxTrainerConfig.load(str(tmp_path / "port.json"))
    assert again.to_json() == jax_cfg.to_json()
    assert TrainerConfig().to_json() == JaxTrainerConfig().to_json()
