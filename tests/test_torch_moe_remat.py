"""The remat policies of the port's mixture-of-experts TransformerLM on
the CPU: one forward and backward of the MoE objective (NLL + the sown
aux and z losses) with no remat, "full" and "save_attention" gives
gradients bit-equal to each other and within 1e-4 of each leaf's max |g|
of `jax.grad` of the JAX model (dense attention there, the port's flash
operator's plain version here); the flash operator runs once, twice and
once a layer (counted through the module's `flash_attention_with_lse`,
which the operator calls by name).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.models.definitions import build_model as jax_build_model
from mmlspark_tpu_torch.models import ModelBundle
from mmlspark_tpu_torch.train.optim import named_tree
from mmlspark_tpu_torch.train.trainer import make_loss

flash_mod = importlib.import_module("mmlspark_tpu_torch.ops.flash_attention")

CFG = {"vocab_size": 64, "d_model": 32, "n_heads": 4, "n_layers": 2,
       "max_len": 64, "dtype": "float32", "mlp_impl": "moe",
       "n_experts": 4, "moe_router_k": 2, "moe_group_size": 8}
TRAIN_CFG = {**CFG, "attn_impl": "dense"}


def _bundle(cfg, seed=0):
    return ModelBundle.init("TransformerLM", cfg, seed=seed)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _corpus(n_rows=2, seq=16, vocab=64, seed=41):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, vocab, size=(n_rows, 1))
    rows = ((starts + np.arange(seq + 1)) % vocab).astype(np.int32)
    return rows[:, :-1], rows[:, 1:]


@pytest.fixture(scope="module")
def jax_refs():
    """`jax.grad` of the objective at dense attention, jitted once."""
    module = jax_build_model("TransformerLM", TRAIN_CFG)
    params = jax.tree_util.tree_map(
        jnp.asarray, _bundle(TRAIN_CFG, seed=11).variables["params"])
    x, y = _corpus()

    def objective(p):
        logits, st = module.apply({"params": p}, jnp.asarray(x),
                                  mutable=["losses", "metrics"])
        lp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(lp, jnp.asarray(y)[..., None], -1).mean()
        return nll + sum(jax.tree_util.tree_leaves(st["losses"]))

    return {"grads": dict(_leaves(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(objective))(params))))}


def test_remat_policies_give_equal_gradients_and_launch_counts(jax_refs,
                                                               monkeypatch):
    want = jax_refs["grads"]
    bundle = _bundle(TRAIN_CFG, seed=11)
    x, y = _corpus()
    calls = [0]
    real = flash_mod.flash_attention_with_lse

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(flash_mod, "flash_attention_with_lse", counted)
    grads, counts = {}, {}
    for mode in ("none", "full", "save_attention"):
        cfg = {**CFG, "attn_impl": "flash", "remat": mode != "none",
               "remat_policy": "full" if mode == "none" else mode}
        lm = ModelBundle("TransformerLM", cfg,
                         bundle.variables).module("cpu").train()
        calls[0] = 0
        logits, sown = lm(torch.from_numpy(x).long(), collect=True)
        loss = make_loss("softmax_xent")(logits, torch.from_numpy(y).long(),
                                         torch.ones(len(x)))
        (loss + sum(v for blk in sown["losses"].values()
                    for v in blk["moe"].values())).backward()
        counts[mode] = calls[0]
        named = {n: p.grad for n, p in lm.named_parameters()}
        grads[mode] = dict(_leaves(named_tree(list(named),
                                              list(named.values()))))
    n_layers = CFG["n_layers"]
    assert counts == {"none": n_layers, "full": 2 * n_layers,
                      "save_attention": n_layers}
    for mode in ("full", "save_attention"):
        for name, g in grads[mode].items():
            assert np.array_equal(g, grads["none"][name]), (mode, name)
    for name, w in want.items():
        np.testing.assert_allclose(grads["none"][name], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
