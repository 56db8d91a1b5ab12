"""The train step's counted FLOPs (mmlspark_tpu_torch/observe/
costmodel.py through `Trainer.fit_arrays`): with flash attention the
counter sees the GEMMs and the kernel wrappers report K1[lse], K2 and K3
by the kernel table's formulas; the dense part equals the analytic
`lm_train_flops(...)["xla_visible"]` and sits below XLA's compiled count
of the same JAX step by its elementwise FLOPs (the JAX check at
tests/test_perf_floor.py)."""

import json
import os

import numpy as np
import pytest

from mmlspark_tpu_torch import run_telemetry
from mmlspark_tpu_torch.ops.flash_attention import visible_pairs
from mmlspark_tpu_torch.train import Trainer, TrainerConfig
from mmlspark_tpu_torch.utils import perf

LM = dict(batch=2, seq=128, d_model=64, n_layers=1, vocab=256)


@pytest.fixture(scope="module")
def xla_dense_step_flops():
    """XLA's compiled count of the JAX train step (dense attention,
    adam), as `tests/test_perf_floor.py` computes it, lowered from the
    parameters' shapes."""
    import jax
    import jax.numpy as jnp
    import optax

    from mmlspark_tpu.models.definitions import build_model
    model = build_model("TransformerLM", {
        "vocab_size": LM["vocab"], "d_model": LM["d_model"], "n_heads": 4,
        "n_layers": LM["n_layers"], "max_len": LM["seq"],
        "attn_impl": "dense"})
    rng = np.random.default_rng(0)
    tokens = jnp.asarray(rng.integers(0, LM["vocab"],
                                      (LM["batch"], LM["seq"])), jnp.int32)
    targets = jnp.roll(tokens, -1, axis=1)
    # shapes are all a cost analysis needs: no eager init
    params = jax.eval_shape(model.init, jax.random.key(0), tokens)
    tx = optax.adam(3e-4)

    def train_step(params, opt_state, tokens, targets):
        def loss_fn(p):
            logits = model.apply(p, tokens)
            lse = jax.scipy.special.logsumexp(logits, axis=-1)
            pick = jnp.take_along_axis(logits, targets[..., None],
                                       axis=-1)[..., 0]
            return (lse - pick).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    cost = jax.jit(train_step).lower(
        params, jax.eval_shape(tx.init, params), tokens,
        targets).compile().cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else {}
    return float(cost.get("flops") or 0)


def _fit_lm(tmp_path, attn_impl: str, steps: int = 2) -> dict:
    cfg = TrainerConfig(
        architecture="TransformerLM",
        model_config={"vocab_size": LM["vocab"], "d_model": LM["d_model"],
                      "n_heads": 4, "n_layers": LM["n_layers"],
                      "max_len": LM["seq"], "attn_impl": attn_impl,
                      "dtype": "float32"},
        optimizer="adam", learning_rate=3e-4, epochs=1,
        batch_size=LM["batch"], seed=0)
    rng = np.random.default_rng(0)
    x = rng.integers(0, LM["vocab"], (LM["batch"] * steps, LM["seq"]))
    d = str(tmp_path / attn_impl)
    with run_telemetry(d):
        Trainer(cfg, device="cpu").fit_arrays(x.astype(np.int32),
                                              np.roll(x, -1, 1))
    with open(os.path.join(d, "run_summary.json")) as f:
        progs = json.load(f)["programs"]
    (key,) = progs
    assert key == f"trainer:({LM['batch']}, {LM['seq']}):int32"
    return progs[key]


def test_train_step_dense_flops_match_analytic_and_xla(tmp_path,
                                                       xla_dense_step_flops):
    ref = perf.lm_train_flops(LM["batch"], LM["seq"], LM["d_model"],
                              LM["n_layers"], LM["vocab"])
    flash = _fit_lm(tmp_path, "flash")
    # the counter sees the GEMMs; the kernels report the attention
    assert flash["flops"] - flash["kernel_flops"] == ref["xla_visible"]
    pairs = visible_pairs(LM["seq"], LM["seq"], True)
    per_layer = (4 + 6 + 8) * LM["batch"] * 4 * 16 * pairs
    assert flash["kernel_flops"] == LM["n_layers"] * per_layer
    assert flash["kernel_launches"] == {"K1[lse]": 1, "K2": 1, "K3": 1}
    # a synced span wall joins, from the second step on; no peaks here
    assert flash["step_basis"] == "span_wall" and flash["executions"] == 1
    assert flash["mfu"] is None and flash["hbm_bw_util"] is None
    assert flash["verdict"] is None
    # dense attention: the S^2 products are GEMMs the counter sees
    dense = _fit_lm(tmp_path, "dense")
    dense_ref = perf.lm_train_flops(LM["batch"], LM["seq"], LM["d_model"],
                                    LM["n_layers"], LM["vocab"],
                                    attn_impl="dense")
    assert dense["flops"] == dense_ref["xla_visible"]
    assert dense["kernel_flops"] == 0
    # XLA also counts the elementwise FLOPs (softmax, LayerNorm, GELU,
    # adam) that the counter's GEMM formulas omit, a larger share the
    # narrower the model: the port's dense count reads 0.783 of XLA's
    # count less the S^2 products at this width (0.867 at two layers of
    # (2, 256, 128))
    if not xla_dense_step_flops:
        pytest.skip("XLA provides no cost model on this backend")
    ratio = (flash["flops"] - flash["kernel_flops"]) / (
        xla_dense_step_flops - ref["attn_full"])
    assert 0.70 <= ratio <= 0.90, ratio
