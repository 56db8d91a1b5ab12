"""The port's tensor-parallel Trainer over a dense `TransformerLM` with
`attn_impl="flash"` (the port's plain kernel versions on the CPU) against
the JAX Trainer on the same (data, model) mesh, on the CPU
(tests/test_torch_tp_train.py holds the helpers, the tolerances and the
scoring models; the JAX side attends densely, the same function at f32).
The LM's layers follow the Megatron split: per-shard heads through the
flash kernels, row-parallel proj / mlp_down summed on the home, the head
over the vocabulary joined in order; the Trainer's fallback also splits
the embeddings on their width, as the JAX Trainer does.  The (4, 2) case
is `slow` (its JAX fit compiles for 8 devices); the MLP's (4, 2) case in
tests/test_torch_tp_train.py stands in for it.

Also: the planted fault of a row-parallel bias added on every shard, the
forward hooks' per-shard widths, and the cost counter's dense FLOPs of a
(2, 2) step, which equal the global batch's
`lm_train_flops(...)["xla_visible"]` exactly.
"""

import json
import os

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch import Trainer, TrainerConfig, run_telemetry
from mmlspark_tpu_torch.utils.perf import lm_train_flops
from test_torch_dp_train import BATCH, CASES, data, fit_config, leaves
from test_torch_tp_train import check_fit, host_mesh, initial, jax_fit, \
    port_fit


@pytest.fixture(scope="module")
def jax_lm_fit():
    return jax_fit(("lm", 2, 2))


def test_tensor_parallel_lm_fit_matches_the_jax_trainer(jax_lm_fit):
    check_fit("lm", 2, 2, *jax_lm_fit)


@pytest.mark.slow
def test_tensor_parallel_lm_fit_at_data_4_matches_the_jax_trainer():
    check_fit("lm", 4, 2, *jax_fit(("lm", 4, 2)))


def test_a_bias_added_per_shard_would_fail_the_parity(jax_lm_fit,
                                                      monkeypatch):
    """The planted fault: a row-parallel layer that adds its bias on every
    shard's partial product (mp times) parts from the JAX fit by far more
    than the tolerance."""
    from mmlspark_tpu_torch.models import definitions
    real = definitions.row_parallel

    def twice(layer, xs):
        return real(layer, xs) + layer.bias.to(layer.compute_dtype)
    monkeypatch.setattr(definitions, "row_parallel", twice)
    _, bundle = port_fit("lm", 2, 2)
    monkeypatch.setattr(definitions, "row_parallel", real)
    _, jax_bundle, _ = jax_lm_fit
    gaps = [np.abs(g - w).max() for (_, g), (_, w) in zip(
        leaves(bundle.variables), leaves(jax_bundle.variables))]
    assert max(gaps) > 1e-2


def test_each_shard_runs_its_own_heads(monkeypatch):
    """At (1, 2) each model shard's qkv gives 3 D/2 columns, its attention
    runs on H/2 heads (the flash wrapper's inputs), its mlp_up 4 D/2
    columns and its head V/2 vocab columns: forward hooks on the layers
    (replicas share their module's hooks; the hook tells them apart by
    the module it is called with) and the wrapper's arguments show it."""
    from mmlspark_tpu_torch.models import definitions
    mc = CASES["lm"][1]
    trainer = Trainer(TrainerConfig(**fit_config("lm")),
                      mesh=host_mesh(1, 2))
    trainer.init_state((1, 16), 1, initial_bundle=initial("lm"))
    home, shards = trainer._replicas.rows[0]
    seen, handles = [], []
    for name in ("block0_w.qkv", "block0_w.mlp_up", "lm_head"):
        index = {id(rep.get_submodule(name)): m
                 for m, rep in enumerate(shards)}
        handles.append(trainer.module.get_submodule(
            name).register_forward_hook(
            lambda mod, args, out, name=name, index=index:
            seen.append((name, index.get(id(mod)), out.shape[-1]))))
    heads = []
    real = definitions.flash_attention
    monkeypatch.setattr(
        definitions, "flash_attention",
        lambda q, *a, **k: heads.append(q.shape[2]) or real(q, *a, **k))
    x, _ = data("lm")
    logits = home(torch.as_tensor(x[:2]))
    for h in handles:
        h.remove()
    d, v = mc["d_model"], mc["vocab_size"]
    # the home's lm_head call joins the vocab columns
    assert ("lm_head", None, v) in seen
    assert sorted(s for s in seen if s[1] is not None) == sorted(
        (name, m, width) for m in (0, 1) for name, width in (
            ("block0_w.qkv", 3 * d // 2), ("block0_w.mlp_up", 4 * d // 2),
            ("lm_head", v // 2)))
    assert heads == [mc["n_heads"] // 2] * 2
    assert logits.shape == (2, mc["max_len"], v)


def test_dense_flops_of_a_tp_step_equal_the_global_batch_count(tmp_path):
    """The cost counter sees every shard's ops: at (2, 2) the LM step's
    row counts the dense FLOPs of the global batch exactly (each shard's
    slices of the column- and row-parallel products sum to the whole; no
    replicated layer counted twice), and the kernels report K1[lse], K2
    and K3 once per (data row, model shard, layer) at the shard's H/mp
    heads, their FLOPs summing to one card's."""
    x, y = data("lm")
    mc = CASES["lm"][1]
    rows = {}
    for dp, mp in ((1, 1), (2, 2)):
        d = str(tmp_path / f"{dp}x{mp}")
        with run_telemetry(d):
            Trainer(TrainerConfig(**{**fit_config("lm"), "epochs": 1}),
                    mesh=host_mesh(dp, mp) if dp * mp > 1 else None,
                    device="cpu").fit_arrays(x[:BATCH], y[:BATCH],
                                             initial_bundle=initial("lm"))
        with open(os.path.join(d, "run_summary.json")) as f:
            (_, row), = json.load(f)["programs"].items()
        rows[dp, mp] = row
    want = lm_train_flops(BATCH, mc["max_len"], mc["d_model"],
                          mc["n_layers"], mc["vocab_size"])["xla_visible"]
    for row in rows.values():
        assert row["flops"] - row["kernel_flops"] == want
    assert rows[2, 2]["kernel_flops"] == rows[1, 1]["kernel_flops"]
    assert rows[2, 2]["kernel_launches"] == {
        k: 4 * v for k, v in rows[1, 1]["kernel_launches"].items()}
