"""The port's data-parallel Trainer over the LMs against the JAX Trainer
on a mesh of the same data width, on the CPU (tests/test_torch_dp_train.py
holds the scoring models, the helpers and the tolerances): a dense
`TransformerLM` with `attn_impl="flash"` (the port's plain kernel
versions on the CPU; tests/test_torch_train.py's fit settings) at data 2
and 4, a mixture-of-experts LM with its sown losses in the objective at
data 2 (20 rows of 16 tokens at batch 8: each shard's 64 tokens route
in groups of the global batch's group size, 8), the MoE group that
would straddle two shards, and the cost counter's dense FLOPs of a
data-parallel step.
"""

import pytest
import torch

from mmlspark_tpu_torch import Trainer, TrainerConfig
from mmlspark_tpu_torch.ops.moe import moe_apply
from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from test_torch_dp_train import (BATCH, LM, check_fit, data, fit_config,
                                 initial, jax_fit_all)

RUNS = [("lm", 2), ("lm", 4), ("moe", 2)]


@pytest.fixture(scope="module")
def jax_fits():
    return jax_fit_all(RUNS)


@pytest.mark.parametrize("name,dp", RUNS)
def test_data_parallel_lm_fit_matches_the_jax_trainer(jax_fits, name, dp):
    check_fit(name, dp, *jax_fits[name, dp])


def test_a_moe_group_straddling_two_shards_raises():
    """Two shards of 12 tokens route with the global 24 tokens' group
    size at a target of 8: 8 does not divide 12 (a port difference: the
    JAX step would route a group across the shard boundary)."""
    from mmlspark_tpu_torch.parallel.ring import ShardGroup
    x = torch.zeros(1, 12, 4)
    w = torch.zeros(2, 4)
    args = (x, w, torch.zeros(2), torch.zeros(2, 4, 8), torch.zeros(2, 8, 4))
    moe_apply(*args, group_size=8)     # one shard: 12 tokens, groups of 6
    with pytest.raises(ValueError, match="12 tokens do not split into "
                                         "routing groups of 8"):
        moe_apply(*args, group_size=8, shards=2)
    group = ShardGroup(2)
    from mmlspark_tpu_torch.ops.moe import MoEMLP
    mlp = MoEMLP(4, n_experts=2, group_size=8, device="cpu")
    with pytest.raises(ValueError, match="of 24 tokens"):
        group.run(lambda i: mlp(x))


def test_dense_flops_of_a_dp_step_equal_the_global_batch_count(tmp_path):
    """The cost counter sees every shard's ops: the LM step's row under
    `run_telemetry` at data 2 counts the dense FLOPs of the global batch,
    `lm_train_flops(...)["xla_visible"]`, as one card's step does, and the
    kernels' FLOPs of one card's step in twice its launches (one per
    shard; tests/test_torch_train_flops.py)."""
    import json
    import os

    from mmlspark_tpu_torch import run_telemetry
    from mmlspark_tpu_torch.utils.perf import lm_train_flops
    x, y = data("lm")
    rows = {}
    for dp in (1, 2):
        cfg = TrainerConfig(**{**fit_config("lm"), "epochs": 1})
        d = str(tmp_path / f"dp{dp}")
        with run_telemetry(d):
            Trainer(cfg, mesh=make_mesh(MeshSpec(data=dp),
                                        [torch.device("cpu")] * dp)
                    ).fit_arrays(x[:BATCH], y[:BATCH],
                                 initial_bundle=initial("lm"))
        with open(os.path.join(d, "run_summary.json")) as f:
            (key, row), = json.load(f)["programs"].items()
        assert key == f"trainer:({BATCH}, {LM['max_len']}):int32"
        rows[dp] = row
    want = lm_train_flops(BATCH, LM["max_len"], LM["d_model"],
                          LM["n_layers"], LM["vocab_size"])["xla_visible"]
    for row in rows.values():
        assert row["flops"] - row["kernel_flops"] == want
    assert rows[2]["kernel_flops"] == rows[1]["kernel_flops"]
    assert {k: 2 * v for k, v in rows[1]["kernel_launches"].items()} == \
        rows[2]["kernel_launches"]
