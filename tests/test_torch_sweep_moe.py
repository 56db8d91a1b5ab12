"""A MoE LM population of the port (`mmlspark_tpu_torch/train/sweep.py`)
against the JAX package's `PopulationTrainer` on the CPU, from the same
member inits: the routing's one-hot and slot table run under
`torch.func.vmap` (`ops/moe.py`), the sown losses join each member's
objective (aux_loss_weight 0.01), the attention is the flash operator.

Bounds: member losses within 1e-5 relative of the JAX population's (at
dense attention: tests/test_torch_sweep_lm.py says why); each leaf as
`check_leaves` holds it (the MoE Trainer's parity test allows the same,
queue C #12 of the roadmap: an expert's rarely routed hidden unit has a
near-zero gradient that Adam scales)."""

import numpy as np
import pytest

from test_torch_sweep_lm import (LM, RATES, check_leaves, jax_population,
                                 port_population)

MOE = {"mlp_impl": "moe", "n_experts": 4, "moe_router_k": 2,
       "moe_group_size": 8}


@pytest.fixture(scope="module")
def jax_ref():
    return jax_population({**LM, **MOE}, RATES[:2])


def test_moe_population_matches_the_jax_population(jax_ref):
    inits, jloss, jparams = jax_ref
    pt, result = port_population({**LM, **MOE, "attn_impl": "flash"},
                                 RATES[:2], inits)
    np.testing.assert_allclose(result.member_loss, jloss, rtol=1e-5)
    for k in range(2):
        check_leaves(pt.member_variables(result.state, k)["params"],
                     jparams[k])
