"""`make_seq_parallel_lm_step(..., remat=True)` on the CPU: it steps a
copy of the module that recomputes each block in the backward (the JAX
step's `module.clone(remat=True)`), so its losses and weights equal the
plain step's bit for bit and the caller's module keeps remat off.  A
rematerialized block recomputes outside the caller's `use_seq_mesh`
block, so it must re-enter the forward's mesh (a seq impl raises
otherwise).  The plain step is held to the JAX step in
tests/test_torch_seq_train.py."""

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch import TrainerConfig
from mmlspark_tpu_torch.models import definitions
from mmlspark_tpu_torch.models.definitions import TransformerLM
from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from mmlspark_tpu_torch.parallel.ring import (make_seq_parallel_lm_step,
                                              shard_tokens)
from mmlspark_tpu_torch.train.optim import Optimizer

LM = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=2, max_len=32,
          dtype="float32")
STEPS = 3


def run_steps(impl, remat):
    """STEPS adam steps over a data 2 x seq 2 mesh of host shards from
    one seeded init: (module, losses)."""
    torch.manual_seed(0)
    module = TransformerLM(**LM, attn_impl=impl, seq_axis="seq",
                           device="cpu")
    mesh = make_mesh(MeshSpec(data=2, model=1, seq=2),
                     [torch.device("cpu")] * 4)
    rng = np.random.default_rng(1)
    rows = rng.integers(0, LM["vocab_size"], (2, LM["max_len"] + 1))
    args = [shard_tokens(a, mesh) for a in (
        rows[:, :-1], rows[:, 1:], np.ones((2, LM["max_len"]), np.float32))]
    params = list(module.parameters())
    tx = Optimizer(TrainerConfig(optimizer="adam", learning_rate=1e-2), 1)
    opt_state = tx.init(params)
    step = make_seq_parallel_lm_step(module, tx, mesh, remat=remat)
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, *args)
        losses.append(loss.item())
    return module, losses


@pytest.mark.parametrize("impl", ["ring_flash", "ulysses"])
def test_remat_step_equals_the_plain_step(impl, monkeypatch):
    calls, real = [], definitions.checkpoint
    monkeypatch.setattr(definitions, "checkpoint", lambda fn, *a, **kw: (
        calls.append(1) or real(fn, *a, **kw)))
    module, losses = run_steps(impl, remat=True)
    assert not module.remat
    assert len(calls) == STEPS * LM["n_layers"]
    ref_module, ref_losses = run_steps(impl, remat=False)
    assert losses == ref_losses and losses[-1] < losses[0]
    for (name, p), ref in zip(module.named_parameters(),
                              ref_module.parameters()):
        assert torch.equal(p, ref), name
