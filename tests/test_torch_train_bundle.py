"""The port's Trainer against the JAX package, on the CPU: `fit_arrays` in
bf16, and a bundle the port trains served by the JAX package.

The bf16 run is the f32 parity run of tests/test_torch_train.py with the
model dtype switched: the same data, `initial_bundle` and optimizer.  The
two frameworks round to bf16 at different points, so the per-epoch loss
and gradient norm agree within a looser tolerance (measured on the CPU:
loss within rel 1.4e-4, grad_norm within rel 3.3e-3); parameters are not
compared, since Adam scales each element's update to about the learning
rate whatever its gradient's size, so a bf16 rounding difference in a
near-zero gradient moves that element by up to lr per step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu import DataTable as JaxDataTable
from mmlspark_tpu.models import load_bundle as jax_load_bundle
from mmlspark_tpu.models.generate import TextGenerator as JaxTextGenerator
from mmlspark_tpu_torch import (DataTable, ModelBundle, TextGenerator,
                                Trainer, TrainerConfig, save_bundle)
from test_torch_train import FIT, LM, corpus, jax_fit

LM_BF16 = {**LM, "dtype": "bfloat16"}


@pytest.fixture(scope="module")
def bf16_fits():
    x, y = corpus()
    init = ModelBundle.init("TransformerLM", LM_BF16, seed=0)
    jax_trainer, jax_bundle = jax_fit(LM_BF16, x, y, init)
    port = Trainer(TrainerConfig(model_config=dict(LM_BF16), **FIT),
                   device="cpu")
    bundle = port.fit_arrays(x, y, initial_bundle=init)
    return jax_trainer, jax_bundle, port, bundle


def test_bf16_fit_history_matches_jax(bf16_fits):
    jax_trainer, jax_bundle, port, bundle = bf16_fits
    for got, ref in zip(port.history, jax_trainer.history):
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-3)
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                                   rtol=1e-2)
    assert bundle.metadata == jax_bundle.metadata
    # the masters stay f32 under a bf16 model
    leaves = [bundle.variables["params"]["block0_w"]["qkv"]["kernel"],
              bundle.variables["params"]["tok_embed"]["embedding"]]
    assert all(leaf.dtype == np.float32 for leaf in leaves)
    assert all(p.dtype == torch.float32 for p in port.module.parameters())


def test_port_trained_bundle_serves_in_jax(tmp_path):
    """A bundle the port trains loads in the JAX package's `load_bundle`,
    and the JAX TextGenerator's greedy tokens equal the port's at f32."""
    x, y = corpus()
    trainer = Trainer(TrainerConfig(model_config=dict(LM),
                                    **{**FIT, "epochs": 3}), device="cpu")
    bundle = trainer.fit_arrays(x, y)
    save_bundle(bundle, str(tmp_path / "b"))
    loaded = jax_load_bundle(str(tmp_path / "b"))
    assert loaded.architecture == "TransformerLM"
    assert loaded.metadata == bundle.metadata
    prompts = x[:4, :8]
    params = dict(inputCol="prompt", maxNewTokens=8)
    ref = JaxTextGenerator(loaded, **params).transform(
        JaxDataTable({"prompt": jnp.asarray(prompts)}))["generated"]
    got = TextGenerator(bundle, device="cpu", **params).transform(
        DataTable({"prompt": prompts}))["generated"]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
