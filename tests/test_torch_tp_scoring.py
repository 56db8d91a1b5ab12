"""Scoring and generation stages over a (data 2, model 2) mesh against
the JAX stages on theirs, on the CPU (tests/test_partition.py:352-395),
with tests/test_torch_tp_serve.py's LM bundle (f32, flash attention: the
port's plain kernel versions here):

  * `TPUModel` over the TransformerLM bundle, on one device and over the
    mesh: logits (B, S, vocab) f32 within 2e-5 of the JAX stage's on its
    mesh (the JAX test's tolerance); the qkv placed head-aligned by the
    bundle's rules;
  * `TextGenerator.set_mesh`: the weights sharded by the bundle's rules,
    greedy tokens equal to the one-device stage's and the JAX stage's.
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu.core.table import DataTable as JaxDataTable
from mmlspark_tpu.models import TPUModel as JaxTPUModel
from mmlspark_tpu.models.bundle import ModelBundle as JaxModelBundle
from mmlspark_tpu.models.generate import TextGenerator as JaxTextGenerator
from mmlspark_tpu_torch import DataTable, ModelBundle, TPUModel
from mmlspark_tpu_torch.models.generate import TextGenerator
from mmlspark_tpu_torch.parallel.partition import ModelShards
from test_torch_tp_serve import CFG, RNG
from test_torch_tp_train import host_mesh, jax_mesh


@pytest.fixture(scope="module")
def bundle():
    return ModelBundle.init("TransformerLM", CFG, seed=6)


def test_tpu_model_scores_an_lm_bundle_as_the_jax_stage(bundle):
    toks = RNG.integers(0, 64, (8, 12)).astype(np.int32)
    jax_bundle = JaxModelBundle(bundle.architecture, bundle.config,
                                bundle.variables)
    ref = np.asarray(JaxTPUModel(jax_bundle, inputCol="t", outputCol="y",
                                 miniBatchSize=8).set_mesh(jax_mesh(2, 2))
                     .transform(JaxDataTable({"t": toks}))["y"])
    one = TPUModel(bundle, device="cpu", inputCol="t", outputCol="y",
                   miniBatchSize=8).transform(DataTable({"t": toks}))["y"]
    stage = TPUModel(bundle, device="cpu", inputCol="t", outputCol="y",
                     miniBatchSize=8).set_mesh(host_mesh(2, 2))
    got = stage.transform(DataTable({"t": toks}))["y"]
    assert got.shape == ref.shape == (8, 12, 64)
    np.testing.assert_allclose(one, ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    home = stage._shard_modules(stage.shard_devices())[0]
    assert home.block0_w.qkv.weight.groups == 3
    assert [tuple(t.shape) for t in home.block0_w.qkv.weight] == \
        [(48, 32)] * 2


def test_text_generator_set_mesh_matches_the_jax_stage(bundle):
    rows = [RNG.integers(1, 64, n).astype(np.int32) for n in (6, 9, 3)]
    stage = TextGenerator(bundle, device="cpu", inputCol="p",
                          outputCol="out", maxNewTokens=5)
    plain = stage.transform(DataTable({"p": rows}))["out"]
    got = stage.set_mesh(host_mesh(2, 2)).transform(
        DataTable({"p": rows}))["out"]
    engine = stage._engine_for()
    qkv = engine._weights_on(torch.device("cpu")).blocks[0].qkv.weight
    assert isinstance(qkv, ModelShards) and qkv.groups == 3
    jstage = JaxTextGenerator(JaxModelBundle(
        bundle.architecture, bundle.config, bundle.variables),
        inputCol="p", outputCol="out", maxNewTokens=5).set_mesh(
        jax_mesh(2, 2))
    ref = jstage.transform(JaxDataTable({"p": rows}))["out"]
    for a, b, c in zip(got, plain, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))
