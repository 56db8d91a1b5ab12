"""Each plain reference agrees with the port at a tiny size, both in
float32 (TF32 has no say on the CPU): the scoring forward, and three
training steps of the check (losses, first gradients, changes)."""

import copy

import numpy as np
import pytest
import torch

from cellbench.harness import compare, manifest
from cellbench.tests import tiny


def _f32(ctx):
    ctx.config = copy.deepcopy(ctx.config)
    ctx.config["program"]["model_config"]["dtype"] = "float32"
    return ctx


@pytest.mark.parametrize("workload", ["gpt2-xl.train.b8s1024",
                                      "resnet50.train.b256"])
def test_training_reference_matches_the_port(workload):
    ctx = _f32(tiny.context(workload, seed=2 ** 31 + 7, limits={}))
    drv = manifest.driver("train")
    p = drv.prepare(ctx)
    prog, _ = drv.program_check(ctx, p)
    numbers = compare.train_numbers(prog, drv.reference_check(ctx, p))
    assert numbers["loss_gap"][0] < 1e-5
    assert numbers["grad_gap"][0] < 1e-4
    assert numbers["change_gap"][0] < 1e-3


def test_scoring_reference_matches_the_port():
    from mmlspark_tpu_torch.models.bundle import ModelBundle, variables_to_jax
    ctx = _f32(tiny.context("resnet50.score.b256", limits={}))
    cfg = ctx.config
    weights = ctx.reference.make_weights(cfg, 5, "cpu")
    bundle = ModelBundle("ResNet", cfg["program"]["model_config"],
                         variables_to_jax(weights))
    images = torch.randint(0, 256, (6, 32, 32, 3), dtype=torch.uint8)
    with torch.no_grad():
        port = bundle.module("cpu")(images.float())[0]
    ref = ctx.reference.score(weights, images, cfg)
    np.testing.assert_allclose(port.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4 * float(ref.abs().max()))


def test_gpt2_reference_logits_match_the_port():
    from mmlspark_tpu_torch.models.bundle import ModelBundle, variables_to_jax
    ctx = _f32(tiny.context("gpt2-xl.train.b8s1024", limits={}))
    cfg = ctx.config
    weights = ctx.reference.make_weights(cfg, 9, "cpu")
    bundle = ModelBundle("TransformerLM", cfg["program"]["model_config"],
                         variables_to_jax(ctx.reference.port_state(weights,
                                                                   cfg)))
    tokens = torch.randint(0, cfg["vocab_size"], (2, 16))
    with torch.no_grad():
        port = bundle.module("cpu")(tokens)
        ref = ctx.reference.logits(weights, tokens, cfg)
    np.testing.assert_allclose(port.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_weights_repeat_for_a_seed_and_differ_between_seeds():
    ref = manifest.reference("resnet50")
    cfg = tiny.RESNET
    a, b = ref.make_weights(cfg, 2 ** 40 + 3, "cpu"), \
        ref.make_weights(cfg, 2 ** 40 + 3, "cpu")
    c = ref.make_weights(cfg, 2 ** 40 + 4, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["stem_conv.weight"], c["stem_conv.weight"])
