"""Serving over a (data, model) mesh, on the CPU: the port's
`ServingEngine` over data 2 and over (data 2, model 2) host shards
against one device (tests/test_torch_tp_scoring.py holds `TPUModel` and
`TextGenerator` over a mesh against the JAX stages, with this file's
bundle).

  * ServingEngine: 8 requests of 8 new tokens at f32 (two sharing a
    20-token prefix, so the prefix pool serves a hit), greedy tokens
    equal to the one-device engine's, the resident batch split into
    `RowShards` (one slab a data row, its caches' heads over the row's
    model group); the int8 cache, chunked prefill and a speculative lane
    likewise.
"""

import numpy as np
import pytest

from mmlspark_tpu_torch import ModelBundle
from mmlspark_tpu_torch.models.generate import RowShards
from mmlspark_tpu_torch.parallel.partition import ModelShards
from mmlspark_tpu_torch.resilience.clock import VirtualClock
from mmlspark_tpu_torch.serve.engine import ServeConfig, ServingEngine
from mmlspark_tpu_torch.zoo import truncated_draft_bundle
from test_torch_tp_train import host_mesh

CFG = {"vocab_size": 64, "d_model": 32, "n_heads": 4, "n_layers": 2,
       "max_len": 96, "dtype": "float32", "attn_impl": "flash"}
RNG = np.random.default_rng(13)
SHARED = RNG.integers(0, 64, 20)
PROMPTS = ([RNG.integers(0, 64, n) for n in (5, 9, 3, 17, 20, 6)]
           + [np.concatenate([SHARED, RNG.integers(0, 64, 3)])
              for _ in range(2)])


@pytest.fixture(scope="module")
def bundle():
    return ModelBundle.init("TransformerLM", CFG, seed=6)


def serve(bundle, mesh, draft=None, **kw):
    cfg = ServeConfig(max_new_tokens=8, max_batch=4, segment_steps=4,
                      cache_chunk=8, prefix_cache=draft is None, **kw)
    engine = ServingEngine(bundle, cfg, clock=VirtualClock(), mesh=mesh,
                           draft_bundle=draft, device="cpu").warmup()
    out = []
    for p in PROMPTS:
        req = engine.submit(p)
        while not req.finished:
            engine._tick()
        out.append(np.asarray(req.tokens))
    return engine, out


@pytest.mark.parametrize("kw", [{}, {"cache_dtype": "int8"},
                                {"prefill_chunk": 8}])
def test_serving_over_a_mesh_equals_one_device(bundle, kw):
    _, want = serve(bundle, None, **kw)
    for dp, mp in ((2, 1), (2, 2)):
        engine, got = serve(bundle, host_mesh(dp, mp), **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert engine._counts.get("prefix_hits", 0) >= 1
        (group,) = engine._groups.values()
        k = group.caches[0][0]
        assert isinstance(k, RowShards) and len(k) == dp
        assert isinstance(k[0], ModelShards) == (mp > 1)


def test_a_speculative_lane_over_a_mesh_equals_one_device(bundle):
    draft = truncated_draft_bundle(bundle, 1)
    _, want = serve(bundle, None, draft=draft, spec_tokens=2)
    _, got = serve(bundle, host_mesh(2, 2), draft=draft, spec_tokens=2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_int8_weights_under_the_split(bundle):
    """An int8-weight bundle (computing at f32 here, so tokens can be held
    exactly) over a model axis: a column-parallel layer's int8 weight and
    its per-channel scales are cut together (qkv head-aligned), a
    row-parallel layer keeps its scales whole, applied after the sum;
    greedy tokens and `TPUModel` logits equal one device's."""
    import torch

    from mmlspark_tpu_torch import DataTable, TPUModel
    from mmlspark_tpu_torch.models.generate import DecodeEngine
    from mmlspark_tpu_torch.parallel.partition import ModelShards
    from mmlspark_tpu_torch.quant.quantize import quantize_bundle
    q = quantize_bundle(bundle, "int8")
    q = ModelBundle(q.architecture, {**q.config, "dtype": "float32"},
                    q.variables, q.metadata)
    module = q.module("cpu")
    prompts = np.zeros((4, 16), np.int32)
    lengths = np.array([9, 16, 5, 12])
    for j, n in enumerate(lengths):
        prompts[j, :n] = RNG.integers(0, 64, n)
    want = DecodeEngine(module, 8, device="cpu").generate(prompts, lengths)
    engine = DecodeEngine(module, 8, device="cpu", mesh=host_mesh(2, 2))
    np.testing.assert_array_equal(engine.generate(prompts, lengths), want)
    block = engine._weights_on(torch.device("cpu")).blocks[0]
    assert block.qkv.weight.dtype == torch.int8
    assert isinstance(block.qkv.scale, ModelShards)
    assert block.qkv.scale.groups == 3
    assert isinstance(block.proj.weight, ModelShards)
    assert not isinstance(block.proj.scale, ModelShards)
    toks = RNG.integers(0, 64, (4, 12)).astype(np.int32)
    one = TPUModel(q, device="cpu", inputCol="t", outputCol="y").transform(
        DataTable({"t": toks}))["y"]
    got = TPUModel(q, device="cpu", inputCol="t", outputCol="y").set_mesh(
        host_mesh(1, 2)).transform(DataTable({"t": toks}))["y"]
    np.testing.assert_allclose(got, one, rtol=1e-5, atol=1e-5)
