"""Tensor-parallel decode of the port (a mesh with a model axis) against
one device and against the JAX engine on its mesh, on the CPU
(tests/test_partition.py:365-395): a 2-layer f32 LM of 4 heads over
(data 2, model 2) host shards `[cpu] * 4` and `jax.devices()[:4]`.

Greedy tokens are byte-identical, at f32, to the one-device port engine
and to the JAX engine on its (2, 2) mesh (weights placed by
`shard_tree`): a short bucket and an int8 KV cache; against one device
also chunked prefill (chunk 8 of a 16 bucket), a 520-token prompt (the
flash prefill branch, per model shard on its 2 heads) and speculative
decoding (the draft replicated, its cache on the data axis only).  The engine's
caches hold each shard's (B/d, W, H/mp, Dh) heads; a cache row that
leaves it (`serialize_cache_row`) is gathered to full heads, byte for
byte the one-device engine's row.  `TextGenerator.set_mesh`:
tests/test_torch_tp_serve.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.models.definitions import build_model as jax_build_model
from mmlspark_tpu.models.generate import DecodeEngine as JaxDecodeEngine
from mmlspark_tpu.parallel.partition import UNMATCHED_REPLICATE
from mmlspark_tpu.parallel.partition import shard_tree as jax_shard_tree
from mmlspark_tpu_torch import ModelBundle
from mmlspark_tpu_torch.models.generate import (DecodeEngine,
                                                serialize_cache_row)
from mmlspark_tpu_torch.parallel.partition import ModelShards
from mmlspark_tpu_torch.zoo import truncated_draft_bundle
from test_torch_tp_train import host_mesh, jax_mesh

CFG = {"vocab_size": 64, "d_model": 32, "n_heads": 4, "n_layers": 2,
       "max_len": 640, "dtype": "float32"}
# name: (prompt lengths, max_new_tokens, engine options, against JAX)
CASES = {
    "short": ([9, 12, 16, 5], 10, {}, True),
    "chunked_prefill": ([9, 12, 16, 5], 10, {"prefill_chunk": 8,
                                             "chunk": 8}, False),
    "int8_cache": ([9, 14, 3, 7], 12, {"cache_dtype": "int8",
                                       "chunk": 8}, True),
    "flash_prefill": ([520, 300, 12, 40], 6, {}, False),
}


@pytest.fixture(scope="module")
def bundle():
    return ModelBundle.init("TransformerLM", CFG, seed=4)


def _padded(lengths, bucket, seed=0):
    rng = np.random.default_rng(seed)
    prompts = np.zeros((len(lengths), bucket), np.int32)
    for j, n in enumerate(lengths):
        prompts[j, :n] = rng.integers(0, CFG["vocab_size"], n)
    return prompts, np.asarray(lengths, np.int32)


@pytest.fixture(scope="module")
def jax_tokens(bundle):
    """The JAX engine's greedy tokens on its (2, 2) mesh, per JAX case."""
    module = jax_build_model("TransformerLM", CFG)
    mesh = jax_mesh(2, 2)
    variables = jax_shard_tree(
        jax.tree_util.tree_map(jnp.asarray, bundle.variables), mesh,
        on_unmatched=UNMATCHED_REPLICATE)
    out = {}
    for name, (lengths, max_new, kw, vs_jax) in CASES.items():
        if not vs_jax:
            continue
        engine = JaxDecodeEngine(module, max_new, mesh=mesh, **kw)
        prompts, tl = _padded(lengths, engine.bucket_for(max(lengths)),
                              seed=len(name))
        out[name] = engine.generate(variables, prompts, tl)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_tensor_parallel_greedy_decode_is_byte_identical(bundle, jax_tokens,
                                                         name):
    lengths, max_new, kw, vs_jax = CASES[name]
    module = bundle.module("cpu")
    one = DecodeEngine(module, max_new, device="cpu", **kw)
    engine = DecodeEngine(module, max_new, device="cpu",
                          mesh=host_mesh(2, 2), **kw)
    prompts, tl = _padded(lengths, one.bucket_for(max(lengths)),
                          seed=len(name))
    got = engine.generate(prompts, tl)
    np.testing.assert_array_equal(got, one.generate(prompts, tl))
    if vs_jax:
        np.testing.assert_array_equal(got, jax_tokens[name])


def test_speculative_decode_over_a_model_axis(bundle):
    """The verify pass runs the target's tensor-parallel layout; the draft
    (one layer, replicated) keeps whole heads."""
    module = bundle.module("cpu")
    draft = truncated_draft_bundle(bundle, 1).module("cpu")
    kw = dict(draft_module=draft, spec_tokens=3)
    prompts, tl = _padded([9, 12, 16, 5], 16)
    want = DecodeEngine(module, 10, device="cpu", **kw).generate(prompts, tl)
    engine = DecodeEngine(module, 10, device="cpu", mesh=host_mesh(2, 2),
                          **kw)
    np.testing.assert_array_equal(engine.generate(prompts, tl), want)
    assert engine.last_spec_rounds > 0


def test_cache_heads_on_the_model_axis_and_rows_gathered(bundle):
    """Each model shard's cache is (B, W, H/mp, Dh) (KV_CACHE_SPEC), int8
    scales (B, W, H/mp); a cache row leaving the engine is gathered to full
    heads in the reference's order: the one-device engine's caches split
    over the heads serialize byte for byte as they do whole, and the
    tensor-parallel engine's own rows (computed with the row-parallel
    sums in model order) hold the one-device values to 1e-5."""
    from mmlspark_tpu_torch.models.generate import deserialize_cache_row
    from mmlspark_tpu_torch.parallel.partition import place
    module = bundle.module("cpu")
    prompts, tl = _padded([9, 12, 16, 5], 16)
    live = np.ones(4, bool)
    seeds = list(range(4))
    for cache_dtype in ("model", "int8"):
        one = DecodeEngine(module, 6, device="cpu", cache_dtype=cache_dtype)
        tp = DecodeEngine(module, 6, device="cpu", mesh=host_mesh(1, 2),
                          cache_dtype=cache_dtype)
        _, _, want = one.serve_prefill(prompts, tl, live, seeds)
        _, _, got = tp.serve_prefill(prompts, tl, live, seeds)
        for layer in got:
            for t in layer:
                assert isinstance(t, ModelShards) and len(t) == 2
                assert t[0].shape[2] == CFG["n_heads"] // 2
        split = [tuple(place(t, [torch.device("cpu")] * 2, 2)
                       for t in layer) for layer in want]
        for row in range(4):
            pages = serialize_cache_row(want, row, 8)
            assert serialize_cache_row(split, row, 8) == pages
            tp_row = deserialize_cache_row(serialize_cache_row(got, row, 8))
            for a, b in zip(tp_row, deserialize_cache_row(pages)):
                for x, y in zip(a, b):
                    assert x.dtype == y.dtype and x.shape == y.shape
                    if x.dtype == torch.float32:
                        torch.testing.assert_close(x, y, rtol=0, atol=1e-5)
