"""KV pages across the two packages, on the CPU: pages the JAX prefill
tier serialized (`serialize_cache_row` of the row its `handoff_export`
hands over) splice into the port's decode engine through `splice_remote`
and decode to the JAX offline tokens at f32; pages the port's prefill
tier wrote decode in the JAX decode engine to the same tokens.  Both
packages write the same page layout, so the crossing needs no
conversion.
"""

import numpy as np
import pytest

from mmlspark_tpu.models.bundle import ModelBundle as JaxModelBundle
from mmlspark_tpu.models.generate import DecodeEngine as JaxDecodeEngine
from mmlspark_tpu.models.generate import \
    deserialize_cache_row as jax_deserialize_cache_row
from mmlspark_tpu.models.generate import \
    serialize_cache_row as jax_serialize_cache_row
from mmlspark_tpu.resilience.clock import VirtualClock as JaxVirtualClock
from mmlspark_tpu.serve import ServeConfig as JaxServeConfig
from mmlspark_tpu.serve import ServingEngine as JaxServingEngine
from mmlspark_tpu_torch.models import ModelBundle
from mmlspark_tpu_torch.models.generate import (deserialize_cache_row,
                                                serialize_cache_row)
from mmlspark_tpu_torch.resilience.clock import VirtualClock
from mmlspark_tpu_torch.serve import ServeConfig, ServingEngine

CFG = {"vocab_size": 64, "d_model": 32, "n_heads": 4, "n_layers": 2,
       "max_len": 64, "dtype": "float32"}


@pytest.fixture(scope="module")
def bundles():
    bundle = ModelBundle.init("TransformerLM", CFG, seed=0)
    return bundle, JaxModelBundle("TransformerLM", CFG, bundle.variables)


def _prompt(n=7, seed=7):
    return np.random.default_rng(seed).integers(1, 60, n).astype(np.int32)


def _exported_pages(engine, prompt, serialize, chunk):
    """Run one prompt through a prefill-tier engine and serialize the row
    it hands off: (pages, first token)."""
    got = {}

    def export(*, bucket, lane, reqs, src, tok_h, caches):
        got["pages"] = serialize(caches, src[0], chunk)
        got["tok"] = int(tok_h[src[0]])

    engine.handoff_export = export
    engine.warmup()
    req = engine.submit(prompt, max_new_tokens=6)
    for _ in range(50):
        if req.finished:
            break
        engine._tick()
    assert req.status == "handoff" and "pages" in got
    return got["pages"], got["tok"]


def _decode_remote(engine, prompt, pages, tok, deserialize):
    engine.warmup()
    req = engine.splice_remote(prompt, 6, engine.now() + 100.0, tok,
                               deserialize(pages))
    assert req is not None
    for _ in range(50):
        if req.finished:
            break
        engine._tick()
    assert req.status == "ok"
    return [int(t) for t in req.tokens]


def _jax_offline(jax_bundle, prompt):
    eng = JaxDecodeEngine(jax_bundle.module(), 6, chunk=8)
    b = eng.bucket_for(len(prompt))
    padded = np.zeros((1, b), np.int32)
    padded[0, :len(prompt)] = prompt
    return eng.generate(jax_bundle.variables, padded,
                        np.asarray([len(prompt)], np.int32))[0].tolist()


SINGLE = dict(max_new_tokens=6, max_batch=1, segment_steps=6,
              default_deadline_s=100.0, cache_chunk=8)


@pytest.mark.parametrize("cache_dtype", ["model", "int8"])
def test_pages_cross_between_the_packages(bundles, cache_dtype):
    """JAX prefill tier -> port decode tier, and port prefill tier -> JAX
    decode tier: the same pages both ways, each decoding to the JAX
    offline tokens (the int8 row: to the JAX int8 tiered tokens)."""
    bundle, jax_bundle = bundles
    prompt = _prompt()
    cfg = dict(SINGLE, cache_dtype=cache_dtype)
    jax_pages, jax_tok = _exported_pages(
        JaxServingEngine(jax_bundle, JaxServeConfig(role="prefill", **cfg),
                         clock=JaxVirtualClock()),
        prompt, jax_serialize_cache_row, 8)
    pages, tok = _exported_pages(
        ServingEngine(bundle, ServeConfig(role="prefill", **cfg),
                      clock=VirtualClock(), device="cpu"),
        prompt, serialize_cache_row, 8)
    assert tok == jax_tok and len(pages) == len(jax_pages)
    if cache_dtype == "model":
        # f32: the port's prefill writes the JAX rows to within round-off
        for a, b in zip(deserialize_cache_row(pages),
                        deserialize_cache_row(jax_pages)):
            for x, y in zip(a, b):
                np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-5)
    port_tokens = _decode_remote(
        ServingEngine(bundle, ServeConfig(role="decode", **cfg),
                      clock=VirtualClock(), device="cpu"),
        prompt, jax_pages, jax_tok, deserialize_cache_row)
    jax_tokens = _decode_remote(
        JaxServingEngine(jax_bundle, JaxServeConfig(role="decode", **cfg),
                         clock=JaxVirtualClock()),
        prompt, pages, tok, jax_deserialize_cache_row)
    assert port_tokens == jax_tokens
    if cache_dtype == "model":
        assert port_tokens == _jax_offline(jax_bundle, prompt)
