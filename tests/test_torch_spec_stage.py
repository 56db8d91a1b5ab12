"""Speculative decoding through the port's `TextGenerator` and
`ServingEngine`, on the CPU, against the JAX package.

The JAX stage (`specTokens` 7, cache chunk 16, a 1-block truncated
draft) and the JAX engine it builds give the tokens the port's stage and
engine must give exactly at f32 (the reference's k 7 / chunk 16 /
model-dtype cell; tests/test_torch_speculative.py has the other).  The
serving engine's speculative lanes must give each request the offline
speculative engine's tokens, with joins mid-flight, at model-dtype and
int8 KV caches.
"""

import jax
import numpy as np
import pytest

from mmlspark_tpu import DataTable as JaxDataTable
from mmlspark_tpu.models import ModelBundle as JaxModelBundle
from mmlspark_tpu.models.generate import TextGenerator as JaxTextGenerator
from mmlspark_tpu.zoo import truncated_draft_bundle as jax_truncated_draft
from mmlspark_tpu_torch import DataTable, TextGenerator
from mmlspark_tpu_torch.core.table import object_column
from mmlspark_tpu_torch.models import DecodeEngine, ModelBundle
from mmlspark_tpu_torch.resilience.clock import VirtualClock
from mmlspark_tpu_torch.serve import ServeConfig, ServingEngine
from mmlspark_tpu_torch.zoo import truncated_draft_bundle

CFG = {"vocab_size": 32, "d_model": 32, "n_heads": 4, "n_layers": 2,
       "max_len": 64, "dtype": "float32"}
K, CHUNK, MAX_NEW = 7, 16, 8


@pytest.fixture(scope="module")
def target():
    return ModelBundle.init("TransformerLM", CFG, seed=11)


@pytest.fixture(scope="module")
def draft(target):
    return truncated_draft_bundle(target, n_layers=1)


def _rows(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG["vocab_size"], (n,)).astype(np.int32)
            for n in lengths]


ROWS = _rows([9, 12, 16, 10], seed=3)        # one bucket (16)


def _padded(rows, bucket):
    prompts = np.zeros((len(rows), bucket), np.int32)
    for j, r in enumerate(rows):
        prompts[j, :len(r)] = r
    return prompts, np.asarray([len(r) for r in rows], np.int32)


@pytest.fixture(scope="module")
def jax_side(target):
    """The JAX stage's output column over ROWS, then its own engine's
    tokens and acceptance for the padded bucket (the programs the stage
    compiled)."""
    jb = JaxModelBundle("TransformerLM", dict(CFG), jax.tree_util.tree_map(
        np.asarray, target.variables), {})
    jd = jax_truncated_draft(jb, 1)
    stage = JaxTextGenerator(jb, inputCol="prompt", outputCol="out",
                             maxNewTokens=MAX_NEW, specTokens=K,
                             cacheChunk=CHUNK).set_draft_bundle(jd)
    out = stage.transform(JaxDataTable({"prompt": object_column(ROWS)}))
    engine = stage._engine_for()
    prompts, tl = _padded(ROWS, 16)
    tokens = engine.generate(jb.variables, prompts, tl,
                             row_ids=np.arange(len(ROWS), dtype=np.int32),
                             draft_variables=jd.variables)
    return list(out["out"]), tokens, engine.last_spec_acceptance


def test_spec_engine_equals_jax_spec_engine(target, draft, jax_side):
    """The reference's k 7 / chunk 16 / model-dtype greedy cell: the
    port's speculative tokens are its plain engine's and the JAX
    speculative engine's, with the same acceptance (< 1: a raw draft)."""
    _, want, jax_rate = jax_side
    module = target.module("cpu")
    prompts, tl = _padded(ROWS, 16)
    spec = DecodeEngine(module, MAX_NEW, chunk=CHUNK, spec_tokens=K,
                        draft_module=draft.module("cpu"), device="cpu")
    got = spec.generate(prompts, tl)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, DecodeEngine(
        module, MAX_NEW, chunk=CHUNK, device="cpu").generate(prompts, tl))
    assert spec.last_spec_acceptance == pytest.approx(jax_rate)
    assert spec.last_spec_acceptance < 1.0


def test_text_generator_spec_matches_jax_stage(target, draft, jax_side,
                                               tmp_path):
    want = jax_side[0]
    table = DataTable({"prompt": object_column(ROWS)})
    stage = TextGenerator(target, device="cpu", inputCol="prompt",
                          outputCol="out", maxNewTokens=MAX_NEW,
                          specTokens=K, cacheChunk=CHUNK)
    with pytest.raises(ValueError, match="set_draft_bundle"):
        stage.transform(table)
    got = stage.set_draft_bundle(draft).transform(table)["out"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert stage._engine_for().last_spec_rounds > 0
    # the draft is not saved with the stage: attach it again after load
    stage.save(str(tmp_path / "stage"))
    loaded = TextGenerator.load(str(tmp_path / "stage"), device="cpu")
    assert loaded.specTokens == K
    with pytest.raises(ValueError, match="set_draft_bundle"):
        loaded.transform(table)


@pytest.mark.parametrize("cache", ["model", "int8"])
def test_serving_spec_lanes_equal_offline_spec_engine(target, draft, cache):
    """Requests through the speculative lanes (rounds instead of
    segments, draft caches spliced at every join, a join while others
    decode) get the offline speculative engine's tokens, request by
    request; a shorter budget stops where asked."""
    engine = ServingEngine(target, ServeConfig(
        max_new_tokens=MAX_NEW, max_batch=4, queue_capacity=8,
        segment_steps=4, default_deadline_s=100.0, cache_chunk=CHUNK,
        cache_dtype=cache, spec_tokens=3), draft_bundle=draft,
        clock=VirtualClock(), device="cpu").warmup()
    offline = DecodeEngine(target.module("cpu"), MAX_NEW, chunk=CHUNK,
                           cache_dtype=cache, spec_tokens=3,
                           draft_module=draft.module("cpu"), device="cpu")
    prompts = _rows([5, 7, 11, 3], seed=8)
    reqs = [engine.submit(p) for p in prompts[:2]]
    engine._tick()
    reqs += [engine.submit(prompts[2]),
             engine.submit(prompts[3], max_new_tokens=5)]
    for _ in range(100):
        if all(r.finished for r in reqs):
            break
        engine._tick()
    for req, prompt in zip(reqs, prompts):
        assert req.status == "ok"
        padded, tl = _padded([prompt], offline.bucket_for(len(prompt)))
        want = offline.generate(padded, tl)[0][:req.max_new_tokens]
        assert req.tokens == want.tolist()
    assert engine.stats()["ok"] == 4
