"""The port's TransformerLM serving path against the JAX package, on the
CPU: greedy tokens of `DecodeEngine` and `TextGenerator` at f32.

Both packages get the same weights (the port's seeded numpy init, fed to
flax as the parameter tree) and the same prompts.  The JAX engine runs as
its own tests run it on the CPU; the port's kernel wrappers run their
plain versions.  Greedy tokens must be IDENTICAL at f32: the two sides
differ only in f32 summation order, far below this model's top-2 logit
gaps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu import DataTable as JaxDataTable
from mmlspark_tpu.models import ModelBundle as JaxModelBundle
from mmlspark_tpu.models.definitions import build_model as jax_build_model
from mmlspark_tpu.models.generate import DecodeEngine as JaxDecodeEngine
from mmlspark_tpu.models.generate import TextGenerator as JaxTextGenerator
from mmlspark_tpu_torch import DataTable, TextGenerator
from mmlspark_tpu_torch.models import DecodeEngine, ModelBundle, naive_generate

CFG = {"vocab_size": 128, "d_model": 64, "n_heads": 4, "n_layers": 2,
       "max_len": 640, "dtype": "float32"}


@pytest.fixture(scope="module")
def bundle():
    return ModelBundle.init("TransformerLM", CFG, seed=0)


@pytest.fixture(scope="module")
def jax_lm(bundle):
    module = jax_build_model("TransformerLM", CFG)
    variables = jax.tree_util.tree_map(jnp.asarray, bundle.variables)
    return module, variables


@pytest.fixture(scope="module")
def torch_lm(bundle):
    return bundle.module("cpu")


def _rows(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG["vocab_size"], (n,)).astype(np.int32)
            for n in lengths]


def _padded(rows, bucket):
    prompts = np.zeros((len(rows), bucket), np.int32)
    for j, r in enumerate(rows):
        prompts[j, :len(r)] = r
    return prompts, np.asarray([len(r) for r in rows], np.int32)


# ------------------------------------------------------ greedy decode ---

# (prompt lengths of one bucket, max_new_tokens, chunk, cache, stops,
#  min_new): short prompts in bucket 16; a 520-token prompt whose bucket
# (624, the max_len - max_new cap) takes the flash prefill branch; a chunk
# of 8 so decode crosses several window growths; the int8 cache; stop
# tokens with a minNewTokens floor
ENGINE_CASES = {
    "short": ([9, 12, 16], 10, 128, "model", (), 1),
    "flash_prefill": ([520, 300], 16, 128, "model", (), 1),
    "chunk_boundary": ([5, 7], 24, 8, "model", (), 1),
    "int8_cache": ([9, 14], 20, 8, "int8", (), 1),
    "stop_tokens": ([10, 11, 13], 20, 8, "model", "find", 3),
}


def _stops_for(module_vars, rows, max_new, chunk):
    """Stop tokens that really occur: the 4th greedy token of each row."""
    module, variables = module_vars
    engine = JaxDecodeEngine(module, max_new, chunk=chunk)
    prompts, tl = _padded(rows, engine.bucket_for(max(map(len, rows))))
    got = engine.generate(variables, prompts, tl)
    return tuple(sorted({int(t) for t in got[:, 3]}))


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_greedy_tokens_identical_to_jax(jax_lm, torch_lm, case):
    lengths, max_new, chunk, cache, stops, min_new = ENGINE_CASES[case]
    rows = _rows(lengths, seed=len(case))
    if stops == "find":
        stops = _stops_for(jax_lm, rows, max_new, chunk)
    module, variables = jax_lm
    kw = dict(chunk=chunk, cache_dtype=cache, stop_tokens=stops,
              min_new_tokens=min_new)
    ref_engine = JaxDecodeEngine(module, max_new, **kw)
    engine = DecodeEngine(torch_lm, max_new, device="cpu", **kw)
    bucket = engine.bucket_for(max(lengths))
    assert bucket == ref_engine.bucket_for(max(lengths))
    prompts, tl = _padded(rows, bucket)
    ref = ref_engine.generate(variables, prompts, tl)
    got = engine.generate(prompts, tl)
    assert got.dtype == np.int32 and got.shape == (len(rows), max_new)
    np.testing.assert_array_equal(got, ref)
    if case == "flash_prefill":
        assert bucket >= 512
    if case == "stop_tokens":
        assert np.isin(got[:, min_new - 1:], stops).any()
        assert engine.last_segments_run == ref_engine.last_segments_run


def test_engine_matches_recompute_oracle(torch_lm):
    """The port's own oracle: bucketed, windowed decode equals greedy
    recompute through the module forward."""
    rows = _rows([3, 8], seed=5)
    engine = DecodeEngine(torch_lm, 12, chunk=8, device="cpu")
    prompts, tl = _padded(rows, engine.bucket_for(8))
    got = engine.generate(prompts, tl)
    for j, r in enumerate(rows):
        ref = naive_generate(torch_lm, r[None], 12)[0]
        np.testing.assert_array_equal(got[j], ref[len(r):])


@pytest.mark.parametrize("cache", [None, "int8"])
def test_text_generator_matches_jax(bundle, cache):
    """Ragged rows over three buckets, stop tokens trimming rows, both
    cache kinds: the output columns are identical."""
    rows = _rows([4, 9, 17, 6, 30], seed=6)
    params = dict(inputCol="prompt", maxNewTokens=12, cacheChunk=16,
                  kvCacheDtype=cache, stopTokens=[5, 77, 101])
    ref = JaxTextGenerator(
        JaxModelBundle("TransformerLM", CFG, bundle.variables),
        **params).transform(JaxDataTable({"prompt": rows}))
    got = TextGenerator(bundle, device="cpu", **params).transform(
        DataTable({"prompt": rows}))
    assert len(got["generated"]) == len(rows)
    for g, r, prompt in zip(got["generated"], ref["generated"], rows):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g[:len(prompt)], prompt)


# ------------------------------------------------------------ sampling ---

@pytest.mark.parametrize("top_k,top_p", [(5, None), (None, 0.7), (8, 0.5)])
def test_filter_logits_matches_jax(top_k, top_p):
    from mmlspark_tpu.models.generate import filter_logits as jax_filter
    from mmlspark_tpu_torch.models.generate import filter_logits
    logits = np.random.default_rng(7).standard_normal((4, 64)) * 3
    ref = np.asarray(jax_filter(jnp.asarray(logits, jnp.float32), top_k,
                                top_p))
    got = filter_logits(torch.from_numpy(logits).float(), top_k, top_p)
    np.testing.assert_array_equal(got.numpy() > -1e29, ref > -1e29)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)


def test_sampled_rows_independent_of_batch_composition(torch_lm):
    """A row's draws depend on (seed, row id, step) only: the same row id
    in another batch draws the same tokens; top_k=1 sampling is greedy."""
    rows = _rows([6, 7, 5], seed=8)
    engine = DecodeEngine(torch_lm, 10, temperature=0.9, top_p=0.9,
                          device="cpu")
    prompts, tl = _padded(rows, 8)
    full = engine.generate(prompts, tl, seed=3)
    alone = engine.generate(prompts[1:2], tl[1:2], seed=3, row_ids=[1])
    np.testing.assert_array_equal(alone[0], full[1])
    assert not np.array_equal(engine.generate(prompts, tl, seed=4), full)
    greedy = DecodeEngine(torch_lm, 10, device="cpu").generate(prompts, tl)
    top1 = DecodeEngine(torch_lm, 10, temperature=1.0, top_k=1,
                        device="cpu").generate(prompts, tl, seed=5)
    np.testing.assert_array_equal(top1, greedy)
