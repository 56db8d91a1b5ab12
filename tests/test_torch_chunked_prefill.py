"""The port's chunked prefill (`DecodeEngine(prefill_chunk=...)`, the chunk
and resume serve hooks, `TextGenerator.prefillChunk`) against the JAX
package's, on the CPU.

The same seeded weights (the port bundle's flax-layout tree, given to the
JAX module as is) and the same numpy prompts go through both packages.
At f32 the chunked tokens equal the JAX engine's with the same chunk and
the port's own whole-prompt tokens, with a model-dtype and an int8 cache;
the hooks' caches agree with the JAX hooks' within 1e-5 of their largest
value (int8 payloads within one quantization step) and the first tokens
are equal.  The JAX side of each comparison runs once, in a module
fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.models.definitions import build_model as jax_build_model
from mmlspark_tpu.models.generate import DecodeEngine as JaxDecodeEngine
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.models import DecodeEngine, ModelBundle, TextGenerator

CFG = {"vocab_size": 64, "d_model": 32, "n_heads": 4, "n_layers": 2,
       "max_len": 64, "dtype": "float32"}
MAX_NEW, CHUNK, PCHUNK = 8, 8, 16
# one bucket of 32, which prefills in two chunks of 16 (one JAX compile of
# each program per cache kind)
LENGTHS = (17, 20, 27, 32)


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG["vocab_size"], n).astype(np.int32)
            for n in lengths]


def _padded(prompts, bucket):
    out = np.zeros((len(prompts), bucket), np.int32)
    for j, p in enumerate(prompts):
        out[j, :len(p)] = p
    return out, np.asarray([len(p) for p in prompts], np.int32)


@pytest.fixture(scope="module")
def bundle():
    return ModelBundle.init("TransformerLM", CFG, seed=0)


@pytest.fixture(scope="module")
def jax_lm(bundle):
    return jax_build_model("TransformerLM", CFG), bundle.variables


def _by_bucket(engine, prompts):
    groups: dict = {}
    for i, p in enumerate(prompts):
        groups.setdefault(engine.bucket_for(len(p)), []).append(i)
    return sorted(groups.items())


def _generate(engine, prompts, call):
    out: list = [None] * len(prompts)
    for bucket, idxs in _by_bucket(engine, prompts):
        padded, tl = _padded([prompts[i] for i in idxs], bucket)
        for j, row in zip(idxs, call(engine, padded, tl)):
            out[j] = np.asarray(row).tolist()
    return out


@pytest.fixture(scope="module")
def jax_tokens(jax_lm):
    module, variables = jax_lm
    prompts = _prompts(LENGTHS, seed=1)
    return {cache: _generate(
        JaxDecodeEngine(module, MAX_NEW, chunk=CHUNK, cache_dtype=cache,
                        prefill_chunk=PCHUNK), prompts,
        lambda e, p, tl: e.generate(variables, p, tl))
        for cache in ("model", "int8")}


@pytest.mark.parametrize("cache", ["model", "int8"])
def test_chunked_generate_equals_jax_and_whole_prompt(bundle, jax_tokens,
                                                      cache):
    prompts = _prompts(LENGTHS, seed=1)
    module = bundle.module("cpu")
    chunked = DecodeEngine(module, MAX_NEW, chunk=CHUNK, cache_dtype=cache,
                           prefill_chunk=PCHUNK, device="cpu")
    whole = DecodeEngine(module, MAX_NEW, chunk=CHUNK, cache_dtype=cache,
                         device="cpu")

    def call(e, p, tl):
        return e.generate(p, tl)

    got = _generate(chunked, prompts, call)
    assert got == jax_tokens[cache]
    assert got == _generate(whole, prompts, call)
    # the bucket of 32 ran two chunks and a finish; 16 would run whole
    assert chunked.serve_prefill_chunks(32) == 2
    assert chunked.serve_prefill_chunks(16) == 0
    assert {k[0] for k in chunked._programs} == {
        "prefill_chunk0", "prefill_chunk", "prefill_finish"}


def test_chunked_generate_at_bf16_agrees_with_whole_prompt(bundle):
    """At bf16 the chunked prefill's later chunk attends through the
    dense branch, a whole prompt's through the same branch at another
    shape: near-tie tokens may differ, the rest agree."""
    bf16 = ModelBundle("TransformerLM", {**CFG, "dtype": "bfloat16"},
                       bundle.variables)
    prompts = _prompts(LENGTHS, seed=1)
    module = bf16.module("cpu")

    def call(e, p, tl):
        return e.generate(p, tl)

    got = _generate(DecodeEngine(module, MAX_NEW, chunk=CHUNK,
                                 prefill_chunk=PCHUNK, device="cpu"),
                    prompts, call)
    ref = _generate(DecodeEngine(module, MAX_NEW, chunk=CHUNK,
                                 device="cpu"), prompts, call)
    for row in got:
        assert len(row) == MAX_NEW
        assert all(0 <= t < CFG["vocab_size"] for t in row)
    agree = sum(a == b for g, r in zip(got, ref) for a, b in zip(g, r))
    assert agree >= 0.9 * MAX_NEW * len(prompts)
    # the first token of every row comes from the last prompt position
    assert [g[0] for g in got] == [r[0] for r in ref]


# ------------------------------------------------------------ hooks ---

def _hooks(side):
    """The chunk, finish and resume scenario through one side's hooks:
    a cohort of three rows in bucket 32 (a not-live pad row among them)
    prefills in two chunks; then one row resumes from the cohort's first
    16 slots of row 0 and prefills its suffix inline."""
    chunk, finish, resume = side
    prompts = _prompts((20, 32, 1), seed=2)
    padded, tl = _padded(prompts, 32)
    live = np.asarray([True, True, False])
    s0 = chunk(padded, tl, 0, None)
    s0_caches = [tuple(np.array(t) for t in layer) for layer in s0[0]]
    s0_last = np.array(s0[1])
    s1 = chunk(padded, tl, 1, s0)
    tok, done, caches = finish(s1, live, [0, 1, 2])
    donor = [tuple(t[0:1, :16] for t in layer) for layer in caches]
    shared = prompts[0].copy()
    shared[17:] = 5                     # diverges after the donor prefix
    rp, rtl = _padded([shared], 32)
    r_tok, r_done, r_caches = resume(rp, rtl, 16, donor, [True], [7])
    return {"chunk0": (s0_caches, s0_last), "finish": (tok, done, caches),
            "resume": (r_tok, r_done, r_caches)}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def hook_runs(bundle, jax_lm):
    module, variables = jax_lm
    base = jax.random.key(0)

    def keys(ids):
        return jax.vmap(lambda i: jax.random.fold_in(base, i))(
            jnp.asarray(ids, jnp.int32))

    out = {}
    for cache in ("model", "int8"):
        ref = JaxDecodeEngine(module, MAX_NEW, chunk=CHUNK,
                              cache_dtype=cache, prefill_chunk=PCHUNK)
        jax_side = (
            lambda p, tl, i, st: ref.serve_prefill_chunk(variables, p, tl,
                                                         i, st),
            lambda st, live, ids: ref.serve_prefill_finish(st, live,
                                                           keys(ids)),
            lambda p, tl, n, rows, live, ids: ref.serve_prefill_resume(
                variables, p, tl, n, rows, np.asarray(live), keys(ids)))
        eng = DecodeEngine(bundle.module("cpu"), MAX_NEW, chunk=CHUNK,
                           cache_dtype=cache, prefill_chunk=PCHUNK,
                           device="cpu")
        port_side = (eng.serve_prefill_chunk, eng.serve_prefill_finish,
                     eng.serve_prefill_resume)
        out[cache] = (_hooks(jax_side), _hooks(port_side), eng)
    return out


def _assert_close(got, ref):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if got.dtype == np.int8:
        assert np.abs(got.astype(np.int32) - ref).max() <= 1
    else:
        tol = 1e-5 * max(np.abs(ref).max(), 1e-30)
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("stage", ["chunk0", "finish", "resume"])
@pytest.mark.parametrize("cache", ["model", "int8"])
def test_chunk_and_resume_hooks_match_jax(hook_runs, cache, stage):
    ref, got, _ = hook_runs[cache]
    if stage == "chunk0":
        for g_layer, r_layer in zip(got[stage][0], ref[stage][0]):
            for g, r in zip(g_layer, r_layer):
                _assert_close(g, r)
        _assert_close(got[stage][1], ref[stage][1])
        return
    tok, done, caches = got[stage]
    np.testing.assert_array_equal(_np(tok), _np(ref[stage][0]))
    np.testing.assert_array_equal(_np(done), _np(ref[stage][1]))
    assert len(caches) == CFG["n_layers"]
    for g_layer, r_layer in zip(caches, ref[stage][2]):
        assert len(g_layer) == (4 if cache == "int8" else 2)
        for g, r in zip(g_layer, r_layer):
            _assert_close(g, r)


def test_hooks_register_the_jax_program_classes(hook_runs):
    _, _, eng = hook_runs["model"]
    assert eng._programs == {
        ("prefill_chunk0", 3, 16, 40), ("prefill_chunk", 3, 16, 40),
        ("prefill_finish", 3, 40), ("resume_init", 1, 16, 40, 2),
        ("prefill_chunk", 1, 16, 40), ("prefill_finish", 1, 40)}
    assert eng.serve_resume_chunks(32, 16) == 1
    assert eng.serve_resume_chunks(32, 8) == 0      # not chunk-aligned
    assert eng.serve_resume_chunks(16, 8) == 0      # bucket not chunked


def test_segment_past_the_window_is_refused(bundle):
    eng = DecodeEngine(bundle.module("cpu"), MAX_NEW, chunk=CHUNK,
                       prefill_chunk=PCHUNK, device="cpu")
    padded, tl = _padded(_prompts((20,), seed=3), 32)
    caches, last = eng.serve_prefill_chunk(padded, tl, 0, None)
    with torch.inference_mode(), pytest.raises(ValueError, match="window"):
        eng._prefill_chunk(torch.zeros((1, 16), dtype=torch.long), caches,
                           last, torch.as_tensor(tl), 32)
    with pytest.raises(ValueError, match="prefill_chunk"):
        DecodeEngine(bundle.module("cpu"), MAX_NEW, prefill_chunk=0,
                     device="cpu")


# ------------------------------------------------------------ stage ---

def test_text_generator_prefill_chunk(bundle):
    prompts = _prompts((6, 20, 31), seed=4)
    table = DataTable({"p": np.asarray(prompts, dtype=object)})

    def run(stage):
        return [list(map(int, r)) for r in stage.transform(table)["out"]]

    kw = dict(inputCol="p", outputCol="out", maxNewTokens=8,
              cacheChunk=CHUNK)
    chunked = TextGenerator(bundle, device="cpu", prefillChunk=PCHUNK, **kw)
    got = run(chunked)
    assert got == run(TextGenerator(bundle, device="cpu", **kw))
    engine = chunked._engine_for()
    assert engine.prefill_chunk == PCHUNK
    assert ("prefill_chunk", 2, PCHUNK, 40) in engine._programs
    # a new chunk size is a new engine
    chunked.set("prefillChunk", 8)
    assert chunked._engine_for().prefill_chunk == 8
    assert run(chunked) == got
