"""The port's serving hooks and cache-row pages against the JAX package's,
on the CPU at f32.

One scenario runs on both sides with the same inputs: a join cohort's
prefill (a not-live pad row among them), a mixed-age segment over the
resident batch (per-row step offsets, a row that spends its budget
mid-segment, a free slot) whose window grows past the prefill's, splices
of a second cohort across windows in both directions, and a second
segment over the spliced batch.  Tokens and `done` must be equal;
model-dtype caches agree within 1e-5 of their largest value; int8 caches
within one quantization step, scales within 1e-5 of their largest.  The
weights are one seeded numpy tree in the flax layout, given to the JAX
module as is and loaded into the port through `params_from_jax`.  The
JAX side runs once per cache kind, in a module fixture.

Pages: the port's `serialize_cache_row` writes the JAX package's bytes,
and each side reads the other's pages bit for bit.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.models.definitions import build_model as jax_build_model
from mmlspark_tpu.models.generate import DecodeEngine as JaxDecodeEngine
from mmlspark_tpu.models.generate import \
    deserialize_cache_row as jax_deserialize
from mmlspark_tpu.models.generate import serialize_cache_row as jax_serialize
from mmlspark_tpu_torch.models import DecodeEngine, ModelBundle
from mmlspark_tpu_torch.models.generate import (deserialize_cache_row,
                                                serialize_cache_row)

CFG = {"vocab_size": 64, "d_model": 32, "n_heads": 4, "n_layers": 2,
       "max_len": 64, "dtype": "float32"}
MAX_NEW, CHUNK, BUCKET, SEG = 12, 8, 16, 4
STAGES = ("prefill", "step", "merge", "step_after_merge")


def _cohort(lengths, live, seed):
    rng = np.random.default_rng(seed)
    prompts = np.zeros((len(lengths), BUCKET), np.int32)
    for j, n in enumerate(lengths):
        prompts[j, :n] = rng.integers(0, CFG["vocab_size"], n)
    return prompts, np.asarray(lengths, np.int32), np.asarray(live, bool)


# cohort A seats in a resident batch of 4 (row 3 a not-live pad row: a
# free slot, born done); row 1 spends its budget of 5 at t = 4, inside
# the first segment.  Cohort B's two live rows (of 4, the same prefill
# shape) splice into rows 1 and 3.
COHORT_A = _cohort([5, 9, 16, 1], [True, True, True, False], seed=1)
COHORT_B = _cohort([7, 12, 1, 1], [True, True, False, False], seed=2)
STEP1 = dict(budget=np.asarray([12, 5, 12, 0], np.int32),
             t_row=np.asarray([0, 3, 6, 0], np.int32))
STEP2 = dict(budget=np.asarray([12, 8, 12, 6], np.int32),
             t_row=np.asarray([4, 0, 10, 0], np.int32))


def _np(caches):
    return [tuple(np.asarray(t) for t in layer) for layer in caches]


def _torch_np(caches):
    return [tuple(t.numpy() for t in layer) for layer in caches]


def _snap(caches):
    """A stage's caches as they stand: the port's hooks write resident
    caches in place, so later stages would change what a stage returned."""
    return [tuple(t.clone() if isinstance(t, torch.Tensor) else t
                  for t in layer) for layer in caches]


def _run(side):
    """The scenario through one side's hooks: per stage (tok, done,
    caches[, toks, window])."""
    prefill, step, merge, window = side
    out = {}
    tok, done, caches = prefill(*COHORT_A, [0, 1, 2, 3])
    out["prefill"] = (tok, done, _snap(caches))
    w1 = window(BUCKET, int(STEP1["t_row"].max()), SEG)
    caches, toks, tok, done = step(caches, tok, done, COHORT_A[1],
                                   STEP1["budget"], STEP1["t_row"],
                                   [0, 1, 2, 3], w1)
    out["step"] = (tok, done, _snap(caches), toks, w1)
    tok_b, done_b, caches_b = prefill(*COHORT_B, [4, 5, 6, 7])
    merged = merge(caches, caches_b, [1, 3], [0, 1])
    # the other direction: a wide resident row into a narrow cohort
    narrow = merge(caches_b, merged, [0], [2])
    out["merge"] = (_snap(merged), narrow)
    tok_h, done_h = np.asarray(tok).copy(), np.asarray(done).copy()
    tok_h[[1, 3]] = np.asarray(tok_b)[:2]
    done_h[[1, 3]] = np.asarray(done_b)[:2]
    true_len = COHORT_A[1].copy()
    true_len[[1, 3]] = COHORT_B[1][:2]
    w2 = window(BUCKET, int(STEP2["t_row"].max()), SEG)
    caches, toks, tok, done = step(merged, tok_h, done_h, true_len,
                                   STEP2["budget"], STEP2["t_row"],
                                   [0, 4, 2, 5], w2)
    out["step_after_merge"] = (tok, done, caches, toks, w2)
    return out


@pytest.fixture(scope="module")
def jax_lm():
    variables = ModelBundle.init("TransformerLM", CFG, seed=0).variables
    return jax_build_model("TransformerLM", CFG), variables


@pytest.fixture(scope="module")
def runs(jax_lm):
    """Both sides' scenario outputs, per cache kind."""
    module, variables = jax_lm
    base = jax.random.key(0)
    out = {}
    for cache in ("model", "int8"):
        ref = JaxDecodeEngine(module, MAX_NEW, chunk=CHUNK, cache_dtype=cache)

        def keys(ids):
            return jax.vmap(lambda i: jax.random.fold_in(base, i))(
                jnp.asarray(ids, jnp.int32))

        jax_side = (
            lambda p, tl, live, ids: ref.serve_prefill(variables, p, tl,
                                                       live, keys(ids)),
            lambda c, tok, done, tl, budget, t_row, ids, w: ref.serve_step(
                variables, c, tok, done, tl, budget, BUCKET, t_row,
                keys(ids), SEG, w),
            JaxDecodeEngine.merge_cache_rows, ref.serve_window)
        bundle = ModelBundle("TransformerLM", CFG, variables)
        eng = DecodeEngine(bundle.module("cpu"), MAX_NEW, chunk=CHUNK,
                           cache_dtype=cache, device="cpu")
        port_side = (
            eng.serve_prefill,
            lambda c, tok, done, tl, budget, t_row, ids, w: eng.serve_step(
                c, tok, done, tl, budget, BUCKET, t_row, ids, SEG, w),
            DecodeEngine.merge_cache_rows, eng.serve_window)
        out[cache] = (_run(jax_side), _run(port_side), eng)
    return out


def _assert_caches_close(got, ref, cache):
    got, ref = _torch_np(got), _np(ref)
    assert len(got) == len(ref) == CFG["n_layers"]
    for g_layer, r_layer in zip(got, ref):
        assert len(g_layer) == len(r_layer) == (4 if cache == "int8" else 2)
        for g, r in zip(g_layer, r_layer):
            assert g.shape == r.shape and g.dtype == r.dtype
            if g.dtype == np.int8:
                # one quantization step: a rounding tie may land apart
                assert np.abs(g.astype(np.int32) - r).max() <= 1
            else:
                tol = 1e-5 * max(np.abs(r).max(), 1e-30)
                np.testing.assert_allclose(g, r, rtol=0, atol=tol)


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("cache", ["model", "int8"])
def test_hooks_match_jax(runs, cache, stage):
    ref, got, _ = runs[cache]
    if stage == "merge":
        for g, r in zip(got["merge"], ref["merge"]):
            _assert_caches_close(g, r, cache)
        return
    tok, done, caches = got[stage][:3]
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref[stage][0]))
    np.testing.assert_array_equal(done.numpy(), np.asarray(ref[stage][1]))
    _assert_caches_close(caches, ref[stage][2], cache)
    if stage != "prefill":
        toks, window = got[stage][3:]
        assert window == ref[stage][4]
        assert toks.shape == (4, SEG)
        np.testing.assert_array_equal(toks.numpy(), np.asarray(ref[stage][3]))


def test_scenario_covers_the_edges(runs):
    """The scenario exercises what it claims: the window grows, the
    budget-limited row freezes mid-segment repeating its token, the free
    slot stays done, and the second segment attends the grown window."""
    _, got, eng = runs["model"]
    w0 = got["prefill"][2][0][0].shape[1]
    tok, done, _, toks, w1 = got["step"]
    assert w0 == 24 and w1 == 32
    assert done[1] and done[3] and not done[0] and not done[2]
    # row 1 produced t = 3 and t = 4 (its budget of 5 spent), then froze
    assert toks[1, 1] == toks[1, 2] == toks[1, 3]
    assert got["merge"][1][0][0].shape[1] == 32
    assert got["step_after_merge"][4] == 32
    assert eng.compiled_programs > 0


def test_serve_window_matches_jax(jax_lm):
    module, _ = jax_lm
    ref = JaxDecodeEngine(module, MAX_NEW, chunk=CHUNK)
    bundle = ModelBundle.init("TransformerLM", CFG)
    eng = DecodeEngine(bundle.module("cpu"), MAX_NEW, chunk=CHUNK,
                       device="cpu")
    for bucket in (8, 16, 32, 48):
        for max_t in (0, 3, 11, 40):
            for seg in (1, 4, 8):
                assert (eng.serve_window(bucket, max_t, seg)
                        == ref.serve_window(bucket, max_t, seg))


# ------------------------------------------------------------- pages ---

def _page_caches(dtype, n_layers=2, batch=3, width=24, heads=4, dh=8):
    """The same cache in both packages, from one numpy draw: (jax list,
    torch list)."""
    rng = np.random.default_rng(0)
    jax_layers, torch_layers = [], []
    for _ in range(n_layers):
        if dtype == "int8":
            parts = [rng.integers(-127, 127, (batch, width, heads, dh)
                                  ).astype(np.int8),
                     rng.normal(size=(batch, width, heads)
                                ).astype(np.float32),
                     rng.integers(-127, 127, (batch, width, heads, dh)
                                  ).astype(np.int8),
                     rng.normal(size=(batch, width, heads)
                                ).astype(np.float32)]
            jax_layers.append(tuple(jnp.asarray(p) for p in parts))
            torch_layers.append(tuple(torch.from_numpy(p) for p in parts))
        else:
            parts = [rng.normal(size=(batch, width, heads, dh)
                                ).astype(np.float32) for _ in range(2)]
            jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16"
                        else (jnp.float32, torch.float32))
            jax_layers.append(tuple(jnp.asarray(p, jdt) for p in parts))
            torch_layers.append(tuple(torch.from_numpy(p).to(tdt)
                                      for p in parts))
    return jax_layers, torch_layers


def _bits(x):
    """The raw bits of a JAX array or a torch tensor, as numpy."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy()
    arr = np.asarray(x)
    return arr.view(np.int16) if arr.dtype.name == "bfloat16" else arr


@pytest.mark.parametrize("chunk", [8, 16, 100])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_pages_are_the_jax_bytes_and_read_jax_pages(dtype, chunk):
    jax_caches, torch_caches = _page_caches(dtype)
    ref = jax_serialize(jax_caches, 1, chunk)
    pages = serialize_cache_row(torch_caches, 1, chunk)
    assert len(pages) == math.ceil(24 / chunk)
    assert pages == ref                      # byte for byte
    back = deserialize_cache_row(ref)        # JAX-made pages in the port
    for src_layer, dst_layer in zip(torch_caches, back):
        assert len(src_layer) == len(dst_layer)
        for src, dst in zip(src_layer, dst_layer):
            assert dst.shape == (1,) + tuple(src.shape[1:])
            assert dst.dtype == src.dtype
            np.testing.assert_array_equal(_bits(dst[0]), _bits(src[1]))


@pytest.mark.parametrize("chunk", [8, 16, 100])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_port_pages_read_in_jax(dtype, chunk):
    jax_caches, torch_caches = _page_caches(dtype)
    back = jax_deserialize(serialize_cache_row(torch_caches, 2, chunk))
    for src_layer, dst_layer in zip(jax_caches, back):
        for src, dst in zip(src_layer, dst_layer):
            assert dst.shape == (1,) + src.shape[1:]
            assert dst.dtype == src.dtype
            np.testing.assert_array_equal(_bits(dst[0]), _bits(src[2]))


def test_pages_reject_garbage():
    _, torch_caches = _page_caches("float32")
    with pytest.raises(ValueError, match="empty"):
        deserialize_cache_row([])
    pages = serialize_cache_row(torch_caches, 0, 8)
    with pytest.raises(ValueError):
        deserialize_cache_row([pages[0][:10]])   # truncated blob
    _, int8_caches = _page_caches("int8")
    other = serialize_cache_row(int8_caches, 0, 8)
    with pytest.raises(ValueError, match="layout"):
        deserialize_cache_row([pages[0], other[1]])
    # an unknown dtype name, and a byte count that does not fit the shape
    bad_name = pages[0].replace(b"float32", b"float99", 1)
    with pytest.raises(ValueError, match="dtype"):
        deserialize_cache_row([bad_name])
    with pytest.raises(ValueError):
        deserialize_cache_row([pages[0][:-4]])
