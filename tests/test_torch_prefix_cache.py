"""The port's cross-request radix prefix KV cache
(mmlspark_tpu_torch/serve/prefix_cache.py) and the serving engine's reuse
of it, on the CPU.

The pool cases of tests/test_prefix_cache.py run on the port over torch
tensors: chunk-granular hashing, longest-prefix match, the acquire limit,
lease pinning, LRU order, leaf-only eviction, first-writer-wins, the byte
budget, int8 rows.  `affinity_key` equals the JAX package's for the same
tokens.  Torch slices are views, so the pool copies what it keeps: a
write into the cache a row came from leaves the pool's bytes alone, the
pool's `resident_bytes` is what its tensors own, and an int8 resume
(dequantize, suffix prefill, re-quantize) leaves the stored int8 bytes
as they were and writes the same bytes into the resumed row.  The
engine's reuse is byte-exact against a fresh engine, through an inline
resume and a chunked one.
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu.serve.prefix_cache import PrefixCache as JaxPrefixCache
from mmlspark_tpu_torch.models import DecodeEngine, ModelBundle
from mmlspark_tpu_torch.observe.telemetry import run_telemetry
from mmlspark_tpu_torch.resilience.clock import VirtualClock
from mmlspark_tpu_torch.serve import PrefixCache, ServeConfig, ServingEngine
from mmlspark_tpu_torch.serve.engine import _assemble_prefix_row

CHUNK = 4


def fake_row(n_slots, seed=0, dtype=torch.float32):
    """A model-dtype cache row stand-in: payloads are opaque to the pool,
    so plain tensors with slot axis 1 exercise it fully."""
    gen = torch.Generator().manual_seed(seed)
    return [tuple(torch.randn((1, n_slots, 2, 3), generator=gen).to(dtype)
                  for _ in range(2)) for _ in range(2)]


def fake_int8_row(n_slots, seed=0):
    """An int8-layout row: (kq, k_scale, vq, v_scale) per layer."""
    gen = torch.Generator().manual_seed(seed)

    def q():
        return torch.randint(-127, 128, (1, n_slots, 2, 3), generator=gen,
                             dtype=torch.int8)

    def s():
        return torch.randn((1, n_slots, 2), generator=gen)

    return [(q(), s(), q(), s()) for _ in range(2)]


def toks(*vals):
    return np.asarray(vals, np.int32)


def row_bytes(row):
    return sum(t.numel() * t.element_size() for layer in row for t in layer)


# ---------------------------------------------------------------------------
# the pool itself (no engine, fake rows)
# ---------------------------------------------------------------------------

def test_miss_then_hit_and_longest_prefix_match():
    pc = PrefixCache(CHUNK, max_rows=8)
    prompt = np.arange(12, dtype=np.int32)
    assert pc.acquire(prompt) is None
    pc.insert(prompt, 8, fake_row(8))
    hit = pc.acquire(prompt)
    assert hit is not None and hit.n_tokens == 8
    assert len(hit.rows) == 2
    pc.release(hit)
    other = np.concatenate([prompt[:4], toks(50, 51, 52, 53, 54)])
    hit = pc.acquire(other)
    assert hit.n_tokens == 4
    pc.release(hit)


def test_chunk_granular_hashing():
    pc = PrefixCache(CHUNK, max_rows=8)
    prompt = np.arange(12, dtype=np.int32)
    pc.insert(prompt, 12, fake_row(12))
    for flip, want in ((1, 0), (5, 4), (9, 8)):
        mutated = prompt.copy()
        mutated[flip] = 63
        hit = pc.acquire(mutated)
        got = 0 if hit is None else hit.n_tokens
        assert got == want, (flip, got, want)
        if hit is not None:
            pc.release(hit)


def test_acquire_limit_caps_match_depth():
    pc = PrefixCache(CHUNK, max_rows=8)
    prompt = np.arange(12, dtype=np.int32)
    pc.insert(prompt, 8, fake_row(8))
    hit = pc.acquire(prompt, limit=4)
    assert hit.n_tokens == 4
    pc.release(hit)


def test_lease_blocks_eviction_until_release():
    pc = PrefixCache(CHUNK, max_rows=1)
    a = np.arange(4, dtype=np.int32)
    b = np.arange(10, 14, dtype=np.int32)
    pc.insert(a, 4, fake_row(4, seed=1))
    hit = pc.acquire(a)
    res = pc.insert(b, 4, fake_row(4, seed=2))
    assert res == {"inserted": 0, "evicted": 0, "refused": True}
    assert pc.stats()["evictions_refused"] == 1
    hit2 = pc.acquire(a, limit=4)
    assert hit2.n_tokens == 4
    assert pc.stats()["leased_rows"] == 1
    pc.release(hit)
    pc.release(hit2)
    res = pc.insert(b, 4, fake_row(4, seed=2))
    assert res["inserted"] == 1 and res["evicted"] == 1
    assert pc.acquire(a) is None


def test_lru_order_under_interleaved_hits():
    pc = PrefixCache(CHUNK, max_rows=2)
    a, b, c = toks(1, 2, 3, 4), toks(5, 6, 7, 8), toks(9, 10, 11, 12)
    pc.insert(a, 4, fake_row(4, seed=1))
    pc.insert(b, 4, fake_row(4, seed=2))
    pc.release(pc.acquire(a))
    res = pc.insert(c, 4, fake_row(4, seed=3))
    assert res["evicted"] == 1
    assert pc.acquire(b) is None
    pc.release(pc.acquire(a))
    pc.release(pc.acquire(c))


def test_interior_nodes_pinned_by_descendants():
    pc = PrefixCache(CHUNK, max_rows=2)
    long_prompt = np.arange(8, dtype=np.int32)
    pc.insert(long_prompt, 8, fake_row(8))
    res = pc.insert(toks(20, 21, 22, 23), 4, fake_row(4, seed=4))
    assert res["inserted"] == 1 and res["evicted"] == 1
    hit = pc.acquire(long_prompt)
    assert hit.n_tokens == 4
    pc.release(hit)


def test_first_writer_wins_and_byte_budget():
    pc = PrefixCache(CHUNK, max_rows=8)
    prompt = np.arange(4, dtype=np.int32)
    first, second = fake_row(4, seed=1), fake_row(4, seed=2)
    pc.insert(prompt, 4, first)
    pc.insert(prompt, 4, second)
    hit = pc.acquire(prompt)
    assert torch.equal(hit.rows[0][0][0], first[0][0][:, :4])
    assert not torch.equal(hit.rows[0][0][0], second[0][0][:, :4])
    pc.release(hit)
    assert pc.stats()["inserts"] == 1
    assert pc.stats()["resident_bytes"] == row_bytes(first)


def test_max_bytes_budget_evicts():
    row = fake_row(4, seed=1)
    pc = PrefixCache(CHUNK, max_rows=64, max_bytes=row_bytes(row) + 1)
    pc.insert(toks(1, 2, 3, 4), 4, row)
    res = pc.insert(toks(5, 6, 7, 8), 4, fake_row(4, seed=2))
    assert res["evicted"] == 1
    assert pc.stats()["resident_rows"] == 1


def test_int8_rows_ride_through_and_are_smaller():
    pc8, pcf = PrefixCache(CHUNK, max_rows=8), PrefixCache(CHUNK, max_rows=8)
    prompt = np.arange(8, dtype=np.int32)
    pc8.insert(prompt, 8, fake_int8_row(8))
    pcf.insert(prompt, 8, fake_row(8))
    hit = pc8.acquire(prompt)
    assert hit.n_tokens == 8
    assert len(hit.rows[0][0]) == 4
    for payload in hit.rows:
        for layer in payload:
            assert layer[0].dtype == torch.int8
            assert layer[0].shape[1] == CHUNK
    pc8.release(hit)
    assert (pc8.stats()["resident_bytes"]
            < pcf.stats()["resident_bytes"])


@pytest.mark.parametrize("n,chunk", [(64, 16), (40, 16), (16, 16), (7, 4),
                                     (300, 64)])
def test_affinity_key_equals_the_jax_key(n, chunk):
    prompt = np.random.default_rng(n).integers(0, 8192, n).astype(np.int32)
    assert (PrefixCache.affinity_key(prompt, chunk)
            == JaxPrefixCache.affinity_key(prompt, chunk))
    # the JAX test's pinned literal holds in the port too
    assert PrefixCache.affinity_key(np.arange(16, dtype=np.int32),
                                    16) == "26ec4e1c03e59b30"
    mutated = prompt.copy()
    mutated[-1] += 1
    if n > chunk:                       # only the first chunk counts
        assert (PrefixCache.affinity_key(mutated, chunk)
                == PrefixCache.affinity_key(prompt, chunk))


# ---------------------------------------------------------------------------
# the pool owns its bytes
# ---------------------------------------------------------------------------

def _payload_tensors(pc):
    stack, out = [pc._root], []
    while stack:
        nd = stack.pop()
        stack.extend(nd.children.values())
        if nd.payload is not None:
            out.extend(t for layer in nd.payload for t in layer)
    return out


def test_pool_copies_what_it_keeps():
    """A payload is a copy of its chunk, never a view: writing into the
    source row leaves it alone, and it owns exactly its own bytes."""
    pc = PrefixCache(CHUNK, max_rows=8)
    row = fake_row(64)                       # a wide prefill cache row
    keep = [[t[:, :8].clone() for t in layer] for layer in row]
    pc.insert(np.arange(64, dtype=np.int32), 8, row)
    for layer in row:
        for t in layer:
            t.fill_(7.0)
    hit = pc.acquire(np.arange(64, dtype=np.int32))
    got = _assemble_prefix_row(hit.rows)
    pc.release(hit)
    for g_layer, k_layer in zip(got, keep):
        for g, k in zip(g_layer, k_layer):
            assert torch.equal(g, k)
    owned = sum(t.untyped_storage().nbytes() for t in _payload_tensors(pc))
    assert owned == pc.stats()["resident_bytes"] == row_bytes(keep)


CFG = {"vocab_size": 64, "d_model": 32, "n_heads": 4, "n_layers": 2,
       "max_len": 64, "dtype": "float32"}


@pytest.fixture(scope="module")
def bundle():
    return ModelBundle.init("TransformerLM", CFG, seed=0)


def make_engine(bundle, **overrides):
    kw = dict(max_new_tokens=8, max_batch=4, queue_capacity=8,
              segment_steps=4, default_deadline_s=100.0, cache_chunk=16,
              prefix_cache=True, prefix_max_rows=16)
    kw.update(overrides)
    return ServingEngine(bundle, ServeConfig(**kw), clock=VirtualClock(),
                         device="cpu").warmup()


def drain(engine, requests, max_ticks=300):
    for _ in range(max_ticks):
        if all(r.finished for r in requests):
            return
        engine._tick()
    raise AssertionError([r.status for r in requests])


def test_group_cache_writes_leave_the_pool_alone(bundle):
    eng = make_engine(bundle)
    prompt = (np.arange(1, 21, dtype=np.int32) % 63) + 1
    req = eng.submit(prompt, max_new_tokens=8)
    eng._tick()                              # joined, pooled, one segment
    assert eng.prefix_stats()["resident_rows"] == 1
    keep = [t.clone() for t in _payload_tensors(eng._prefix)]
    with torch.inference_mode():             # the resident batch, in place
        for g in eng._groups.values():
            for layer in g.caches:
                for t in layer:
                    t.fill_(3)
    drain(eng, [req])
    assert req.status == "ok"
    for t, k in zip(_payload_tensors(eng._prefix), keep):
        assert torch.equal(t, k)
    owned = sum(t.untyped_storage().nbytes()
                for t in _payload_tensors(eng._prefix))
    assert owned == eng.prefix_stats()["resident_bytes"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_resume_keeps_the_stored_bytes(bundle, dtype):
    """Resume dequantizes the donor, prefills the suffix and re-quantizes
    the window: the pool's int8 bytes do not move, and the resumed row's
    prefix slots hold the same bytes (quantize_kv is idempotent on its
    own round trip)."""
    lm = ModelBundle("TransformerLM", {**CFG, "dtype": dtype},
                     bundle.variables)
    eng = DecodeEngine(lm.module("cpu"), 8, chunk=16, cache_dtype="int8",
                       device="cpu")
    prompt = np.random.default_rng(0).integers(0, 64, 30).astype(np.int32)
    padded = np.zeros((1, 32), np.int64)
    padded[0, :30] = prompt
    _, _, caches = eng.serve_prefill(padded, [30], [True], [1])
    pc = PrefixCache(16)
    pc.insert(prompt, 16, [tuple(t[0:1] for t in layer) for layer in caches])
    hit = pc.acquire(prompt, 16)
    stored = [t.clone() for t in _payload_tensors(pc)]
    padded[0, 20:30] = 3                     # a new suffix
    _, _, resumed = eng.serve_prefill_resume(
        padded, [30], 16, _assemble_prefix_row(hit.rows), [True], [2])
    pc.release(hit)
    for t, s in zip(_payload_tensors(pc), stored):
        assert torch.equal(t, s)
    for r_layer, p_layer in zip(resumed, hit.rows[0]):
        for r, p in zip(r_layer, p_layer):
            assert torch.equal(r[:, :16], p)


def test_prefill_tier_rejects_prefix_cache():
    with pytest.raises(ValueError, match="decode"):
        ServeConfig(role="prefill", prefix_cache=True)
    assert ServeConfig(prefix_cache=True).prefix_cache
    with pytest.raises(ValueError, match="prefix_max_rows"):
        ServeConfig(prefix_max_rows=0)
    with pytest.raises(ValueError, match="prefix_max_mb"):
        ServeConfig(prefix_max_mb=0)


def test_engine_reuse_byte_exact_whole_join(bundle):
    eng = make_engine(bundle)
    prompt = (np.arange(1, 21, dtype=np.int32) % 63) + 1
    first = eng.submit(prompt)
    drain(eng, [first])
    second = eng.submit(prompt)
    drain(eng, [second])
    assert first.status == second.status == "ok"
    assert first.tokens == second.tokens
    stats = eng.prefix_stats()
    assert stats["hits"] == 1 and stats["hit_tokens"] == 16
    assert stats["misses"] >= 1 and stats["leased_rows"] == 0
    assert eng.stats()["prefix"]["hits"] == stats["hits"]
    assert eng.stats()["prefix_hits"] == 1


@pytest.mark.parametrize("cache", ["model", "int8"])
def test_engine_reuse_byte_exact_chunked_resume(bundle, cache):
    """A 30-token prompt in bucket 32 sharing one 16-token chunk with a
    resident donor resumes CHUNKED at chunk 1 (a pending job, its slot
    reserved) and matches a fresh engine's tokens."""
    donor = (np.arange(1, 31, dtype=np.int32) % 63) + 1
    shared = donor.copy()
    shared[20:] = 7
    fresh_eng = make_engine(bundle, prefix_cache=False, prefill_chunk=16,
                            cache_dtype=cache)
    fresh = fresh_eng.submit(shared)
    drain(fresh_eng, [fresh])
    with run_telemetry(None) as rt:
        eng = make_engine(bundle, prefill_chunk=16, cache_dtype=cache)
        a = eng.submit(donor)
        drain(eng, [a])
        b = eng.submit(shared)
        drain(eng, [b])
    # the resume ran as a pending job from chunk 1, not inline
    chunks = [(r["index"], r["requests"]) for r in rt.tracer.records()
              if r.get("type") == "serve"
              and r.get("event") == "prefill_chunk"]
    assert chunks == [(0, [a.id]), (1, [a.id]), (1, [b.id])]
    assert eng._engines["primary"].serve_resume_chunks(32, 16) == 1
    assert fresh.status == b.status == "ok"
    assert b.tokens == fresh.tokens
    stats = eng.prefix_stats()
    assert stats["hits"] == 1 and stats["leased_rows"] == 0
    assert ("resume_init", 1, 16, 48, 4 if cache == "int8" else 2) in \
        eng._engines["primary"]._programs


def test_prefix_timeline_and_gauges_in_run_summary(bundle, tmp_path):
    with run_telemetry(str(tmp_path)) as rt:
        eng = make_engine(bundle)
        prompt = (np.arange(1, 21, dtype=np.int32) % 63) + 1
        for _ in range(2):
            req = eng.submit(prompt)
            drain(eng, [req])
        summary = rt.summary()
    events = [e["event"] for e in summary["prefix"]]
    assert events == ["insert", "hit"]
    hit = summary["prefix"][1]
    assert hit["matched"] == 16 and hit["suffix"] == 4
    assert summary["gauges"]["prefix.resident_rows"]["n"] >= 1
    spans = summary["spans"]
    assert spans["serve.prefill_resume"]["count"] == 1
