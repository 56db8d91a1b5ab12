"""The port's speculative decoding against the JAX package's, on the CPU.

Greedy tokens through draft/verify rounds must be the plain engine's AND
the JAX speculative engine's, exactly, at f32: with a raw truncated
draft (acceptance well below 1, so the rejection and correction paths
run), here with the int8 KV cache at k 2 and cache chunk 32 (the cell at
k 7, chunk 16 and the model-dtype cache is in
tests/test_torch_spec_stage.py, with the stage and the serving lanes);
with stops and a minNewTokens floor; with chunked prefill.  The sampler
is pinned as the reference pins it (tests/test_speculative.py): the first
speculatively committed token is distributed as the target's softmax
(total variation < 0.15 over 512 rows) and a seed reproduces its tokens
byte for byte.  The draft bundle functions alias and soften as the JAX
package's do (bytes equal).
"""

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.models import ModelBundle as JaxModelBundle
from mmlspark_tpu.models.definitions import build_model as jax_build_model
from mmlspark_tpu.models.generate import DecodeEngine as JaxDecodeEngine
from mmlspark_tpu.ops.attention import \
    segment_cache_attention as jax_segment_cache_attention
from mmlspark_tpu.zoo import soften_late_blocks as jax_soften_late_blocks
from mmlspark_tpu.zoo import truncated_draft_bundle as jax_truncated_draft
from mmlspark_tpu_torch.models import DecodeEngine, ModelBundle
from mmlspark_tpu_torch.ops.attention import (segment_cache_attention,
                                              single_query_attention)
from mmlspark_tpu_torch.quant.quantize import quantize_kv
from mmlspark_tpu_torch.zoo import soften_late_blocks, truncated_draft_bundle

# the reference's test model with 2 blocks (its has 3): the draft is the
# first block, the JAX side compiles in half the time
CFG = {"vocab_size": 32, "d_model": 32, "n_heads": 4, "n_layers": 2,
       "max_len": 64, "dtype": "float32"}
# (cache chunk, KV cache, k): one of the reference's two greedy cells
SPEC_CASES = ((32, "int8", 2),)
# one cache window class, so the JAX side compiles one round program
MAX_NEW = 8


@pytest.fixture(scope="module")
def target():
    return ModelBundle.init("TransformerLM", CFG, seed=11)


@pytest.fixture(scope="module")
def draft(target):
    return truncated_draft_bundle(target, n_layers=1)


@pytest.fixture(scope="module")
def modules(target, draft):
    return target.module("cpu"), draft.module("cpu")


def _rows(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG["vocab_size"], (n,)).astype(np.int32)
            for n in lengths]


def _padded(rows, bucket):
    prompts = np.zeros((len(rows), bucket), np.int32)
    for j, r in enumerate(rows):
        prompts[j, :len(r)] = r
    return prompts, np.asarray([len(r) for r in rows], np.int32)


ROWS = _rows([9, 12, 16, 10], seed=3)        # one bucket (16)


@pytest.fixture(scope="module")
def jax_spec(target):
    """The JAX speculative engine's greedy tokens for each SPEC_CASES
    cell over ROWS (its draft the JAX `truncated_draft_bundle`)."""
    jb = JaxModelBundle("TransformerLM", dict(CFG), jax.tree_util.tree_map(
        np.asarray, target.variables), {})
    jd = jax_truncated_draft(jb, 1)
    module = jax_build_model("TransformerLM", CFG)
    dmodule = jax_build_model("TransformerLM", jd.config)
    prompts, tl = _padded(ROWS, 16)

    def job(chunk, cache, k):
        eng = JaxDecodeEngine(module, MAX_NEW, chunk=chunk, cache_dtype=cache,
                              draft_module=dmodule, spec_tokens=k)
        out = eng.generate(jb.variables, prompts, tl,
                           draft_variables=jd.variables)
        return out, eng.last_spec_acceptance

    return {case: job(*case) for case in SPEC_CASES}


# ------------------------------------------------- the verify's read ---

@pytest.mark.parametrize("cache", ["model", "int8"])
@pytest.mark.parametrize("s", [1, 4])
def test_segment_cache_attention_matches_reference(cache, s):
    """S queries a row against a (B, L, H, D) window under per-query
    visibility, f32 statistics: within 1e-5 of the JAX function; at S = 1
    elementwise the port's `single_query_attention` (bitwise), the
    property the speculative path's greedy equality rests on."""
    rng = np.random.default_rng(s)
    b, length, h, d = 3, 40, 4, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, length, h, d)).astype(np.float32)
            for _ in range(2))
    visible = rng.random((b, s, length)) < 0.7
    visible[:, :, 0] = True
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    kw, jax_kw = {}, {}
    if cache == "int8":
        (kt, ks), (vt, vs) = quantize_kv(kt), quantize_kv(vt)
        kw = dict(k_scale=ks, v_scale=vs)
        jax_kw = {name: t.numpy() for name, t in kw.items()}
    got = segment_cache_attention(torch.from_numpy(q), kt, vt,
                                  torch.from_numpy(visible), **kw)
    want = jax_segment_cache_attention(q, kt.numpy(), vt.numpy(), visible,
                                       **jax_kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if s == 1:
        single = single_query_attention(torch.from_numpy(q[:, 0]), kt, vt,
                                        torch.from_numpy(visible[:, 0]),
                                        **kw)
        assert torch.equal(got[:, 0], single)


# ------------------------------------------------- draft construction ---

def test_truncated_draft_aliases_target(target, draft):
    """The draft is the target's first block + embeddings and head,
    aliased: no copy of any array."""
    assert draft.config == {**target.config, "n_layers": 1}
    tp, dp = target.variables["params"], draft.variables["params"]
    for name in ("tok_embed", "pos_embed", "final_norm_w", "lm_head",
                 "block0_w"):
        assert dp[name] is tp[name]
    assert np.shares_memory(dp["block0_w"]["qkv"]["kernel"],
                            tp["block0_w"]["qkv"]["kernel"])
    assert "block1_w" not in dp
    assert draft.metadata["speculative"] == {
        "draft_of": "TransformerLM", "target_layers": 2, "draft_layers": 1}
    with pytest.raises(ValueError, match="n_layers"):
        truncated_draft_bundle(target, n_layers=3)
    moe = ModelBundle(target.architecture,
                      {**target.config, "mlp_impl": "moe"}, target.variables)
    with pytest.raises(ValueError, match="MoE"):
        truncated_draft_bundle(moe, 1)


def test_soften_late_blocks_matches_reference(target):
    """The late blocks' proj and mlp_down scaled by the factor, bytes as
    the JAX package's; at 0.0 the softened target IS its truncation, so
    the truncated draft is accepted on every token."""
    jb = JaxModelBundle("TransformerLM", dict(CFG), target.variables, {})
    for factor in (0.0, 0.05):
        got = soften_late_blocks(target, 1, factor).variables["params"]
        want = jax_soften_late_blocks(jb, 1, factor).variables["params"]
        for blk in ("block0_w", "block1_w"):
            for layer in ("proj", "mlp_down", "qkv"):
                for leaf in ("kernel", "bias"):
                    a = np.asarray(got[blk][layer][leaf])
                    b = np.asarray(want[blk][layer][leaf])
                    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert np.asarray(target.variables["params"]["block1_w"]["proj"][
        "kernel"]).any()
    soft = soften_late_blocks(target, 1, 0.0)
    spec = DecodeEngine(soft.module("cpu"), MAX_NEW, chunk=16,
                        draft_module=truncated_draft_bundle(
                            soft, 1).module("cpu"),
                        spec_tokens=3, device="cpu")
    prompts, tl = _padded(ROWS, 16)
    spec.generate(prompts, tl)
    assert spec.last_spec_acceptance == 1.0


# ------------------------------------ greedy tokens (the contract) ---

@pytest.mark.parametrize("case", SPEC_CASES,
                         ids=[f"chunk{c}-{kv}-k{k}" for c, kv, k in
                              SPEC_CASES])
def test_spec_greedy_tokens_equal_plain_and_jax(modules, jax_spec, case):
    chunk, cache, k = case
    module, dmodule = modules
    prompts, tl = _padded(ROWS, 16)
    plain = DecodeEngine(module, MAX_NEW, chunk=chunk, cache_dtype=cache,
                         device="cpu").generate(prompts, tl)
    spec = DecodeEngine(module, MAX_NEW, chunk=chunk, cache_dtype=cache,
                        draft_module=dmodule, spec_tokens=k, device="cpu")
    got = spec.generate(prompts, tl)
    want, jax_rate = jax_spec[case]
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, want)
    # a raw truncated draft: some proposals rejected, the rounds ran
    assert 0.0 <= spec.last_spec_acceptance < 1.0
    assert spec.last_spec_acceptance == pytest.approx(jax_rate)
    assert spec.last_spec_rounds > 0
    assert spec.last_spec_accepted <= spec.last_spec_drafted


def test_spec_greedy_with_stops_and_floor(modules):
    """Stops and min_new_tokens compose with speculation: the spec engine
    freezes on the same token at the same index as the plain engine."""
    module, dmodule = modules
    rows = _rows([4, 6], seed=9)
    prompts, tl = _padded(rows, 8)
    free = DecodeEngine(module, 16, chunk=8, device="cpu").generate(
        prompts, tl)
    stop = int(free[0][1])
    kw = dict(chunk=8, stop_tokens=(stop,), min_new_tokens=3, device="cpu")
    want = DecodeEngine(module, 16, **kw).generate(prompts, tl)
    got = DecodeEngine(module, 16, draft_module=dmodule, spec_tokens=3,
                       **kw).generate(prompts, tl)
    np.testing.assert_array_equal(got, want)
    assert (got == stop).any()


@pytest.mark.parametrize("cache", ["model", "int8"])
def test_chunked_prefill_composes_with_speculation(modules, cache):
    """The reference's composition: chunked prefill (chunk 8 over buckets
    of 8 and 32) under draft/verify rounds gives the plain engine's
    tokens."""
    module, dmodule = modules
    for rows in (_rows([5], seed=6), _rows([18, 30], seed=6)):
        bucket = DecodeEngine(module, 8, chunk=16,
                              device="cpu").bucket_for(max(map(len, rows)))
        prompts, tl = _padded(rows, bucket)
        want = DecodeEngine(module, 8, chunk=16, cache_dtype=cache,
                            device="cpu").generate(prompts, tl)
        both = DecodeEngine(module, 8, chunk=16, cache_dtype=cache,
                            prefill_chunk=8, draft_module=dmodule,
                            spec_tokens=3, device="cpu")
        np.testing.assert_array_equal(both.generate(prompts, tl), want)
    assert both.serve_prefill_chunks(32) == 4


def test_spec_engine_validation(modules):
    module, dmodule = modules
    with pytest.raises(ValueError, match="draft_module"):
        DecodeEngine(module, 8, spec_tokens=3, device="cpu")
    with pytest.raises(ValueError, match="spec_tokens"):
        DecodeEngine(module, 8, draft_module=dmodule, device="cpu")
    small = ModelBundle.init("TransformerLM", {**CFG, "vocab_size": 16})
    with pytest.raises(ValueError, match="vocab"):
        DecodeEngine(module, 8, draft_module=small.module("cpu"),
                     spec_tokens=3, device="cpu")
    short = ModelBundle.init("TransformerLM", {**CFG, "max_len": 32})
    with pytest.raises(ValueError, match="max_len"):
        DecodeEngine(module, 8, draft_module=short.module("cpu"),
                     spec_tokens=3, device="cpu")


def test_spec_on_a_data_mesh_matches_single_device(modules):
    """A data-only mesh splits the rows into groups, each speculating on
    its own; the tokens are the single-device engine's."""
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    module, dmodule = modules
    prompts, tl = _padded(ROWS, 16)
    mesh = make_mesh(MeshSpec(data=2), [torch.device("cpu")] * 2)
    kw = dict(chunk=16, draft_module=dmodule, spec_tokens=3, device="cpu")
    want = DecodeEngine(module, MAX_NEW, **kw).generate(prompts, tl)
    got = DecodeEngine(module, MAX_NEW, mesh=mesh, **kw).generate(prompts, tl)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------- rejection sampler (pin) ---

def test_spec_sampler_preserves_target_distribution(modules):
    """512 rows share one prompt at temperature 1.0; the first token the
    rounds commit (index 1: index 0 is the prefill's draw) must follow the
    target's softmax given each row's first token: total variation to
    the analytic mixture under 0.15 (seeded, so deterministic), and the
    same seed reproduces the tokens byte for byte."""
    module, dmodule = modules
    b = 512
    prompt = np.asarray([7, 3, 11], np.int32)
    spec = DecodeEngine(module, 4, temperature=1.0, chunk=16,
                        draft_module=dmodule, spec_tokens=3, device="cpu")
    prompts = np.zeros((b, spec.bucket_for(len(prompt))), np.int32)
    prompts[:, :len(prompt)] = prompt
    tl = np.full(b, len(prompt), np.int32)
    out = spec.generate(prompts, tl, seed=5)
    np.testing.assert_array_equal(out, spec.generate(prompts, tl, seed=5))
    assert spec.last_spec_rounds > 0
    prefixes = np.concatenate([np.tile(prompt, (b, 1)), out[:, :1]], axis=1)
    with torch.inference_mode():
        logits = module(torch.as_tensor(prefixes, dtype=torch.long))[:, -1]
    mixture = torch.softmax(logits, dim=-1).mean(dim=0).numpy()
    freq = np.bincount(out[:, 1], minlength=CFG["vocab_size"]) / b
    tv = 0.5 * np.abs(freq - mixture).sum()
    assert tv < 0.15, f"TV {tv:.3f} from the target distribution"
    # another seed draws other tokens
    assert not np.array_equal(out, spec.generate(prompts, tl, seed=6))
