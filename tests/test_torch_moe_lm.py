"""The mixture-of-experts TransformerLM of the port against the JAX
package's, on the CPU: the forward and the serving paths.

Both packages take the same weights (the port's seeded numpy init, fed to
flax as the parameter tree).  Tolerances:

  * f32 logits of the forward and of the engine's prefill within 2e-5 of
    the JAX `module.apply` and prefill (the packages sum in other
    orders); the sown values within 1e-5 relative;
  * greedy tokens IDENTICAL to the JAX package's: `generate` in the
    drop-free regime (moe_group_size=1) and under capacity pressure (2
    experts, groups of 8, 4 rows), and `TextGenerator` over ragged rows,
    where the port routes the same rows in the same order, padding
    positions included;
  * the online engine over a drop-free MoE bundle: tokens equal the
    offline engine's.

Every JAX reference is jitted and computed once, on threads, in a module
fixture.  Bundles and training are in tests/test_torch_moe_train.py,
the remat policies in tests/test_torch_moe_remat.py.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu import DataTable as JaxDataTable
from mmlspark_tpu.models import ModelBundle as JaxModelBundle
from mmlspark_tpu.models.definitions import build_model as jax_build_model
from mmlspark_tpu.models.generate import TextGenerator as JaxTextGenerator
from mmlspark_tpu.models.generate import _forward_with_cache as jax_fwc
from mmlspark_tpu.models.generate import generate as jax_generate
from mmlspark_tpu_torch import DataTable, TextGenerator
from mmlspark_tpu_torch.models import DecodeEngine, ModelBundle, naive_generate
from mmlspark_tpu_torch.models.generate import (ServingWeights,
                                                _forward_with_cache)
from mmlspark_tpu_torch.resilience.clock import VirtualClock
from mmlspark_tpu_torch.serve import ServeConfig, ServingEngine

CFG = {"vocab_size": 64, "d_model": 32, "n_heads": 4, "n_layers": 2,
       "max_len": 64, "dtype": "float32", "mlp_impl": "moe",
       "n_experts": 4, "moe_router_k": 2, "moe_group_size": 8}
# capacity pressure: 2 experts, groups of 8 -> capacity ceil(8/2*1.25) = 5
TIGHT = {**CFG, "n_experts": 2, "moe_router_k": 1, "moe_group_size": 8}
DROP_FREE = {**CFG, "n_experts": 2, "moe_router_k": 1, "moe_group_size": 1}


def _bundle(cfg, seed=0):
    return ModelBundle.init("TransformerLM", cfg, seed=seed)


def _jax(cfg, bundle):
    return (jax_build_model("TransformerLM", cfg),
            jax.tree_util.tree_map(jnp.asarray, bundle.variables))


def _rows(lengths, seed=0, vocab=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lengths]


def _padded(rows, bucket):
    prompts = np.zeros((len(rows), bucket), np.int32)
    for j, r in enumerate(rows):
        prompts[j, :len(r)] = r
    return prompts, np.asarray([len(r) for r in rows], np.int32)



FWD_TOKS = np.random.default_rng(6).integers(0, 64, (3, 16))
DROP_FREE_TOKS = np.asarray([[3, 1, 4, 1, 5, 9, 2, 6],
                             [2, 7, 1, 8, 2, 8, 1, 8]], np.int32)
RAGGED = _rows([5, 8, 3, 7], seed=6)      # one bucket of 8
GEN = dict(inputCol="prompt", maxNewTokens=8, cacheChunk=8)


@pytest.fixture(scope="module")
def jax_refs():
    """Every JAX reference of this file, jitted, on threads."""
    def forward(cfg):
        module, variables = _jax(cfg, _bundle(cfg))
        logits, sown = jax.jit(lambda v, t: module.apply(
            v, t, mutable=["losses", "metrics"]))(variables,
                                                 jnp.asarray(FWD_TOKS))
        shape = (3, 32, 4, 8)
        caches = [(jnp.zeros(shape), jnp.zeros(shape)) for _ in range(2)]
        pre = jax.jit(lambda p, t, c: jax_fwc(p, t, c, 0, module)[0])(
            variables["params"], jnp.asarray(FWD_TOKS), caches)
        return (np.asarray(logits), jax.tree_util.tree_map(float, sown),
                np.asarray(pre))

    def drop_free():
        module, variables = _jax(DROP_FREE, _bundle(DROP_FREE, seed=2))
        return jax_generate(module, variables, DROP_FREE_TOKS,
                            max_new_tokens=6)

    def pressure():
        module, variables = _jax(TIGHT, _bundle(TIGHT, seed=3))
        prompts, tl = _padded(_rows([8, 8, 8, 8], seed=4), 8)
        return jax_generate(module, variables, prompts, max_new_tokens=10)

    def ragged(cache):
        bundle = _bundle(TIGHT, seed=5)
        return JaxTextGenerator(
            JaxModelBundle("TransformerLM", TIGHT, bundle.variables),
            kvCacheDtype=cache, **GEN).transform(
            JaxDataTable({"prompt": RAGGED}))["generated"]

    jobs = {"top2": lambda: forward(CFG), "drop_free": drop_free,
            "pressure": pressure,
            ("ragged", None): lambda: ragged(None),
            ("ragged", "int8"): lambda: ragged("int8")}
    with ThreadPoolExecutor(6) as pool:
        futures = {key: pool.submit(job) for key, job in jobs.items()}
        return {key: f.result() for key, f in futures.items()}


# ------------------------------------------------------------ forward ---

def test_moe_forward_and_engine_prefill_match_module_apply(jax_refs):
    """Top-2 routing over 4 experts in groups of 8 (capacity 5 an expert,
    so tokens drop): logits, sown values and the engine's prefill."""
    ref, sown_ref, jax_prefill = jax_refs["top2"]
    lm = _bundle(CFG).module("cpu")
    logits, sown = lm(torch.from_numpy(FWD_TOKS), collect=True)
    np.testing.assert_allclose(logits.detach().numpy(), ref, rtol=0,
                               atol=2e-5)
    for col in ("losses", "metrics"):
        for blk, mods in sown_ref[col].items():
            for key, (want,) in mods["moe"].items():
                got = sown[col][blk]["moe"][key].item()
                assert got == pytest.approx(want, rel=1e-5), key
    shape = (3, 32, 4, 8)
    caches = [(torch.zeros(shape), torch.zeros(shape)) for _ in range(2)]
    with torch.inference_mode():
        got = _forward_with_cache(ServingWeights(lm),
                                  torch.from_numpy(FWD_TOKS), caches, 0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), jax_prefill, rtol=0, atol=2e-5)


# ------------------------------------------------------------ serving ---

def test_greedy_tokens_equal_jax_generate_drop_free(jax_refs):
    """moe_group_size=1: every token routes alone, so decode routing is
    the recompute's; tokens equal the JAX `generate` and the port's own
    recompute oracle."""
    ref = jax_refs["drop_free"]
    lm = _bundle(DROP_FREE, seed=2).module("cpu")
    engine = DecodeEngine(lm, 6, chunk=8, device="cpu")
    got = engine.generate(DROP_FREE_TOKS, np.full(2, 8, np.int32))
    np.testing.assert_array_equal(got, ref[:, 8:])
    np.testing.assert_array_equal(naive_generate(lm, DROP_FREE_TOKS, 6), ref)


def test_greedy_tokens_equal_jax_under_capacity_pressure(jax_refs):
    """4 rows of a full bucket of 8 routed in groups of 8 (capacity 5 an
    expert): prefill drops tokens and every decode step routes the 4
    rows as one group.  The JAX `generate` and the port's engine agree
    token for token (the JAX engine is held in the ragged-rows test)."""
    ref = jax_refs["pressure"]
    lm = _bundle(TIGHT, seed=3).module("cpu")
    prompts, tl = _padded(_rows([8, 8, 8, 8], seed=4), 8)
    got = DecodeEngine(lm, 10, chunk=8, device="cpu").generate(prompts, tl)
    np.testing.assert_array_equal(got, ref[:, 8:])
    # the pressure is real: prefill drops routed slots
    _, sown = lm(torch.from_numpy(prompts.astype(np.int64)), collect=True)
    overflow = [m["moe"]["moe_overflow_fraction"].item()
                for m in sown["metrics"].values()]
    assert max(overflow) > 0


@pytest.mark.parametrize("cache", [None, "int8"])
def test_text_generator_ragged_rows_equal_jax_with_padding(cache, jax_refs):
    """Ragged rows in one bucket through the engines of both packages:
    the padding positions join the routing groups in both alike."""
    got = TextGenerator(_bundle(TIGHT, seed=5), device="cpu",
                        kvCacheDtype=cache, **GEN).transform(
        DataTable({"prompt": RAGGED}))
    for g, r in zip(got["generated"], jax_refs[("ragged", cache)]):
        np.testing.assert_array_equal(g, r)


def test_serving_engine_over_a_moe_bundle_equals_the_offline_engine():
    """The online engine's mixed-age batch over a drop-free MoE bundle:
    every request's tokens equal the offline engine's."""
    bundle = _bundle(DROP_FREE, seed=7)
    rows = _rows([5, 9, 3], seed=8)
    engine = ServingEngine(bundle, ServeConfig(
        max_new_tokens=6, max_batch=4, segment_steps=2, cache_chunk=16),
        clock=VirtualClock(), device="cpu").warmup()
    reqs = [engine.submit(r) for r in rows]
    for _ in range(200):
        if all(r.finished for r in reqs):
            break
        engine._tick()
    offline = DecodeEngine(bundle.module("cpu"), 6, chunk=16, device="cpu")
    for r, req in zip(rows, reqs):
        prompts, tl = _padded([r], offline.bucket_for(len(r)))
        np.testing.assert_array_equal(np.asarray(req.tokens),
                                      offline.generate(prompts, tl)[0])


def test_moe_refusals():
    bundle = _bundle(CFG)
    lm = bundle.module("cpu")
    with pytest.raises(ValueError, match="MoE"):
        DecodeEngine(lm, 4, device="cpu", draft_module=lm, spec_tokens=2)
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        ModelBundle("TransformerLM", {**CFG, "expert_axis": "model"},
                    bundle.variables).module("cpu")
