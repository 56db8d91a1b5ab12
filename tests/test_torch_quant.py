"""The port's weight quantization against the JAX package's, on the CPU:
`quantize_array_int8` and `quantize_bundle` ("bf16", "int8") give the
same bytes, the saved `params.msgpack` files are identical and each
package loads the other's, and an int8 `TransformerLM` bundle decodes to
the JAX engine's greedy tokens through the port's int8 Dense layers.

Tolerances: bytes are compared exactly; the dequant error bound is the
reference's own, max(scale/2, amax - 127*scale) per channel (+1e-6).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.models import ModelBundle as JaxModelBundle
from mmlspark_tpu.models.bundle import load_bundle as jax_load_bundle
from mmlspark_tpu.models.bundle import save_bundle as jax_save_bundle
from mmlspark_tpu.models.definitions import build_model as jax_build_model
from mmlspark_tpu.models.generate import DecodeEngine as JaxDecodeEngine
from mmlspark_tpu.quant import dequantize_bundle as jax_dequantize_bundle
from mmlspark_tpu.quant import quantize_array_int8 as jax_quantize_array_int8
from mmlspark_tpu.quant import quantize_bundle as jax_quantize_bundle
from mmlspark_tpu_torch.core.bf16 import BF16Array
from mmlspark_tpu_torch.models import (DecodeEngine, ModelBundle,
                                       load_bundle, naive_generate,
                                       save_bundle)
from mmlspark_tpu_torch.models.bundle import params_to_jax
from mmlspark_tpu_torch.models.definitions import Int8Dense
from mmlspark_tpu_torch.models.generate import (ServingWeights,
                                                _forward_with_cache)
from mmlspark_tpu_torch.quant import (INT8_MAX, dequantize_array,
                                      dequantize_bundle, quantization_mode,
                                      quantize_array_int8, quantize_bundle)
from mmlspark_tpu_torch.resilience.clock import VirtualClock
from mmlspark_tpu_torch.serve import ServeConfig, ServingEngine

CFG = {"vocab_size": 64, "d_model": 32, "n_heads": 4, "n_layers": 2,
       "max_len": 96, "dtype": "float32"}
MODES = ("bf16", "int8")


@pytest.fixture(scope="module")
def bundle():
    return ModelBundle.init("TransformerLM", CFG, seed=0)


@pytest.fixture(scope="module")
def jax_bundle(bundle):
    return JaxModelBundle("TransformerLM", dict(CFG),
                          jax.tree_util.tree_map(np.asarray,
                                                 bundle.variables), {})


@pytest.fixture(scope="module")
def quantized(bundle, jax_bundle):
    """{mode: (port bundle, JAX bundle)} of one seeded LM."""
    return {mode: (quantize_bundle(bundle, mode),
                   jax_quantize_bundle(jax_bundle, mode)) for mode in MODES}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _raw(leaf) -> tuple:
    """(dtype name, raw bytes) of a port or JAX leaf."""
    if isinstance(leaf, BF16Array):
        return "bfloat16", leaf.bits.tobytes()
    arr = np.asarray(leaf)
    return str(arr.dtype), arr.tobytes()


def _assert_trees_identical(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert list(got) == list(want)
    for name in want:
        assert _raw(got[name]) == _raw(want[name]), name


# ------------------------------------------------------------ arrays ---

@pytest.mark.parametrize("shape,zero_channel", [
    ((32, 96), False), ((128, 64), True), ((3, 3, 4, 8), False)])
def test_quantize_array_int8_bytes_equal_reference(shape, zero_channel):
    w = np.random.default_rng(len(shape)).standard_normal(shape).astype(
        np.float32)
    w[..., 3] *= 40.0                    # an outlier channel: clip search
    if zero_channel:
        w[..., 5] = 0.0
    q, scale = quantize_array_int8(w)
    q_ref, scale_ref = jax_quantize_array_int8(w)
    assert q.dtype == np.int8 and scale.dtype == np.float32
    assert q.tobytes() == np.asarray(q_ref).tobytes()
    assert scale.tobytes() == np.asarray(scale_ref).tobytes()
    if zero_channel:
        assert scale[5] == 0 and not q[..., 5].any()


def test_dequant_error_bound(bundle):
    """|w - dequant(quant(w))| <= max(scale/2, amax - 127*scale) per
    channel, for every Dense kernel of the LM and a conv-shaped one."""
    kernels = [v for name, v in _leaves(bundle.variables)
               if name.endswith("kernel")]
    kernels.append(np.random.default_rng(3).standard_normal(
        (3, 3, 8, 16)).astype(np.float32))
    for w in kernels:
        q, scale = quantize_array_int8(w)
        red = tuple(range(w.ndim - 1))
        err = np.abs(w - dequantize_array(q, scale)).max(axis=red)
        amax = np.abs(w).max(axis=red)
        assert (err <= np.maximum(scale / 2, amax - INT8_MAX * scale)
                + 1e-6).all()


# ----------------------------------------------------------- bundles ---

@pytest.mark.parametrize("mode", MODES)
def test_quantize_bundle_trees_byte_identical(quantized, mode):
    q, ref = quantized[mode]
    assert q.config == ref.config and q.config["dtype"] == "bfloat16"
    assert q.metadata == ref.metadata
    assert quantization_mode(q) == mode
    _assert_trees_identical(q.variables, ref.variables)
    if mode == "int8":
        assert q.metadata["quantization"]["int8_kernels"] == 9


def test_quantize_bundle_validation_and_input_untouched(bundle):
    before = {k: _raw(v) for k, v in _leaves(bundle.variables)}
    quantize_bundle(bundle, "int8")
    assert {k: _raw(v) for k, v in _leaves(bundle.variables)} == before
    assert quantization_mode(bundle) is None
    with pytest.raises(ValueError, match="bf16 | int8"):
        quantize_bundle(bundle, "fp4")


@pytest.mark.parametrize("mode", MODES)
def test_saved_files_identical_and_each_loads_the_other(quantized, mode,
                                                         tmp_path):
    q, ref = quantized[mode]
    save_bundle(q, str(tmp_path / "port"))
    jax_save_bundle(ref, str(tmp_path / "jax"))
    for name in ("params.msgpack", "bundle.json"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    _assert_trees_identical(load_bundle(str(tmp_path / "jax")).variables,
                            ref.variables)
    _assert_trees_identical(jax_load_bundle(str(tmp_path / "port")).variables,
                            ref.variables)
    # the reference's save/load contract: a loaded bundle saves back with
    # the same bytes (bfloat16 leaves stay bfloat16)
    save_bundle(load_bundle(str(tmp_path / "jax")), str(tmp_path / "again"))
    assert ((tmp_path / "again" / "params.msgpack").read_bytes()
            == (tmp_path / "jax" / "params.msgpack").read_bytes())


def test_dequantize_bundle_matches_reference(quantized):
    q, ref = quantized["int8"]
    got, want = dequantize_bundle(q), jax_dequantize_bundle(ref)
    assert "quantization" not in got.metadata
    _assert_trees_identical(got.variables, want.variables)


# ----------------------------------------------------- int8 decoding ---

def test_int8_module_holds_int8_layers_and_writes_them_back(quantized):
    """bundle.module() of an int8 bundle: every Dense an `Int8Dense`
    holding the int8 weight (out, in), resident int8 in `ServingWeights`
    (no model-dtype copy); `params_to_jax` writes the int8 nodes back
    unchanged."""
    q, _ = quantized["int8"]
    module = q.module("cpu")
    dense = [m for m in module.modules() if isinstance(m, Int8Dense)]
    assert len(dense) == 9
    weights = ServingWeights(module)
    assert all(layer.weight.dtype == torch.int8 and layer.weight.data_ptr()
               == src.weight.data_ptr()
               for layer, src in zip(weights.dense_layers(), [
                   getattr(blk, n) for blk in module.blocks
                   for n in ("qkv", "proj", "mlp_up", "mlp_down")]
                   + [module.lm_head]))
    back = params_to_jax(module.state_dict())
    int8_nodes = [name[:-len("/kernel_scale")]
                  for name, _ in _leaves(q.variables["params"])
                  if name.endswith("/kernel_scale")]
    assert len(int8_nodes) == 9
    for path in int8_nodes:
        got, want = back, q.variables["params"]
        for key in path.split("/"):
            got, want = got[key], want[key]
        assert {k: _raw(v) for k, v in got.items()} == {
            k: _raw(v) for k, v in want.items()}, path


# two bf16 ulps of a logit in [2, 4): how far apart the two packages'
# bf16 products (summed in different orders) round a logit at this size
NEAR_TIE = 2.0 ** -5


@pytest.fixture(scope="module")
def int8_decode(quantized):
    """The JAX engine's greedy tokens for the int8 bundle at bf16 compute
    (its own config) and at f32 compute (the same tree, config dtype
    float32): (prompts, true lengths, {(compute, cache): tokens})."""
    _, ref = quantized["int8"]
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, 64, (3, 16)).astype(np.int32)
    tl = np.asarray([16, 9, 5], np.int32)

    def job(compute, cache):
        module = jax_build_model("TransformerLM",
                                 {**ref.config, "dtype": compute})
        eng = JaxDecodeEngine(module, 12, chunk=16, cache_dtype=cache)
        return eng.generate(ref.variables, prompts, tl)

    keys = [(c, k) for c in ("bfloat16", "float32") for k in ("model", "int8")]
    with ThreadPoolExecutor(4) as pool:
        futures = {key: pool.submit(job, *key) for key in keys}
    return prompts, tl, {key: f.result() for key, f in futures.items()}


def _near_tie_margin(weights, prompt, ref_row, got_row) -> float:
    """At the first token where the two rows part, the port's top-2
    logit gap over the reference's prefix (through the engine's own block
    math); it must be the two tokens the rows chose."""
    i = int(np.nonzero(ref_row != got_row)[0][0])
    seq = torch.as_tensor(np.concatenate([prompt, ref_row[:i]])[None],
                          dtype=torch.long)
    shape = (1, seq.shape[1], weights.n_heads,
             weights.d_model // weights.n_heads)
    caches = [tuple(torch.zeros(shape, dtype=weights.dtype)
                    for _ in range(2)) for _ in range(weights.n_layers)]
    with torch.inference_mode():
        logits = _forward_with_cache(weights, seq, caches, 0)[0, -1]
    top = torch.topk(logits, 2)
    assert set(top.indices.tolist()) == {int(ref_row[i]), int(got_row[i])}
    return float(top.values[0] - top.values[1])


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
@pytest.mark.parametrize("cache", ["model", "int8"])
def test_int8_weight_bundle_greedy_tokens_equal_jax(quantized, int8_decode,
                                                    compute, cache):
    """The reference's `test_int8_weight_bundle_decodes`, held to the JAX
    engine's tokens: int8 weights x activations in the compute dtype, the
    product rounded there before the per-channel scale.  At f32 compute
    every token is equal.  At bf16 the packages' products round apart by
    up to NEAR_TIE: a row may part from the reference only at a near
    tie.  This seed has one: row 2 at generated index 5 (tokens 49 and
    63, top-2 gap 0.03125 = 2 bf16 ulps at logit 2.375); every token
    before it, and rows 0 and 1 whole, are equal."""
    q, _ = quantized["int8"]
    prompts, tl, ref = int8_decode
    bundle = ModelBundle("TransformerLM", {**q.config, "dtype": compute},
                         q.variables)
    weights = ServingWeights(bundle.module("cpu"))
    engine = DecodeEngine(weights, 12, chunk=16, cache_dtype=cache,
                          device="cpu")
    got, want = engine.generate(prompts, tl), ref[(compute, cache)]
    if compute == "float32":
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_array_equal(got[:2], want[:2])
    for r in range(len(got)):
        if not np.array_equal(got[r], want[r]):
            margin = _near_tie_margin(weights, prompts[r, :tl[r]], want[r],
                                      got[r])
            print(f"row {r} parts from the JAX engine at a near tie: "
                  f"top-2 logit gap {margin}")
            assert margin <= NEAR_TIE


def test_int8_engine_matches_its_recompute_oracle(quantized):
    """The port's own oracle over the int8 module's forward (the same
    int8 Dense math outside the engine)."""
    q, _ = quantized["int8"]
    module = q.module("cpu")
    prompt = np.random.default_rng(6).integers(0, 64, (1, 8)).astype(
        np.int32)
    got = DecodeEngine(module, 8, chunk=16, device="cpu").generate(
        prompt, np.asarray([8]))
    np.testing.assert_array_equal(got[0],
                                  naive_generate(module, prompt, 8)[0, 8:])


def test_breaker_open_degraded_lane_on_int8_bundle(bundle, quantized):
    """The reference's `test_breaker_open_fails_over_to_degraded`: with the
    miss breaker open a new request runs on the int8 degraded lane and
    gets the offline int8 engine's tokens."""
    q, _ = quantized["int8"]
    engine = ServingEngine(bundle, ServeConfig(
        max_new_tokens=12, max_batch=4, queue_capacity=8, segment_steps=4,
        default_deadline_s=100.0, cache_chunk=16, miss_window=8,
        miss_min_samples=4, shed_miss_rate=0.5), degraded_bundle=q,
        clock=VirtualClock(), device="cpu").warmup()
    for _ in range(4):
        engine.breaker.record(missed=True)
    assert engine.breaker.state == "open"
    prompt = np.random.default_rng(8).integers(0, 64, (5,)).astype(np.int32)
    req = engine.submit(prompt, max_new_tokens=8)
    assert req.degraded
    for _ in range(50):
        if req.finished:
            break
        engine._tick()
    assert req.status == "ok"
    ref = DecodeEngine(q.module("cpu"), 8, chunk=16, device="cpu")
    padded = np.zeros((1, ref.bucket_for(5)), np.int32)
    padded[0, :5] = prompt
    assert req.tokens == ref.generate(padded, np.asarray([5]))[0].tolist()
    assert engine.stats()["degraded"] == 1


def test_fleet_replicas_take_the_int8_degraded_bundle(bundle, quantized):
    """The router hands its replicas only `degraded_bundle` (the JAX
    `build_fleet` does the same): every replica's degraded lane holds the
    int8 weights."""
    from mmlspark_tpu_torch.serve import RouterConfig, build_fleet
    q, _ = quantized["int8"]
    router = build_fleet(bundle, cfg=RouterConfig(replicas=2),
                         serve_cfg=ServeConfig(max_new_tokens=8, max_batch=2,
                                               cache_chunk=16),
                         degraded_bundle=q, clock=VirtualClock(),
                         device="cpu")
    assert len(router.replicas) == 2
    for replica in router.replicas:
        lane = replica.engine._engines["degraded"].weights
        assert all(layer.weight.dtype == torch.int8
                   for layer in lane.dense_layers())
