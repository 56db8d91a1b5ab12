"""The port's seq-sharded long-context decode (`DecodeEngine` and
`TextGenerator` over a mesh with 'seq' > 1) against the JAX package, on
the CPU, mirroring tests/test_seq_decode.py at its f32 configuration.

The port's mesh repeats the CPU device (its shards share the host, as the
JAX shards share one CPU through the virtual devices of tests/conftest.py).
Ring prefill, the window slabs and their re-split on growth, owner-only
writes and the stats merge all run; the kernel wrappers run their plain
versions.  Greedy tokens must be IDENTICAL to the JAX seq-sharded
engine's and to the port's seq=1 engine's: the sides differ only in f32
summation order, far below this model's top-2 logit gaps.  Stop tokens,
sampling and the `TextGenerator` stage over a mesh are in
tests/test_torch_seq_serving.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.models.definitions import build_model as jax_build_model
from mmlspark_tpu.models.generate import DecodeEngine as JaxDecodeEngine
from mmlspark_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from mmlspark_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mmlspark_tpu_torch.models import DecodeEngine, ModelBundle
from mmlspark_tpu_torch.models.generate import ServingWeights
from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh

CFG = {"vocab_size": 32, "d_model": 32, "n_heads": 4, "n_layers": 2,
       "max_len": 64, "dtype": "float32"}
CHUNK = 16


@pytest.fixture(scope="module")
def bundle():
    return ModelBundle.init("TransformerLM", CFG, seed=3)


@pytest.fixture(scope="module")
def jax_lm(bundle):
    return (jax_build_model("TransformerLM", CFG),
            jax.tree_util.tree_map(jnp.asarray, bundle.variables))


@pytest.fixture(scope="module")
def module(bundle):
    return bundle.module("cpu")


def _mesh(data=1, seq=2, model=1):
    return make_mesh(MeshSpec(data=data, model=model, seq=seq),
                     [torch.device("cpu")] * (data * seq * model))


def _jax_mesh(data=1, seq=2):
    return jax_make_mesh(JaxMeshSpec(data=data, model=1, seq=seq),
                         jax.devices()[:data * seq])


def _prompts(b=2, seed=0, lengths=(8, 5)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, CFG["vocab_size"], (b, 8)).astype(np.int32),
            np.asarray(lengths, np.int32))


def _three_way(jax_lm, module, toks, true_len, data, seq, **kw):
    """(port seq engine, JAX seq engine, port seq=1 engine) tokens, and
    the two seq engines."""
    jax_module, variables = jax_lm
    port = DecodeEngine(module, device="cpu", chunk=CHUNK,
                        mesh=_mesh(data, seq), **kw)
    ref = JaxDecodeEngine(jax_module, chunk=CHUNK,
                          mesh=_jax_mesh(data, seq), **kw)
    assert port.seq_shards == ref.seq_shards == seq
    single = DecodeEngine(module, device="cpu", chunk=CHUNK, **kw)
    return (port.generate(toks, true_len),
            np.asarray(ref.generate(variables, toks, true_len)),
            single.generate(toks, true_len), port, ref)


# -------------------------------------------------- greedy parity ---

@pytest.mark.parametrize("cache_dtype", ["model", "int8"])
def test_seq2_greedy_matches_jax_and_single_shard(jax_lm, module,
                                                  cache_dtype):
    """max_new 12 crosses a cache-chunk boundary (bucket 8, chunk 16), so
    the grown window's re-split over 'seq' (slots changing owner) runs,
    not only the prefill layout."""
    toks, true_len = _prompts()
    got, ref, single, _, _ = _three_way(
        jax_lm, module, toks, true_len, 1, 2, max_new_tokens=12,
        cache_dtype=cache_dtype)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, single)


def test_seq4_greedy_matches(jax_lm, module):
    toks, true_len = _prompts(seed=2, lengths=(7, 8))
    got, ref, single, _, _ = _three_way(jax_lm, module, toks, true_len, 1,
                                        4, max_new_tokens=12)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, single)


def test_data2_seq2_compose(jax_lm, module):
    """A 'data' x 'seq' 2x2 mesh: rows split into two groups, each with its
    own seq ring."""
    toks, true_len = _prompts(b=4, seed=1, lengths=(8, 3, 6, 8))
    got, ref, single, _, _ = _three_way(jax_lm, module, toks, true_len, 2,
                                        2, max_new_tokens=6)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, single)


# ------------------------------------------------------- refusals ---

def test_refusals_at_construction(module):
    """The JAX engine's refusals of a seq mesh, as ValueErrors on the same
    conditions."""
    mesh = _mesh()
    for kw, match in (({"chunk": 15}, "chunk.*seq"),
                      ({"min_bucket": 7}, "min_bucket.*seq"),
                      ({"prefill_chunk": 8}, "chunked prefill"),
                      ({"draft_module": module, "spec_tokens": 2},
                       "speculative"),
                      ({"mesh": _mesh(seq=2, model=2)}, "model>1")):
        with pytest.raises(ValueError, match=match):
            DecodeEngine(module, 4, device="cpu",
                         **{"chunk": CHUNK, "mesh": mesh, **kw})
    moe = ServingWeights(module)
    moe.mlp_impl = "moe"
    with pytest.raises(ValueError, match="MoE"):
        DecodeEngine(moe, 4, chunk=CHUNK, mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="the engine runs on"):
        DecodeEngine(module, 4, chunk=CHUNK, device="cpu",
                     mesh=make_mesh(MeshSpec(data=1, seq=2),
                                    [torch.device("meta")] * 2))


def test_generate_refuses_unshardable_batches(module):
    eng = DecodeEngine(module, 4, chunk=CHUNK, mesh=_mesh(), device="cpu")
    with pytest.raises(ValueError, match="seq axis"):
        eng.generate(np.zeros((2, 9), np.int32), np.array([9, 9]))
    eng = DecodeEngine(module, 4, chunk=CHUNK, mesh=_mesh(data=2),
                       device="cpu")
    with pytest.raises(ValueError, match="data axis"):
        eng.generate(np.zeros((3, 8), np.int32), np.array([8, 8, 8]))
