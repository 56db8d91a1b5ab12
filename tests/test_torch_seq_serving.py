"""The port's seq-sharded decode behind its serving controls, against the
JAX package on the CPU (the rest of tests/test_seq_decode.py's cases; the
engine parity cases are in tests/test_torch_seq_decode.py): stop tokens
with early exit, sampling, and `TextGenerator` over a data x seq mesh.
Greedy tokens must be identical to the JAX seq-sharded engine's and to
the port's seq=1 engine's.
"""

import numpy as np

from mmlspark_tpu import DataTable as JaxDataTable
from mmlspark_tpu.models import ModelBundle as JaxModelBundle
from mmlspark_tpu.models.generate import TextGenerator as JaxTextGenerator
from mmlspark_tpu_torch import DataTable, ModelBundle, TextGenerator
from mmlspark_tpu_torch.models import DecodeEngine
from test_torch_seq_decode import (CFG, CHUNK, _jax_mesh, _mesh, _prompts,
                                   _three_way, bundle, jax_lm,  # noqa: F401
                                   module)


def test_seq2_stop_token_early_exit(jax_lm, module):
    toks, true_len = _prompts()
    stop = int(DecodeEngine(module, 16, chunk=CHUNK, device="cpu").generate(
        toks, true_len)[0, 2])
    got, ref, single, port, jax_engine = _three_way(
        jax_lm, module, toks, true_len, 1, 2, max_new_tokens=16,
        stop_tokens=(stop,))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, single)
    row = got[0]
    assert (row[np.argmax(row == stop):] == stop).all()
    assert port.last_segments_run == jax_engine.last_segments_run


def test_seq2_sampled_runs(module):
    toks, true_len = _prompts()
    out = DecodeEngine(module, 5, temperature=0.8, top_k=8, chunk=CHUNK,
                       mesh=_mesh(), device="cpu").generate(toks, true_len,
                                                            seed=7)
    assert out.shape == (2, 5) and out.dtype == np.int32
    assert ((0 <= out) & (out < CFG["vocab_size"])).all()


def test_textgenerator_data_seq_mesh_end_to_end(bundle):
    """Ragged rows on a data x seq mesh through `transform`: five rows pad
    to whole data groups with not-live rows; the output column equals the
    JAX stage's over its mesh and the port's without one."""
    rows = [((np.arange(3 + i, dtype=np.int32) + i) % CFG["vocab_size"])
            for i in range(5)]
    params = dict(inputCol="prompt", outputCol="out", maxNewTokens=5,
                  cacheChunk=CHUNK)
    ref = JaxTextGenerator(
        JaxModelBundle("TransformerLM", CFG, bundle.variables),
        **params).set_mesh(_jax_mesh(data=2, seq=2)).transform(
        JaxDataTable({"prompt": rows}))["out"]
    single = TextGenerator(bundle, device="cpu", **params).transform(
        DataTable({"prompt": rows}))["out"]
    stage = TextGenerator(bundle, device="cpu", **params).set_mesh(
        _mesh(data=2, seq=2))
    meshed = stage.transform(DataTable({"prompt": rows}))["out"]
    assert len(meshed) == len(rows)
    for got, r, s, prompt in zip(meshed, ref, single, rows):
        np.testing.assert_array_equal(got, np.asarray(r))
        np.testing.assert_array_equal(got, s)
        np.testing.assert_array_equal(got[:len(prompt)], prompt)
    # one model-dtype copy of the weights for the one distinct device
    assert not stage._engine_for().weights._copies


def test_set_bundle_after_set_mesh_decodes_with_the_new_bundle(bundle):
    """A stage with a data x seq mesh attached, after `set_bundle(B)`,
    decodes with B's weights: its tokens equal a fresh stage's on B, with
    and without the mesh.  (The JAX stage keeps the mesh weights of the
    bundle it first decoded with; the port does not copy that.)"""
    other = ModelBundle.init("TransformerLM", CFG, seed=11)
    rows = [((np.arange(4 + i, dtype=np.int32) * 3 + i) % CFG["vocab_size"])
            for i in range(3)]
    table = DataTable({"prompt": rows})
    params = dict(inputCol="prompt", outputCol="out", maxNewTokens=6,
                  cacheChunk=CHUNK)
    stage = TextGenerator(bundle, device="cpu", **params).set_mesh(
        _mesh(data=2, seq=2))
    first = stage.transform(table)["out"]
    got = stage.set_bundle(other).transform(table)["out"]
    fresh = TextGenerator(other, device="cpu", **params).set_mesh(
        _mesh(data=2, seq=2)).transform(table)["out"]
    single = TextGenerator(other, device="cpu", **params).transform(
        table)["out"]
    for g, f, s in zip(got, fresh, single):
        np.testing.assert_array_equal(g, f)
        np.testing.assert_array_equal(g, s)
    # the two bundles decode differently, so stale weights would show
    assert any(not np.array_equal(a, g) for a, g in zip(first, got))
