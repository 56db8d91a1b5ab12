"""The port's `TPUModel` against the JAX package's, on the CPU: scores, a
ragged last batch, node selection, `computeDtype`, quantized bundles,
`transform_batches` across tables, uint8 and integer inputs, saving and
loading in both directions, and the paths that are not ported.

Both stages get the same bundle (the port's seeded init in the flax
layout, with random non-zero BatchNorm statistics).  The JAX side runs
on the suite's virtual CPU mesh; every JAX result is computed once, on
threads, in a module fixture.  Tolerances: f32 within rtol 1e-5 / atol
1e-5 of max |output|; bf16 compute (an override or a quantized bundle)
within 2e-2 of max |logit| with identical argmax.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from mmlspark_tpu.core.pipeline import load_stage as jax_load_stage
from mmlspark_tpu.core.table import DataTable as JaxDataTable
from mmlspark_tpu.data import Dataset as JaxDataset
from mmlspark_tpu.models import TPUModel as JaxTPUModel
from mmlspark_tpu.models.bundle import ModelBundle as JaxModelBundle
from mmlspark_tpu.quant import quantize_bundle as jax_quantize_bundle
from mmlspark_tpu_torch import DataTable, TPUModel
from mmlspark_tpu_torch.core.pipeline import load_stage
from mmlspark_tpu_torch.data import Dataset
from mmlspark_tpu_torch.models import ModelBundle
from mmlspark_tpu_torch.models.tpu_model import exact_f32
from mmlspark_tpu_torch.observe.spans import pipeline_timing
from mmlspark_tpu_torch.observe.trace import Tracer, tracing
from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from mmlspark_tpu_torch.quant import quantize_bundle

CONVNET = ("ConvNetCIFAR10", {"widths": [4, 8, 8], "dense_width": 16,
                              "dtype": "float32"}, (1, 16, 16, 3))
MLP = ("MLPClassifier", {"hidden_sizes": [12, 6], "num_classes": 4,
                         "dtype": "float32"}, (1, 9))
RESNET = ("ResNet", {"stage_sizes": [1, 1], "widths": [4, 8],
                     "num_classes": 5, "block_kind": "bottleneck",
                     "dtype": "float32"}, (1, 19, 19, 3))
N_ROWS, BATCH = 37, 16     # a ragged last batch of 5 rows


def _stats(tree, rng):
    if not isinstance(tree, dict):
        return tree
    return {k: (rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                if k in ("scale", "var") and not isinstance(v, dict)
                else rng.normal(0, 0.2, v.shape).astype(np.float32)
                if k == "mean" else _stats(v, rng))
            for k, v in tree.items()}


def make_bundle(spec) -> ModelBundle:
    arch, cfg, shape = spec
    b = ModelBundle.init(arch, cfg, seed=1, input_shape=shape)
    return ModelBundle(arch, b.config,
                       _stats(b.variables, np.random.default_rng(2)))


BUNDLES = {"convnet": make_bundle(CONVNET), "mlp": make_bundle(MLP),
           "resnet": make_bundle(RESNET)}


def rows(spec, n=N_ROWS, seed=3, dtype=np.float32) -> np.ndarray:
    shape = (n,) + spec[2][1:]
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.uniform(0, 2, shape).astype(dtype)


def jax_bundle(b):
    return JaxModelBundle(b.architecture, dict(b.config), b.variables,
                          dict(b.metadata))


def port_model(name, **params) -> TPUModel:
    bundle = params.pop("bundle", None) or BUNDLES[name]
    return TPUModel(bundle, device="cpu", inputCol="x", outputCol="y",
                    miniBatchSize=BATCH, **params)


def jax_model(name, **params) -> JaxTPUModel:
    bundle = params.pop("bundle", None) or jax_bundle(BUNDLES[name])
    return JaxTPUModel(bundle, inputCol="x", outputCol="y",
                       miniBatchSize=BATCH, **params)


SPECS = {"convnet": CONVNET, "mlp": MLP, "resnet": RESNET}

# the JAX stage's results the file compares with
JAX_CASES = {
    "convnet": lambda: jax_model("convnet"),
    "mlp": lambda: jax_model("mlp"),
    "resnet": lambda: jax_model("resnet"),
    "convnet_pool2": lambda: jax_model("convnet", outputNodeName="pool2"),
    "convnet_index1": lambda: jax_model("convnet", outputNodeIndex=1),
    "mlp_h0": lambda: jax_model("mlp", outputNodeName="h0"),
    "resnet_bf16": lambda: jax_model("resnet", computeDtype="bfloat16"),
    "convnet_int8": lambda: jax_model("convnet", bundle=jax_quantize_bundle(
        jax_bundle(BUNDLES["convnet"]), "int8")),
    "resnet_int8": lambda: jax_model("resnet", bundle=jax_quantize_bundle(
        jax_bundle(BUNDLES["resnet"]), "int8")),
    "mlp_bf16q": lambda: jax_model("mlp", bundle=jax_quantize_bundle(
        jax_bundle(BUNDLES["mlp"]), "bf16")),
}


def _spec_of(case: str):
    return SPECS[case.split("_")[0]]


@pytest.fixture(scope="module")
def jax_scores():
    def run(case):
        table = JaxDataTable({"x": rows(_spec_of(case))})
        return JAX_CASES[case]().transform(table)["y"]

    with ThreadPoolExecutor(4) as pool:
        futures = {c: pool.submit(run, c) for c in JAX_CASES}
        return {c: np.asarray(f.result(), np.float32)
                for c, f in futures.items()}


def port_scores(case, **params) -> np.ndarray:
    table = DataTable({"x": rows(_spec_of(case))})
    return port_model(case.split("_")[0], **params).transform(table)["y"]


def close_f32(got, ref):
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def close_bf16(got, ref):
    assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("case", ["convnet", "mlp", "resnet"])
def test_scores_match_jax_with_a_ragged_last_batch(jax_scores, case):
    got = port_scores(case)
    assert got.shape == jax_scores[case].shape
    assert got.shape[0] == N_ROWS and got.dtype == np.float32
    close_f32(got, jax_scores[case])


@pytest.mark.parametrize("case,params", [
    ("convnet_pool2", {"outputNodeName": "pool2"}),
    ("convnet_index1", {"outputNodeIndex": 1}),
    ("mlp_h0", {"outputNodeName": "h0"})])
def test_output_node_selection_matches_jax(jax_scores, case, params):
    got = port_scores(case, **params)
    assert got.shape == jax_scores[case].shape
    close_f32(got, jax_scores[case])


def test_unknown_nodes_raise_the_jax_errors():
    table = DataTable({"x": rows(CONVNET, n=4)})
    with pytest.raises(KeyError, match="no node 'nope'"):
        port_model("convnet", outputNodeName="nope").transform(table)
    with pytest.raises(IndexError, match="out of range"):
        port_model("convnet", outputNodeIndex=8).transform(table)
    jt = JaxDataTable({"x": rows(CONVNET, n=8)})
    with pytest.raises(KeyError, match="no node 'nope'"):
        jax_model("convnet", outputNodeName="nope").transform(jt)


def test_compute_dtype_override_matches_jax(jax_scores):
    got = port_scores("resnet", computeDtype="bfloat16")
    assert got.dtype == np.float32
    close_bf16(got, jax_scores["resnet_bf16"])
    # an f32 override of a bf16 bundle computes exactly in f32
    b = BUNDLES["resnet"]
    bf16 = ModelBundle(b.architecture, {**b.config, "dtype": "bfloat16"},
                       b.variables)
    f32 = port_scores("resnet", bundle=bf16, computeDtype="float32")
    close_f32(f32, jax_scores["resnet"])


@pytest.mark.parametrize("case,mode", [("convnet_int8", "int8"),
                                       ("resnet_int8", "int8"),
                                       ("mlp_bf16q", "bf16")])
def test_quantized_bundles_score_as_the_jax_stage(jax_scores, case, mode):
    name = case.split("_")[0]
    q = quantize_bundle(BUNDLES[name], mode)
    got = port_scores(case, bundle=q)
    assert got.dtype == np.float32
    close_bf16(got, jax_scores[case])
    if mode == "int8":
        module = port_model(name, bundle=q)._scoring_module()
        assert {type(m).__name__ for m in module.modules()} >= {"Int8Dense"}


@pytest.mark.parametrize("depth", [-1, 1, 8])
def test_transform_batches_over_three_tables_one_empty(depth):
    model = port_model("convnet", prefetchDepth=depth)
    tables = [DataTable({"x": rows(CONVNET, n=21, seed=5)}),
              DataTable({"x": rows(CONVNET, n=0)}),
              DataTable({"x": rows(CONVNET, n=40, seed=6)})]
    out = list(model.transform_batches(iter(tables)))
    assert [len(t) for t in out] == [21, 0, 40]
    assert out[1]["y"].shape == (0, 10) and out[1]["y"].dtype == np.float32
    for table, scored in zip(tables, out):
        np.testing.assert_array_equal(
            scored["y"], port_model("convnet").transform(table)["y"])
    jax_out = list(jax_model("convnet").transform_batches(
        [JaxDataTable({"x": t["x"]}) for t in tables]))
    for got, ref in zip(out, jax_out):
        assert got["y"].shape == ref["y"].shape
        if len(ref):
            close_f32(got["y"], np.asarray(ref["y"]))


def test_uint8_inputs_are_cast_on_device_and_integers_are_not():
    images = rows(CONVNET, dtype=np.uint8)
    as_bytes = port_model("convnet").transform(DataTable({"x": images}))
    as_f32 = port_model("convnet").transform(
        DataTable({"x": images.astype(np.float32)}))
    np.testing.assert_array_equal(as_bytes["y"], as_f32["y"])
    ints = np.random.default_rng(7).integers(0, 5, (N_ROWS, 9)).astype(
        np.int32)
    seen = []
    model = port_model("mlp")
    module = model._scoring_module()
    forward = module.forward
    module.forward = lambda x: seen.append(x.dtype) or forward(x)
    got = model.transform(DataTable({"x": ints}))["y"]
    assert seen and set(seen) == {torch.int32}
    ref = jax_model("mlp").transform(JaxDataTable({"x": ints}))["y"]
    close_f32(got, np.asarray(ref))


def test_object_rows_stack_as_the_jax_stage_does():
    x = rows(MLP)
    obj = np.empty(N_ROWS, dtype=object)
    obj[:] = list(x.astype(np.float64))
    got = port_model("mlp").transform(DataTable({"x": obj}))["y"]
    np.testing.assert_array_equal(
        got, port_model("mlp").transform(DataTable({"x": x}))["y"])


def test_saved_stages_load_in_both_packages(tmp_path, jax_scores):
    table = DataTable({"x": rows(CONVNET)})
    port_model("convnet", outputNodeIndex=1).save(str(tmp_path / "port"))
    with open(tmp_path / "port" / "stage.json") as f:
        assert json.load(f)["class"] == "mmlspark_tpu.models.tpu_model.TPUModel"
    jax_stage = jax_load_stage(str(tmp_path / "port"))
    assert type(jax_stage) is JaxTPUModel
    ref = jax_stage.transform(JaxDataTable({"x": table["x"]}))["y"]
    close_f32(np.asarray(ref), jax_scores["convnet_index1"])
    jax_stage.save(str(tmp_path / "jax"))
    back = load_stage(str(tmp_path / "jax"), device="cpu")
    assert type(back) is TPUModel and back.outputNodeIndex == 1
    close_f32(back.transform(table)["y"], jax_scores["convnet_index1"])
    again = TPUModel.load(str(tmp_path / "port"), device="cpu")
    np.testing.assert_array_equal(again.transform(table)["y"],
                                  back.transform(table)["y"])


def test_defaults_to_the_card_and_raises_on_unported_paths(monkeypatch):
    table = DataTable({"x": rows(MLP, n=4)})
    # depth 0 (the Autotuner) and a Dataset of tables are ported: parity
    # with depth 8 and with the tables themselves
    np.testing.assert_array_equal(
        port_model("mlp", prefetchDepth=0).transform(table)["y"],
        port_model("mlp", prefetchDepth=8).transform(table)["y"])
    [streamed] = port_model("mlp").transform_batches(
        Dataset.from_iterable(lambda: iter([table])))
    np.testing.assert_array_equal(streamed["y"],
                                  port_model("mlp").transform(table)["y"])
    with pytest.raises(TypeError, match="transform_batches"):
        port_model("mlp").transform(Dataset.from_iterable(lambda: iter([])))
    cached = DataTable({"x": rows(MLP, n=4)})
    cached._device_cache = {"x": object()}
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        port_model("mlp").transform(cached)
    mesh = make_mesh(MeshSpec(data=2), devices=[torch.device("cpu")] * 2)
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        port_model("mlp").set_mesh(mesh)
    lm = ModelBundle.init("TransformerLM", {"vocab_size": 16, "d_model": 8,
                                            "n_heads": 2, "n_layers": 1,
                                            "max_len": 16})
    with pytest.raises(NotImplementedError, match="TextGenerator"):
        port_model("mlp", bundle=lm).transform(table)
    with pytest.raises(ValueError, match="no model bundle"):
        TPUModel(device="cpu", inputCol="x").transform(table)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPUModel(BUNDLES["mlp"], inputCol="x")


def test_f32_forward_runs_with_tf32_off_by_the_stage_itself():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    seen = []
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        for name, params in (("convnet", {}),
                             ("convnet", {"computeDtype": "bfloat16"})):
            model = port_model(name, **params)
            module = model._scoring_module()
            forward = module.forward
            module.forward = lambda x, f=forward: seen.append(
                (cudnn.allow_tf32, matmul.allow_tf32)) or f(x)
            model.transform(DataTable({"x": rows(CONVNET, n=4)}))
        assert seen == [(False, False), (True, True)]
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
        with exact_f32():
            assert not cudnn.allow_tf32 and not matmul.allow_tf32
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def test_scoring_spans_and_stage_timings():
    tracer = Tracer(ring=256)
    with tracing(tracer), pipeline_timing() as spans:
        port_model("mlp").transform(DataTable({"x": rows(MLP)}))
    names = [r["name"] for r in tracer.records()]
    assert names.count("score.batch") == 3
    assert names.count("score.stage") == 3
    assert names.count("score.transform_batches") == 1
    assert {"host", "transfer", "compute", "drain"} <= set(spans.seconds)
    assert spans.counts["compute"] == 3


def test_a_bf16_node_leaves_as_float32_where_jax_keeps_bfloat16():
    """numpy has no bfloat16: the port widens a bf16 node (exactly) to
    float32 at the table boundary; the JAX stage returns bfloat16."""
    b = BUNDLES["convnet"]
    bf16 = ModelBundle(b.architecture, {**b.config, "dtype": "bfloat16"},
                       b.variables)
    x = rows(CONVNET, n=8)
    got = port_model("convnet", bundle=bf16,
                     outputNodeName="dense1").transform(DataTable({"x": x}))
    ref = jax_model("convnet", bundle=jax_bundle(bf16),
                    outputNodeName="dense1").transform(JaxDataTable({"x": x}))
    assert got["y"].dtype == np.float32 and ref["y"].dtype.name == "bfloat16"
    wide = np.asarray(ref["y"], np.float32)
    assert np.abs(got["y"] - wide).max() <= 2e-2 * np.abs(wide).max()


def test_projection_is_decided_at_construction_not_from_shapes():
    """A stride-2 block whose input is already 1 x 1 with as many
    channels as it outputs: flax compares shapes at trace time and builds
    no projection; the port builds one from the strides, so such a bundle
    does not load (a strict state_dict)."""
    arch, cfg = "ResNet", {"stage_sizes": [1, 1], "widths": [64, 64],
                           "num_classes": 3, "block_kind": "basic",
                           "dtype": "float32"}
    import jax
    from mmlspark_tpu.models.definitions import build_model
    ref = jax.eval_shape(build_model(arch, cfg).init, jax.random.key(0),
                         np.zeros((1, 4, 4, 3), np.float32))
    assert "Conv_2" not in ref["params"]["ResNetBlock_1"]
    port = ModelBundle.init(arch, cfg, input_shape=(1, 4, 4, 3))
    assert "Conv_2" in port.variables["params"]["ResNetBlock_1"]


@pytest.mark.parametrize("knob", [0, 8, -1])
def test_a_dataset_of_tables_scores_like_the_jax_stage(jax_scores, knob):
    """A port `Dataset` of ragged tables through `transform_batches` at
    depth 0 (the Autotuner), 8 and -1 (synchronous), against the JAX
    stage over a JAX `Dataset` of the same tables: f32 within rtol 1e-5."""
    parts = np.split(rows(MLP), [5, 6, 6, 30])     # an empty table too
    got = list(port_model("mlp", prefetchDepth=knob).transform_batches(
        Dataset.from_iterable(lambda: (DataTable({"x": p}) for p in parts))))
    ref = list(jax_model("mlp", prefetchDepth=knob).transform_batches(
        JaxDataset.from_iterable(
            lambda: (JaxDataTable({"x": p}) for p in parts))))
    assert [len(t["y"]) for t in got] == [len(p) for p in parts]
    for g, r in zip(got, ref):
        assert g["y"].shape == np.asarray(r["y"]).shape
        if len(g["y"]):
            close_f32(g["y"], np.asarray(r["y"], np.float32))
    close_f32(np.concatenate([t["y"] for t in got]), jax_scores["mlp"])


def test_depth_zero_tunes_the_scoring_window_live(monkeypatch):
    """With prefetchDepth=0 the score stage starts at DEPTH_FLOOR and the
    Autotuner may widen it while the stream runs; scores stay in order."""
    from mmlspark_tpu_torch.data import dataset as dataset_mod
    from mmlspark_tpu_torch.parallel.prefetch import DEPTH_FLOOR
    seen = []
    real = dataset_mod.DatasetIterator.__init__

    def spy(self, *a, **kw):
        real(self, *a, **kw)
        seen.append(self)
    monkeypatch.setattr(dataset_mod.DatasetIterator, "__init__", spy)
    tables = [DataTable({"x": rows(MLP, n=16, seed=s)}) for s in range(12)]
    model = port_model("mlp", prefetchDepth=0)
    got = [t["y"] for t in model.transform_batches(tables)]
    want = [port_model("mlp").transform(t)["y"] for t in tables]
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    score = seen[0].stage("score")
    assert score.tunable and seen[0].tuner is not None
    assert DEPTH_FLOOR <= score.runner.depth <= score.runner.max_depth
