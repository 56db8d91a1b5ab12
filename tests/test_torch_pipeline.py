"""The port's pipeline core against the JAX package's, on the CPU:
`Pipeline` / `PipelineModel` (fit, transform, save and load in both
directions), the `DataTable` helpers (the same seeds give the same rows),
the schema helpers (the same metadata JSON), and the staging layer
(`Prefetcher`'s contract, held on both packages' classes, `OncePerTable`,
`resolve_depth`, `pad_to_multiple`).
"""

import json
import threading

import numpy as np
import pytest

import mmlspark_tpu.core.schema as jax_schema
from mmlspark_tpu.core.params import Param as JaxParam
from mmlspark_tpu.core.pipeline import Estimator as JaxEstimator
from mmlspark_tpu.core.pipeline import Pipeline as JaxPipeline
from mmlspark_tpu.core.pipeline import PipelineModel as JaxPipelineModel
from mmlspark_tpu.core.pipeline import Transformer as JaxTransformer
from mmlspark_tpu.core.pipeline import load_stage as jax_load_stage
from mmlspark_tpu.core.table import DataTable as JaxDataTable
from mmlspark_tpu.parallel.bridge import pad_to_multiple as jax_pad
from mmlspark_tpu.parallel.prefetch import OncePerTable as JaxOncePerTable
from mmlspark_tpu.parallel.prefetch import Prefetcher as JaxPrefetcher
import mmlspark_tpu_torch.core.schema as schema
from mmlspark_tpu_torch import config
from mmlspark_tpu_torch.core.pipeline import (Estimator, Pipeline,
                                              PipelineModel, Transformer,
                                              check_on_error, load_stage,
                                              port_class_path,
                                              record_skipped_rows)
from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.models import ModelBundle, TPUModel
from mmlspark_tpu_torch.observe.metrics import get_counter
from mmlspark_tpu_torch.parallel.bridge import pad_to_multiple
from mmlspark_tpu_torch.parallel.prefetch import (DEPTH_FLOOR, OncePerTable,
                                                  Prefetcher, resolve_depth)


# ------------------------------------------------------- pipelines ---

class Scale(Transformer):
    """x -> factor * x (a port stage with a param)."""

    factor = Param(1.0, "multiplier", ptype=float)

    def transform(self, table):
        return table.with_column("x", table["x"] * self.factor)


class Center(Estimator):
    """Fits the mean of x; the model subtracts it."""

    def fit(self, table):
        return _Shift(float(np.mean(table["x"])))


class _Shift(Transformer):
    def __init__(self, mean: float = 0.0, **kw):
        super().__init__(**kw)
        self.mean = mean

    def transform(self, table):
        return table.with_column("x", table["x"] - self.mean)


class JaxScale(JaxTransformer):
    factor = JaxParam(1.0, "multiplier", ptype=float)

    def transform(self, table):
        return table.with_column("x", table["x"] * self.factor)


class JaxCenter(JaxEstimator):
    def fit(self, table):
        return _JaxShift(float(np.mean(table["x"])))


class _JaxShift(JaxTransformer):
    def __init__(self, mean: float = 0.0, **kw):
        super().__init__(**kw)
        self.mean = mean

    def transform(self, table):
        return table.with_column("x", table["x"] - self.mean)


def test_pipeline_fit_threads_transforms_as_the_jax_pipeline():
    x = np.random.default_rng(0).normal(3.0, 1.0, 50)
    port = Pipeline([Scale(factor=2.0), Center(), Scale(factor=-1.0)])
    jax = JaxPipeline([JaxScale(factor=2.0), JaxCenter(),
                       JaxScale(factor=-1.0)])
    model = port.fit(DataTable({"x": x}))
    ref = jax.fit(JaxDataTable({"x": x}))
    assert isinstance(model, PipelineModel) and len(model.get_stages()) == 3
    assert isinstance(model.get_stages()[1], _Shift)
    np.testing.assert_array_equal(model.transform(DataTable({"x": x}))["x"],
                                  ref.transform(JaxDataTable({"x": x}))["x"])
    with pytest.raises(TypeError, match="neither Estimator"):
        Pipeline([object()]).fit(DataTable({"x": x}))


def _mlp_bundle():
    b = ModelBundle.init("MLPClassifier", {"hidden_sizes": [6],
                                           "num_classes": 3,
                                           "dtype": "float32"},
                         seed=0, input_shape=(1, 4))
    return b


@pytest.mark.parametrize("kind", ["PipelineModel", "Pipeline"])
def test_pipelines_of_tpu_models_load_in_both_packages(tmp_path, kind):
    bundle = _mlp_bundle()
    stages = [TPUModel(bundle, device="cpu", inputCol="x", outputCol="z",
                       miniBatchSize=8),
              TPUModel(bundle, device="cpu", inputCol="x", outputCol="h",
                       outputNodeName="h0", miniBatchSize=8)]
    x = np.random.default_rng(1).normal(size=(13, 4)).astype(np.float32)
    cls = {"Pipeline": Pipeline, "PipelineModel": PipelineModel}[kind]
    cls(stages).save(str(tmp_path / "port"))
    with open(tmp_path / "port" / "stage.json") as f:
        assert json.load(f)["class"] == f"mmlspark_tpu.core.pipeline.{kind}"
    jax_stage = jax_load_stage(str(tmp_path / "port"))
    assert type(jax_stage) is {"Pipeline": JaxPipeline,
                               "PipelineModel": JaxPipelineModel}[kind]
    jax_stage.save(str(tmp_path / "jax"))
    if kind == "Pipeline":
        jax_stage = jax_stage.fit(JaxDataTable({"x": x}))
    ref = jax_stage.transform(JaxDataTable({"x": x}))
    back = load_stage(str(tmp_path / "jax"), device="cpu")
    assert type(back) is cls
    assert all(type(s) is TPUModel and s.device.type == "cpu"
               for s in back.get_stages())
    if kind == "Pipeline":
        back = back.fit(DataTable({"x": x}))
    got = back.transform(DataTable({"x": x}))
    for col in ("z", "h"):
        np.testing.assert_allclose(got[col], np.asarray(ref[col]),
                                   rtol=1e-5, atol=1e-6)


def test_class_paths_map_by_string_and_port_stages_keep_theirs():
    assert (port_class_path("mmlspark_tpu.models.tpu_model.TPUModel")
            == "mmlspark_tpu_torch.models.tpu_model.TPUModel")
    assert (port_class_path("mmlspark_tpu_torch.models.generate."
                            "TextGenerator")
            == "mmlspark_tpu_torch.models.generate.TextGenerator")
    assert port_class_path("tests.stage.Custom") == "tests.stage.Custom"


def test_on_error_helpers():
    assert check_on_error("skip") == "skip"
    with pytest.raises(ValueError, match="on_error"):
        check_on_error("ignore")
    before = get_counter("rows.skipped_on_error")
    record_skipped_rows("reader", 3)
    record_skipped_rows("reader", 0)
    assert get_counter("rows.skipped_on_error") == before + 3


# ------------------------------------------------------- DataTable ---

def _tables():
    rng = np.random.default_rng(2)
    cols = {"a": rng.normal(size=12), "b": rng.integers(0, 5, 12),
            "img": rng.integers(0, 255, (12, 2, 2, 1)).astype(np.uint8),
            "s": np.array(["x", None, "y", "z"] * 3, dtype=object)}
    cols["a"][[3, 7]] = np.nan
    return DataTable(cols), JaxDataTable(cols)


def _same(port, ref):
    assert port.columns == ref.columns and port.num_rows == ref.num_rows
    assert port.num_shards == ref.num_shards
    for c in ref.columns:
        if ref[c].dtype == object:   # a NaN cell equals itself
            assert [repr(v) for v in port[c]] == [repr(v) for v in ref[c]]
        else:
            np.testing.assert_array_equal(port[c], ref[c])
        assert port[c].dtype == ref[c].dtype
        assert port.meta(c).to_json() == ref.meta(c).to_json()


@pytest.mark.parametrize("op", [
    lambda t: t.select("b", "a"), lambda t: t.drop("img"),
    lambda t: t.rename({"a": "alpha"}), lambda t: t.filter(t["b"] > 1),
    lambda t: t.take(5), lambda t: t.slice(3, 9),
    lambda t: t.sample(0.5, seed=4), lambda t: t.shuffle(seed=5),
    lambda t: t.concat(t.take(2)), lambda t: t.repartition(4),
    lambda t: t.drop_nulls(), lambda t: t.drop_nulls(["s"])])
def test_table_helpers_give_the_jax_rows(op):
    port, ref = _tables()
    _same(op(port), op(ref))


def test_table_construction_batches_and_names_match_jax(tmp_path):
    port, ref = _tables()
    rows = list(ref.rows())
    assert [list(r) for r in port.rows()] == [list(r) for r in rows]
    _same(DataTable.from_rows(rows[:4]), JaxDataTable.from_rows(rows[:4]))
    assert DataTable.from_rows([]).num_rows == 0
    got = list(port.batches(["a", "img"], 5))
    want = list(ref.batches(["a", "img"], 5))
    assert [v for _, v in got] == [v for _, v in want] == [5, 5, 2]
    for (g, _), (w, _) in zip(got, want):
        for c in w:
            np.testing.assert_array_equal(g[c], w[c])
    assert port.find_unused_column_name("a") == "a_1"
    frame = ref.select("a", "b", "s").to_pandas()
    _same(DataTable.from_pandas(frame), JaxDataTable.from_pandas(frame))
    _same(DataTable.from_pandas(port.select("a", "s").to_pandas()),
          JaxDataTable.from_pandas(frame[["a", "s"]]))
    frame.to_csv(tmp_path / "t.csv", index=False)
    _same(DataTable.read_csv(str(tmp_path / "t.csv")),
          JaxDataTable.read_csv(str(tmp_path / "t.csv")))
    with pytest.raises(ValueError, match="column mismatch"):
        port.concat(port.drop("a"))


# ---------------------------------------------------------- schema ---

def _meta_json(table, col):
    d = table.meta(col).to_json()
    d.get("extra", {}).pop("score_seq", None)   # each package's own counter
    return d


def test_schema_helpers_write_the_jax_metadata(tmp_path):
    vals = ["red", "blue", "red", "green", None]
    nums = [3.0, 1.0, 3.0, 2.0]
    port = schema.make_categorical(DataTable({"c": vals[:4], "n": nums}),
                                   "c", output_col="ci")
    ref = jax_schema.make_categorical(JaxDataTable({"c": vals[:4],
                                                    "n": nums}),
                                      "c", output_col="ci")
    np.testing.assert_array_equal(port["ci"], ref["ci"])
    assert _meta_json(port, "ci") == _meta_json(ref, "ci")
    for kw in ({"ordinal": True}, {"levels": [2.0, 3.0]}, {}):
        p = schema.make_categorical(DataTable({"n": nums}), "n", **kw)
        r = jax_schema.make_categorical(JaxDataTable({"n": nums}), "n", **kw)
        np.testing.assert_array_equal(p["n"], r["n"])
        assert _meta_json(p, "n") == _meta_json(r, "n")
    cmap = schema.get_categorical_map(port, "ci")
    assert cmap.num_levels == 3 and cmap.get_index("red") == 2
    assert cmap.get_index("purple") == -1 and cmap.get_level(0) == "blue"
    assert cmap.to_levels([0, 5, -1]).tolist() == ["blue", None, None]
    assert port.meta("ci").is_categorical
    for mod, table in ((schema, port), (jax_schema, ref)):
        mod.set_score_column(table, "m1", "n", "scores", "regression")
        mod.set_score_column(table, "m2", "ci", "scored_labels",
                             "classification")
    assert (schema.find_score_columns(port)
            == jax_schema.find_score_columns(ref) == {"scored_labels": "ci"})
    assert (schema.find_score_columns(port, "m1")
            == jax_schema.find_score_columns(ref, "m1"))
    assert _meta_json(port, "n") == _meta_json(ref, "n")
    assert schema.SchemaConstants.SCORES_COLUMN == "scores"
    port.save(str(tmp_path / "t"))
    loaded = JaxDataTable.load(str(tmp_path / "t"))
    assert loaded.meta("ci").to_json() == port.meta("ci").to_json()


# --------------------------------------------------------- staging ---

PREFETCHERS = [Prefetcher, JaxPrefetcher]


@pytest.mark.parametrize("cls", PREFETCHERS)
def test_prefetcher_keeps_item_order_when_later_items_finish_first(cls):
    n = 4
    gates = [threading.Event() for _ in range(n)]
    done = [threading.Event() for _ in range(n)]

    def fn(i):
        gates[i].wait(5)
        done[i].set()
        return i

    results: list = []
    pf = cls(fn, range(n), depth=n, workers=n)
    consumer = threading.Thread(target=lambda: results.extend(pf))
    consumer.start()
    for i in reversed(range(n)):
        gates[i].set()
        assert done[i].wait(5)
    consumer.join(5)
    assert not consumer.is_alive() and results == [0, 1, 2, 3]
    assert list(cls(lambda i: i * 2, range(7), depth=3)) == [
        i * 2 for i in range(7)]


@pytest.mark.parametrize("cls", PREFETCHERS)
def test_prefetcher_backpressure_and_errors(cls):
    pulled: list = []

    def source():
        for i in range(10):
            pulled.append(i)
            yield i

    pf = cls(lambda i: i, source(), depth=2)
    assert next(pf) == 0
    assert len(pulled) <= 3   # never more than depth past the consumer
    pf.close()

    def fn(i):
        if i == 2:
            raise KeyError("bad item")
        return i

    pf = cls(fn, range(5), depth=3)
    assert [next(pf), next(pf)] == [0, 1]
    with pytest.raises(KeyError, match="bad item"):
        next(pf)

    def broken():
        yield 0
        yield 1
        raise OSError("source failed")

    got = []
    with pytest.raises(OSError, match="source failed"):
        for v in cls(lambda i: i, broken(), depth=4):
            got.append(v)
    assert got == [0, 1]


@pytest.mark.parametrize("cls", PREFETCHERS)
def test_prefetcher_depth_zero_is_inline_and_close_never_wedges(cls):
    threads = []
    pf = cls(lambda i: threads.append(threading.get_ident()) or i,
             range(3), depth=0)
    assert list(pf) == [0, 1, 2]
    assert set(threads) == {threading.get_ident()}
    with pytest.raises(ValueError, match="depth"):
        cls(lambda i: i, range(3), depth=-1)
    gate = threading.Event()
    pf = cls(lambda i: gate.wait(5) and i, range(8), depth=4, workers=2)
    pf._top_up()
    pf.close()          # returns with workers still blocked
    gate.set()
    assert list(pf) == []


@pytest.mark.parametrize("cls", [OncePerTable, JaxOncePerTable])
def test_once_per_table_computes_once_across_threads(cls):
    calls = []
    barrier = threading.Barrier(8)
    once = cls(lambda: calls.append(1) or "value")

    def worker(out):
        barrier.wait(5)
        out.append(once.get())

    out: list = []
    threads = [threading.Thread(target=worker, args=(out,))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(5)
    assert not any(t.is_alive() for t in threads)
    assert calls == [1] and out == ["value"] * 8


def test_resolve_depth_follows_the_jax_knob_except_autotune():
    """The knob resolves to (depth, autotune) as the JAX package's does,
    autotune (0) included now that the data layer's Autotuner is
    ported."""
    assert resolve_depth(3) == (3, False)
    assert resolve_depth(-1) == (0, False)
    assert resolve_depth(None) == (8, False)
    config.set("MMLSPARK_TPU_PREFETCH_DEPTH", 2)
    try:
        assert resolve_depth(None) == (2, False)
        config.set("MMLSPARK_TPU_PREFETCH_DEPTH", 0)
        assert resolve_depth(None) == (DEPTH_FLOOR, True) == (2, True)
    finally:
        config.set("MMLSPARK_TPU_PREFETCH_DEPTH", None)
    assert config.get("MMLSPARK_TPU_PREFETCH_WORKERS") == 4


@pytest.mark.parametrize("n,multiple", [(10, 4), (8, 4), (0, 3), (5, 1)])
def test_pad_to_multiple_matches_jax(n, multiple):
    arr = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    got, valid = pad_to_multiple(arr, multiple)
    want, want_valid = jax_pad(arr, multiple)
    assert valid == want_valid == n
    np.testing.assert_array_equal(got, want)
