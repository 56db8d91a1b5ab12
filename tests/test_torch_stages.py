"""The port's utility stages (`mmlspark_tpu_torch/stages/`) and
`quant.accuracy_gate` against the JAX package's, on the CPU.

  * Every stage of `stages/` gives the JAX stage's table: the same
    columns, values, dtypes and categorical metadata.
  * Stages saved by either package load in the other (`load_stage` both
    ways; a nested stage gets the run-time `device`).
  * `CheckpointData` caches the numeric columns as tensors on its device;
    `TPUModel` over a cached table gives the uncached table's scores
    bit for bit and puts none of that column's bytes on the device;
    `removeCheckpoint` releases the cache.
  * `accuracy_gate` gives the JAX package's record.
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu.core.pipeline import load_stage as jax_load_stage
from mmlspark_tpu.core.schema import make_categorical as jax_make_cat
from mmlspark_tpu.core.table import DataTable as JaxDataTable
from mmlspark_tpu.quant import accuracy_gate as jax_accuracy_gate
import mmlspark_tpu.stages as JST
from mmlspark_tpu_torch import TPUModel
from mmlspark_tpu_torch.core.pipeline import load_stage
from mmlspark_tpu_torch.core.schema import make_categorical
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.models import ModelBundle
from mmlspark_tpu_torch.quant import accuracy_gate
import mmlspark_tpu_torch.stages as PST


def columns():
    rng = np.random.default_rng(0)
    return {
        "a": np.arange(40, dtype=np.float64),
        "b": np.arange(40, dtype=np.int64) * 2,
        "f": np.where(rng.random(40) < 0.1, np.nan, rng.normal(size=40)),
        "s": np.asarray([f"v{i % 3}" for i in range(40)], object),
        "n": np.asarray([str(i * 7) for i in range(40)], object),
    }


def both():
    cols = columns()
    return DataTable(cols), JaxDataTable(cols)


def assert_same(port, jax):
    assert port.columns == jax.columns
    for c in port.columns:
        a, b = port[c], jax[c]
        assert a.dtype == b.dtype, c
        if a.dtype == object:
            assert list(a) == list(b), c
        else:
            np.testing.assert_array_equal(a, b, err_msg=c)
        assert port.meta(c).to_json() == jax.meta(c).to_json(), c


STAGES = {
    "SelectColumns": dict(cols=["a", "s"]),
    "DropColumns": dict(cols=["b"]),
    "RenameColumns": dict(mapping={"a": "alpha", "s": "sigma"}),
    "Repartition": dict(n=4),
    "DataConversion-double": dict(cols="a,b", convertTo="double"),
    "DataConversion-integer": dict(cols=["n"], convertTo="integer"),
    "DataConversion-string": dict(cols=["a"], convertTo="string"),
    "DataConversion-categorical": dict(cols="s", convertTo="toCategorical"),
    "SummarizeData": {},
    "SummarizeData-counts": dict(basic=False, percentiles=False),
    "PartitionSample-head": dict(mode="Head", count=7),
    "PartitionSample-sample": dict(mode="RandomSample", percent=0.3,
                                   seed=4),
    "PartitionSample-assign": dict(mode="AssignToPartition", numParts=3,
                                   seed=2),
}


@pytest.mark.parametrize("key", sorted(STAGES))
def test_stage_matches_jax_and_loads_both_ways(key, tmp_path):
    name = key.split("-")[0]
    port, jax = both()
    ps, js = getattr(PST, name)(**STAGES[key]), \
        getattr(JST, name)(**STAGES[key])
    assert_same(ps.transform(port), js.transform(jax))
    js.save(str(tmp_path / "jax"))
    assert_same(load_stage(str(tmp_path / "jax")).transform(port),
                js.transform(jax))
    ps.save(str(tmp_path / "port"))
    back = jax_load_stage(str(tmp_path / "port"))
    assert type(back) is type(js)
    assert_same(ps.transform(port), back.transform(jax))


def test_clear_categorical_matches_jax():
    port, jax = both()
    port, jax = make_categorical(port, "s"), jax_make_cat(jax, "s")
    args = dict(cols=["s"], convertTo="clearCategorical")
    assert_same(PST.DataConversion(**args).transform(port),
                JST.DataConversion(**args).transform(jax))


def test_multi_column_adapter_matches_jax(tmp_path):
    port, jax = both()
    from mmlspark_tpu.feature import Tokenizer as JaxTokenizer
    from mmlspark_tpu_torch.feature import Tokenizer
    pa = PST.MultiColumnAdapter(Tokenizer(inputCol="x"),
                                inputCols=["s", "n"],
                                outputCols=["s_t", "n_t"])
    ja = JST.MultiColumnAdapter(JaxTokenizer(inputCol="x"),
                                inputCols=["s", "n"],
                                outputCols=["s_t", "n_t"])
    out, jout = pa.transform(port), ja.transform(jax)
    for c in ("s_t", "n_t"):
        assert [list(v) for v in out[c]] == [list(v) for v in jout[c]]
    fitted, jfitted = pa.fit(port), ja.fit(jax)
    assert len(fitted.get_stages()) == len(jfitted.get_stages()) == 2
    ja.save(str(tmp_path / "jax"))
    loaded = load_stage(str(tmp_path / "jax"), device="cpu")
    assert [list(v) for v in loaded.transform(port)["n_t"]] == \
        [list(v) for v in jout["n_t"]]
    pa.save(str(tmp_path / "port"))
    back = jax_load_stage(str(tmp_path / "port"))
    assert [list(v) for v in back.transform(jax)["s_t"]] == \
        [list(v) for v in jout["s_t"]]


MLP = ("MLPClassifier", {"hidden_sizes": [12, 6], "num_classes": 4,
                         "dtype": "float32"}, (1, 9))


def scoring_stage():
    arch, cfg, shape = MLP
    bundle = ModelBundle.init(arch, cfg, seed=1, input_shape=shape)
    return TPUModel(bundle, device="cpu", inputCol="x", outputCol="y",
                    miniBatchSize=16)


def test_checkpoint_data_caches_on_its_device_and_tpu_model_reads_it():
    rng = np.random.default_rng(1)
    table = DataTable({"x": rng.normal(size=(37, 9)),
                       "i": np.arange(37), "s": np.asarray(["a"] * 37,
                                                           object)})
    cached = PST.CheckpointData(device="cpu").transform(table)
    cache = PST.CheckpointData.get_device_cache(cached)
    assert sorted(cache) == ["i", "x"]
    assert all(t.device.type == "cpu" for t in cache.values())
    np.testing.assert_array_equal(cache["x"].numpy(), table["x"])
    model = scoring_stage()
    plain = model.transform(table)["y"]
    feed = model._get_feed()
    before = feed.put_bytes
    scored = model.transform(cached)["y"]
    assert feed.put_bytes == before
    assert scored.dtype == plain.dtype
    np.testing.assert_array_equal(scored, plain)
    # the last batch is padded on the device (37 = 2 x 16 + 5)
    assert scored.shape == (37, 4)
    released = PST.CheckpointData(removeCheckpoint=True,
                                  device="cpu").transform(cached)
    assert PST.CheckpointData.get_device_cache(released) == {}
    assert PST.CheckpointData.get_device_cache(cached) == {}


def test_checkpoint_data_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PST.CheckpointData()


def test_accuracy_gate_matches_jax():
    rng = np.random.default_rng(2)

    class Scores:
        outputCol = "y"

        def __init__(self, scores, table_type):
            self.scores, self.table_type = scores, table_type

        def transform(self, table):
            return self.table_type({"y": self.scores})

    base = rng.normal(size=(300, 5)).astype(np.float32)
    quant = base + rng.normal(0, 0.3, size=base.shape).astype(np.float32)
    labels = rng.integers(0, 5, 300)
    got = accuracy_gate(Scores(base, DataTable), Scores(quant, DataTable),
                        DataTable({"z": labels}), labels)
    want = jax_accuracy_gate(Scores(base, JaxDataTable),
                             Scores(quant, JaxDataTable),
                             JaxDataTable({"z": labels}), labels)
    assert got == want


def test_subpackages_export_the_jax_names():
    import mmlspark_tpu.feature as JF
    import mmlspark_tpu.ml as JM
    import mmlspark_tpu.quant as JQ
    import mmlspark_tpu_torch.feature as PF
    import mmlspark_tpu_torch.ml as PM
    import mmlspark_tpu_torch.quant as PQ
    for port, jax in ((PM, JM), (PF, JF), (PST, JST)):
        assert sorted(port.__all__) == sorted(jax.__all__)
        assert all(hasattr(port, name) for name in jax.__all__)
    assert hasattr(PQ, "accuracy_gate") and hasattr(JQ, "accuracy_gate")
