"""The port's core layer against the JAX package's: tables saved by either
package load in the other with their metadata, params validate alike, and
a TextGenerator stage round-trips through save/load."""

import numpy as np
import pytest

from mmlspark_tpu import DataTable as JaxDataTable
from mmlspark_tpu.core.params import ParamError as JaxParamError
from mmlspark_tpu.core.schema import CategoricalMap as JaxCategoricalMap
from mmlspark_tpu.core.schema import ColumnMeta as JaxColumnMeta
from mmlspark_tpu.models.generate import TextGenerator as JaxTextGenerator
from mmlspark_tpu_torch import DataTable, ModelBundle, TextGenerator
from mmlspark_tpu_torch.core import ColumnMeta, ParamError, object_column

CFG = {"vocab_size": 32, "d_model": 32, "n_heads": 2, "n_layers": 1,
       "max_len": 64, "dtype": "float32"}


def _columns():
    prompts = object_column([np.arange(3, dtype=np.int32),
                             np.arange(5, dtype=np.int32)])
    return {"x": np.array([1.5, 2.5]), "name": ["a", None],
            "prompt": prompts}


def _assert_same(a, b):
    assert a.columns == b.columns
    for col in a.columns:
        for u, v in zip(a[col], b[col]):
            if isinstance(u, np.ndarray):
                np.testing.assert_array_equal(u, v)
            else:
                assert u == v


def test_table_saved_by_jax_loads_in_port(tmp_path):
    table = JaxDataTable(_columns())
    meta = JaxColumnMeta(score_model="m1", score_kind="scores",
                         categorical=JaxCategoricalMap(["a", "b"]),
                         extra={"k": 1})
    table.set_meta("x", meta)
    table.save(str(tmp_path / "t"))
    got = DataTable.load(str(tmp_path / "t"))
    _assert_same(got, table)
    assert got.meta("x").to_json() == meta.to_json()


def test_table_saved_by_port_loads_in_jax(tmp_path):
    table = DataTable(_columns()).with_column(
        "y", [7, 8], meta=ColumnMeta(model_kind="regression"))
    table.save(str(tmp_path / "t"))
    got = JaxDataTable.load(str(tmp_path / "t"))
    _assert_same(got, table)
    assert got.meta("y").model_kind == "regression"


@pytest.mark.parametrize("param,value", [
    ("maxNewTokens", 0), ("topP", 1.5), ("kvCacheDtype", "fp8"),
    ("temperature", "hot")])
def test_text_generator_params_validate_like_jax(param, value):
    with pytest.raises(JaxParamError):
        JaxTextGenerator(**{param: value})
    with pytest.raises(ParamError):
        TextGenerator(device="cpu", **{param: value})


def test_text_generator_stage_round_trip(tmp_path):
    bundle = ModelBundle.init("TransformerLM", CFG, seed=3)
    stage = TextGenerator(bundle, device="cpu", inputCol="p",
                          maxNewTokens=5, stopTokens=[7])
    table = DataTable({"p": object_column(
        [np.array([1, 2, 3], np.int32), np.array([4] * 9, np.int32)])})
    stage.save(str(tmp_path / "s"))
    loaded = TextGenerator.load(str(tmp_path / "s"), device="cpu")
    assert loaded.param_values() == stage.param_values()
    for a, b in zip(stage.transform(table)["generated"],
                    loaded.transform(table)["generated"]):
        np.testing.assert_array_equal(a, b)
