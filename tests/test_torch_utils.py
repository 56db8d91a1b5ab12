"""The port's utilities (`mmlspark_tpu_torch/utils/`) on the CPU:
`generate_table` equal to the JAX package's for the same seed and
options, the stage registry against the stages the port exports, a
fuzzing pass over every stage on generated tables (the JAX package's
tests/test_fuzzing.py on the port: params documented, save/load
round-trips, fit/transform runs), `api_summary` listing the port's knobs,
the int8-forward registry keyed by torch layer classes, and the CPU test
environment of `utils/testenv.py`.
"""

import inspect
import keyword
import subprocess
import sys

import numpy as np
import pytest

from mmlspark_tpu.utils import ColumnOptions as JaxColumnOptions
from mmlspark_tpu.utils import generate_table as jax_generate_table
from mmlspark_tpu_torch import DataTable
from mmlspark_tpu_torch.core.pipeline import (Estimator, Transformer,
                                              load_stage)
from mmlspark_tpu_torch.utils import (ColumnOptions, all_stage_classes,
                                      api_summary, generate_table)


def assert_tables_equal(got, want):
    assert list(got.columns) == list(want.columns)
    for c in got.columns:
        a, b = np.asarray(got[c]), np.asarray(want[c])
        assert a.dtype == b.dtype and a.shape == b.shape, c
        if a.dtype == object:
            assert list(a) == list(b), c
        else:
            np.testing.assert_array_equal(a, b, err_msg=c)
        assert got.meta(c).to_json() == want.meta(c).to_json(), c


@pytest.mark.parametrize("seed,kw", [
    (0, {}),
    (3, {"num_rows": 17, "num_cols": 7}),
    (5, {"num_cols": 7, "options": "all_kinds_missing"}),
    (9, {"num_cols": 2, "with_label": False}),
])
def test_generate_table_equal_to_the_jax_package(seed, kw):
    jkw = dict(kw)
    if kw.get("options") == "all_kinds_missing":
        kw["options"] = ColumnOptions(
            kinds=("double", "int", "bool", "string", "vector",
                   "categorical", "image"), missing_ratio=0.3,
            vector_width=3, num_levels=4, image_hw=(4, 5))
        jkw["options"] = JaxColumnOptions(
            kinds=("double", "int", "bool", "string", "vector",
                   "categorical", "image"), missing_ratio=0.3,
            vector_width=3, num_levels=4, image_hw=(4, 5))
    assert_tables_equal(generate_table(seed=seed, **kw),
                        jax_generate_table(seed=seed, **jkw))


def test_generate_table_rejects_an_unknown_kind():
    with pytest.raises(ValueError, match="unknown column kind"):
        generate_table(options=ColumnOptions(kinds=("complex",)))


# ------------------------------------------------------------ registry ---

def test_registry_covers_every_exported_stage():
    """Every PipelineStage the port's packages export is discovered, and
    the discovered set is the JAX package's, name for name."""
    import mmlspark_tpu_torch as port
    from mmlspark_tpu.utils import all_stage_classes as jax_all
    from mmlspark_tpu_torch import feature, ml, stages, train, vision
    from mmlspark_tpu_torch.core.pipeline import PipelineStage
    found = set(all_stage_classes())
    exported = set()
    for pkg in (port, feature, ml, stages, train, vision):
        for name in getattr(pkg, "__all__", dir(pkg)):
            obj = getattr(pkg, name, None)
            if (inspect.isclass(obj) and issubclass(obj, PipelineStage)
                    and not inspect.isabstract(obj)
                    and obj.__module__ != "mmlspark_tpu_torch.core.pipeline"):
                exported.add(obj)
    assert exported and exported <= found, exported - found
    assert {c.__qualname__ for c in found} == \
        {c.__qualname__ for c in jax_all()}


def test_quant_wrappers_keyed_by_torch_layer_classes():
    from mmlspark_tpu_torch.models.definitions import Conv, Dense
    from mmlspark_tpu_torch.quant.modules import (quant_conv_apply,
                                                  quant_dense_apply)
    from mmlspark_tpu_torch.utils.registry import (quant_wrapper_for,
                                                   register_quant_wrapper)
    assert quant_wrapper_for(Dense) is quant_dense_apply
    assert quant_wrapper_for(Conv) is quant_conv_apply

    class WideDense(Dense):   # subclasses inherit through the MRO
        pass
    assert quant_wrapper_for(WideDense) is quant_dense_apply
    register_quant_wrapper(WideDense, quant_conv_apply)
    try:
        assert quant_wrapper_for(WideDense) is quant_conv_apply
    finally:
        from mmlspark_tpu_torch.utils.registry import QUANT_MODULE_WRAPPERS
        del QUANT_MODULE_WRAPPERS[WideDense]
    import torch
    assert quant_wrapper_for(torch.nn.ReLU) is None


def test_api_summary_lists_stages_and_the_ports_knobs():
    doc = api_summary()
    assert "TrainClassifier" in doc and "| param |" in doc
    for knob in ("MMLSPARK_TPU_DATA_SERVICE_WORKERS",
                 "MMLSPARK_TPU_DATA_SERVICE_MODE",
                 "MMLSPARK_TPU_DATA_SERVICE_SPLIT_ELEMS",
                 "MMLSPARK_TPU_DATA_SERVICE_MAX_WORKERS",
                 "MMLSPARK_TPU_DATA_SERVICE_RESPAWNS",
                 "MMLSPARK_TPU_DATA_SERVICE_START_TIMEOUT",
                 "MMLSPARK_TPU_DATA_SERVICE_CHAOS",
                 "MMLSPARK_TPU_DATA_SERVICE_WORKER_LOG",
                 "MMLSPARK_TPU_DATA_SERVICE_WORKER_NS",
                 "MMLSPARK_TPU_TEST_PLATFORM", "MMLSPARK_TPU_TEST_BUDGET_S",
                 "MMLSPARK_TPU_PREFETCH_DEPTH", "MMLSPARK_TPU_COORDINATOR"):
        assert f"| `{knob}` |" in doc, knob
    # XLA's persistent compilation cache has no counterpart in the port
    assert "MMLSPARK_TPU_COMPILATION_CACHE" not in doc


def test_testenv_pins_the_cpu_environment():
    """A fresh interpreter after `pin_cpu_test_env()` sees no CUDA device
    and makes float32 tensors on the CPU; an unknown platform raises."""
    code = ("import os, torch\n"
            "from mmlspark_tpu_torch.utils import testenv\n"
            "dev = testenv.pin_cpu_test_env()\n"
            "x = torch.zeros(2)\n"
            "print(dev, repr(os.environ.get('CUDA_VISIBLE_DEVICES')), "
            "torch.cuda.device_count(), x.dtype, x.device, "
            "testenv.budget_seconds())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout.split()
    assert out == ["cpu", "''", "0", "torch.float32", "cpu", "30.0"]
    from mmlspark_tpu_torch import config
    from mmlspark_tpu_torch.utils import testenv
    config.set("MMLSPARK_TPU_TEST_PLATFORM", "tpu")
    try:
        with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
            testenv.pin_cpu_test_env()
    finally:
        config.set("MMLSPARK_TPU_TEST_PLATFORM", None)


# ------------------------------------------------------------- fuzzing ---

def cpu(cls, *args, **kw):
    """`cls(*args, **kw)` on the CPU where the stage takes a device."""
    if "device" in inspect.signature(cls.__init__).parameters:
        kw.setdefault("device", "cpu")
    return cls(*args, **kw)


def _ml_table(seed=0, n=40):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    X = (np.stack([y * 3.0 + rng.normal(0, 0.5, n),
                   -y * 2.0 + rng.normal(0, 0.5, n)],
                  axis=1)).astype(np.float32)
    return DataTable({"features": X, "label": y.astype(np.int64)})


def _image_table(seed=0, n=3):
    rng = np.random.default_rng(seed)
    return DataTable({"image": rng.integers(0, 255, size=(n, 8, 8, 3),
                                            dtype=np.uint8)})


def _text_table():
    return DataTable({"txt": ["alpha beta", "beta gamma delta", "alpha"],
                      "tokens": [["alpha", "beta"], ["beta"], []]})


def _tiny_bundle():
    from mmlspark_tpu_torch.models import ModelBundle
    return ModelBundle.init("MLPClassifier",
                            {"hidden_sizes": [4], "num_classes": 2,
                             "dtype": "float32"}, seed=0,
                            input_shape=(1, 2))


def _conv_bundle():
    from mmlspark_tpu_torch.models import ModelBundle
    return ModelBundle.init("ConvNetCIFAR10",
                            {"widths": [4, 4, 8], "dense_width": 8,
                             "dtype": "float32"}, seed=0,
                            input_shape=(1, 8, 8, 3))


def _lm_bundle():
    from mmlspark_tpu_torch.models import ModelBundle
    return ModelBundle.init("TransformerLM",
                            {"vocab_size": 16, "d_model": 16, "n_heads": 2,
                             "n_layers": 1, "max_len": 12,
                             "dtype": "float32"}, seed=0)


def _scored_table(seed=0, n=24):
    """A classification-scored table with the score metadata set."""
    from mmlspark_tpu_torch.core.schema import (SchemaConstants,
                                                set_score_column)
    rng = np.random.default_rng(seed)
    y = (rng.random(n) > 0.5).astype(np.float64)
    pred = np.where(rng.random(n) < 0.8, y, 1 - y)
    p1 = np.clip(pred + rng.normal(0, .1, n), 0.01, 0.99)
    t = DataTable({"label": y, "prediction": pred,
                   "prob": np.stack([1 - p1, p1], axis=1)})
    for col, kind in (("prediction", SchemaConstants.SCORED_LABELS_COLUMN),
                      ("label", SchemaConstants.TRUE_LABELS_COLUMN),
                      ("prob",
                       SchemaConstants.SCORED_PROBABILITIES_COLUMN)):
        set_score_column(t, "fuzz", col, kind,
                         SchemaConstants.CLASSIFICATION_KIND)
    return t


def _fixtures():
    """stage name -> () -> (instance, table)."""
    from mmlspark_tpu_torch import Pipeline
    from mmlspark_tpu_torch.feature import (IDF, AssembleFeatures, Featurize,
                                            HashingTF, NGram,
                                            StopWordsRemover,
                                            TextFeaturizer, Tokenizer,
                                            Word2Vec)
    from mmlspark_tpu_torch.ml import (ComputeModelStatistics,
                                       ComputePerInstanceStatistics,
                                       DecisionTreeClassifier,
                                       DecisionTreeRegressor, FindBestModel,
                                       GBTClassifier, GBTRegressor,
                                       LinearRegression, LogisticRegression,
                                       MultilayerPerceptronClassifier,
                                       NaiveBayes, OneVsRest,
                                       RandomForestClassifier,
                                       RandomForestRegressor,
                                       TrainClassifier, TrainRegressor)
    from mmlspark_tpu_torch.models.generate import TextGenerator
    from mmlspark_tpu_torch.models.tpu_model import TPUModel
    from mmlspark_tpu_torch.stages import (CheckpointData, DataConversion,
                                           DropColumns, MultiColumnAdapter,
                                           PartitionSample, RenameColumns,
                                           Repartition, SelectColumns,
                                           SummarizeData)
    from mmlspark_tpu_torch.train import TPULearner, TrainerConfig
    from mmlspark_tpu_torch.vision import (ImageFeaturizer,
                                           ImageTransformer, UnrollImage)

    gen = generate_table(num_rows=20, seed=0)
    ml = _ml_table()
    txt = _text_table()
    img = _image_table()
    feats = ml.rename({"features": "feats"})

    def lr(**kw):
        return cpu(LogisticRegression, **kw)

    return {
        "SelectColumns": lambda: (SelectColumns(cols=["double_0"]), gen),
        "DropColumns": lambda: (DropColumns(cols=["double_0"]), gen),
        "RenameColumns": lambda: (
            RenameColumns(mapping={"double_0": "d"}), gen),
        "Repartition": lambda: (Repartition(n=2), gen),
        "CheckpointData": lambda: (cpu(CheckpointData), gen),
        "DataConversion": lambda: (
            DataConversion(cols=["int_1"], convertTo="double"), gen),
        "SummarizeData": lambda: (SummarizeData(), gen),
        "PartitionSample": lambda: (
            PartitionSample(mode="Head", count=5), gen),
        "MultiColumnAdapter": lambda: (
            cpu(MultiColumnAdapter, Tokenizer(), inputCols=["txt"],
                outputCols=["txt_tok"]), txt),
        "Tokenizer": lambda: (Tokenizer(inputCol="txt"), txt),
        "StopWordsRemover": lambda: (
            StopWordsRemover(inputCol="tokens"), txt),
        "NGram": lambda: (NGram(inputCol="tokens"), txt),
        "HashingTF": lambda: (
            HashingTF(inputCol="tokens", numFeatures=64), txt),
        "IDF": lambda: (
            IDF(inputCol="tf"),
            HashingTF(inputCol="tokens", outputCol="tf",
                      numFeatures=64).transform(txt)),
        "TextFeaturizer": lambda: (
            TextFeaturizer(inputCol="txt", numFeatures=64), txt),
        "Word2Vec": lambda: (
            cpu(Word2Vec, inputCol="tokens", vectorSize=4, minCount=1,
                maxIter=1), txt),
        "AssembleFeatures": lambda: (
            AssembleFeatures(columnsToFeaturize=["double_0", "int_1"],
                             numberOfFeatures=64), gen),
        "Featurize": lambda: (
            Featurize(featureColumns={"f": ["double_0"]},
                      numberOfFeatures=64), gen),
        "LogisticRegression": lambda: (lr(), ml),
        "DecisionTreeClassifier": lambda: (
            cpu(DecisionTreeClassifier, maxDepth=2), ml),
        "RandomForestClassifier": lambda: (
            cpu(RandomForestClassifier, maxDepth=2, numTrees=2), ml),
        "GBTClassifier": lambda: (
            cpu(GBTClassifier, maxDepth=2, maxIter=2), ml),
        "DecisionTreeRegressor": lambda: (
            cpu(DecisionTreeRegressor, maxDepth=2), ml),
        "RandomForestRegressor": lambda: (
            cpu(RandomForestRegressor, maxDepth=2, numTrees=2), ml),
        "GBTRegressor": lambda: (
            cpu(GBTRegressor, maxDepth=2, maxIter=2), ml),
        "LinearRegression": lambda: (cpu(LinearRegression), ml),
        "NaiveBayes": lambda: (
            cpu(NaiveBayes),
            ml.with_column("features", np.abs(ml["features"]))),
        "MultilayerPerceptronClassifier": lambda: (
            cpu(MultilayerPerceptronClassifier, layers=[2, 4, 2],
                maxIter=2), ml),
        "OneVsRest": lambda: (cpu(OneVsRest, lr()), ml),
        "TrainClassifier": lambda: (
            cpu(TrainClassifier, lr(), labelCol="label"), feats),
        "TrainRegressor": lambda: (
            cpu(TrainRegressor, cpu(LinearRegression), labelCol="label"),
            feats),
        "ComputeModelStatistics": lambda: (
            ComputeModelStatistics(), _scored_table()),
        "ComputePerInstanceStatistics": lambda: (
            ComputePerInstanceStatistics(), _scored_table()),
        "FindBestModel": lambda: (
            FindBestModel([
                cpu(TrainClassifier, lr(), labelCol="label").fit(feats),
                cpu(TrainClassifier, lr(regParam=1.0),
                    labelCol="label").fit(feats),
            ]), feats),
        "TPULearner": lambda: (
            cpu(TPULearner, TrainerConfig(
                architecture="MLPClassifier",
                model_config={"hidden_sizes": [4], "num_classes": 2,
                              "dtype": "float32"},
                epochs=1, batch_size=8, loss="softmax_xent")), ml),
        "TPUModel": lambda: (
            cpu(TPUModel, _tiny_bundle(), inputCol="features",
                miniBatchSize=8), ml),
        "TextGenerator": lambda: (
            cpu(TextGenerator, _lm_bundle(), inputCol="prompt",
                maxNewTokens=2),
            DataTable({"prompt": np.tile(np.arange(4, dtype=np.int32),
                                         (6, 1))})),
        "ImageTransformer": lambda: (
            cpu(ImageTransformer).resize(4, 4), img),
        "UnrollImage": lambda: (cpu(UnrollImage), img),
        "ImageFeaturizer": lambda: (
            cpu(ImageFeaturizer, _conv_bundle(), layerName="dense1"), img),
        "Pipeline": lambda: (
            Pipeline([SelectColumns(cols=["double_0", "label"])]), gen),
    }


# model classes that only arise from fit(); their round-trips are covered
# through their estimators
_MODEL_ONLY = {
    "AssembleFeaturesModel", "PipelineModel", "TextFeaturizerModel",
    "IDFModel", "LogisticRegressionModel", "LinearRegressionModel",
    "NaiveBayesModel", "MultilayerPerceptronClassifierModel",
    "OneVsRestModel", "TrainedClassifierModel", "TrainedRegressorModel",
    "BestModel", "ClassifierModel", "RegressorModel", "Evaluator",
    "TreeClassifierModel", "TreeRegressorModel", "Word2VecModel",
}


def load_cpu(path: str, stage):
    """`load_stage` on the CPU where the stage takes a device."""
    takes = "device" in inspect.signature(type(stage).__init__).parameters
    return load_stage(path, **({"device": "cpu"} if takes else {}))


def test_every_stage_is_fixtured_or_model_only():
    fixtures = _fixtures()
    missing = [c.__qualname__ for c in all_stage_classes()
               if c.__qualname__ not in fixtures
               and c.__qualname__ not in _MODEL_ONLY]
    assert not missing, f"stages without fuzzing fixtures: {missing}"


def test_param_hygiene():
    for cls in all_stage_classes(concrete_only=False):
        for name, p in cls.params().items():
            assert name.isidentifier() and not keyword.iskeyword(name), \
                f"{cls.__qualname__}.{name}"
            assert p.doc, f"{cls.__qualname__}.{name} has no doc"
            assert p.name == name


@pytest.mark.parametrize("stage_name", sorted(_fixtures()))
def test_fuzz_save_load_fit_transform(stage_name, tmp_path):
    """Each stage on generated data: its params survive save/load, and
    fit/transform runs (a fitted model round-trips too)."""
    stage, table = _fixtures()[stage_name]()
    stage.save(str(tmp_path / "s"))
    loaded = load_cpu(str(tmp_path / "s"), stage)
    assert type(loaded) is type(stage)
    assert loaded.param_values().keys() == stage.param_values().keys()
    for k, v in stage.param_values().items():
        lv = loaded.get(k)
        if isinstance(v, np.ndarray):
            assert np.array_equal(lv, v)
        elif isinstance(v, tuple):
            assert list(lv) == list(v)
        else:
            assert lv == v, f"{stage_name}.{k}: {lv!r} != {v!r}"
    if isinstance(stage, Estimator):
        model = stage.fit(table)
        assert isinstance(model, Transformer)
        out = model.transform(table)
        model.save(str(tmp_path / "m"))
        out2 = load_cpu(str(tmp_path / "m"), model).transform(table)
        assert out2.num_rows == out.num_rows
    else:
        out = stage.transform(table)
    assert out.num_rows >= 0
    assert out.columns
