"""The port's AutoML layer (`TrainClassifier`, `TrainRegressor`,
`ComputeModelStatistics`, `ComputePerInstanceStatistics`, `FindBestModel`)
against the JAX package's on the CPU, and against the committed metrics.

  * Statistics: the same numpy inputs give bit-identical reports, batched
    confusion matrices, ROC curves and AUCs; a table scored by each
    package evaluates to bit-identical metrics where the scores agree
    (trees, naive Bayes).
  * TrainClassifier / TrainRegressor: the featurized tables bit-identical,
    tree and naive Bayes models giving identical predictions, L-BFGS on
    all but at most one test row (on the unscaled census columns it stops
    at maxIter in both packages), linear regression within 1e-4 of
    max |w|; FindBestModel's batched
    (classifiers) and serial (regressors) rankings pick the JAX package's
    winner with its metrics.
  * A JAX-saved `TrainedClassifierModel`, `TrainedRegressorModel` and
    `BestModel` load through the port's `load_stage` and score the same;
    the port's load in the JAX package.
  * The committed metrics (`tests/benchmark_metrics.csv`,
    `tests/example_metrics.json`): tree and naive Bayes rows exact; an
    L-BFGS row within one test row's accuracy and 0.005 AUC.  MLP rows are
    printed, not held: their initial weights come from a seeded numpy
    init where the JAX package's come from `jax.random`, and the JAX
    package itself no longer reproduces those rows with this jax
    (census_mixed 0.62 for the committed 0.73, example 101's MLP 0.74
    for 0.6533).  The whole grid is `slow`; blobs_noisy and collinear
    stand in for it in tier 1.
"""

import contextlib
import json
import os
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from mmlspark_tpu.core.pipeline import load_stage as jax_load_stage
from mmlspark_tpu.core.table import DataTable as JaxDataTable
from mmlspark_tpu.ml import statistics as JS
import mmlspark_tpu.ml as JM
from mmlspark_tpu_torch.core.pipeline import load_stage
from mmlspark_tpu_torch.core.table import DataTable
import mmlspark_tpu_torch.ml as PM
from mmlspark_tpu_torch.ml import statistics as PS
from mmlspark_tpu_torch.utils import demo_data
from mmlspark_tpu_torch.utils.benchmarks import compute_learner_grid

HERE = os.path.dirname(os.path.abspath(__file__))


@contextlib.contextmanager
def jax_quiet():
    """The JAX package's L-BFGS touches `optax.tree_utils.tree_l2_norm`,
    whose DeprecationWarning the suite's settings turn into an error."""
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message="optax.tree_utils.tree_l2_norm is deprecated")
        yield


def both(table):
    cols = {c: table[c] for c in table.columns}
    return DataTable(cols), JaxDataTable(cols)


def test_statistics_functions_are_bit_identical():
    rng = np.random.default_rng(0)
    y = rng.integers(0, 3, 200)
    preds = np.stack([rng.integers(0, 3, 200) for _ in range(4)])
    np.testing.assert_array_equal(
        PS.confusion_matrix_batch(np.stack([y] * 4), preds, n_classes=3),
        JS.confusion_matrix_batch(np.stack([y] * 4), preds, n_classes=3))
    a = PS.classification_report_batch(y, preds)
    b = JS.classification_report_batch(y, preds)
    assert a.columns == b.columns
    for c in a.columns:
        np.testing.assert_array_equal(a[c], b[c])
    for m, n in ((PS.classification_report(y, preds[0]).metrics,
                  JS.classification_report(y, preds[0]).metrics),):
        assert m.columns == n.columns
        for c in m.columns:
            np.testing.assert_array_equal(m[c], n[c])
    yb, scores = rng.integers(0, 2, 300), rng.normal(size=300)
    for p, j in zip(PS.roc_curve(yb, scores), JS.roc_curve(yb, scores)):
        np.testing.assert_array_equal(p, j)
    assert PS.auc_score(yb, scores) == JS.auc_score(yb, scores)


CENSUS = demo_data.adult_census_like(n=400, seed=0)


def census_split():
    port, jax = both(CENSUS)
    return ((port.slice(0, 300), port.slice(300, 400)),
            (jax.slice(0, 300), jax.slice(300, 400)))


CLASSIFIERS = {
    "DecisionTreeClassifier": dict(maxDepth=4),
    "NaiveBayes": {},
    "LogisticRegression": {},
}


REGRESSORS = {"LinearRegression": {},
              "DecisionTreeRegressor": dict(maxDepth=4)}
FLIGHTS = demo_data.flight_delays_like(n=400, seed=1)


def _jax_census():
    (_, _), (jtrain, jtest) = census_split()
    with jax_quiet():
        models = [JM.TrainClassifier(getattr(JM, n)(**a),
                                     labelCol="income").fit(jtrain)
                  for n, a in CLASSIFIERS.items()]
        best = JM.FindBestModel(models, evaluationMetric="AUC").fit(jtest)
    return models, best


def _jax_flights():
    _, jax = both(FLIGHTS)
    jtrain, jtest = jax.slice(0, 300), jax.slice(300, 400)
    models = [JM.TrainRegressor(getattr(JM, n)(**a),
                                labelCol="arr_delay").fit(jtrain)
              for n, a in REGRESSORS.items()]
    return models, JM.FindBestModel(models,
                                    evaluationMetric="rmse").fit(jtest)


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX fits, once, on two threads."""
    with ThreadPoolExecutor(2) as pool:
        census, flights = pool.submit(_jax_census), pool.submit(_jax_flights)
        return {"census": census.result(), "flights": flights.result()}


@pytest.fixture(scope="module")
def jax_census(jax_refs):
    return jax_refs["census"]


def test_train_classifier_and_find_best_model_match_jax(jax_census,
                                                        tmp_path):
    (train, test), (_, jtest) = census_split()
    jmodels, jbest = jax_census
    models = [PM.TrainClassifier(getattr(PM, n)(device="cpu", **a),
                                 labelCol="income").fit(train)
              for n, a in CLASSIFIERS.items()]
    for name, m, jm in zip(CLASSIFIERS, models, jmodels):
        assert m.levels == jm.levels
        np.testing.assert_array_equal(
            m.featurized_model.transform(train)["features"],
            jm.featurized_model.transform(
                JaxDataTable({c: train[c] for c in train.columns}))[
                    "features"])
        scored, jscored = m.transform(test), jm.transform(jtest)
        differ = int(np.sum(scored["scored_labels"]
                            != jscored["scored_labels"]))
        # L-BFGS on the unscaled census columns stops at maxIter in both
        # packages (|grad| ~0.05), where float32 round-off parts the two
        # paths: one test row may fall on the other side of 0.5
        assert differ <= (1 if name == "LogisticRegression" else 0), name
        stats = PM.ComputeModelStatistics().evaluate(scored).metrics
        jstats = JM.ComputeModelStatistics().evaluate(jscored).metrics
        assert stats.columns == jstats.columns
        if name == "LogisticRegression":
            assert abs(stats["accuracy"][0] - jstats["accuracy"][0]) <= (
                1.0 / test.num_rows + 1e-12)
            assert abs(stats["AUC"][0] - jstats["AUC"][0]) <= 5e-3
        else:
            for c in stats.columns:
                np.testing.assert_array_equal(stats[c], jstats[c])
        per = PM.ComputePerInstanceStatistics().transform(scored)
        jper = JM.ComputePerInstanceStatistics().transform(jscored)
        assert per.columns == jper.columns
    best = PM.FindBestModel(models, evaluationMetric="AUC").fit(test)
    assert models.index(best.best_model) == jmodels.index(jbest.best_model)
    a, b = best.get_all_model_metrics(), jbest.get_all_model_metrics()
    assert a.columns == b.columns
    np.testing.assert_allclose(a["AUC"], b["AUC"], atol=5e-3)
    # a JAX-saved BestModel / TrainedClassifierModel load in the port and
    # score the same; the port's load in the JAX package
    jbest.save(str(tmp_path / "jax_best"))
    loaded = load_stage(str(tmp_path / "jax_best"), device="cpu")
    assert type(loaded).__module__ == "mmlspark_tpu_torch.ml.find_best_model"
    np.testing.assert_array_equal(
        loaded.transform(test)["scored_labels"],
        jbest.transform(jtest)["scored_labels"])
    best.save(str(tmp_path / "port_best"))
    back = jax_load_stage(str(tmp_path / "port_best"))
    np.testing.assert_array_equal(back.transform(jtest)["scored_labels"],
                                  best.transform(test)["scored_labels"])
    jmodels[0].save(str(tmp_path / "jax_tc"))
    np.testing.assert_array_equal(
        load_stage(str(tmp_path / "jax_tc"), device="cpu").transform(test)[
            "scored_labels"], jmodels[0].transform(jtest)["scored_labels"])


def test_train_regressor_and_serial_ranking_match_jax(jax_refs, tmp_path):
    port, jax = both(FLIGHTS)
    train, test = port.slice(0, 300), port.slice(300, 400)
    jtest = jax.slice(300, 400)
    models = [PM.TrainRegressor(getattr(PM, n)(device="cpu", **a),
                                labelCol="arr_delay").fit(train)
              for n, a in REGRESSORS.items()]
    jmodels, jbest = jax_refs["flights"]
    lr, jlr = models[0].fit_model, jmodels[0].fit_model
    assert np.abs(lr.w - jlr.w).max() <= 1e-4 * np.abs(jlr.w).max()
    for m, jm in list(zip(models, jmodels))[1:]:
        np.testing.assert_array_equal(m.transform(test)["scores"],
                                      jm.transform(jtest)["scores"])
    best = PM.FindBestModel(models, evaluationMetric="rmse").fit(test)
    assert models.index(best.best_model) == jmodels.index(jbest.best_model)
    np.testing.assert_allclose(
        best.get_all_model_metrics()["root_mean_squared_error"],
        jbest.get_all_model_metrics()["root_mean_squared_error"], rtol=1e-5)
    jmodels[0].save(str(tmp_path / "jax"))
    loaded = load_stage(str(tmp_path / "jax"), device="cpu")
    np.testing.assert_allclose(loaded.transform(test)["scores"],
                               jmodels[0].transform(jtest)["scores"],
                               rtol=1e-6)
    models[1].save(str(tmp_path / "port"))
    np.testing.assert_array_equal(
        jax_load_stage(str(tmp_path / "port")).transform(jtest)["scores"],
        models[1].transform(test)["scores"])


def test_population_sweep_is_not_ported():
    (train, _), _ = census_split()
    mlp = PM.MultilayerPerceptronClassifier(layers=[-1, 4, -1], maxIter=1,
                                            device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        PM.TrainClassifier(mlp, labelCol="income",
                           populationSize=3).fit(train)


# -- the committed metrics ---------------------------------------------

def committed_rows(dataset):
    with open(os.path.join(HERE, "benchmark_metrics.csv")) as f:
        lines = f.read().splitlines()[1:]
    return {tuple(l.split(",")[:2]): l.split(",")[2:] for l in lines
            if l.startswith(dataset + ",")}


def check_grid(dataset):
    table = demo_data.grid_datasets()[dataset]
    n_test = table.num_rows - int(table.num_rows * 0.75)
    committed = committed_rows(dataset)
    rows = compute_learner_grid(dataset, device="cpu")
    assert len(rows) == len(committed)
    for r in rows:
        acc, auc = committed[(dataset, r["learner"])]
        d_acc = r["accuracy"] - float(acc)
        d_auc = (r["AUC"] - float(auc)) if auc else 0.0
        print(f"{dataset} {r['learner']}: accuracy {r['accuracy']} "
              f"({d_acc:+.6f}), AUC {r['AUC']} ({d_auc:+.6f})")
        if r["learner"] == "MultilayerPerceptronClassifier":
            continue
        if r["learner"] == "LogisticRegression":
            assert abs(d_acc) <= 1.0 / n_test + 1e-9
            assert abs(d_auc) <= 0.005
        else:
            assert str(r["accuracy"]) == acc and str(r["AUC"]) == auc


@pytest.mark.parametrize("dataset", ["blobs_noisy", "collinear"])
def test_grid_stand_in_meets_committed_metrics(dataset):
    check_grid(dataset)


@pytest.mark.slow
@pytest.mark.parametrize("dataset", sorted(demo_data.grid_datasets()))
def test_whole_grid_meets_committed_metrics(dataset):
    check_grid(dataset)


@pytest.mark.slow
def test_example_101_meets_committed_metrics():
    with open(os.path.join(HERE, "example_metrics.json")) as f:
        pinned = json.load(f)["example_101_adult_census.py"]
    data = demo_data.adult_census_like(n=600, seed=0)
    train, test = data.slice(0, 450), data.slice(450, 600)
    learners = {
        "LogisticRegression": PM.LogisticRegression(device="cpu"),
        "DecisionTree": PM.DecisionTreeClassifier(maxDepth=5, device="cpu"),
        "RandomForest": PM.RandomForestClassifier(numTrees=10, maxDepth=5,
                                                  device="cpu"),
        "GBT": PM.GBTClassifier(maxIter=10, maxDepth=4, device="cpu"),
        "NaiveBayes": PM.NaiveBayes(device="cpu"),
        "MLP": PM.MultilayerPerceptronClassifier(layers=[-1, 32, -1],
                                                 maxIter=40, device="cpu"),
    }
    models = {n: PM.TrainClassifier(l, labelCol="income").fit(train)
              for n, l in learners.items()}
    best = PM.FindBestModel(list(models.values()),
                            evaluationMetric="accuracy").fit(test)
    for name, m in models.items():
        acc = round(float(PM.ComputeModelStatistics().transform(
            m.transform(test))["accuracy"][0]), 4)
        print(f"{name}: {acc} (committed {pinned['accuracy_' + name]})")
        if name == "MLP":
            continue
        if name == "LogisticRegression":
            assert abs(acc - pinned["accuracy_" + name]) <= 1 / 150 + 1e-4
        else:
            assert acc == pinned["accuracy_" + name]
    assert round(float(best.get_evaluation_results()["accuracy"][0]),
                 4) == pinned["best_accuracy"]
