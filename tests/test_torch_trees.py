"""The port's tree learners (`mmlspark_tpu_torch/ml/trees.py`) against the
JAX package's, on the CPU, at small sizes with numpy seeds.

  * `bin_features`: the same bin ids; `quantile_bin_edges` the same edges.
  * `build_tree` on (n=2000, F=8, 32 bins, depth 5), plain, with a feature
    mask and with zero-weight rows: `split_feature` and `split_bin`
    identical, leaves within 1e-5 relative (they come out bit-equal: the
    histograms add rows in row order and the prefix sums in XLA's CPU
    order, `_prefix_sum`).
  * `_prefix_sum` equals `jnp.cumsum` bit for bit at 20, 32, 64 and 256
    bins.
  * Every estimator (DT / RF / GBT, classifier and regressor): the same
    trees and the same predictions; a fit repeats bit for bit; models
    saved by either package load and score in the other.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.core.pipeline import load_stage as jax_load_stage
from mmlspark_tpu.core.table import DataTable as JaxDataTable
from mmlspark_tpu.ml import trees as JT
from mmlspark_tpu_torch.core.pipeline import load_stage
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.ml import trees as PT

N, F, BINS, DEPTH = 2000, 8, 32, 5


def data(seed=0, n=N, f=F):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] + 0.3 * rng.normal(size=n) > 0)
    return X, y.astype(np.float32)


@pytest.fixture(scope="module")
def binned():
    X, y = data()
    edges = JT.quantile_bin_edges(X, BINS)
    jb = np.asarray(JT.bin_features(jnp.asarray(X), jnp.asarray(edges)))
    return X, y, edges, jb


def test_binning_matches(binned):
    X, _, edges, jb = binned
    np.testing.assert_array_equal(PT.quantile_bin_edges(X, BINS), edges)
    pb = PT.bin_features(torch.from_numpy(X), torch.from_numpy(edges))
    np.testing.assert_array_equal(pb.numpy(), jb)


@pytest.mark.parametrize("variant", ["plain", "mask", "weights"])
def test_build_tree_matches_jax(binned, variant):
    X, y, _, jb = binned
    grad = (0.5 - y).astype(np.float32)
    hess = np.full(N, 0.25, np.float32)
    mask = None
    if variant == "weights":
        w = np.random.default_rng(1).poisson(1.0, N).astype(np.float32)
        grad, hess = grad * w, hess * w
    if variant == "mask":
        mask = np.array([True, False, True, True, False, True, False, True])
    jf, jbin, jl = JT.build_tree(
        jnp.asarray(jb), jnp.asarray(grad), jnp.asarray(hess), DEPTH, BINS,
        1.0, None if mask is None else jnp.asarray(mask))
    pf, pbin, pl = PT.build_tree(
        torch.from_numpy(jb).long(), torch.from_numpy(grad),
        torch.from_numpy(hess), DEPTH, BINS, 1.0,
        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(pbin.numpy(), np.asarray(jbin))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=0)
    pred = PT.predict_tree(torch.from_numpy(jb).long(), pf, pbin, pl, DEPTH)
    jpred = JT.predict_tree(jnp.asarray(jb), jf, jbin, jl, DEPTH)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=1e-5)


@pytest.mark.parametrize("width", [20, 32, 64, 256])
def test_prefix_sum_adds_in_xlas_order(width):
    rng = np.random.default_rng(width)
    a = (rng.normal(size=(40, width))
         * 10 ** rng.uniform(-3, 3, (40, width))).astype(np.float32)
    np.testing.assert_array_equal(
        PT._prefix_sum(torch.from_numpy(a)).numpy(),
        np.asarray(jnp.cumsum(jnp.asarray(a), axis=-1)))


def classification_table(seed, classes):
    """At build_tree's test shapes (N x F, depth 5, 32 bins), so the JAX
    side reuses its compiled programs."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, F)).astype(np.float32)
    score = X[:, 0] + X[:, 1] * X[:, 2] + 0.5 * rng.normal(size=N)
    y = np.digitize(score, np.quantile(score, np.linspace(
        0, 1, classes + 1)[1:-1])).astype(np.float64)
    return X, y


ESTIMATORS = {
    "DecisionTreeClassifier": (dict(maxDepth=DEPTH), 3),
    "RandomForestClassifier": (dict(numTrees=6, maxDepth=DEPTH, seed=3), 3),
    "GBTClassifier": (dict(maxIter=6, maxDepth=DEPTH), 2),
    "DecisionTreeRegressor": (dict(maxDepth=DEPTH), 0),
    "RandomForestRegressor": (dict(numTrees=6, maxDepth=DEPTH, seed=3,
                                   featureSubsetStrategy="onethird"), 0),
    "GBTRegressor": (dict(maxIter=6, maxDepth=DEPTH, stepSize=0.3), 0),
}


def fitted(name, seed=11):
    params, classes = ESTIMATORS[name]
    X, y = classification_table(seed, max(classes, 2))
    if not classes:
        y = (X[:, 0] * 2 + X[:, 3] ** 2).astype(np.float64)
    jm = getattr(JT, name)(**params).fit(
        JaxDataTable({"features": X, "label": y}))
    pm = getattr(PT, name)(device="cpu", **params).fit(
        DataTable({"features": X, "label": y}))
    return X, jm, pm


def trees_of(model):
    ensembles = (model._ensembles if hasattr(model, "_ensembles")
                 else [model._ensemble])
    return [(e.edges, e.bias, [a for t in e.trees for a in t])
            for e in ensembles]


@pytest.mark.parametrize("name", sorted(ESTIMATORS))
def test_estimators_match_jax_and_repeat(name, tmp_path):
    X, jm, pm = fitted(name)
    for (je, jbias, jt), (pe, pbias, ptr) in zip(trees_of(jm),
                                                  trees_of(pm)):
        np.testing.assert_array_equal(pe, je)
        assert jbias == pbias and len(jt) == len(ptr)
        for a, b in zip(jt, ptr):
            assert a.dtype == b.dtype
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=0)
            if a.dtype != np.float32:
                np.testing.assert_array_equal(b, a)
    col = "prediction"
    np.testing.assert_array_equal(
        pm.transform(DataTable({"features": X}))[col],
        jm.transform(JaxDataTable({"features": X}))[col])
    _, _, again = fitted(name)
    for (_, _, a), (_, _, b) in zip(trees_of(pm), trees_of(again)):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    # across packages, both ways
    jm.save(str(tmp_path / "jax"))
    loaded = load_stage(str(tmp_path / "jax"), device="cpu")
    np.testing.assert_array_equal(
        loaded.transform(DataTable({"features": X}))[col],
        jm.transform(JaxDataTable({"features": X}))[col])
    pm.save(str(tmp_path / "port"))
    back = jax_load_stage(str(tmp_path / "port"))
    assert type(back) is type(jm)
    np.testing.assert_array_equal(
        back.transform(JaxDataTable({"features": X}))[col],
        pm.transform(DataTable({"features": X}))[col])


def test_multiclass_gbt_is_refused_as_in_jax():
    X, y = classification_table(2, 3)
    with pytest.raises(ValueError, match="Multiclass GBTClassifier"):
        PT.GBTClassifier(device="cpu").fit(
            DataTable({"features": X, "label": y}))
