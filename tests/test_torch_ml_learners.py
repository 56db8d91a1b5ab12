"""The port's learners (`mmlspark_tpu_torch/ml/learners.py`) against the
JAX package's, on the CPU, at small sizes with numpy seeds.

  * L-BFGS (`LogisticRegression`, regParam 0.01 and 0): weights within
    1e-4 of max |w| of the JAX fit; at regParam 0.01 the same iteration
    count.
  * One-vs-rest: every lane of the port's one-loop fit bit-equal to that
    class's own serial fit, and within 1e-4 of the JAX fit.
  * LinearRegression on a collinear table (a one-hot family summing to
    the intercept) within 1e-4 of `jnp.linalg.lstsq`'s solution; on a tall
    table where `jnp.linalg.lstsq`'s eps * max(m, n) cutoff drops a real
    direction, the port keeps it and meets float64 numpy's minimum-norm
    solution (the port difference of the module docstring).
  * NaiveBayes parameters within 1e-6 relative.
  * Models saved by either package load and score in the other.

The JAX L-BFGS calls run inside `jax_quiet()`: the JAX package reads
`optax.tree_utils.tree_l2_norm` as the default of a `getattr`
(`mmlspark_tpu/ml/learners.py`), which warns with this optax, and the
suite's settings turn that one DeprecationWarning into an error.
"""

import contextlib
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mmlspark_tpu.core.pipeline import load_stage as jax_load_stage
from mmlspark_tpu.core.table import DataTable as JaxDataTable
from mmlspark_tpu.ml import learners as J
from mmlspark_tpu_torch.core.pipeline import load_stage
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.ml import learners as P

CPU = torch.device("cpu")
LR_CASES = [(300, 5, 0.01, 0), (400, 8, 0.0, 2)]


@contextlib.contextmanager
def jax_quiet():
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message="optax.tree_utils.tree_l2_norm is deprecated")
        yield


def jax_lbfgs_count(X, y, reg, max_iter=100, tol=1e-6):
    """The JAX package's `run_lbfgs` loop over its logistic objective,
    returning the L-BFGS state's iteration count."""
    Xj, yj = jnp.asarray(X), jnp.asarray(y)

    def loss(params):
        w, b = params
        z = Xj @ w + b
        return (optax.sigmoid_binary_cross_entropy(z, yj).mean()
                + 0.5 * reg * jnp.sum(w * w))

    opt = optax.lbfgs()
    value_and_grad = optax.value_and_grad_from_state(loss)

    def step(carry):
        params, state = carry
        value, grad = value_and_grad(params, state=state)
        updates, state = opt.update(grad, state, params, value=value,
                                    grad=grad, value_fn=loss)
        return optax.apply_updates(params, updates), state

    def cont(carry):
        _, state = carry
        count = optax.tree_utils.tree_get(state, "count")
        err = optax.tree_utils.tree_norm(
            optax.tree_utils.tree_get(state, "grad"))
        return (count == 0) | ((count < max_iter) & (err >= tol))

    init = (jnp.zeros((X.shape[1],), jnp.float32),
            jnp.zeros((), jnp.float32))
    _, state = jax.jit(lambda p: jax.lax.while_loop(
        cont, step, (p, opt.init(p))))(init)
    return int(optax.tree_utils.tree_get(state, "count"))


def lr_data(n, d, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X @ rng.normal(size=d) + rng.normal(size=n) > 0).astype(np.float32)
    return X, y


def collinear_table(n=240, seed=7):
    """Two numeric columns and a 4-level one-hot family (the featurized
    shape of a categorical column: its columns sum to the intercept)."""
    rng = np.random.default_rng(seed)
    level = rng.integers(0, 4, n)
    onehot = np.eye(4, dtype=np.float32)[level]
    X = np.concatenate([rng.normal(size=(n, 2)).astype(np.float32) * 3,
                        onehot], axis=1)
    y = (X[:, 0] * 1.5 - X[:, 1] + np.array([4., -2., 6., 0.])[level]
         + rng.normal(0, 0.5, n)).astype(np.float32)
    return X, y


def _jax_lr(X, y, reg):
    with jax_quiet():
        w, b = J._fit_binary_lr(jnp.asarray(X), jnp.asarray(y), reg, 100,
                                1e-6, True)
        return np.asarray(w), float(b)


def _jax_ovr(X, Y):
    with jax_quiet():
        w, b = J._fit_binary_lr_multi(jnp.asarray(X), jnp.asarray(Y), 0.01,
                                      100, 1e-6, True)
        return np.asarray(w), np.asarray(b)


def _jax_saved_models(out):
    """JAX models to save: the two L-BFGS ones built from the reference
    fits (no further compile), naive Bayes and linear regression fitted."""
    X5, y5 = lr_data(*LR_CASES[0][:2], LR_CASES[0][3])
    X6, _ = lr_data(360, 6, 11)
    labels = np.argmax(X6[:, :3], axis=1).astype(np.float64)
    w, b = out["ovr"]
    return {
        "lr": (J.LogisticRegressionModel(*out["lr"][LR_CASES[0][3]]), X5),
        "ovr": (J.OneVsRestModel([J.LogisticRegressionModel(w[k], b[k])
                                  for k in range(len(w))]), X6),
        "nb": (J.NaiveBayes().fit(JaxDataTable(
            {"features": np.abs(X6), "label": labels})), X6),
        "linreg": (J.LinearRegression().fit(JaxDataTable(
            {"features": X5, "label": y5})), X5),
    }


@pytest.fixture(scope="module")
def ref():
    """Every JAX result, computed once on threads (each L-BFGS shape is a
    compile of its own)."""
    jobs = {}
    with ThreadPoolExecutor(4) as pool:
        for n, d, reg, seed in LR_CASES:
            X, y = lr_data(n, d, seed)
            jobs[("lr", seed)] = pool.submit(_jax_lr, X, y, reg)
            if reg:
                jobs[("count", seed)] = pool.submit(jax_lbfgs_count, X, y,
                                                    reg)
        X, _ = lr_data(360, 6, 11)
        Y = np.stack([(X[:, k] > 0).astype(np.float32) for k in range(3)])
        jobs["ovr"] = pool.submit(_jax_ovr, X, Y)
        out = {"lr": {}, "count": {}}
        for key, job in jobs.items():
            if isinstance(key, tuple):
                out[key[0]][key[1]] = job.result()
            else:
                out[key] = job.result()
    X, y = collinear_table()
    w, b = J._solve_ridge(jnp.asarray(X), jnp.asarray(y), 0.0, True)
    out["ridge"] = (np.asarray(w), float(b))
    w, b = J._solve_ridge(jnp.asarray(X), jnp.asarray(y), 0.05, True)
    out["ridge_reg"] = (np.asarray(w), float(b))
    out["saved"] = _jax_saved_models(out)
    return out


@pytest.mark.parametrize("case", LR_CASES, ids=lambda c: f"n{c[0]}d{c[1]}")
def test_lbfgs_matches_optax(ref, case):
    n, d, reg, seed = case
    X, y = lr_data(n, d, seed)
    w, b, count = P._fit_lr_lanes(X, y[None], reg, 100, 1e-6, True, CPU)
    jw, jb = ref["lr"][seed]
    scale = np.abs(jw).max()
    print(f"n {n} d {d} reg {reg}: |dw| {np.abs(w[0] - jw).max() / scale:.2e}"
          f" of max |w|, iterations {count[0]} (JAX "
          f"{ref['count'].get(seed, '-')})")
    assert np.abs(w[0] - jw).max() <= 1e-4 * scale
    assert abs(b[0] - jb) <= 1e-4 * max(scale, abs(jb))
    if reg:
        assert int(count[0]) == ref["count"][seed]


def test_one_vs_rest_lanes_equal_serial_fits_and_jax(ref):
    X, _ = lr_data(360, 6, 11)
    Y = np.stack([(X[:, k] > 0).astype(np.float32) for k in range(3)])
    w, b, count = P._fit_lr_lanes(X, Y, 0.01, 100, 1e-6, True, CPU)
    for k in range(3):
        sw, sb, sc = P._fit_lr_lanes(X, Y[k:k + 1], 0.01, 100, 1e-6, True,
                                     CPU)
        assert np.array_equal(sw[0], w[k]) and sb[0] == b[k]
        assert sc[0] == count[k]
    jw, jb = ref["ovr"]
    assert np.abs(w - jw).max() <= 1e-4 * np.abs(jw).max()
    assert np.abs(b - jb).max() <= 1e-4 * np.abs(jw).max()
    # the estimator takes the lane path and keeps each lane's count
    labels = np.argmax(X[:, :3], axis=1).astype(np.float64)
    model = P.OneVsRest(P.LogisticRegression(device="cpu")).fit(
        DataTable({"features": X, "label": labels}))
    assert len(model._models) == 3
    assert all(m.iterations >= 1 for m in model._models)


def test_linear_regression_on_collinear_table_matches_jnp_lstsq(ref):
    X, y = collinear_table()
    for key, reg in (("ridge", 0.0), ("ridge_reg", 0.05)):
        w, b = P.solve_ridge(torch.from_numpy(X), torch.from_numpy(y), reg,
                             True)
        jw, jb = ref[key]
        scale = np.abs(jw).max()
        assert np.abs(w.numpy() - jw).max() <= 1e-4 * scale, key
        assert abs(float(b) - jb) <= 1e-4 * max(scale, abs(jb)), key


def test_linear_regression_keeps_directions_the_jax_cutoff_drops():
    """A tall table whose smallest real direction lies below eps * max(m,
    n) * s[0]: `jnp.linalg.lstsq` drops it, the port keeps it and meets
    float64 numpy's minimum-norm solution."""
    rng = np.random.default_rng(3)
    n = 4000
    X = np.stack([rng.normal(0, 1000, n), rng.normal(0, 1, n),
                  rng.normal(0, 0.2, n)], 1).astype(np.float32)
    y = (X @ np.array([0.01, 2.0, -3.0]) + rng.normal(0, 0.1, n)).astype(
        np.float32)
    x64 = X.astype(np.float64)
    ref = np.linalg.lstsq(x64 - x64.mean(0), y - y.mean(), rcond=None)[0]
    w, _ = P.solve_ridge(torch.from_numpy(X), torch.from_numpy(y), 0.0, True)
    jw, _ = J._solve_ridge(jnp.asarray(X), jnp.asarray(y), 0.0, True)
    scale = np.abs(ref).max()
    assert np.abs(w.numpy() - ref).max() <= 1e-4 * scale
    assert np.abs(np.asarray(jw) - ref).max() > 0.1 * scale


def test_naive_bayes_matches_jax():
    rng = np.random.default_rng(5)
    X = rng.poisson(2.0, size=(300, 10)).astype(np.float32)
    y = rng.integers(0, 3, 300).astype(np.float64)
    jm = J.NaiveBayes().fit(JaxDataTable({"features": X, "label": y}))
    pm = P.NaiveBayes(device="cpu").fit(
        DataTable({"features": X, "label": y}))
    np.testing.assert_allclose(pm.log_prob, jm.log_prob, rtol=1e-6)
    np.testing.assert_allclose(pm.log_prior, jm.log_prior, rtol=1e-6)
    raw, prob, pred = pm._score(X)
    jraw, jprob, jpred = jm._score(X)
    np.testing.assert_array_equal(pred, jpred)
    np.testing.assert_allclose(prob, jprob, rtol=1e-5, atol=1e-7)


def test_mlp_estimator_builds_the_jax_trainer_config():
    X, y = lr_data(50, 7, 9)
    table = {"features": X, "label": y.astype(np.float64)}
    est_args = dict(layers=[-1, 16, 3], maxIter=5, stepSize=0.01, seed=4)
    _, _, pcfg = P.MultilayerPerceptronClassifier(
        device="cpu", **est_args)._fit_inputs(DataTable(table))
    _, _, jcfg = J.MultilayerPerceptronClassifier(
        **est_args)._fit_inputs(JaxDataTable(table))
    for field in ("architecture", "model_config", "optimizer",
                  "learning_rate", "epochs", "batch_size", "loss", "seed"):
        assert getattr(pcfg, field) == getattr(jcfg, field), field
    model, report = P.MultilayerPerceptronClassifier(
        device="cpu", **est_args).fit_population(DataTable(table),
                                                 [0.1, 0.01])
    assert report.num_rows == 2
    assert list(report["learning_rate"]) == [0.1, 0.01]
    best = int(np.argmax(report["accuracy"]))
    assert model._bundle.metadata["sweep"] == {
        "member": best, "population": 2, "learning_rate": [0.1, 0.01][best]}


def test_models_load_and_score_across_packages(ref, tmp_path):
    for name, (jm, X) in ref["saved"].items():
        jm.save(str(tmp_path / f"jax_{name}"))
        pm = load_stage(str(tmp_path / f"jax_{name}"), device="cpu")
        assert type(pm).__module__.startswith("mmlspark_tpu_torch.ml")
        col = "prediction"
        np.testing.assert_array_equal(
            pm.transform(DataTable({"features": X}))[col],
            jm.transform(JaxDataTable({"features": X}))[col])
        pm.save(str(tmp_path / f"port_{name}"))
        back = jax_load_stage(str(tmp_path / f"port_{name}"))
        assert type(back) is type(jm)
        np.testing.assert_array_equal(
            back.transform(JaxDataTable({"features": X}))[col],
            jm.transform(JaxDataTable({"features": X}))[col])


def test_learners_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (P.LogisticRegression, P.LinearRegression, P.NaiveBayes,
                 lambda: P.MultilayerPerceptronClassifier(layers=[-1, 2])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
