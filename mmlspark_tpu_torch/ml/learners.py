"""Learners with SparkML-shaped contracts (the port of
`mmlspark_tpu/ml/learners.py`).

The reference trains through Spark MLlib estimators (LogisticRegression,
MultilayerPerceptronClassifier, NaiveBayes, linear regressors, dispatched
in TrainClassifier.scala:74-129).  Here each learner is a torch program on
the stage's device (the card unless `device="cpu"`): full-batch L-BFGS for
logistic regression, the port's `Trainer` for the MLP, an SVD solve for
linear regression and one matmul for naive Bayes.  No hand-written kernel
lies on this path: the JAX package leaves all of it to XLA.

  * **L-BFGS** is `optax.lbfgs()` with its defaults, carried as torch
    algebra (`LBFGSLanes`): memory 10, the scaled initial preconditioner,
    and the zoom line search (at most 20 steps, initial guess 1, the
    default decrease / curvature tolerances), under the JAX package's stop
    rule (`count == 0 | (count < maxIter & |grad| >= tol)`).  The weights,
    not only the metrics, follow the JAX package's.
  * **One-vs-rest** fits every class as one lane of the same loop.  A lane
    freezes once its own stop rule holds, as a lane of `jax.vmap` over a
    `while_loop` does, so each lane equals its own serial fit.
  * **Linear regression** is the minimum-norm least-squares solution by
    SVD (`torch.linalg.lstsq` on CUDA takes only `gels`, which assumes
    full rank, and featurized one-hot families are collinear with the
    intercept).  Port difference: singular values below
    `eps · min(m, n) · s[0]` are dropped, where `jnp.linalg.lstsq` drops
    those below `eps · max(m, n) · s[0]`; on a tall table that cutoff grows
    with the row count (0.06 · s[0] at 500,000 rows) and discards real
    directions.
  * float32 stays float32 on the card: the fits and the scoring matmuls run
    under `core.device.exact_f32()`.

Host-side numpy parts stay on the host, as in the JAX package: the
feature matrix, the class priors, the scoring products the JAX package
computes in numpy.  Output columns follow SparkML: `rawPrediction`,
`probability`, `prediction` for classifiers; `prediction` for regressors.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from mmlspark_tpu_torch.core.device import exact_f32, resolve_device
from mmlspark_tpu_torch.core.params import Param, ParamError
from mmlspark_tpu_torch.core.pipeline import (Estimator, JaxTwin,
                                              Transformer, load_stage)
from mmlspark_tpu_torch.core.table import DataTable

def _features_matrix(col: np.ndarray) -> np.ndarray:
    if col.dtype == object:
        return (np.stack([np.asarray(v, np.float32).ravel() for v in col])
                if len(col) else np.zeros((0, 1), np.float32))
    arr = col.astype(np.float32)
    return arr[:, None] if arr.ndim == 1 else arr.reshape(len(arr), -1)


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def _sigmoid(z: np.ndarray, device) -> np.ndarray:
    with torch.inference_mode():
        return torch.sigmoid(_to_device(z, device)).cpu().numpy()


def _softmax(raw: np.ndarray, device) -> np.ndarray:
    with torch.inference_mode():
        return torch.softmax(_to_device(raw, device), dim=1).cpu().numpy()


# --------------------------------------------------------------------------
# L-BFGS with the zoom line search (optax.lbfgs() as torch algebra), over
# K independent lanes of (w (K, d), b (K,)) parameters.
# --------------------------------------------------------------------------

MEMORY = 10
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL, CURV_RTOL, APPROX_DEC_RTOL = 1e-4, 0.9, 1e-6
INCREASE_FACTOR, INTERVAL_THRESHOLD = 2.0, 1e-5


def _lane_sum(t: torch.Tensor) -> torch.Tensor:
    """Each lane's sum over its last axis, one lane at a time: a reduction
    over a (K, d) tensor may order a row's terms otherwise than over the
    lane alone (CUDA picks its reduction plan from the whole shape), and a
    lane must equal its serial fit."""
    return torch.stack([t[k].sum() for k in range(len(t))])


def _vdot(a, b):
    return _lane_sum(a[0] * b[0]) + a[1] * b[1]


def _add_scale(x, s, y):
    return (x[0] + s[:, None] * y[0], x[1] + s * y[1])


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1])


def _where(mask, a, b):
    """Lane-wise select of a tree (or a lane tensor) by a (K,) mask."""
    if isinstance(a, tuple):
        return tuple(_where(mask, x, y) for x, y in zip(a, b))
    m = mask.view(-1, *([1] * (a.dim() - 1)))
    return torch.where(m, a, b)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    c_ = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    e0, e1 = fb - fa - c_ * db, fc - fa - c_ * dc
    big_a = (dc ** 2 * e0 + (-(db ** 2)) * e1) / denom
    big_b = ((-(dc ** 3)) * e0 + db ** 3 * e1) / denom
    radical = big_b * big_b - 3.0 * big_a * c_
    return a + (-big_b + torch.sqrt(radical)) / (3.0 * big_a)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    big_b = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * big_b)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    dec = value - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope - (2 * SLOPE_RTOL - 1.0) * slope_init
    delta_values = value - value_init - APPROX_DEC_RTOL * value_init.abs()
    dec = torch.minimum(torch.maximum(approx, delta_values), dec)
    dec = torch.clamp_min(dec, 0.0)
    return torch.where(dec.isnan(), torch.full_like(dec, float("inf")), dec)


def _curvature_error(slope, slope_init):
    curv = torch.clamp_min(slope.abs() - CURV_RTOL * slope_init.abs(), 0.0)
    return torch.where(curv.isnan(), torch.full_like(curv, float("inf")),
                       curv)


class LBFGSLanes:
    """Minimise K objectives over (w, b) lanes with optax's L-BFGS and zoom
    line search, each lane stopping by its own rule (module docstring).

    `value_and_grad(params) -> (value (K,), grad tree)` evaluates every
    lane at once.  `run()` returns the parameters and each lane's
    iteration count."""

    def __init__(self, value_and_grad, k: int, d: int, device,
                 max_iter: int, tol: float):
        self.value_and_grad = value_and_grad
        self.k, self.d, self.device = k, d, device
        self.max_iter, self.tol = int(max_iter), float(tol)

    def _zeros(self, *lead):
        return (torch.zeros(*lead, self.k, self.d, device=self.device),
                torch.zeros(*lead, self.k, device=self.device))

    def _precondition(self, grad, dw_mem, du_mem, rho, scale, memory_idx):
        """The two-loop product of optax's `_precondition_by_lbfgs`."""
        vec, alphas = grad, []
        rows = torch.arange(self.k, device=self.device)
        # per lane the ring starts at its own memory index
        idx = (memory_idx[None, :]
               + torch.arange(MEMORY, device=self.device)[:, None]) % MEMORY
        for j in reversed(range(MEMORY)):
            i = idx[j]
            dwi = (dw_mem[0][i, rows], dw_mem[1][i, rows])
            dui = (du_mem[0][i, rows], du_mem[1][i, rows])
            alpha = rho[i, rows] * _vdot(dwi, vec)
            vec = _add_scale(vec, -alpha, dui)
            alphas.append(alpha)
        alphas.reverse()
        vec = (scale[:, None] * vec[0], scale * vec[1])
        for j in range(MEMORY):
            i = idx[j]
            dwi = (dw_mem[0][i, rows], dw_mem[1][i, rows])
            dui = (du_mem[0][i, rows], du_mem[1][i, rows])
            beta = rho[i, rows] * _vdot(dui, vec)
            vec = _add_scale(vec, alphas[j] - beta, dwi)
        return vec

    def _linesearch(self, params, updates, value, grad, live):
        """optax's zoom line search from stepsize guess 1 on every live
        lane; returns (stepsize, value, grad) at the accepted step."""
        f32 = dict(device=self.device, dtype=torch.float32)
        k = self.k
        zero = torch.zeros(k, **f32)
        inf = torch.full((k,), float("inf"), **f32)
        false = torch.zeros(k, dtype=torch.bool, device=self.device)
        slope = _vdot(updates, grad)
        s = dict(count=torch.zeros(k, dtype=torch.int32, device=self.device),
                 stepsize=zero, value=value, grad=grad, slope=slope,
                 decrease_error=inf, curvature_error=inf,
                 interval_found=false, done=false, failed=false,
                 low=zero, value_low=value, slope_low=slope,
                 high=zero, value_high=value, slope_high=slope,
                 cubic_ref=zero, value_cubic_ref=value,
                 safe_stepsize=zero, safe_value=value, safe_grad=grad)
        value_init, slope_init = value, slope
        while True:
            running = live & ~(s["done"] | s["failed"])
            if not bool(running.any()):
                break
            found, count = s["interval_found"], s["count"]
            low, high = s["low"], s["high"]
            # the search-interval branch's trial step
            new_stepsize = torch.where(count == 0, torch.ones_like(zero),
                                       INCREASE_FACTOR * s["stepsize"])
            # the zoom branch's trial step
            delta = (high - low).abs()
            left, right = torch.minimum(high, low), torch.maximum(high, low)
            cubic_chk, quad_chk = 0.2 * delta, 0.1 * delta
            too_small = delta <= INTERVAL_THRESHOLD
            m_cubic = _cubicmin(low, s["value_low"], s["slope_low"], high,
                                s["value_high"], s["cubic_ref"],
                                s["value_cubic_ref"])
            use_cubic = (m_cubic > left + cubic_chk) & (
                m_cubic < right - cubic_chk)
            m_quad = _quadmin(low, s["value_low"], s["slope_low"], high,
                              s["value_high"])
            use_quad = ~use_cubic & (m_quad > left + quad_chk) & (
                m_quad < right - quad_chk)
            use_bisect = ~use_cubic & ~use_quad
            middle = torch.where(use_cubic, m_cubic, s["cubic_ref"])
            middle = torch.where(use_quad, m_quad, middle)
            middle = torch.where(use_bisect, (low + high) / 2.0, middle)
            t = torch.where(found, middle, new_stepsize)

            v_t, g_t = self.value_and_grad(_add_scale(params, t, updates))
            sl_t = _vdot(g_t, updates)
            dec = _decrease_error(t, v_t, sl_t, value_init, slope_init)
            curv = _curvature_error(sl_t, slope_init)
            err = torch.maximum(dec, curv)
            safe_dec = dec <= 0.0
            done = err <= 0.0

            # search-interval branch (`_search_interval`)
            prev_t, prev_v, prev_sl = s["stepsize"], s["value"], s["slope"]
            up_safe_s = safe_dec
            hi_new = (dec > 0.0) | ((v_t >= prev_v) & (count > 0))
            lo_new = (sl_t >= 0.0) & ~hi_new
            s_low = torch.where(lo_new, t, prev_t)
            s_vlow = torch.where(lo_new, v_t, prev_v)
            s_slow = torch.where(lo_new, sl_t, prev_sl)
            s_high = torch.where(lo_new, prev_t, t)
            s_vhigh = torch.where(lo_new, prev_v, v_t)
            s_shigh = torch.where(lo_new, prev_sl, sl_t)
            s_found = hi_new | lo_new | done
            s_failed = ((count + 1) >= MAX_LINESEARCH_STEPS) & ~done

            # zoom branch (`_zoom_into_interval`)
            up_safe_z = safe_dec & (v_t < s["safe_value"])
            hi_mid = (dec > 0.0) | (v_t >= s["value_low"])
            hi_low = (sl_t * (high - low) >= 0.0) & ~hi_mid
            lo_mid = ~hi_mid
            z_high = torch.where(hi_mid, t, high)
            z_vhigh = torch.where(hi_mid, v_t, s["value_high"])
            z_shigh = torch.where(hi_mid, sl_t, s["slope_high"])
            z_high = torch.where(hi_low, low, z_high)
            z_vhigh = torch.where(hi_low, s["value_low"], z_vhigh)
            z_shigh = torch.where(hi_low, s["slope_low"], z_shigh)
            z_low = torch.where(lo_mid, t, low)
            z_vlow = torch.where(lo_mid, v_t, s["value_low"])
            z_slow = torch.where(lo_mid, sl_t, s["slope_low"])
            moved_high = hi_mid | hi_low
            z_cref = torch.where(moved_high, high, low)
            z_vcref = torch.where(moved_high, s["value_high"],
                                  s["value_low"])

            up_safe = torch.where(found, up_safe_z, up_safe_s)
            new_safe_step = torch.where(up_safe, t, s["safe_stepsize"])
            z_failed = (((count + 1) >= MAX_LINESEARCH_STEPS)
                        | (too_small & (new_safe_step > 0.0))) & ~done
            new = dict(
                count=count + 1, stepsize=t, value=v_t, grad=g_t,
                slope=sl_t, decrease_error=dec, curvature_error=curv,
                interval_found=torch.where(found, found, s_found),
                done=done, failed=torch.where(found, z_failed, s_failed),
                low=torch.where(found, z_low, s_low),
                value_low=torch.where(found, z_vlow, s_vlow),
                slope_low=torch.where(found, z_slow, s_slow),
                high=torch.where(found, z_high, s_high),
                value_high=torch.where(found, z_vhigh, s_vhigh),
                slope_high=torch.where(found, z_shigh, s_shigh),
                cubic_ref=torch.where(found, z_cref, s_low),
                value_cubic_ref=torch.where(found, z_vcref, s_vlow),
                safe_stepsize=new_safe_step,
                safe_value=torch.where(up_safe, v_t, s["safe_value"]),
                safe_grad=_where(up_safe, g_t, s["safe_grad"]))
            # `_try_safe_step` on the lanes that failed
            take_safe = new["failed"] & ((new["safe_stepsize"] > 0.0)
                                         | new["decrease_error"].isinf())
            new["stepsize"] = torch.where(take_safe, new["safe_stepsize"],
                                          new["stepsize"])
            new["value"] = torch.where(take_safe, new["safe_value"],
                                       new["value"])
            new["grad"] = _where(take_safe, new["safe_grad"], new["grad"])
            s = {key: _where(running, new[key], s[key]) for key in s}
        return s["stepsize"], s["value"], s["grad"]

    def run(self):
        k, dev = self.k, self.device
        f32 = dict(device=dev, dtype=torch.float32)
        params = self._zeros()
        count = torch.zeros(k, dtype=torch.int32, device=dev)
        prev_params, prev_grad = self._zeros(), self._zeros()
        dw_mem, du_mem = self._zeros(MEMORY), self._zeros(MEMORY)
        rho = torch.zeros(MEMORY, k, **f32)
        ls_value = torch.full((k,), float("inf"), **f32)
        ls_grad = self._zeros()
        rows = torch.arange(k, device=dev)
        while True:
            grad_norm = torch.sqrt(_vdot(ls_grad, ls_grad))
            live = (count == 0) | ((count < self.max_iter)
                                   & (grad_norm >= self.tol))
            if not bool(live.any()):
                break
            # value_and_grad_from_state: reuse the line search's value and
            # gradient at the current parameters when they are finite
            fresh = ~torch.isfinite(ls_value)
            if bool((fresh & live).any()):
                v0, g0 = self.value_and_grad(params)
                value = torch.where(fresh, v0, ls_value)
                grad = _where(fresh, g0, ls_grad)
            else:
                value, grad = ls_value, ls_grad
            # scale_by_lbfgs: the memory, then the preconditioned direction
            memory_idx = (count % MEMORY).long()
            prev_idx = ((count - 1) % MEMORY).long()
            dp, du = _sub(params, prev_params), _sub(grad, prev_grad)
            dot = _vdot(du, dp)
            weight = torch.where(dot == 0.0, torch.zeros_like(dot), 1.0 / dot)
            first = count == 0
            dp = _where(first, (torch.zeros_like(dp[0]),
                                torch.zeros_like(dp[1])), dp)
            du = _where(first, (torch.zeros_like(du[0]),
                                torch.zeros_like(du[1])), du)
            weight = torch.where(first, torch.zeros_like(weight), weight)
            dw_mem = (dw_mem[0].index_put((prev_idx, rows), dp[0]),
                      dw_mem[1].index_put((prev_idx, rows), dp[1]))
            du_mem = (du_mem[0].index_put((prev_idx, rows), du[0]),
                      du_mem[1].index_put((prev_idx, rows), du[1]))
            rho = rho.index_put((prev_idx, rows), weight)
            numerator, denominator = _vdot(du, dp), _vdot(du, du)
            scale = torch.where(denominator > 0.0, numerator / denominator,
                                torch.ones_like(numerator))
            capped = torch.clamp_max(1.0 / torch.sqrt(_vdot(grad, grad)),
                                     1.0)
            scale = torch.where(count > 0, scale, capped)
            precond = self._precondition(grad, dw_mem, du_mem, rho, scale,
                                         memory_idx)
            updates = (-precond[0], -precond[1])
            step, v_new, g_new = self._linesearch(params, updates, value,
                                                  grad, live)
            new_params = _add_scale(params, step, updates)
            # a lane whose rule stopped it keeps its state (vmap's select)
            prev_params = _where(live, params, prev_params)
            prev_grad = _where(live, grad, prev_grad)
            params = _where(live, new_params, params)
            ls_value = torch.where(live, v_new, ls_value)
            ls_grad = _where(live, g_new, ls_grad)
            count = torch.where(live, count + 1, count)
        return params, count


def _logistic_lanes(X: torch.Tensor, Y: torch.Tensor, reg: float,
                    fit_intercept: bool):
    """value_and_grad of the K binary logistic objectives (mean sigmoid
    cross-entropy + reg/2 |w|^2), Y (K, n).  Each lane is evaluated on
    its own tensors: a product, a reduction or a vectorised exp over a
    (K, n) block rounds a lane's terms otherwise than over the lane
    alone, and a lane must equal its serial fit."""
    n = X.shape[0]

    def one(w, b, y):
        z = X @ w
        if fit_intercept:
            z = z + b
        loss = -y * F.logsigmoid(z) - (1.0 - y) * F.logsigmoid(-z)
        value = loss.mean() + 0.5 * reg * (w * w).sum()
        gz = ((1.0 - y) * torch.sigmoid(z) - y * torch.sigmoid(-z)) / n
        gw = gz @ X + reg * w
        gb = gz.sum() if fit_intercept else torch.zeros_like(b)
        return value, gw, gb

    def value_and_grad(params):
        w, b = params
        value, gw, gb = zip(*(one(w[k], b[k], Y[k]) for k in range(len(w))))
        return torch.stack(value), (torch.stack(gw), torch.stack(gb))

    return value_and_grad


def _fit_lr_lanes(X: np.ndarray, Y: np.ndarray, reg: float, max_iter: int,
                  tol: float, fit_intercept: bool, device):
    """All K binary fits of Y (K, n) on one feature matrix; returns w
    (K, d), b (K,) and each lane's iteration count, on the host."""
    with torch.inference_mode(), exact_f32():
        Xd = _to_device(X.astype(np.float32), device)
        Yd = _to_device(Y.astype(np.float32), device)
        solver = LBFGSLanes(_logistic_lanes(Xd, Yd, reg, fit_intercept),
                            Yd.shape[0], Xd.shape[1], device, max_iter, tol)
        (w, b), count = solver.run()
        if not fit_intercept:
            b = torch.zeros_like(b)
        return w.cpu().numpy(), b.cpu().numpy(), count.cpu().numpy()


# --------------------------------------------------------------------------
# Classifier model base: transform() contract
# --------------------------------------------------------------------------

class ClassifierModel(JaxTwin, Transformer):
    """Adds rawPrediction / probability / prediction columns."""

    featuresCol = Param("features", "features column", ptype=str)
    rawPredictionCol = Param("rawPrediction", "margins output", ptype=str)
    probabilityCol = Param("probability", "probability output", ptype=str)
    predictionCol = Param("prediction", "label-index output", ptype=str)

    def __init__(self, device="cuda", **kw):
        super().__init__(**kw)
        self.device = resolve_device(device)

    @property
    def num_classes(self) -> int:
        raise NotImplementedError

    def _score(self, X: np.ndarray) -> tuple:
        """(raw, probability, prediction) for a dense feature matrix."""
        raise NotImplementedError

    def transform(self, table: DataTable) -> DataTable:
        X = _features_matrix(table[self.featuresCol])
        raw, prob, pred = self._score(X)
        out = table.with_column(self.rawPredictionCol, np.asarray(raw))
        out = out.with_column(self.probabilityCol, np.asarray(prob))
        return out.with_column(self.predictionCol,
                               np.asarray(pred, np.float64))


class RegressorModel(JaxTwin, Transformer):
    featuresCol = Param("features", "features column", ptype=str)
    predictionCol = Param("prediction", "prediction output", ptype=str)

    def __init__(self, device="cuda", **kw):
        super().__init__(**kw)
        self.device = resolve_device(device)

    def _predict(self, X: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def transform(self, table: DataTable) -> DataTable:
        X = _features_matrix(table[self.featuresCol])
        return table.with_column(self.predictionCol,
                                 np.asarray(self._predict(X), np.float64))


class _DeviceEstimator(JaxTwin, Estimator):
    """An estimator whose fit runs on `device` (a run-time setting, not a
    Param; its models score there too)."""

    def __init__(self, device="cuda", **kw):
        super().__init__(**kw)
        self.device = resolve_device(device)


# --------------------------------------------------------------------------
# Logistic regression (binary)
# --------------------------------------------------------------------------

class LogisticRegressionModel(ClassifierModel):
    def __init__(self, w: Optional[np.ndarray] = None, b: float = 0.0,
                 device="cuda", **kw):
        super().__init__(device=device, **kw)
        self.w = np.asarray(w, np.float32) if w is not None else None
        self.b = float(b)
        self.iterations: Optional[int] = None

    @property
    def num_classes(self) -> int:
        return 2

    def _score(self, X):
        z = X @ self.w + self.b
        p = _sigmoid(z, self.device)
        raw = np.stack([-z, z], axis=1)
        prob = np.stack([1.0 - p, p], axis=1)
        return raw, prob, (p > 0.5).astype(np.float64)

    def _save_extra(self, path):
        np.savez(os.path.join(path, "coef.npz"), w=self.w, b=self.b)

    def _load_extra(self, path, **_init_kwargs):
        d = np.load(os.path.join(path, "coef.npz"))
        self.w, self.b = d["w"], float(d["b"])


class LogisticRegression(_DeviceEstimator):
    """Binary logistic regression (Spark's LogisticRegression counterpart;
    multiclass goes through OneVsRest as in TrainClassifier.scala:87-95)."""

    featuresCol = Param("features", "features column", ptype=str)
    labelCol = Param("label", "label column (0/1)", ptype=str)
    regParam = Param(0.0, "L2 regularization strength", ptype=float)
    maxIter = Param(100, "max L-BFGS iterations", ptype=int)
    tol = Param(1e-6, "gradient-norm convergence tolerance", ptype=float)
    fitIntercept = Param(True, "fit an intercept term", ptype=bool)

    def _fit_lanes(self, X: np.ndarray, Y: np.ndarray):
        return _fit_lr_lanes(X, Y, float(self.regParam), int(self.maxIter),
                             float(self.tol), bool(self.fitIntercept),
                             self.device)

    def fit(self, table: DataTable) -> LogisticRegressionModel:
        X = _features_matrix(table[self.featuresCol])
        y = np.asarray(table[self.labelCol], np.float32)
        w, b, count = self._fit_lanes(X, y[None, :])
        model = LogisticRegressionModel(w[0], float(b[0]),
                                        device=self.device,
                                        featuresCol=self.featuresCol)
        model.iterations = int(count[0])
        return model


class OneVsRestModel(ClassifierModel):
    def __init__(self, models: Optional[list] = None, device="cuda", **kw):
        super().__init__(device=device, **kw)
        self._models = list(models or [])

    @property
    def num_classes(self) -> int:
        return len(self._models)

    def _score(self, X):
        # column k = positive-class score of the k-th binary model
        pos = np.stack([m._score(X)[1][:, 1] for m in self._models], axis=1)
        denom = np.maximum(pos.sum(axis=1, keepdims=True), 1e-12)
        prob = pos / denom
        return pos, prob, np.argmax(pos, axis=1).astype(np.float64)

    def _save_extra(self, path):
        for i, m in enumerate(self._models):
            m.save(os.path.join(path, f"class_{i:03d}"))
        with open(os.path.join(path, "n.txt"), "w") as f:
            f.write(str(len(self._models)))

    def _load_extra(self, path, **init_kwargs):
        with open(os.path.join(path, "n.txt")) as f:
            n = int(f.read())
        self._models = [load_stage(os.path.join(path, f"class_{i:03d}"),
                                   **init_kwargs) for i in range(n)]


class OneVsRest(_DeviceEstimator):
    """Multiclass reduction over a binary classifier
    (reference TrainClassifier.scala:87-95 wraps LR in Spark's OneVsRest).
    A `LogisticRegression` base fits every class as one lane of one L-BFGS
    loop on the base's device (module docstring)."""

    featuresCol = Param("features", "features column", ptype=str)
    labelCol = Param("label", "label column (class indices)", ptype=str)

    def __init__(self, classifier: Optional[Estimator] = None,
                 device=None, **kw):
        if device is None:
            device = getattr(classifier, "device", "cuda")
        super().__init__(device=device, **kw)
        self._classifier = classifier

    def fit(self, table: DataTable) -> OneVsRestModel:
        if self._classifier is None:
            raise ParamError("OneVsRest: no base classifier set")
        y = np.asarray(table[self.labelCol], np.int64)
        n_classes = int(y.max()) + 1 if len(y) else 0
        if type(self._classifier) is LogisticRegression:
            # one lane per class.  Exact-type gate: a subclass with an
            # overridden fit() takes the generic path
            base = self._classifier
            X = _features_matrix(table[self.featuresCol])
            Y = (y[None, :] == np.arange(n_classes)[:, None]).astype(
                np.float32)
            w, b, count = base._fit_lanes(X, Y)
            models = []
            for k in range(n_classes):
                m = LogisticRegressionModel(w[k], float(b[k]),
                                            device=base.device,
                                            featuresCol=self.featuresCol)
                m.iterations = int(count[k])
                models.append(m)
            return OneVsRestModel(models, device=base.device,
                                  featuresCol=self.featuresCol)
        models = []
        for k in range(n_classes):
            binary = table.with_column(self.labelCol,
                                       (y == k).astype(np.float32))
            est = self._classifier.copy(featuresCol=self.featuresCol,
                                        labelCol=self.labelCol)
            models.append(est.fit(binary))
        return OneVsRestModel(models, device=self.device,
                              featuresCol=self.featuresCol)


# --------------------------------------------------------------------------
# Linear regression: minimum-norm least squares by SVD
# --------------------------------------------------------------------------

class LinearRegressionModel(RegressorModel):
    def __init__(self, w: Optional[np.ndarray] = None, b: float = 0.0,
                 device="cuda", **kw):
        super().__init__(device=device, **kw)
        self.w = np.asarray(w, np.float32) if w is not None else None
        self.b = float(b)

    def _predict(self, X):
        return X @ self.w + self.b

    def _save_extra(self, path):
        np.savez(os.path.join(path, "coef.npz"), w=self.w, b=self.b)

    def _load_extra(self, path, **_init_kwargs):
        d = np.load(os.path.join(path, "coef.npz"))
        self.w, self.b = d["w"], float(d["b"])


class LinearRegression(_DeviceEstimator):
    """Ridge / OLS as the minimum-norm least-squares solution, solved by
    SVD on the device in float32 (module docstring)."""

    featuresCol = Param("features", "features column", ptype=str)
    labelCol = Param("label", "target column", ptype=str)
    regParam = Param(0.0, "L2 regularization", ptype=float)
    fitIntercept = Param(True, "fit an intercept", ptype=bool)

    def fit(self, table: DataTable) -> LinearRegressionModel:
        X = _features_matrix(table[self.featuresCol])
        y = np.asarray(table[self.labelCol], np.float32)
        with torch.inference_mode(), exact_f32():
            w, b = solve_ridge(_to_device(X, self.device),
                               _to_device(y, self.device),
                               float(self.regParam),
                               bool(self.fitIntercept))
            w, b = w.cpu().numpy(), float(b)
        return LinearRegressionModel(w, b, device=self.device,
                                     featuresCol=self.featuresCol)


def lstsq_min_norm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimum-norm solution of min |a x - b| for a 2-D `a` and 1-D `b`
    by SVD, dropping singular values below eps * min(m, n) * s[0] (module
    docstring)."""
    m, n = a.shape
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    rcond = torch.finfo(a.dtype).eps * min(m, n)
    mask = (s > 0) & (s >= rcond * s[0])
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    return vt.T @ (s_inv * (u.T @ b))


def solve_ridge(X: torch.Tensor, y: torch.Tensor, reg: float,
                fit_intercept: bool):
    """Least squares on X itself, not the normal equations: squaring the
    condition number in float32 ruins the solve whenever featurization
    emits collinear blocks.  Ridge becomes sqrt(lambda) augmentation rows,
    keeping one code path."""
    if fit_intercept:
        mu_x, mu_y = X.mean(0), y.mean()
        Xc, yc = X - mu_x, y - mu_y
    else:
        Xc, yc = X, y
    d = X.shape[1]
    lam = reg * len(y)
    if lam > 0:
        Xc = torch.cat([Xc, float(np.sqrt(lam)) * torch.eye(
            d, dtype=X.dtype, device=X.device)])
        yc = torch.cat([yc, torch.zeros(d, dtype=y.dtype, device=y.device)])
    w = lstsq_min_norm(Xc, yc)
    b = (mu_y - mu_x @ w) if fit_intercept else torch.zeros((),
                                                            device=X.device)
    return w, b


# --------------------------------------------------------------------------
# Multinomial naive Bayes
# --------------------------------------------------------------------------

class NaiveBayesModel(ClassifierModel):
    def __init__(self, log_prior: Optional[np.ndarray] = None,
                 log_prob: Optional[np.ndarray] = None, device="cuda", **kw):
        super().__init__(device=device, **kw)
        self.log_prior = (np.asarray(log_prior, np.float32)
                          if log_prior is not None else None)
        self.log_prob = (np.asarray(log_prob, np.float32)
                         if log_prob is not None else None)

    @property
    def num_classes(self) -> int:
        return len(self.log_prior)

    def _score(self, X):
        raw = X @ self.log_prob.T + self.log_prior
        prob = _softmax(raw, self.device)
        return raw, prob, np.argmax(raw, axis=1).astype(np.float64)

    def _save_extra(self, path):
        np.savez(os.path.join(path, "nb.npz"),
                 log_prior=self.log_prior, log_prob=self.log_prob)

    def _load_extra(self, path, **_init_kwargs):
        d = np.load(os.path.join(path, "nb.npz"))
        self.log_prior, self.log_prob = d["log_prior"], d["log_prob"]


class NaiveBayes(_DeviceEstimator):
    """Multinomial NB with Laplace smoothing (Spark NaiveBayes counterpart;
    requires non-negative features, e.g. hashed counts)."""

    featuresCol = Param("features", "features column (non-negative)",
                        ptype=str)
    labelCol = Param("label", "label column (class indices)", ptype=str)
    smoothing = Param(1.0, "Laplace smoothing", ptype=float)

    def fit(self, table: DataTable) -> NaiveBayesModel:
        X = _features_matrix(table[self.featuresCol])
        if (X < 0).any():
            raise ValueError("NaiveBayes requires non-negative features")
        y = np.asarray(table[self.labelCol], np.int64)
        n_classes = int(y.max()) + 1 if len(y) else 0
        onehot = np.zeros((len(y), n_classes), np.float32)
        onehot[np.arange(len(y)), y] = 1.0
        with torch.inference_mode(), exact_f32():
            counts = (_to_device(onehot, self.device).T
                      @ _to_device(X, self.device))             # (C, D)
            smoothed = counts + float(self.smoothing)
            log_prob = (torch.log(smoothed)
                        - torch.log(smoothed.sum(dim=1, keepdim=True)))
            log_prob = log_prob.cpu().numpy()
        class_count = onehot.sum(axis=0)
        log_prior = np.log(np.maximum(class_count, 1e-12) / len(y))
        return NaiveBayesModel(log_prior, log_prob, device=self.device,
                               featuresCol=self.featuresCol)


# --------------------------------------------------------------------------
# Multilayer perceptron: the port's Trainer
# --------------------------------------------------------------------------

class MultilayerPerceptronClassifierModel(ClassifierModel):
    def __init__(self, bundle=None, device="cuda", **kw):
        super().__init__(device=device, **kw)
        self._bundle = bundle
        self._module = None

    @property
    def num_classes(self) -> int:
        return int(self._bundle.config["num_classes"])

    def _score(self, X):
        if self._module is None:
            self._module = self._bundle.module(self.device)
        with torch.inference_mode(), exact_f32():
            raw, _ = self._module(_to_device(X, self.device))
            prob = torch.softmax(raw, dim=1)
            raw, prob = raw.cpu().numpy(), prob.cpu().numpy()
        return raw, prob, np.argmax(raw, axis=1).astype(np.float64)

    def _save_extra(self, path):
        from mmlspark_tpu_torch.models.bundle import save_bundle
        save_bundle(self._bundle, os.path.join(path, "bundle"))

    def _load_extra(self, path, **_init_kwargs):
        from mmlspark_tpu_torch.models.bundle import load_bundle
        self._bundle = load_bundle(os.path.join(path, "bundle"))
        self._module = None


class MultilayerPerceptronClassifier(_DeviceEstimator):
    """MLP classifier (Spark's MultilayerPerceptronClassifier counterpart,
    TrainClassifier.scala:96-101).  `layers` = [in, hidden..., classes];
    the input size is autosized by TrainClassifier when left as -1."""

    featuresCol = Param("features", "features column", ptype=str)
    labelCol = Param("label", "label column (class indices)", ptype=str)
    layers = Param(None, "layer sizes [input, hidden..., output]",
                   ptype=(list, tuple), required=True)
    maxIter = Param(100, "training epochs", ptype=int)
    stepSize = Param(0.005, "learning rate", ptype=float)
    seed = Param(0, "init/shuffle seed", ptype=int)

    def _fit_inputs(self, table: DataTable):
        """(X, y, trainer config), as the JAX package builds them."""
        from mmlspark_tpu_torch.train import TrainerConfig
        self._check_required()
        layers = list(self.layers)
        if len(layers) < 2:
            raise ParamError("layers needs at least [input, output]")
        X = _features_matrix(table[self.featuresCol])
        if layers[0] in (-1, 0, None):
            layers[0] = X.shape[1]
        elif layers[0] != X.shape[1]:
            raise ParamError(
                f"layers[0]={layers[0]} != feature dim {X.shape[1]}")
        y = np.asarray(table[self.labelCol], np.int64)
        cfg = TrainerConfig(
            architecture="MLPClassifier",
            model_config={"hidden_sizes": layers[1:-1],
                          "num_classes": layers[-1], "dtype": "float32"},
            optimizer="adam", learning_rate=float(self.stepSize),
            epochs=int(self.maxIter),
            batch_size=int(min(max(len(X), 1), 4096)),
            loss="softmax_xent", seed=int(self.seed))
        return X, y, cfg

    def fit(self, table: DataTable) -> MultilayerPerceptronClassifierModel:
        from mmlspark_tpu_torch.train import Trainer
        X, y, cfg = self._fit_inputs(table)
        bundle = Trainer(cfg, device=self.device).fit_arrays(
            X, y.astype(np.int32))
        return MultilayerPerceptronClassifierModel(
            bundle, device=self.device, featuresCol=self.featuresCol)

    def fit_population(self, table: DataTable, learning_rates,
                       halving_rungs: int = 0):
        """Train one candidate per learning rate as a vmapped population
        (`train/sweep.py`), score every member with one vmapped forward
        and rank them with one `classification_report_batch`.  Returns
        (the winner's model, per-member metrics ordered like
        `learning_rates`, with `learning_rate` / `final_loss` / `active`
        columns)."""
        from mmlspark_tpu_torch.ml.statistics import \
            classification_report_batch
        from mmlspark_tpu_torch.train import PopulationTrainer
        X, y, cfg = self._fit_inputs(table)
        rates = [float(r) for r in learning_rates]
        if not rates:
            raise ParamError("fit_population needs at least one rate")
        pt = PopulationTrainer(cfg, [{"learning_rate": r} for r in rates],
                               halving_rungs=int(halving_rungs),
                               device=self.device)
        result = pt.fit_arrays(X, y.astype(np.int32))
        logits = pt.score_population(result.state, X)  # (N, rows, classes)
        preds = np.argmax(logits, axis=-1)
        report = classification_report_batch(
            y, preds, model_uids=[f"member_{k}_lr={r:g}"
                                  for k, r in enumerate(rates)])
        acc = np.asarray(report["accuracy"], np.float64)
        best = int(np.argmax(np.where(result.active > 0, acc, -np.inf)))
        report = report.with_column("learning_rate",
                                    np.asarray(rates, np.float64))
        report = report.with_column("final_loss",
                                    result.final_losses().astype(np.float64))
        report = report.with_column("active",
                                    result.active.astype(np.float64))
        model = MultilayerPerceptronClassifierModel(
            result.member_bundle(best), device=self.device,
            featuresCol=self.featuresCol)
        return model, report
