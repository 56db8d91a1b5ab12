"""Tree learners as histogram programs (the port of
`mmlspark_tpu/ml/trees.py`).

The design is the JAX package's: features are quantile-binned once to
int bins (numpy on the host, so the edges are bit-identical); every tree
is a complete binary tree of static depth, "no split" encoded as a
send-everything-left split; each level builds (feature x node x bin)
gradient / hessian histograms and picks the XGBoost Newton gain's best
split per node, first index on ties; leaves take -G / (H + lambda).
Boosting (GBT) wraps tree building with logistic / squared-loss
gradients; forests (RF) bag Poisson row weights and feature subsets drawn
by numpy in the JAX package's order; a decision tree is a forest of one.

Bit-repeatable on the card: `segment_sum` on CUDA (`index_add_`,
`scatter_add_`) adds floats atomically in no fixed order, so near-tie
gains would pick different splits from fit to fit.  The histograms here
are `index_put_(accumulate=True)`, which sums each bin's rows in a fixed
order (a stable sort of the ids on CUDA, serially on the CPU; torch's
global deterministic mode is not needed, and turning it on imports the
compiler stack, ~13 s on the card's host), and the per-bin prefix sums
add their terms in the order XLA's CPU `jnp.cumsum` does
(`_prefix_sum`).  Every other op on the path is exact or elementwise, so
a fit repeats bit for bit on the card, and on the CPU equals the JAX
package's.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core.device import exact_f32
from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.ml.learners import (ClassifierModel, RegressorModel,
                                            _DeviceEstimator,
                                            _features_matrix, _sigmoid,
                                            _to_device)


# --------------------------------------------------------------------------
# binning
# --------------------------------------------------------------------------

def quantile_bin_edges(X: np.ndarray, max_bins: int) -> np.ndarray:
    """Per-feature quantile edges, (F, max_bins-1), on the host.

    Mirrors MLlib's quantile-based continuous-feature binning (its maxBins
    param has the same meaning)."""
    qs = np.linspace(0, 1, max_bins + 1)[1:-1]
    return np.quantile(X, qs, axis=0).T.astype(np.float32)   # (F, B-1)


def bin_features(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """(n, F) float -> (n, F) int64 bin ids by per-feature left-side
    searchsorted (`jnp.searchsorted`'s default)."""
    return torch.searchsorted(edges.contiguous(),
                              X.T.contiguous()).T.contiguous()


PREFIX_BLOCK = 16


def segment_sum(values: torch.Tensor, ids: torch.Tensor,
                n_segments: int) -> torch.Tensor:
    """Sum of `values` per segment id, each segment's terms added in
    their order in `values` (module docstring)."""
    out = torch.zeros(n_segments, dtype=values.dtype, device=values.device)
    return out.index_put_((ids,), values, accumulate=True)


def _prefix_sum(t: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the last axis in XLA's CPU order: serial within
    blocks of 16 terms, each block then offset by the running total of
    the blocks before it (XLA rewrites the cumulative reduce-window of
    `jnp.cumsum` so; one block for up to 16 bins)."""
    cols, carry = [], None
    for s0 in range(0, t.shape[-1], PREFIX_BLOCK):
        local = [t[..., s0]]
        for j in range(s0 + 1, min(s0 + PREFIX_BLOCK, t.shape[-1])):
            local.append(local[-1] + t[..., j])
        if carry is not None:
            local = [v + carry for v in local]
        cols += local
        carry = cols[-1]
    return torch.stack(cols, dim=-1)


# --------------------------------------------------------------------------
# single-tree build + predict (static depth / bins)
# --------------------------------------------------------------------------

def build_tree(binned: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
               depth: int, n_bins: int, lam: float = 1.0,
               feature_mask: Optional[torch.Tensor] = None):
    """Grow one complete tree of `depth` levels.

    binned: (n, F) int; grad/hess: (n,) float32 (zero-weight rows simply
    contribute nothing).  Returns (split_feature (I,), split_bin (I,),
    leaf_value (2**depth,)) with I = 2**depth - 1 internal nodes laid out
    heap-style; "no split" is (feature 0, bin n_bins) => all rows go left.
    """
    n, F = binned.shape
    dev = binned.device
    n_internal = 2 ** depth - 1
    split_feature = torch.zeros(n_internal, dtype=torch.int32, device=dev)
    split_bin = torch.full((n_internal,), n_bins, dtype=torch.int32,
                           device=dev)
    node_of_row = torch.zeros(n, dtype=torch.int64, device=dev)
    rows = torch.arange(n, device=dev)
    feat_base = torch.arange(F, device=dev)[:, None]

    for d in range(depth):
        level_size = 2 ** d
        first = level_size - 1
        local = node_of_row - first               # 0..level_size-1
        width = level_size * n_bins
        # one segment per (feature, node, bin), features outermost
        ids = (feat_base * width + (local * n_bins)[None, :]
               + binned.T).reshape(-1)
        hg = segment_sum(grad.repeat(F), ids, F * width).view(
            F, level_size, n_bins)
        hh = segment_sum(hess.repeat(F), ids, F * width).view(
            F, level_size, n_bins)
        GL, HL = _prefix_sum(hg), _prefix_sum(hh)
        G, H = GL[..., -1:], HL[..., -1:]
        GR, HR = G - GL, H - HL

        def score(g, h):
            return g * g / (h + lam)

        gain = score(GL, HL) + score(GR, HR) - score(G, H)   # (F, nodes, bins)
        # a split at bin b sends bins <= b left; the last bin is no-split
        gain[..., -1] = -torch.inf
        # empty children are useless splits
        gain = torch.where((HL <= 0) | (HR <= 0), -torch.inf, gain)
        if feature_mask is not None:
            gain = torch.where(feature_mask[:, None, None], gain, -torch.inf)

        flat = gain.permute(1, 0, 2).reshape(level_size, F * n_bins)
        best = torch.argmax(flat, dim=1)                       # (nodes,)
        best_gain = flat.gather(1, best[:, None])[:, 0]
        do_split = best_gain > 1e-12
        feat = torch.where(do_split, best // n_bins, 0)
        b = torch.where(do_split, best % n_bins, n_bins)       # no-split: left

        split_feature[first:first + level_size] = feat.to(torch.int32)
        split_bin[first:first + level_size] = b.to(torch.int32)

        go_right = binned[rows, feat[local]] > b[local]
        node_of_row = 2 * node_of_row + 1 + go_right.long()

    leaf_local = node_of_row - n_internal
    n_leaves = 2 ** depth
    leaf_g = segment_sum(grad, leaf_local, n_leaves)
    leaf_h = segment_sum(hess, leaf_local, n_leaves)
    leaf_value = -leaf_g / (leaf_h + lam)
    return split_feature, split_bin, leaf_value


def predict_tree(binned: torch.Tensor, split_feature: torch.Tensor,
                 split_bin: torch.Tensor, leaf_value: torch.Tensor,
                 depth: int) -> torch.Tensor:
    """(n, F) bins -> (n,) leaf values in `depth` gather steps."""
    n = binned.shape[0]
    rows = torch.arange(n, device=binned.device)
    node = torch.zeros(n, dtype=torch.int64, device=binned.device)
    for _ in range(depth):
        feat = split_feature[node].long()
        thr = split_bin[node]
        go_right = binned[rows, feat] > thr
        node = 2 * node + 1 + go_right.long()
    return leaf_value[node - (2 ** depth - 1)]


# --------------------------------------------------------------------------
# ensembles
# --------------------------------------------------------------------------

class TreeEnsemble:
    """Bins + a list of (feature, bin, leaf) arrays + a bias; scores on
    `device`."""

    def __init__(self, edges: np.ndarray, depth: int, bias: float = 0.0,
                 device="cpu"):
        self.edges = np.asarray(edges, np.float32)
        self.depth = depth
        self.bias = float(bias)
        self.device = torch.device(device)
        self.trees: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []

    def add(self, feature, bins, leaves, weight: float = 1.0):
        leaves = leaves * weight if weight != 1.0 else leaves
        self.trees.append(tuple(t.cpu().numpy() if torch.is_tensor(t)
                                else np.asarray(t)
                                for t in (feature, bins, leaves)))

    def bin(self, X: np.ndarray) -> torch.Tensor:
        return bin_features(_to_device(np.asarray(X, np.float32),
                                       self.device),
                            _to_device(self.edges, self.device))

    def raw_predict(self, X: np.ndarray, binned=None) -> np.ndarray:
        with torch.inference_mode():
            if binned is None:
                binned = self.bin(X)
            out = np.full(len(X), self.bias, np.float32)
            for f, b, l in self.trees:
                out += predict_tree(
                    binned, _to_device(f, self.device),
                    _to_device(b, self.device), _to_device(l, self.device),
                    self.depth).cpu().numpy()
        return out

    def save(self, path: str, name: str):
        arrs = {"edges": self.edges, "bias": np.float32(self.bias),
                "depth": np.int32(self.depth),
                "n_trees": np.int32(len(self.trees))}
        for i, (f, b, l) in enumerate(self.trees):
            arrs[f"f{i}"] = f
            arrs[f"b{i}"] = b
            arrs[f"l{i}"] = l
        np.savez(os.path.join(path, f"{name}.npz"), **arrs)

    @staticmethod
    def load(path: str, name: str, device="cpu") -> "TreeEnsemble":
        d = np.load(os.path.join(path, f"{name}.npz"))
        ens = TreeEnsemble(d["edges"], int(d["depth"]), float(d["bias"]),
                           device)
        for i in range(int(d["n_trees"])):
            ens.trees.append((d[f"f{i}"], d[f"b{i}"], d[f"l{i}"]))
        return ens


def _fit_boosted(X, y, *, depth, n_bins, n_trees, step, lam, loss, device,
                 row_weights=None, feature_masks=None, boost=True,
                 prebinned=None):
    """Generic tree-ensemble loop, one tree build per round.

    boost=True: gradients from the running prediction (GBT).
    boost=False: gradients always from the bias — trees are independent
    fits of (y - bias), so step=1/T yields forest averaging (RF/DT).
    `prebinned=(edges, binned)` skips the quantile/binning pass (shared
    across the per-class ensembles of a multiclass forest).
    """
    with torch.inference_mode(), exact_f32():
        if prebinned is not None:
            edges, binned = prebinned
        else:
            edges = quantile_bin_edges(X, n_bins)
            binned = bin_features(_to_device(X.astype(np.float32), device),
                                  _to_device(edges, device))
        yj = _to_device(np.asarray(y, np.float32), device)
        w = (_to_device(np.asarray(row_weights, np.float32), device)
             if row_weights is not None else None)
        bias = 0.0 if loss == "logistic" else (
            float(np.mean(y)) if len(y) else 0.0)
        ens = TreeEnsemble(edges, depth, bias, device)
        pred = torch.full((len(y),), bias, dtype=torch.float32,
                          device=device)
        masks = (_to_device(feature_masks, device)
                 if feature_masks is not None else None)
        for t in range(n_trees):
            if loss == "logistic":
                p = torch.sigmoid(pred)
                grad, hess = p - yj, p * (1 - p)
            else:
                grad, hess = pred - yj, torch.ones_like(pred)
            if w is not None:
                wt = w if w.dim() == 1 else w[t]
                grad, hess = grad * wt, hess * wt
            mask = masks[t] if masks is not None else None
            f, b, l = build_tree(binned, grad, hess, depth, n_bins, lam,
                                 mask)
            l = l * step if step != 1.0 else l
            ens.add(f, b, l)
            if boost:
                pred = pred + predict_tree(binned, f, b, l, depth)
    return ens


def _subset_size(n_feats: int, strategy: str) -> int:
    """Features per tree (Spark featureSubsetStrategy vocabulary)."""
    if strategy in ("sqrt", "auto"):
        k = int(np.sqrt(n_feats))
    elif strategy == "log2":
        k = int(np.log2(max(n_feats, 2)))
    elif strategy == "onethird":
        k = n_feats // 3
    else:
        k = int(n_feats * float(strategy))
    return min(max(k, 1), n_feats)


def _valid_strategy(v: str) -> bool:
    if v in ("all", "sqrt", "auto", "log2", "onethird"):
        return True
    try:
        return 0.0 < float(v) <= 1.0
    except ValueError:
        return False


def _bagging(n_rows, n_feats, n_trees, subsample, feat_strategy, rng):
    """Poisson row weights + per-tree feature masks (static shapes)."""
    weights = rng.poisson(subsample, size=(n_trees, n_rows)).astype(
        np.float32)
    if feat_strategy == "all" or n_feats <= 1:
        masks = np.ones((n_trees, n_feats), bool)
    else:
        k = _subset_size(n_feats, feat_strategy)
        masks = np.zeros((n_trees, n_feats), bool)
        for t in range(n_trees):
            masks[t, rng.choice(n_feats, size=k, replace=False)] = True
    return weights, masks


# --------------------------------------------------------------------------
# models
# --------------------------------------------------------------------------

class TreeClassifierModel(ClassifierModel):
    """Per-class probability ensembles (DT/RF) or a logit ensemble (GBT)."""

    def __init__(self, ensembles: Optional[list] = None,
                 mode: str = "prob", device="cuda", **kw):
        super().__init__(device=device, **kw)
        self._ensembles = list(ensembles or [])
        for e in self._ensembles:
            e.device = self.device
        self._mode = mode  # "prob" (leaf-mean trees) | "logit" (boosted)

    @property
    def ensembles(self) -> list:
        return list(self._ensembles)

    @property
    def num_classes(self) -> int:
        return max(len(self._ensembles), 2)

    def _score(self, X):
        if self._mode == "logit":
            z = self._ensembles[0].raw_predict(X)
            p = _sigmoid(z, self.device)
            prob = np.stack([1 - p, p], 1)
            raw = np.stack([-z, z], 1)
            return raw, prob, (p > 0.5).astype(np.float64)
        # all per-class ensembles share edges: bin once
        with torch.inference_mode():
            binned = self._ensembles[0].bin(X)
        raw = np.stack([e.raw_predict(X, binned=binned)
                        for e in self._ensembles], 1)
        clipped = np.clip(raw, 1e-6, 1.0)
        prob = clipped / clipped.sum(1, keepdims=True)
        return raw, prob, np.argmax(raw, 1).astype(np.float64)

    def _save_extra(self, path):
        with open(os.path.join(path, "mode.txt"), "w") as f:
            f.write(f"{self._mode}\n{len(self._ensembles)}")
        for i, e in enumerate(self._ensembles):
            e.save(path, f"ens{i}")

    def _load_extra(self, path, **_init_kwargs):
        with open(os.path.join(path, "mode.txt")) as f:
            self._mode, n = f.read().split("\n")
        self._ensembles = [TreeEnsemble.load(path, f"ens{i}", self.device)
                           for i in range(int(n))]


class TreeRegressorModel(RegressorModel):
    def __init__(self, ensemble: Optional[TreeEnsemble] = None,
                 device="cuda", **kw):
        super().__init__(device=device, **kw)
        self._ensemble = ensemble
        if ensemble is not None:
            ensemble.device = self.device

    @property
    def ensemble(self) -> Optional[TreeEnsemble]:
        return self._ensemble

    def _predict(self, X):
        return self._ensemble.raw_predict(X)

    def _save_extra(self, path):
        self._ensemble.save(path, "ens")

    def _load_extra(self, path, **_init_kwargs):
        self._ensemble = TreeEnsemble.load(path, "ens", self.device)


# --------------------------------------------------------------------------
# estimators
# --------------------------------------------------------------------------

class _TreeParams(_DeviceEstimator):
    featuresCol = Param("features", "features column", ptype=str)
    labelCol = Param("label", "label column", ptype=str)
    maxDepth = Param(5, "tree depth", ptype=int,
                     validator=lambda v: 1 <= v <= 12)
    maxBins = Param(32, "histogram bins per feature", ptype=int,
                    validator=lambda v: 2 <= v <= 256)
    lam = Param(1.0, "L2 leaf regularization", ptype=float)
    seed = Param(0, "sampling seed", ptype=int)

    def _xy(self, table: DataTable):
        X = _features_matrix(table[self.featuresCol]).astype(np.float32)
        y = np.asarray(table[self.labelCol], np.float64)
        return X, y


def _per_class_forest(X, y, n_classes, *, depth, n_bins, n_trees, lam,
                      subsample, feat_strategy, seed, device):
    """Probability forests: per class, trees of leaf-mean(indicator)."""
    rng = np.random.default_rng(seed)
    weights, masks = _bagging(len(X), X.shape[1], n_trees, subsample,
                              feat_strategy, rng)
    # one quantile/binning pass shared by all K class ensembles
    edges = quantile_bin_edges(X, n_bins)
    with torch.inference_mode():
        binned = bin_features(_to_device(X.astype(np.float32), device),
                              _to_device(edges, device))
    ensembles = []
    for c in range(n_classes):
        target = (y == c).astype(np.float32)
        # squared loss from a zero bias: leaf value = smoothed mean of the
        # indicator = P(class | leaf); average over trees with weight 1/T
        ensembles.append(_fit_boosted(
            X, target, depth=depth, n_bins=n_bins, n_trees=n_trees,
            step=1.0 / n_trees, lam=lam, loss="squared", device=device,
            row_weights=weights if n_trees > 1 else None,
            feature_masks=masks, boost=False, prebinned=(edges, binned)))
    return ensembles


class DecisionTreeClassifier(_TreeParams):
    """Single probability tree (Spark DecisionTreeClassifier counterpart)."""

    def fit(self, table: DataTable) -> TreeClassifierModel:
        X, y = self._xy(table)
        n_classes = int(y.max()) + 1 if len(y) else 2
        ens = _per_class_forest(X, y, max(n_classes, 2), depth=self.maxDepth,
                                n_bins=self.maxBins, n_trees=1, lam=self.lam,
                                subsample=1.0, feat_strategy="all",
                                seed=self.seed, device=self.device)
        return TreeClassifierModel(ens, device=self.device,
                                   featuresCol=self.featuresCol)


class RandomForestClassifier(_TreeParams):
    numTrees = Param(20, "trees in the forest", ptype=int)
    subsamplingRate = Param(1.0, "Poisson bootstrap rate", ptype=float)
    featureSubsetStrategy = Param(
        "sqrt", "all | auto | sqrt | log2 | onethird | fraction in (0,1]",
        ptype=str, validator=_valid_strategy)

    def fit(self, table: DataTable) -> TreeClassifierModel:
        X, y = self._xy(table)
        n_classes = int(y.max()) + 1 if len(y) else 2
        ens = _per_class_forest(
            X, y, max(n_classes, 2), depth=self.maxDepth, n_bins=self.maxBins,
            n_trees=self.numTrees, lam=self.lam,
            subsample=self.subsamplingRate,
            feat_strategy=self.featureSubsetStrategy, seed=self.seed,
            device=self.device)
        return TreeClassifierModel(ens, device=self.device,
                                   featuresCol=self.featuresCol)


class GBTClassifier(_TreeParams):
    """Binary logistic boosting; multiclass unsupported, as the reference
    (TrainClassifier.scala:101-104)."""

    maxIter = Param(20, "boosting rounds", ptype=int)
    stepSize = Param(0.1, "shrinkage", ptype=float)

    def fit(self, table: DataTable) -> TreeClassifierModel:
        X, y = self._xy(table)
        if len(y) and y.max() > 1:
            raise ValueError("Multiclass GBTClassifier is not supported "
                             "(reference TrainClassifier.scala:101-104)")
        ens = _fit_boosted(X, y.astype(np.float32), depth=self.maxDepth,
                           n_bins=self.maxBins, n_trees=self.maxIter,
                           step=self.stepSize, lam=self.lam, loss="logistic",
                           device=self.device)
        return TreeClassifierModel([ens], mode="logit", device=self.device,
                                   featuresCol=self.featuresCol)


class DecisionTreeRegressor(_TreeParams):
    def fit(self, table: DataTable) -> TreeRegressorModel:
        X, y = self._xy(table)
        ens = _fit_boosted(X, y.astype(np.float32), depth=self.maxDepth,
                           n_bins=self.maxBins, n_trees=1, step=1.0,
                           lam=self.lam, loss="squared", device=self.device)
        return TreeRegressorModel(ens, device=self.device,
                                  featuresCol=self.featuresCol)


class RandomForestRegressor(_TreeParams):
    numTrees = Param(20, "trees in the forest", ptype=int)
    subsamplingRate = Param(1.0, "Poisson bootstrap rate", ptype=float)
    featureSubsetStrategy = Param(
        "sqrt", "all | auto | sqrt | log2 | onethird | fraction in (0,1]",
        ptype=str, validator=_valid_strategy)

    def fit(self, table: DataTable) -> TreeRegressorModel:
        X, y = self._xy(table)
        rng = np.random.default_rng(self.seed)
        weights, masks = _bagging(len(X), X.shape[1], self.numTrees,
                                  self.subsamplingRate,
                                  self.featureSubsetStrategy, rng)
        ens = _fit_boosted(X, y.astype(np.float32), depth=self.maxDepth,
                           n_bins=self.maxBins, n_trees=self.numTrees,
                           step=1.0 / self.numTrees, lam=self.lam,
                           loss="squared", device=self.device,
                           row_weights=weights, feature_masks=masks,
                           boost=False)
        return TreeRegressorModel(ens, device=self.device,
                                  featuresCol=self.featuresCol)


class GBTRegressor(_TreeParams):
    maxIter = Param(20, "boosting rounds", ptype=int)
    stepSize = Param(0.1, "shrinkage", ptype=float)

    def fit(self, table: DataTable) -> TreeRegressorModel:
        X, y = self._xy(table)
        ens = _fit_boosted(X, y.astype(np.float32), depth=self.maxDepth,
                           n_bins=self.maxBins, n_trees=self.maxIter,
                           step=self.stepSize, lam=self.lam, loss="squared",
                           device=self.device)
        return TreeRegressorModel(ens, device=self.device,
                                  featuresCol=self.featuresCol)
