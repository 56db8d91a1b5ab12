"""TrainClassifier: auto-ML classification estimator (the port of
`mmlspark_tpu/ml/train_classifier.py`).

Counterpart of the reference's train-classifier
(TrainClassifier.scala:49-160): index the label to categorical (keeping the
levels), pick featurization settings per learner family (hash-space size,
one-hot on/off), featurize every non-label column, autosize the MLP input
layer, fit the learner, and return a model whose transform tags the scored
columns in metadata (lines 213-264) so evaluators find them without
hard-coded names.

`device` (a run-time setting, not a Param) moves the learner onto that
device when given; left None, the learner keeps its own.  With
`populationSize` > 1 or `sweepLearningRates`, an MLP learner trains every
candidate rate as one vmapped population (`train/sweep.py`) over the
table featurized once, and the model keeps the best-accuracy member
(`sweep_metrics` holds every member's row).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.device import resolve_device
from mmlspark_tpu_torch.core.pipeline import (Estimator, JaxTwin,
                                              PipelineModel, Transformer,
                                              load_stage)
from mmlspark_tpu_torch.core.schema import (CategoricalMap, SchemaConstants,
                                      make_categorical, set_score_column)
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.feature.assemble import (NUM_FEATURES_DEFAULT,
                                           NUM_FEATURES_TREE_OR_NN, Featurize)
from mmlspark_tpu_torch.ml.learners import (LogisticRegression,
                                            MultilayerPerceptronClassifier,
                                            OneVsRest)

_TREE_LEARNERS = ("DecisionTreeClassifier", "RandomForestClassifier",
                  "GBTClassifier", "DecisionTreeRegressor",
                  "RandomForestRegressor", "GBTRegressor")


def _is_tree(est) -> bool:
    return type(est).__name__ in _TREE_LEARNERS


class TrainClassifier(JaxTwin, Estimator):
    """Featurize + fit a classifier with label indexing."""

    labelCol = Param("label", "label column", ptype=str)
    featuresCol = Param("features", "assembled features column", ptype=str)
    numFeatures = Param(0, "hash space size (0 = per-learner default, "
                        "Featurize.scala:13-19)", ptype=int)
    indexLabel = Param(True, "convert label to categorical indices", ptype=bool)
    populationSize = Param(0, "when > 1 and the learner is the MLP, train a "
                           "population of candidates at log-spaced learning "
                           "rates around stepSize in ONE vmapped program "
                           "(train/sweep.py) and keep the winner", ptype=int)
    sweepLearningRates = Param(None, "explicit learning-rate grid for the "
                               "population sweep (one member per rate; "
                               "overrides populationSize)",
                               ptype=(list, tuple))
    sweepHalvingRungs = Param(0, "successive-halving rungs for the sweep "
                              "(0 = train every member to completion)",
                              ptype=int)

    def __init__(self, model: Optional[Estimator] = None, device=None,
                 mesh=None, **kw):
        super().__init__(**kw)
        self._model = model
        self.device = None if device is None else resolve_device(device)
        # a run-time setting: an MLP learner (a fit or a population)
        # trains data-parallel over this mesh
        self.mesh = mesh

    def set_model(self, model: Estimator) -> "TrainClassifier":
        self._model = model
        return self

    def fit(self, table: DataTable) -> "TrainedClassifierModel":
        learner = on_device(self._model, self.device, LogisticRegression)
        label = self.labelCol
        data = table.drop_nulls([label])

        levels: Optional[list] = None
        if self.indexLabel:
            if not data.meta(label).is_categorical:
                data = make_categorical(data, label)
            cmap = data.meta(label).categorical
            levels = list(cmap.levels)

        # per-learner featurization config (TrainClassifier.scala:74-86)
        is_tree = _is_tree(learner)
        is_mlp = isinstance(learner, MultilayerPerceptronClassifier)
        one_hot = not is_tree
        num_features = self.numFeatures or (
            NUM_FEATURES_TREE_OR_NN if (is_tree or is_mlp)
            else NUM_FEATURES_DEFAULT)

        # class count: from the levels, or from the raw integer labels when
        # indexLabel is off
        if levels is not None:
            n_classes = len(levels)
        else:
            y = np.asarray(data[label], np.float64)
            n_classes = int(y.max(initial=0)) + 1 if len(y) else 2

        # multiclass LR -> one-vs-rest (TrainClassifier.scala:87-95)
        if isinstance(learner, LogisticRegression) and n_classes > 2:
            learner = OneVsRest(learner)

        feature_cols = [c for c in data.columns if c != label]
        featurizer = Featurize(
            featureColumns={self.featuresCol: feature_cols},
            numberOfFeatures=num_features,
            oneHotEncodeCategoricals=one_hot)
        featurized_model = featurizer.fit(data)
        processed = featurized_model.transform(data)

        # MLP input autosizing (TrainClassifier.scala:143-150)
        if is_mlp:
            dim = processed[self.featuresCol].shape[1]
            layers = list(learner.layers or [-1, 100, -1])
            layers[0] = dim
            if layers[-1] in (-1, 0, None):
                layers[-1] = max(n_classes, 2)
            learner = learner.copy(layers=layers)

        learner.set_params(featuresCol=self.featuresCol, labelCol=label)
        if is_mlp and self.mesh is not None:
            learner = learner.copy().set_mesh(self.mesh)
        sweep_metrics = None
        rates = self._sweep_rates(learner) if is_mlp else None
        if rates:
            # featurized once above; every candidate trains in one
            # vmapped population, the winner picked by one batched
            # evaluation (train/sweep.py)
            fit_model, sweep_metrics = learner.fit_population(
                processed, rates, int(self.sweepHalvingRungs))
        else:
            fit_model = learner.fit(processed)
        pipeline = PipelineModel([featurized_model, fit_model])
        model = TrainedClassifierModel(
            pipeline, levels=levels, labelCol=label,
            featuresCol=self.featuresCol)
        model._sweep_metrics = sweep_metrics
        return model

    def _sweep_rates(self, learner) -> Optional[list]:
        """The candidate learning-rate grid, or None for a plain fit:
        an explicit sweepLearningRates list wins; populationSize > 1
        log-spaces a decade either side of the learner's stepSize."""
        if self.sweepLearningRates:
            return [float(r) for r in self.sweepLearningRates]
        n = int(self.populationSize)
        if n <= 1:
            return None
        base = float(learner.stepSize)
        return [float(r) for r in np.geomspace(base / 10.0, base * 10.0, n)]

    def _save_extra(self, path: str) -> None:
        if self._model is not None:
            self._model.save(os.path.join(path, "model"))

    def _load_extra(self, path: str, **init_kwargs) -> None:
        p = os.path.join(path, "model")
        self._model = (load_stage(p, **init_kwargs) if os.path.exists(p)
                       else None)


def on_device(learner: Optional[Estimator], device, default) -> Estimator:
    """The learner to fit: `default()` when None, and a copy moved to
    `device` when one is given."""
    if learner is None:
        return default(device="cuda" if device is None else device)
    if device is None or getattr(learner, "device", None) == device:
        return learner
    moved = learner.copy()
    moved.device = device
    return moved


class TrainedClassifierModel(JaxTwin, Transformer):
    """Scores a table and tags scored columns in metadata
    (TrainClassifier.scala:213-264)."""

    labelCol = Param("label", "label column", ptype=str)
    featuresCol = Param("features", "features column", ptype=str)

    def __init__(self, pipeline: Optional[PipelineModel] = None,
                 levels: Optional[list] = None, device=None, **kw):
        # `device` is a run-time setting of the fitted learner, which
        # `load_stage` hands on to it through `_load_extra`
        super().__init__(**kw)
        self._pipeline = pipeline
        self._levels = list(levels) if levels is not None else None
        self._sweep_metrics: Optional[DataTable] = None

    @property
    def levels(self) -> Optional[list]:
        return self._levels

    @property
    def sweep_metrics(self) -> Optional[DataTable]:
        """Per-member metrics of the population sweep that produced this
        model (one row per candidate learning rate), or None for a plain
        fit."""
        return self._sweep_metrics

    @property
    def featurized_model(self):
        return self._pipeline.get_stages()[0] if self._pipeline else None

    @property
    def fit_model(self):
        return self._pipeline.get_stages()[-1] if self._pipeline else None

    def transform(self, table: DataTable) -> DataTable:
        out = self._pipeline.transform(table)
        C = SchemaConstants
        renames = {"rawPrediction": C.SCORES_COLUMN,
                   "probability": C.SCORED_PROBABILITIES_COLUMN,
                   "prediction": C.SCORED_LABELS_COLUMN}
        out = out.rename({k: v for k, v in renames.items() if k in out})
        for kind, col in ((C.SCORES_COLUMN, C.SCORES_COLUMN),
                          (C.SCORED_PROBABILITIES_COLUMN,
                           C.SCORED_PROBABILITIES_COLUMN),
                          (C.SCORED_LABELS_COLUMN, C.SCORED_LABELS_COLUMN)):
            if col in out:
                set_score_column(out, self.uid, col, kind,
                                 C.CLASSIFICATION_KIND)
        if self.labelCol in out:
            set_score_column(out, self.uid, self.labelCol,
                             C.TRUE_LABELS_COLUMN, C.CLASSIFICATION_KIND)
        # carry the label levels on the scored labels (scala:253-263)
        if self._levels is not None and C.SCORED_LABELS_COLUMN in out:
            meta = out.meta(C.SCORED_LABELS_COLUMN)
            meta.categorical = CategoricalMap(list(self._levels))
            out.set_meta(C.SCORED_LABELS_COLUMN, meta)
        return out

    # -- persistence ----------------------------------------------------
    def _save_extra(self, path: str) -> None:
        self._pipeline.save(os.path.join(path, "pipeline"))
        with open(os.path.join(path, "levels.json"), "w") as f:
            json.dump(self._levels, f)
        if self._sweep_metrics is not None:
            self._sweep_metrics.save(os.path.join(path, "sweep_metrics"))

    def _load_extra(self, path: str, **init_kwargs) -> None:
        self._pipeline = load_stage(os.path.join(path, "pipeline"),
                                    **init_kwargs)
        with open(os.path.join(path, "levels.json")) as f:
            self._levels = json.load(f)
        sm = os.path.join(path, "sweep_metrics")
        self._sweep_metrics = DataTable.load(sm) if os.path.exists(sm) \
            else None
