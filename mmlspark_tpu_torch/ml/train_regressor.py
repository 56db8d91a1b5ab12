"""TrainRegressor: auto-ML regression estimator (the port of
`mmlspark_tpu/ml/train_regressor.py`).

Counterpart of the reference's train-regressor
(TrainRegressor.scala:43-117): cast the label to double, drop rows with
missing labels, featurize the remaining columns (same per-learner settings
as TrainClassifier), fit, and tag scored columns as regression outputs.
`device` works as TrainClassifier's.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.device import resolve_device
from mmlspark_tpu_torch.core.pipeline import (Estimator, JaxTwin,
                                              PipelineModel, Transformer,
                                              load_stage)
from mmlspark_tpu_torch.core.schema import SchemaConstants, set_score_column
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.feature.assemble import (NUM_FEATURES_DEFAULT,
                                           NUM_FEATURES_TREE_OR_NN, Featurize)
from mmlspark_tpu_torch.ml.learners import LinearRegression
from mmlspark_tpu_torch.ml.train_classifier import _is_tree, on_device


class TrainRegressor(JaxTwin, Estimator):
    labelCol = Param("label", "target column", ptype=str)
    featuresCol = Param("features", "assembled features column", ptype=str)
    numFeatures = Param(0, "hash space size (0 = per-learner default)",
                        ptype=int)

    def __init__(self, model: Optional[Estimator] = None, device=None, **kw):
        super().__init__(**kw)
        self._model = model
        self.device = None if device is None else resolve_device(device)

    def set_model(self, model: Estimator) -> "TrainRegressor":
        self._model = model
        return self

    def fit(self, table: DataTable) -> "TrainedRegressorModel":
        learner = on_device(self._model, self.device, LinearRegression)
        label = self.labelCol
        data = table.drop_nulls([label])
        # label -> double (TrainRegressor.scala:77-95)
        data = data.with_column(label, np.asarray(data[label], np.float64))

        is_tree = _is_tree(learner)
        num_features = self.numFeatures or (
            NUM_FEATURES_TREE_OR_NN if is_tree else NUM_FEATURES_DEFAULT)
        feature_cols = [c for c in data.columns if c != label]
        featurizer = Featurize(
            featureColumns={self.featuresCol: feature_cols},
            numberOfFeatures=num_features,
            oneHotEncodeCategoricals=not is_tree)
        featurized_model = featurizer.fit(data)
        processed = featurized_model.transform(data)

        learner.set_params(featuresCol=self.featuresCol, labelCol=label)
        fit_model = learner.fit(processed)
        pipeline = PipelineModel([featurized_model, fit_model])
        return TrainedRegressorModel(pipeline, labelCol=label,
                                     featuresCol=self.featuresCol)

    def _save_extra(self, path: str) -> None:
        if self._model is not None:
            self._model.save(os.path.join(path, "model"))

    def _load_extra(self, path: str, **init_kwargs) -> None:
        p = os.path.join(path, "model")
        self._model = (load_stage(p, **init_kwargs) if os.path.exists(p)
                       else None)


class TrainedRegressorModel(JaxTwin, Transformer):
    labelCol = Param("label", "target column", ptype=str)
    featuresCol = Param("features", "features column", ptype=str)

    def __init__(self, pipeline: Optional[PipelineModel] = None, device=None,
                 **kw):
        # `device` is a run-time setting of the fitted learner, which
        # `load_stage` hands on to it through `_load_extra`
        super().__init__(**kw)
        self._pipeline = pipeline

    @property
    def fit_model(self):
        return self._pipeline.get_stages()[-1] if self._pipeline else None

    def transform(self, table: DataTable) -> DataTable:
        out = self._pipeline.transform(table)
        C = SchemaConstants
        if "prediction" in out:
            out = out.rename({"prediction": C.SCORES_COLUMN})
        if C.SCORES_COLUMN in out:
            set_score_column(out, self.uid, C.SCORES_COLUMN, C.SCORES_COLUMN,
                             C.REGRESSION_KIND)
        if self.labelCol in out:
            set_score_column(out, self.uid, self.labelCol,
                             C.TRUE_LABELS_COLUMN, C.REGRESSION_KIND)
        return out

    def _save_extra(self, path: str) -> None:
        self._pipeline.save(os.path.join(path, "pipeline"))

    def _load_extra(self, path: str, **init_kwargs) -> None:
        self._pipeline = load_stage(os.path.join(path, "pipeline"),
                                    **init_kwargs)
