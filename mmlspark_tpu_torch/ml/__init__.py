"""AutoML layer (reference L4: train-classifier, train-regressor,
compute-model-statistics, compute-per-instance-statistics, find-best-model).
The port of `mmlspark_tpu/ml/`: the same names."""

from mmlspark_tpu_torch.ml.learners import (
    LinearRegression,
    LogisticRegression,
    MultilayerPerceptronClassifier,
    NaiveBayes,
    OneVsRest,
)
from mmlspark_tpu_torch.ml.trees import (
    DecisionTreeClassifier,
    DecisionTreeRegressor,
    GBTClassifier,
    GBTRegressor,
    RandomForestClassifier,
    RandomForestRegressor,
)
from mmlspark_tpu_torch.ml.train_classifier import TrainClassifier, TrainedClassifierModel
from mmlspark_tpu_torch.ml.train_regressor import TrainRegressor, TrainedRegressorModel
from mmlspark_tpu_torch.ml.statistics import (
    ComputeModelStatistics,
    ComputePerInstanceStatistics,
    EvalResult,
)
from mmlspark_tpu_torch.ml.find_best_model import BestModel, FindBestModel

__all__ = [
    "LogisticRegression", "LinearRegression", "NaiveBayes",
    "MultilayerPerceptronClassifier", "OneVsRest",
    "DecisionTreeClassifier", "RandomForestClassifier", "GBTClassifier",
    "DecisionTreeRegressor", "RandomForestRegressor", "GBTRegressor",
    "TrainClassifier", "TrainedClassifierModel",
    "TrainRegressor", "TrainedRegressorModel",
    "ComputeModelStatistics", "ComputePerInstanceStatistics", "EvalResult",
    "FindBestModel", "BestModel",
]
