"""TPULearner: the Estimator face of training (the port of
`mmlspark_tpu/train/learner.py`; MMLSpark's CNTKLearner).

The reference's contract: `fit(table with features and label) -> a
scoring model`.  The learner drops the rows whose label is null, refuses
a non-numeric label, trains the config's architecture with the port's
`Trainer` on one device, and wraps the trained bundle as a `TPUModel`, as
CNTKLearner wraps its output model as a CNTKModel.  Fine-tuning is
`set_initial_bundle` (a zoo bundle, say).

`device` is a run-time setting, as the port's `TPUModel` has it: the
card unless the caller asks for the CPU, passed on to the fitted model.
The stage saves under the JAX class path, so a learner saved by either
package loads in the other through `load_stage`; its initial bundle goes
with it.  `set_mesh(mesh)` trains over the mesh (the Trainer's mesh:
the batch cut over 'data' and replicated over 'seq', the weights placed
over 'model') and the fitted model scores over the same mesh.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from mmlspark_tpu_torch.core.device import resolve_device
from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.pipeline import Estimator
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.models.bundle import (ModelBundle, load_bundle,
                                              save_bundle)
from mmlspark_tpu_torch.models.tpu_model import TPUModel
from mmlspark_tpu_torch.observe.logging import get_logger
from mmlspark_tpu_torch.train.config import TrainerConfig
from mmlspark_tpu_torch.train.trainer import Trainer


class TPULearner(Estimator):
    """Train a model on a table's features and label; `fit` returns the
    `TPUModel` that scores it (module docstring)."""

    saved_class = "mmlspark_tpu.train.learner.TPULearner"

    featuresCol = Param("features", "features column", ptype=str)
    labelCol = Param("label", "label column", ptype=str)
    outputCol = Param("output", "output column of the fitted model", ptype=str)
    config = Param(None, "TrainerConfig as a JSON dict", ptype=dict)
    logEvery = Param(50, "epoch logging interval", ptype=int)

    def __init__(self, config: Optional[TrainerConfig] = None,
                 device="cuda", **kwargs):
        super().__init__(**kwargs)
        self.device = resolve_device(device)
        if config is not None:
            self.set("config", config.to_json())
        self._initial_bundle: Optional[ModelBundle] = None
        self._mesh = None

    def trainer_config(self) -> TrainerConfig:
        return TrainerConfig.from_json(self.config) if self.config \
            else TrainerConfig()

    def set_initial_bundle(self, bundle: Optional[ModelBundle]
                           ) -> "TPULearner":
        """Warm-start weights (transfer learning, fine-tuning)."""
        self._initial_bundle = bundle
        return self

    def set_mesh(self, mesh) -> "TPULearner":
        """Train over `mesh` (None: on `device`); the Trainer checks it."""
        if mesh is not None:
            self.device = resolve_device(mesh.devices.flat[0])
        self._mesh = mesh
        return self

    def fit(self, table: DataTable) -> TPUModel:
        cfg = self.trainer_config()
        # drop the rows with a missing label (CNTKLearner.scala:58)
        clean = table.drop_nulls([self.labelCol])
        x = np.asarray(clean[self.featuresCol], np.float32)
        y = np.asarray(clean[self.labelCol])
        if y.dtype == object:
            raise TypeError(
                f"label column '{self.labelCol}' must be numeric; "
                "encode categoricals first (see core.schema.make_categorical)")
        trainer = Trainer(cfg, mesh=self._mesh, device=self.device)
        bundle = trainer.fit_arrays(
            x, y, initial_bundle=self._initial_bundle,
            log_every=self.logEvery, log_fn=get_logger("train").info)
        model = TPUModel(bundle, device=self.device,
                         inputCol=self.featuresCol, outputCol=self.outputCol,
                         miniBatchSize=max(cfg.batch_size, 1))
        if self._mesh is not None:
            model.set_mesh(self._mesh)
        model._history = list(trainer.history)
        return model

    def _save_extra(self, path: str) -> None:
        if self._initial_bundle is not None:
            save_bundle(self._initial_bundle, f"{path}/initial_bundle")

    def _load_extra(self, path: str, **_init_kwargs) -> None:
        self._initial_bundle = (load_bundle(f"{path}/initial_bundle")
                                if os.path.exists(f"{path}/initial_bundle")
                                else None)
