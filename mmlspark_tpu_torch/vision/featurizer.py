"""ImageFeaturizer: transfer learning from zoo models (the port of
`mmlspark_tpu/vision/featurizer.py`).

The counterpart of the reference's image-featurizer
(ImageFeaturizer.scala:93-120): resize the image column to the model's
input shape, scale it to [0, 1], run a truncated forward pass (cut
`cutOutputLayers` named layers off the head, scala:98-103), and emit the
activations as features.  The cut resolves, through the bundle's
`layer_names` metadata, to a named node of the module, which the port's
`TPUModel` selects with `outputNodeName`.  `device` is a constructor
keyword, passed on to the `ImageTransformer` and the `TPUModel`.
"""

from __future__ import annotations

import os
from typing import Optional

from mmlspark_tpu_torch.core.device import resolve_device
from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.models.bundle import (ModelBundle, load_bundle,
                                              save_bundle)
from mmlspark_tpu_torch.models.tpu_model import TPUModel
from mmlspark_tpu_torch.vision.transformer import ImageTransformer


class ImageFeaturizer(Transformer):
    """Truncated-model image featurization."""

    saved_class = "mmlspark_tpu.vision.featurizer.ImageFeaturizer"

    inputCol = Param("image", "image column", ptype=str)
    outputCol = Param("features", "feature output column", ptype=str)
    cutOutputLayers = Param(1, "how many named output layers to cut "
                            "(1 = use the layer feeding the classifier head, "
                            "ImageFeaturizer.scala:60-66)", ptype=int)
    layerName = Param(None, "explicit node to output (overrides "
                      "cutOutputLayers)", ptype=str)
    inputHeight = Param(None, "model input height (None = from bundle "
                        "metadata)", ptype=int)
    inputWidth = Param(None, "model input width", ptype=int)
    scaleToUnit = Param(True, "scale uint8 [0,255] to [0,1] before the net",
                        ptype=bool)
    miniBatchSize = Param(512, "scoring batch size", ptype=int)

    def __init__(self, bundle: Optional[ModelBundle] = None, device="cuda",
                 **kw):
        super().__init__(**kw)
        self.device = resolve_device(device)
        self._bundle = bundle

    def set_bundle(self, bundle: ModelBundle) -> "ImageFeaturizer":
        self._bundle = bundle
        return self

    @property
    def bundle(self) -> Optional[ModelBundle]:
        return self._bundle

    def _resolve_layer(self) -> Optional[str]:
        if self.layerName is not None:
            return self.layerName
        layer_names = (self._bundle.metadata or {}).get("layer_names")
        cut = self.cutOutputLayers
        if layer_names:
            # layer_names ordered output-side first, as the reference's
            # ModelSchema.layerNames (Schema.scala:56-76)
            if cut >= len(layer_names):
                raise ValueError(
                    f"cutOutputLayers={cut} but model only names "
                    f"{len(layer_names)} layers: {layer_names}")
            return layer_names[cut] if cut > 0 else None
        return None  # final output

    def _input_hw(self) -> Optional[tuple[int, int]]:
        if self.inputHeight is not None and self.inputWidth is not None:
            return (self.inputHeight, self.inputWidth)
        shape = (self._bundle.metadata or {}).get("input_shape")
        if shape and len(shape) == 4:
            return (int(shape[1]), int(shape[2]))
        return None

    def transform(self, table: DataTable) -> DataTable:
        if self._bundle is None:
            raise ValueError("ImageFeaturizer has no model bundle")
        work_col = table.find_unused_column_name(f"{self.outputCol}_img")
        hw = self._input_hw()
        current = table
        it = ImageTransformer(inputCol=self.inputCol, outputCol=work_col,
                              device=self.device)
        if hw is not None:
            it = it.resize(*hw)
        if self.scaleToUnit:
            it = it.normalize()
        if it.stages:
            current = it.transform(current)
            src_col = work_col
        else:
            src_col = self.inputCol

        scorer = TPUModel(self._bundle, device=self.device, inputCol=src_col,
                          outputCol=self.outputCol,
                          miniBatchSize=self.miniBatchSize,
                          outputNodeName=self._resolve_layer())
        out = scorer.transform(current)
        return out.drop(work_col) if work_col in out else out

    # -- persistence ----------------------------------------------------
    def _save_extra(self, path: str) -> None:
        if self._bundle is not None:
            save_bundle(self._bundle, os.path.join(path, "bundle"))

    def _load_extra(self, path: str, **_init_kwargs) -> None:
        p = os.path.join(path, "bundle")
        self._bundle = load_bundle(p) if os.path.exists(p) else None
