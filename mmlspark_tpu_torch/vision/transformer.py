"""ImageTransformer and UnrollImage (the port of
`mmlspark_tpu/vision/transformer.py`).

The counterpart of the reference's image-transformer
(ImageTransformer.scala:28-154 stage classes, 272-304 UDF application):
the same fluent stage API (resize/crop/colorFormat/blur/threshold/
gaussianKernel/flip), with the stage names and param keys of the JAX
package (`appertureSize` included), so saved stages move between the
packages.  A uniform column goes to the stage's device once, runs the op
list there op by op (`ops/image.py`), and comes back once.  A ragged
object column is grouped by shape, one batch per group.

`device` is a constructor keyword, not a Param (default the card).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core.device import resolve_device
from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.core.schema import ColumnMeta, ImageSchema
from mmlspark_tpu_torch.core.table import DataTable, object_column
from mmlspark_tpu_torch.ops import image as ops

# stage names follow the reference (ImageTransformer.scala objects)
_STAGE_FNS = {
    "resize": lambda x, p: ops.resize(x, p["height"], p["width"]),
    "crop": lambda x, p: ops.crop(x, p["x"], p["y"], p["height"], p["width"]),
    "centercrop": lambda x, p: ops.center_crop(x, p["height"], p["width"]),
    "colorformat": lambda x, p: ops.cvt_color(x, p["format"]),
    "blur": lambda x, p: ops.blur(x, int(p["height"]), int(p["width"])),
    "threshold": lambda x, p: ops.threshold(x, p["threshold"], p["maxVal"],
                                            p.get("type", "binary")),
    "gaussiankernel": lambda x, p: ops.gaussian_kernel(
        x, p["appertureSize"], p["sigma"]),
    "flip": lambda x, p: ops.flip(x, p.get("code", 1)),
    "normalize": lambda x, p: ops.normalize(x, p.get("mean"), p.get("std")),
}


def _to_host(x: torch.Tensor) -> np.ndarray:
    """A fresh host array (never a view of the input column)."""
    return x.contiguous().to("cpu", copy=True).numpy()


class ImageTransformer(Transformer):
    """Apply a sequence of image ops to an image column."""

    saved_class = "mmlspark_tpu.vision.transformer.ImageTransformer"

    inputCol = Param("image", "input image column", ptype=str)
    outputCol = Param("image", "output image column", ptype=str)
    stages = Param(None, "op list: [{'stage': name, ...params}]",
                   ptype=(list, tuple))

    def __init__(self, device="cuda", **kwargs):
        super().__init__(**kwargs)
        self.device = resolve_device(device)

    # -- fluent setters (the reference's setter API) ------------------
    def _add(self, stage: str, **params) -> "ImageTransformer":
        cur = list(self.stages or [])
        cur.append({"stage": stage, **params})
        return self.set("stages", cur)

    def resize(self, height: int, width: int) -> "ImageTransformer":
        return self._add("resize", height=height, width=width)

    def crop(self, x: int, y: int, height: int, width: int) -> "ImageTransformer":
        return self._add("crop", x=x, y=y, height=height, width=width)

    def center_crop(self, height: int, width: int) -> "ImageTransformer":
        return self._add("centercrop", height=height, width=width)

    def color_format(self, format: str) -> "ImageTransformer":
        return self._add("colorformat", format=format)

    def blur(self, height: float, width: float) -> "ImageTransformer":
        return self._add("blur", height=height, width=width)

    def threshold(self, threshold: float, max_val: float,
                  thresh_type: str = "binary") -> "ImageTransformer":
        return self._add("threshold", threshold=threshold, maxVal=max_val,
                         type=thresh_type)

    def gaussian_kernel(self, apperture_size: int, sigma: float) -> "ImageTransformer":
        return self._add("gaussiankernel", appertureSize=apperture_size,
                         sigma=sigma)

    def flip(self, code: int = 1) -> "ImageTransformer":
        return self._add("flip", code=code)

    def normalize(self, mean=None, std=None) -> "ImageTransformer":
        return self._add("normalize", mean=mean, std=std)

    # -- application ----------------------------------------------------
    def _apply_ops(self, batch: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            x = ops.as_images(batch, self.device)
            for spec in (self.stages or []):
                name = spec["stage"]
                if name not in _STAGE_FNS:
                    raise ValueError(f"unknown image stage '{name}'; "
                                     f"known: {sorted(_STAGE_FNS)}")
                x = _STAGE_FNS[name](x, spec)
            return _to_host(x)

    def transform(self, table: DataTable) -> DataTable:
        col = table[self.inputCol]
        if col.dtype == object:
            # ragged: group rows by shape, one batch per group
            by_shape: dict[tuple, list[int]] = {}
            for i, img in enumerate(col):
                by_shape.setdefault(np.asarray(img).shape, []).append(i)
            results: list[Optional[np.ndarray]] = [None] * len(col)
            out_shapes = set()
            for shape, idxs in by_shape.items():
                batch = np.stack([np.asarray(col[i]) for i in idxs])
                out = self._apply_ops(batch)
                out_shapes.add(out.shape[1:])
                for j, i in enumerate(idxs):
                    results[i] = out[j]
            if len(out_shapes) == 1 and results:
                stacked = np.stack(results)
                return self._with_image(table, stacked)
            return table.with_column(self.outputCol, object_column(results))
        return self._with_image(table, self._apply_ops(col))

    def _with_image(self, table: DataTable, arr: np.ndarray) -> DataTable:
        meta = ColumnMeta(image=ImageSchema(
            height=arr.shape[1], width=arr.shape[2],
            channels=arr.shape[3] if arr.ndim > 3 else 1))
        return table.with_column(self.outputCol, arr, meta=meta)


class UnrollImage(Transformer):
    """Flatten images to CHW float vectors for classical learners
    (reference UnrollImage.scala:18-42)."""

    saved_class = "mmlspark_tpu.vision.transformer.UnrollImage"

    inputCol = Param("image", "input image column", ptype=str)
    outputCol = Param("unrolled", "flattened output column", ptype=str)

    def __init__(self, device="cuda", **kwargs):
        super().__init__(**kwargs)
        self.device = resolve_device(device)

    def transform(self, table: DataTable) -> DataTable:
        col = table[self.inputCol]
        if col.dtype == object:
            raise ValueError(
                "UnrollImage needs a uniform image tensor; resize first "
                "(ImageTransformer.resize)")
        with torch.inference_mode():
            flat = _to_host(ops.unroll(col, device=self.device))
        return table.with_column(self.outputCol, flat)
