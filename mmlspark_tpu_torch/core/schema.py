"""Column metadata carried by `DataTable` (the port's copy of the part of
`mmlspark_tpu/core/schema.py` that the table needs).

`ColumnMeta` keeps the same fields and JSON form as the JAX package's, so
a table saved by either package loads in the other with its metadata.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np


def _json_scalar(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    if isinstance(v, np.str_):
        return str(v)
    return v


@dataclasses.dataclass
class CategoricalMap:
    """Bidirectional value<->index map for a categorical column; `levels[i]`
    is the raw value encoded as index i."""

    levels: list
    ordinal: bool = False
    has_null_level: bool = False

    def to_json(self) -> dict:
        return {
            "levels": [_json_scalar(v) for v in self.levels],
            "ordinal": self.ordinal,
            "has_null_level": self.has_null_level,
        }

    @staticmethod
    def from_json(d: dict) -> "CategoricalMap":
        return CategoricalMap(list(d["levels"]), bool(d.get("ordinal", False)),
                              bool(d.get("has_null_level", False)))


@dataclasses.dataclass
class ImageSchema:
    """Shape/layout contract for a batched HWC uint8 image column."""

    height: int
    width: int
    channels: int = 3
    color_space: str = "BGR"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "ImageSchema":
        return ImageSchema(**d)


@dataclasses.dataclass
class BinaryFileSchema:
    """Marks a column of raw file bytes, with paths alongside."""

    path_col: Optional[str] = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "BinaryFileSchema":
        return BinaryFileSchema(**d)


@dataclasses.dataclass
class ColumnMeta:
    """Per-column ML metadata: the scored-columns protocol (score_model /
    score_kind / model_kind), categorical levels, image/binary payload
    markers, and free-form extras."""

    score_model: Optional[str] = None
    score_kind: Optional[str] = None
    model_kind: Optional[str] = None
    categorical: Optional[CategoricalMap] = None
    image: Optional[ImageSchema] = None
    binary: Optional[BinaryFileSchema] = None
    extra: dict = dataclasses.field(default_factory=dict)

    def copy(self) -> "ColumnMeta":
        return dataclasses.replace(self, extra=dict(self.extra))

    def to_json(self) -> dict:
        d: dict[str, Any] = {}
        for name in ("score_model", "score_kind", "model_kind"):
            if getattr(self, name) is not None:
                d[name] = getattr(self, name)
        for name in ("categorical", "image", "binary"):
            if getattr(self, name) is not None:
                d[name] = getattr(self, name).to_json()
        if self.extra:
            d["extra"] = self.extra
        return d

    @staticmethod
    def from_json(d: dict) -> "ColumnMeta":
        return ColumnMeta(
            score_model=d.get("score_model"),
            score_kind=d.get("score_kind"),
            model_kind=d.get("model_kind"),
            categorical=(CategoricalMap.from_json(d["categorical"])
                         if "categorical" in d else None),
            image=ImageSchema.from_json(d["image"]) if "image" in d else None,
            binary=(BinaryFileSchema.from_json(d["binary"])
                    if "binary" in d else None),
            extra=d.get("extra", {}),
        )
