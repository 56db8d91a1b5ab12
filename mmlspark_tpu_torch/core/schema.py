"""Column metadata carried by `DataTable`: score kinds, categorical
levels, image schema (the port's copy of `mmlspark_tpu/core/schema.py`).

`ColumnMeta` keeps the same fields and JSON form as the JAX package's, so
a table saved by either package loads in the other with its metadata.
Evaluators discover the scored-label / score columns by this metadata
(`find_score_columns`), never by hard-coded names.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Optional

import numpy as np


class SchemaConstants:
    MML_TAG = "mml"                     # metadata namespace tag
    SCORE_MODEL_PREFIX = "score_model"  # value identifying the producing model
    SCORE_COLUMN_KIND = "score_column_kind"

    # score column kinds
    SCORES_COLUMN = "scores"
    SCORED_LABELS_COLUMN = "scored_labels"
    SCORED_PROBABILITIES_COLUMN = "scored_probabilities"
    TRUE_LABELS_COLUMN = "true_labels"

    # model categories
    CLASSIFICATION_KIND = "classification"
    REGRESSION_KIND = "regression"

    SPARK_PREDICTION_COLUMN = "prediction"


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

    def __post_init__(self):
        self._index: dict = {v: i for i, v in enumerate(self.levels)}

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def get_index(self, value, default: int = -1) -> int:
        return self._index.get(value, default)

    def get_level(self, index: int):
        return self.levels[index]

    def to_indices(self, values) -> np.ndarray:
        return np.asarray([self._index.get(v, -1) for v in values],
                          dtype=np.int32)

    def to_levels(self, indices) -> np.ndarray:
        """Levels of `indices` (object array); an index outside the levels
        gives None."""
        idx = np.asarray(indices, dtype=np.int64)
        if ((idx < 0) | (idx >= len(self.levels))).any():
            out = np.empty(len(idx), dtype=object)
            for i, j in enumerate(idx):
                out[i] = self.levels[j] if 0 <= j < len(self.levels) else None
            return out
        return np.asarray(self.levels, dtype=object)[idx]

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

    @property
    def is_categorical(self) -> bool:
        return self.categorical is not None

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


_score_tag_seq = itertools.count(1)


def set_score_column(table, model_uid: str, column: str, score_kind: str,
                     model_kind: str) -> None:
    """Tag `column` as a score column produced by `model_uid` (in place);
    `extra["score_seq"]` records the order of tagging."""
    meta = table.meta(column)
    meta.score_model = model_uid
    meta.score_kind = score_kind
    meta.model_kind = model_kind
    meta.extra["score_seq"] = next(_score_tag_seq)
    table.set_meta(column, meta)


def find_score_columns(table, model_uid: Optional[str] = None) -> dict:
    """Map score_kind -> column name for columns tagged by `model_uid`, or,
    when it is None, by the most recently tagged model (by tagging order,
    not column order)."""
    tagged = {c: m for c in table.columns
              if (m := table.meta(c)).score_model is not None}
    if model_uid is None:
        if not tagged:
            return {}
        latest = max(tagged.values(),
                     key=lambda m: m.extra.get("score_seq", 0))
        model_uid = latest.score_model
    return {m.score_kind: c for c, m in tagged.items()
            if m.score_model == model_uid}


def make_categorical(table, column: str, levels: Optional[list] = None,
                     ordinal: bool = False, output_col: Optional[str] = None):
    """A new table whose `output_col` (default: `column`) holds int32
    level indices and carries a CategoricalMap.  Without `levels`: first
    appearance order when `ordinal`, else numeric order for numbers and
    (type name, str) order for anything else."""
    values = table[column]
    vals_list = list(values.tolist() if isinstance(values, np.ndarray)
                     else values)
    if levels is None:
        seen: dict = {}
        for v in vals_list:
            if v not in seen:
                seen[v] = len(seen)
        if ordinal:
            levels = list(seen)
        elif all(isinstance(v, (int, float)) and not isinstance(v, bool)
                 for v in seen):
            levels = sorted(seen)
        else:
            levels = sorted(seen, key=lambda v: (str(type(v)), str(v)))
    cmap = CategoricalMap(list(levels), ordinal=ordinal)
    out = output_col or column
    new = table.with_column(out, cmap.to_indices(vals_list))
    meta = new.meta(out)
    meta.categorical = cmap
    new.set_meta(out, meta)
    return new


def get_categorical_map(table, column: str) -> Optional[CategoricalMap]:
    return table.meta(column).categorical
