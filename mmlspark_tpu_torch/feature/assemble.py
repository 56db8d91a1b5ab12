"""Auto-featurization: AssembleFeatures / Featurize (the port's copy of
`mmlspark_tpu/feature/assemble.py`: numpy on the host, as there).

TPU-native counterpart of the reference's featurize component
(AssembleFeatures.scala:133-390, Featurize.scala:67-82): per-column type
dispatch, string hashing with count-based slot selection, one-hot encoding
of categoricals, missing-value handling, and assembly — except the output
is a dense float32 matrix column ready for device transfer instead of a
Spark SparseVector, and the per-row UDF loops become batched numpy ops.

Block order mirrors FastVectorAssembler's categoricals-first rule
(FastVectorAssembler.scala:50): categorical blocks, then numeric/vector
blocks in input order, then the hash-selected string block last.  The block
plan is recorded in the output column's metadata so learners can recover
slot names, categorical slot ranges, and the total width (the MLP
input-autosizing information, TrainClassifier.scala:143-150).
"""

from __future__ import annotations

import json
import os
import weakref
from typing import Optional

import numpy as np

from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.pipeline import (Estimator, JaxTwin, Pipeline,
                                              PipelineModel, Transformer)
from mmlspark_tpu_torch.core.schema import ColumnMeta
from mmlspark_tpu_torch.core.table import DataTable, object_column
from mmlspark_tpu_torch.feature.hashing import (densify_sparse_column,
                                          hash_token_lists, nonzero_slots)

# 2^18 slots by default; 2^12 for tree/NN learners (Featurize.scala:13-19)
NUM_FEATURES_DEFAULT = 1 << 18
NUM_FEATURES_TREE_OR_NN = 1 << 12


def _tokenize_string_columns(cols_data, n: int) -> list[list[str]]:
    """Per-row token lists over several string columns, one pass per column
    (reference hashStringColumns, AssembleFeatures.scala:46-53)."""
    row_tokens: list[list[str]] = [[] for _ in range(n)]
    for cd in cols_data:
        for i, v in enumerate(cd):
            if v is None or v == "":
                continue
            row_tokens[i].extend(str(v).lower().split())
    return row_tokens


class AssembleFeatures(JaxTwin, Estimator):
    """Fit the per-column featurization plan on a table."""

    columnsToFeaturize = Param(None, "columns to featurize",
                               ptype=(list, tuple), required=True)
    featuresCol = Param("features", "assembled output column", ptype=str)
    numberOfFeatures = Param(NUM_FEATURES_DEFAULT,
                             "hash space for string columns", ptype=int)
    oneHotEncodeCategoricals = Param(True, "one-hot encode categoricals",
                                     ptype=bool)

    def fit(self, table: DataTable) -> "AssembleFeaturesModel":
        self._check_required()
        cat_blocks: list[dict] = []
        num_blocks: list[dict] = []
        hash_cols: list[str] = []
        clean_cols: list[str] = []

        for col in self.columnsToFeaturize:
            arr = table[col]
            meta = table.meta(col)
            if meta.is_categorical:
                cat_blocks.append({
                    "col": col, "kind": "categorical",
                    "num_levels": meta.categorical.num_levels,
                    # persist the fitted level order: score-time tables may
                    # carry raw values or a differently-inferred encoding
                    "levels": list(meta.categorical.levels),
                    "ohe": bool(self.oneHotEncodeCategoricals),
                })
                continue
            if arr.dtype == object:
                if any(isinstance(v, str) for v in arr if v is not None):
                    hash_cols.append(col)
                else:  # numeric-list rows must form a rectangular block
                    widths = {len(np.asarray(v).ravel()) for v in arr
                              if v is not None}
                    if len(widths) > 1:
                        raise ValueError(
                            f"column '{col}' has ragged numeric rows "
                            f"(widths {sorted(widths)}); pad or split it "
                            "before featurizing")
                    num_blocks.append({"col": col, "kind": "vector",
                                       "width": widths.pop() if widths else 0})
                    clean_cols.append(col)
                continue
            if arr.ndim > 1:
                num_blocks.append({"col": col, "kind": "vector",
                                   "width": int(np.prod(arr.shape[1:]))})
                clean_cols.append(col)
            elif np.issubdtype(arr.dtype, np.floating):
                num_blocks.append({"col": col, "kind": "numeric", "width": 1})
                clean_cols.append(col)
            elif np.issubdtype(arr.dtype, np.number) or arr.dtype == np.bool_:
                num_blocks.append({"col": col, "kind": "numeric", "width": 1})
            elif np.issubdtype(arr.dtype, np.str_):
                hash_cols.append(col)

        selected = None
        fit_rows = None
        if hash_cols:
            nf = self.numberOfFeatures
            cols_data = [table[c] for c in hash_cols]
            fit_rows = hash_token_lists(
                _tokenize_string_columns(cols_data, table.num_rows), nf)
            selected = nonzero_slots(fit_rows)

        model = AssembleFeaturesModel(
            cat_blocks=cat_blocks, num_blocks=num_blocks,
            hash_cols=hash_cols, clean_cols=clean_cols,
            selected_slots=selected,
            featuresCol=self.featuresCol,
            numberOfFeatures=self.numberOfFeatures,
        )
        if fit_rows is not None:
            # the pipeline transforms the fit table right after fit(); reuse
            # the hashed rows instead of re-tokenizing the whole corpus
            model._fit_cache = (weakref.ref(table), fit_rows)
        return model


class AssembleFeaturesModel(JaxTwin, Transformer):
    """Apply the fitted featurization plan
    (reference AssembleFeaturesModel.transform, AssembleFeatures.scala:307-390).

    Rows with missing values in float/vector feature columns are dropped,
    as the reference's na.drop does (line 352).
    """

    featuresCol = Param("features", "assembled output column", ptype=str)
    numberOfFeatures = Param(NUM_FEATURES_DEFAULT, "hash space", ptype=int)

    def __init__(self, cat_blocks: Optional[list] = None,
                 num_blocks: Optional[list] = None,
                 hash_cols: Optional[list] = None,
                 clean_cols: Optional[list] = None,
                 selected_slots: Optional[np.ndarray] = None,
                 **kwargs):
        super().__init__(**kwargs)
        self._cat_blocks = list(cat_blocks or [])
        self._num_blocks = list(num_blocks or [])
        self._hash_cols = list(hash_cols or [])
        self._clean_cols = list(clean_cols or [])
        self._selected = (np.asarray(selected_slots, np.int32)
                          if selected_slots is not None else None)
        self._fit_cache: Optional[tuple] = None

    @property
    def feature_blocks(self) -> list[dict]:
        """The assembled block plan, categoricals first."""
        blocks = []
        for b in self._cat_blocks:
            width = (b["num_levels"] - 1 if b["ohe"] else 1)
            blocks.append({**b, "width": max(width, 0)})
        blocks.extend({**b} for b in self._num_blocks)
        if self._hash_cols:
            blocks.append({"col": "+".join(self._hash_cols), "kind": "hashed",
                           "width": len(self._selected)})
        return blocks

    @property
    def num_output_features(self) -> int:
        return int(sum(b["width"] for b in self.feature_blocks))

    def _categorical_indices(self, table: DataTable, block: dict) -> np.ndarray:
        """Indices in the FITTED level order.

        Score-time tables may hold raw values (strings) or a categorical
        encoding inferred from different data; both are re-mapped through
        the levels saved at fit time (the reference reads them from column
        metadata, Categoricals.scala:186-261).  Unseen values become -1 and
        one-hot to all zeros.
        """
        from mmlspark_tpu_torch.core.schema import CategoricalMap
        arr = table[block["col"]]
        fitted = CategoricalMap(block["levels"])
        own = table.meta(block["col"]).categorical
        if own is not None:
            if list(own.levels) == block["levels"]:
                return np.asarray(arr, np.int64)
            # re-encoded with different levels: decode then re-map
            return fitted.to_indices(list(own.to_levels(arr))).astype(np.int64)
        if arr.dtype == object or np.issubdtype(arr.dtype, np.str_):
            return fitted.to_indices(list(arr)).astype(np.int64)
        # raw numeric values that match the fitted levels
        if set(np.unique(arr).tolist()) <= set(block["levels"]):
            return fitted.to_indices(arr.tolist()).astype(np.int64)
        return np.asarray(arr, np.int64)

    def transform(self, table: DataTable) -> DataTable:
        for col in self._hash_cols:
            if table[col].dtype != object and not np.issubdtype(
                    table[col].dtype, np.str_):
                raise TypeError(
                    f"column '{col}' must be string at score time "
                    "(reference AssembleFeatures.scala:314)")
        kept = table.drop_nulls(self._clean_cols) if self._clean_cols else table
        n = kept.num_rows
        parts: list[np.ndarray] = []

        for b in self._cat_blocks:
            idx = self._categorical_indices(kept, b)
            if b["ohe"]:
                # Spark OneHotEncoder dropLast: last level encodes as zeros
                width = max(b["num_levels"] - 1, 0)
                block = np.zeros((n, width), np.float32)
                ok = (idx >= 0) & (idx < width)
                block[np.arange(n)[ok], idx[ok]] = 1.0
                parts.append(block)
            else:
                parts.append(idx.astype(np.float32)[:, None])

        for b in self._num_blocks:
            arr = kept[b["col"]]
            if arr.dtype == object:
                arr = np.stack([np.asarray(v, np.float32).ravel() for v in arr]) \
                    if n else np.zeros((0, b["width"]), np.float32)
            block = arr.astype(np.float32)
            parts.append(block.reshape(n, -1) if block.ndim != 1
                         else block[:, None])

        if self._hash_cols:
            nf = self.numberOfFeatures
            rows = None
            cache = self._fit_cache
            self._fit_cache = None  # single-shot: free the corpus rows
            if (cache is not None and cache[0]() is table
                    and kept.num_rows == table.num_rows):
                rows = cache[1]
            if rows is None:
                cols_data = [kept[c] for c in self._hash_cols]
                rows = hash_token_lists(
                    _tokenize_string_columns(cols_data, n), nf)
            parts.append(densify_sparse_column(object_column(rows),
                                               selected=self._selected))

        features = (np.concatenate(parts, axis=1) if parts
                    else np.zeros((n, 0), np.float32))
        meta = ColumnMeta()
        meta.extra["feature_blocks"] = [
            {k: v for k, v in b.items()} for b in self.feature_blocks]
        meta.extra["num_features"] = int(features.shape[1])
        return kept.with_column(self.featuresCol, features, meta=meta)

    # -- persistence ----------------------------------------------------
    def _save_extra(self, path: str) -> None:
        plan = {"cat_blocks": self._cat_blocks, "num_blocks": self._num_blocks,
                "hash_cols": self._hash_cols, "clean_cols": self._clean_cols}
        with open(os.path.join(path, "plan.json"), "w") as f:
            json.dump(plan, f)
        if self._selected is not None:
            np.save(os.path.join(path, "selected.npy"), self._selected)

    def _load_extra(self, path: str, **_init_kwargs) -> None:
        with open(os.path.join(path, "plan.json")) as f:
            plan = json.load(f)
        self._cat_blocks = plan["cat_blocks"]
        self._num_blocks = plan["num_blocks"]
        self._hash_cols = plan["hash_cols"]
        self._clean_cols = plan["clean_cols"]
        sel = os.path.join(path, "selected.npy")
        self._selected = np.load(sel) if os.path.exists(sel) else None


class Featurize(JaxTwin, Estimator):
    """Featurize several column groups, one AssembleFeatures per output
    (reference Featurize.scala:67-82: featureColumns map -> Pipeline)."""

    featureColumns = Param(None, "output col -> list of input cols",
                           ptype=dict, required=True)
    numberOfFeatures = Param(NUM_FEATURES_DEFAULT, "hash space", ptype=int)
    oneHotEncodeCategoricals = Param(True, "one-hot encode categoricals",
                                     ptype=bool)

    def fit(self, table: DataTable) -> PipelineModel:
        self._check_required()
        stages = [
            AssembleFeatures(
                columnsToFeaturize=list(cols), featuresCol=out,
                numberOfFeatures=self.numberOfFeatures,
                oneHotEncodeCategoricals=self.oneHotEncodeCategoricals)
            for out, cols in self.featureColumns.items()
        ]
        return Pipeline(stages).fit(table)
