"""Random table generation for fuzz testing (the port of
`mmlspark_tpu/utils/datagen.py`).

The counterpart of the reference's datagen component
(GenerateDataset.scala:17-114, DatasetOptions.scala): generate DataTables
over a space of column kinds (numeric scalar and vector, string,
categorical, boolean, image) with controllable missing-value rates,
driving the generic stage fuzzing pass (reference Fuzzing.scala:49-104).
The draws are the JAX package's, in its order, so one seed and one set of
options give the same table in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from mmlspark_tpu_torch.core.schema import make_categorical
from mmlspark_tpu_torch.core.table import DataTable, object_column

COLUMN_KINDS = ("double", "int", "bool", "string", "vector", "categorical",
                "image")


@dataclasses.dataclass
class ColumnOptions:
    """Which column kinds to generate and how."""

    kinds: Sequence[str] = COLUMN_KINDS[:6]  # image opt-in (big)
    missing_ratio: float = 0.0
    vector_width: int = 4
    num_levels: int = 3
    image_hw: tuple = (8, 8)


def generate_table(num_rows: int = 20, num_cols: int = 4,
                   options: Optional[ColumnOptions] = None,
                   seed: int = 0,
                   with_label: bool = True) -> DataTable:
    """A random table cycling through the configured column kinds."""
    opts = options or ColumnOptions()
    rng = np.random.default_rng(seed)
    cols: dict = {}
    for i in range(num_cols):
        kind = opts.kinds[i % len(opts.kinds)]
        cols[f"{kind}_{i}"] = _gen_column(kind, num_rows, opts, rng)
    if with_label:
        cols["label"] = rng.integers(0, 2, num_rows).astype(np.int64)
    table = DataTable(cols)
    for name in list(table.columns):
        if name.startswith("categorical_"):
            table = make_categorical(table, name)
    return table


def _gen_column(kind: str, n: int, opts: ColumnOptions,
                rng: np.random.Generator):
    if kind == "double":
        vals = rng.normal(size=n)
        if opts.missing_ratio > 0:
            vals[rng.random(n) < opts.missing_ratio] = np.nan
        return vals
    if kind == "int":
        return rng.integers(-100, 100, n).astype(np.int64)
    if kind == "bool":
        return rng.integers(0, 2, n).astype(np.bool_)
    if kind == "string":
        words = ["alpha", "beta", "gamma", "delta", "epsilon"]
        out = [" ".join(rng.choice(words, size=rng.integers(1, 4)))
               for _ in range(n)]
        if opts.missing_ratio > 0:
            out = [None if rng.random() < opts.missing_ratio else v
                   for v in out]
        return object_column(out)
    if kind == "vector":
        return rng.normal(size=(n, opts.vector_width)).astype(np.float32)
    if kind == "categorical":
        return object_column(
            [f"level{int(i)}" for i in rng.integers(0, opts.num_levels, n)])
    if kind == "image":
        h, w = opts.image_hw
        return rng.integers(0, 255, size=(n, h, w, 3), dtype=np.uint8)
    raise ValueError(f"unknown column kind '{kind}'")
