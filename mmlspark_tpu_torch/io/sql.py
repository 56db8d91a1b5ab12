"""SQL ingestion: database queries into DataTables (the port of
`mmlspark_tpu/io/sql.py`).

The counterpart of the reference's SQL reader (AzureSQLReader.scala:12-29,
which wrapped Spark's JDBC source).  The seam is Python's DB-API 2.0: any
conforming connection works (sqlite3, psycopg2, pyodbc, ...), so the
reader depends on no database package of its own.

  * `read_sql(query, conn)`       - one execute, one fetch, one DataTable.
  * `iter_sql(query, conn, n)`    - DataTable batches of n rows (only one
    batch of rows is resident at a time).

Column typing: `read_sql` infers over the full result - all-numeric
columns become float64 (ints without NULLs stay int64), everything else an
object column with None for SQL NULL.  `iter_sql` keeps dtypes STABLE
across batches (a consumer of fixed-shape batches cannot absorb a
mid-stream dtype flip): it decides numeric-vs-object from the FIRST batch
and renders every numeric column float64 (NULLs as NaN) for the whole
stream.
"""

from __future__ import annotations

from typing import Any, Iterator, Optional

import numpy as np

from mmlspark_tpu_torch.core.table import DataTable, object_column


def _connect(conn: Any):
    """Accept a DB-API connection, a sqlite path/URI, or a zero-arg
    factory returning a connection; returns (connection, owned)."""
    if isinstance(conn, str):
        import sqlite3
        return sqlite3.connect(conn), True
    if callable(conn) and not hasattr(conn, "cursor"):
        return conn(), True
    return conn, False


def _column_array(values: list) -> np.ndarray:
    """Infer one column's array: numeric -> int64/float64, else object."""
    non_null = [v for v in values if v is not None]
    if non_null and all(isinstance(v, (int, float)) and
                        not isinstance(v, bool) for v in non_null):
        if len(non_null) == len(values):
            if all(isinstance(v, int) for v in non_null):
                return np.asarray(values, np.int64)
            return np.asarray(values, np.float64)
        # NULLs force float (NaN holes), the usual dataframe convention
        return np.asarray([np.nan if v is None else float(v)
                           for v in values], np.float64)
    return object_column(values)


def _rows_to_table(names: list[str], rows: list[tuple]) -> DataTable:
    cols = list(zip(*rows)) if rows else [[] for _ in names]
    return DataTable({n: _column_array(list(c))
                      for n, c in zip(names, cols)})


def _is_numeric(values: list) -> bool:
    non_null = [v for v in values if v is not None]
    return bool(non_null) and all(
        isinstance(v, (int, float)) and not isinstance(v, bool)
        for v in non_null)


def _stable_column(values: list, numeric: bool) -> np.ndarray:
    """Stream-stable rendering: numeric -> float64 (NULL as NaN)."""
    if numeric:
        return np.asarray([np.nan if v is None else float(v)
                           for v in values], np.float64)
    return object_column(values)


def iter_sql(query: str, conn: Any, batch_rows: int = 4096,
             params: Optional[tuple] = None) -> Iterator[DataTable]:
    """Stream query results as DataTable batches of `batch_rows`.

    Feeds `TPUModel.transform_batches` directly for score-from-database
    pipelines; the cursor's fetchmany does the windowing, so the database
    result set never materializes on the host at once.  Dtypes are decided
    from the first batch and held STABLE for the whole stream (see module
    docstring): a fixed-shape consumer must not see a mid-stream dtype
    flip.
    """
    if batch_rows <= 0:
        raise ValueError(f"batch_rows must be positive, got {batch_rows}")
    connection, owned = _connect(conn)
    try:
        cur = connection.cursor()
        try:
            cur.execute(query, params or ())
            names = [d[0] for d in cur.description]
            numeric: Optional[list[bool]] = None
            while True:
                rows = [tuple(r) for r in cur.fetchmany(batch_rows)]
                if not rows:
                    break
                cols = [list(c) for c in zip(*rows)]
                if numeric is None:  # schema decided on the first batch
                    numeric = [_is_numeric(c) for c in cols]
                yield DataTable({n: _stable_column(c, isnum)
                                 for n, c, isnum
                                 in zip(names, cols, numeric)})
        finally:
            cur.close()
    finally:
        if owned:
            connection.close()


def read_sql(query: str, conn: Any,
             params: Optional[tuple] = None) -> DataTable:
    """Run `query` once and materialize the full result as one DataTable
    (whole-result type inference: int columns without NULLs stay int64)."""
    connection, owned = _connect(conn)
    try:
        cur = connection.cursor()
        try:
            cur.execute(query, params or ())
            names = [d[0] for d in cur.description]
            return _rows_to_table(names, [tuple(r) for r in cur.fetchall()])
        finally:
            cur.close()
    finally:
        if owned:
            connection.close()
