"""Stable token hashing + sparse-row helpers for the hashing trick (the
port's copy of `mmlspark_tpu/feature/hashing.py`).

The reference's string featurization hashes tokens with Spark's HashingTF
into 2^18 slots and keeps only slots seen non-zero in the fit corpus
(AssembleFeatures.scala:198-224: BitSet reduce + VectorSlicer).  Slot
selection is what makes the TPU path dense-friendly: XLA is dense-first, so
instead of materializing 262144-wide batches we select the observed slots
once at fit time and emit a dense (rows, n_selected) block.

Sparse rows (pre-selection) are represented as (indices:int32, values:float32)
tuples in an object column — the host-side analogue of Spark's SparseVector.
"""

from __future__ import annotations

import zlib
from typing import Iterable, Optional, Sequence

import numpy as np


def stable_hash(token: str) -> int:
    """Process-stable 32-bit token hash (crc32; Python's hash() is salted)."""
    return zlib.crc32(token.encode("utf-8"))


def hash_tokens_to_slots(tokens: Iterable[str], num_features: int) -> np.ndarray:
    """Map tokens to slot ids in [0, num_features)."""
    return np.asarray([stable_hash(t) % num_features for t in tokens],
                      dtype=np.int64)


def sparse_count_row(tokens: Sequence[str], num_features: int,
                     binary: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """One row of term counts as (sorted unique indices, counts)."""
    if len(tokens) == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.float32))
    slots = hash_tokens_to_slots(tokens, num_features)
    idx, counts = np.unique(slots, return_counts=True)
    vals = (np.ones(len(idx), np.float32) if binary
            else counts.astype(np.float32))
    return idx.astype(np.int32), vals


def hash_token_lists(token_lists: Sequence[Sequence[str]], num_features: int,
                     binary: bool = False) -> list[tuple[np.ndarray, np.ndarray]]:
    """All rows' term counts in one bulk pass.

    Equivalent to `[sparse_count_row(toks, ...) for toks in token_lists]`
    but hashes the whole corpus in a single C-speed sweep and
    segment-reduces counts with ONE np.unique over (row, slot) keys — the
    reference ran this as a distributed Spark job
    (AssembleFeatures.scala:198-224); per-row Python calls would leave the
    TPU idling behind the host at corpus scale.
    """
    n = len(token_lists)
    lengths = (np.fromiter((len(t) for t in token_lists), np.int64, n)
               if n else np.zeros(0, np.int64))
    total = int(lengths.sum())
    if total == 0:
        empty = (np.zeros(0, np.int32), np.zeros(0, np.float32))
        return [empty] * n
    hashes = np.fromiter(
        (zlib.crc32(t.encode("utf-8")) for toks in token_lists for t in toks),
        np.uint32, total)
    slots = hashes.astype(np.int64) % num_features
    row_ids = np.repeat(np.arange(n, dtype=np.int64), lengths)
    keys = row_ids * num_features + slots
    uniq, counts = np.unique(keys, return_counts=True)
    rows = uniq // num_features
    slot_ids = (uniq % num_features).astype(np.int32)
    vals = (np.ones(len(uniq), np.float32) if binary
            else counts.astype(np.float32))
    bounds = np.searchsorted(rows, np.arange(n + 1))
    return [(slot_ids[bounds[i]:bounds[i + 1]], vals[bounds[i]:bounds[i + 1]])
            for i in range(n)]


def concat_sparse_rows(col) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flatten a sparse-row column to (row_ids, indices, values)."""
    n = len(col)
    lengths = (np.fromiter((len(idx) for idx, _ in col), np.int64, n)
               if n else np.zeros(0, np.int64))
    if int(lengths.sum()) == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.float32))
    row_ids = np.repeat(np.arange(n, dtype=np.int64), lengths)
    indices = np.concatenate([np.asarray(idx, np.int64) for idx, _ in col
                              if len(idx)])
    values = np.concatenate([np.asarray(v, np.float32) for idx, v in col
                             if len(idx)])
    return row_ids, indices, values


def nonzero_slots(sparse_rows: Iterable[tuple[np.ndarray, np.ndarray]]) -> np.ndarray:
    """Union of observed slot ids over the corpus (the BitSet reduce)."""
    arrays = [np.asarray(idx, np.int64) for idx, _ in sparse_rows]
    if not arrays:
        return np.zeros(0, np.int32)
    return np.unique(np.concatenate(arrays)).astype(np.int32)


def densify_sparse_column(col: np.ndarray,
                          selected: Optional[np.ndarray] = None,
                          num_features: Optional[int] = None) -> np.ndarray:
    """Materialize sparse rows as a dense float32 matrix.

    With `selected`, emit one dense column per selected slot (the
    VectorSlicer path); otherwise emit the full `num_features` width.
    """
    n = len(col)
    row_ids, indices, values = concat_sparse_rows(col)
    if selected is not None:
        width = len(selected)
        out = np.zeros((n, width), np.float32)
        if width == 0 or len(indices) == 0:
            return out
        pos = np.searchsorted(selected, indices)
        ok = (pos < width) & (selected[np.minimum(pos, width - 1)] == indices)
        out[row_ids[ok], pos[ok]] = values[ok]
        return out
    if num_features is None:
        raise ValueError("need selected slots or num_features")
    out = np.zeros((n, num_features), np.float32)
    out[row_ids, indices] = values
    return out
