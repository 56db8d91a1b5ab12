"""Binary-file enumeration and ingestion (the port of
`mmlspark_tpu/io/files.py`).

The counterpart of the reference's readers (BinaryFileReader.scala:28-69,
HadoopUtils.scala:79-177 SamplePathFilter / RecursiveFlag,
FileUtilities.scala:93-138 ZipIterator): enumerate files under a path
(optionally recursively), sample them by ratio, expand zip archives into
their entries, and load bytes into a DataTable with a `path` column and a
`bytes` column carrying BinaryFileSchema metadata.  The sampling draws
come from `np.random.default_rng(seed)` in the JAX package's order, so a
sampled path list is the JAX package's.
"""

from __future__ import annotations

import fnmatch
import os
import zipfile
from typing import Iterator, Optional

import numpy as np

from mmlspark_tpu_torch.core.schema import BinaryFileSchema, ColumnMeta
from mmlspark_tpu_torch.core.table import DataTable, object_column


def list_files(path: str, recursive: bool = False,
               pattern: Optional[str] = None) -> list[str]:
    """Enumerate files under `path` (a file, directory, or glob pattern)."""
    if any(ch in path for ch in "*?["):
        import glob
        return sorted(p for p in glob.glob(path, recursive=recursive)
                      if os.path.isfile(p))
    if os.path.isfile(path):
        return [path]
    out: list[str] = []
    if recursive:
        for root, _, names in os.walk(path):
            out.extend(os.path.join(root, n) for n in names)
    else:
        out = [os.path.join(path, n) for n in os.listdir(path)
               if os.path.isfile(os.path.join(path, n))]
    if pattern:
        out = [p for p in out if fnmatch.fnmatch(os.path.basename(p), pattern)]
    return sorted(out)


def _zip_entries(path: str, sample_ratio: float,
                 rng: np.random.Generator) -> Iterator[tuple[str, bytes]]:
    """Yield (virtual-path, bytes) per zip entry; sampling applies per
    entry, as the reference's ZipIterator + SamplePathFilter does
    (FileUtilities.scala:93-138, BinaryFileReader.scala:43-59)."""
    with zipfile.ZipFile(path) as zf:
        for info in zf.infolist():
            if info.is_dir():
                continue
            if sample_ratio < 1.0 and rng.random() > sample_ratio:
                continue
            yield f"{path}/{info.filename}", zf.read(info)


def iter_binary_files(path: str, recursive: bool = False,
                      sample_ratio: float = 1.0, inspect_zip: bool = True,
                      pattern: Optional[str] = None,
                      seed: int = 0) -> Iterator[tuple[str, bytes]]:
    """Stream (path, bytes) pairs one file at a time — the out-of-core
    ingestion primitive (the reference streams partitions the same way,
    BinaryFileReader.scala:28-69).  Only one file's bytes are resident at a
    time; corpus size is unbounded by host RAM.

    `path` may also be a remote source — ``http(s)://``, ``gs://``,
    ``s3://`` — with identical sampling/zip/pattern semantics (io/remote.py,
    the reference's HDFS/WASB reader seam, AzureBlobReader.scala:12-47);
    `recursive` is meaningless there (object listings are already flat).
    """
    from mmlspark_tpu_torch.io.remote import is_remote, iter_remote_binary_files
    if is_remote(path):
        yield from iter_remote_binary_files(
            path, sample_ratio=sample_ratio, inspect_zip=inspect_zip,
            pattern=pattern, seed=seed)
        return
    if not 0.0 <= sample_ratio <= 1.0:
        raise ValueError(f"sample_ratio must be in [0,1], got {sample_ratio}")
    rng = np.random.default_rng(seed)
    for p in list_files(path, recursive, pattern):
        if inspect_zip and zipfile.is_zipfile(p):
            yield from _zip_entries(p, sample_ratio, rng)
            continue
        if sample_ratio < 1.0 and rng.random() > sample_ratio:
            continue
        with open(p, "rb") as f:
            yield p, f.read()


def read_binary_files(path: str, recursive: bool = False,
                      sample_ratio: float = 1.0, inspect_zip: bool = True,
                      pattern: Optional[str] = None,
                      seed: int = 0) -> DataTable:
    """Read files into a (path, bytes) table.

    sample_ratio subsamples FILES (not bytes), mirroring SamplePathFilter;
    zips are expanded into entries when inspect_zip (ZipIterator).  For
    corpora larger than host RAM use `iter_binary_files` /
    `read_images_iter` instead.
    """
    paths: list[str] = []
    blobs: list[bytes] = []
    for p, data in iter_binary_files(path, recursive, sample_ratio,
                                     inspect_zip, pattern, seed):
        paths.append(p)
        blobs.append(data)
    table = DataTable({"path": object_column(paths),
                       "bytes": object_column(blobs)})
    meta = ColumnMeta(binary=BinaryFileSchema(path_col="path"))
    table.set_meta("bytes", meta)
    return table
