"""Image ingestion: decode files into batched image tensors (the port of
`mmlspark_tpu/io/image_reader.py`).

The counterpart of the reference's ImageReader (ImageReader.scala:25-62:
per-row OpenCV imdecode inside a Spark UDF; readImages, Readers.scala:
15-50).  Decode runs on the host through the C++ codec
(`native_loader.py`, with PIL as the fallback), and the result is batched:
uniform-size images (or any images with resize_to) land in one dense
(N, H, W, C) uint8 array.  `resize_to` resizes on `device` (default the
card, `ops/image.py`), then rounds half to even, clips and narrows to
uint8 there, so one uint8 batch comes back.

`decoder_counts` counts the images each decoder produced in this process
("native", "pil"), so a caller can see which one ran.
"""

from __future__ import annotations

import threading
from typing import Iterator, Optional

import numpy as np

from mmlspark_tpu_torch.core.pipeline import check_on_error, record_skipped_rows
from mmlspark_tpu_torch.core.schema import ColumnMeta, ImageSchema
from mmlspark_tpu_torch.core.table import DataTable, object_column
from mmlspark_tpu_torch.data import Dataset
from mmlspark_tpu_torch.io.files import read_binary_files
from mmlspark_tpu_torch.native_loader import native_decode, native_decode_batch
from mmlspark_tpu_torch.observe.spans import active_timings, span_on


def _resolve_on_error(on_error: Optional[str], drop_failures: bool) -> str:
    """Back-compat shim: the legacy drop_failures flag maps onto the
    shared on_error policy ('skip'/'fail'); an explicit on_error wins."""
    if on_error is not None:
        return check_on_error(on_error)
    return "skip" if drop_failures else "fail"


decoder_counts = {"native": 0, "pil": 0}
_counts_lock = threading.Lock()


def _count(decoder: str, n: int) -> None:
    if n:
        with _counts_lock:
            decoder_counts[decoder] += n


def _pil_decode(data: bytes) -> Optional[np.ndarray]:
    try:
        import io
        from PIL import Image
        img = Image.open(io.BytesIO(data))
        arr = np.asarray(img.convert("L" if img.mode == "L" else "RGB"))
    except Exception:
        return None
    _count("pil", 1)
    if arr.ndim == 2:
        return arr[:, :, None]
    return arr[:, :, ::-1].copy()  # RGB -> BGR


def decode_bytes(data: bytes) -> Optional[np.ndarray]:
    """Decode one image buffer to (H, W, C) BGR/gray uint8, or None.

    Tries the C++ decoder first; falls back to PIL for formats it doesn't
    cover (or when the native build is unavailable).
    """
    out = native_decode(data)
    if out is not None:
        _count("native", 1)
        return out
    return _pil_decode(data)


def _resize_all(images: list, resize_to: tuple, device="cuda") -> list:
    """Shared resize contract of BOTH readers: every image becomes
    (H, W, 3) uint8, gray widened to 3 channels deterministically (OpenCV
    imdecode's default always-BGR behavior; the streaming reader cannot
    see the whole corpus, so the contract must not depend on it).  Images
    are grouped by source shape; each group goes to `device` once,
    resizes, rounds half to even, clips and narrows to uint8 there, and
    comes back once."""
    import torch

    from mmlspark_tpu_torch.ops.image import resize
    h, w = resize_to
    fixed = [np.repeat(img, 3, axis=2) if img.shape[2] == 1 else img
             for img in images]
    by_shape: dict[tuple, list[int]] = {}
    for i, img in enumerate(fixed):
        by_shape.setdefault(img.shape, []).append(i)
    out: list = [None] * len(fixed)
    for _, idxs in by_shape.items():
        batch = np.stack([fixed[i] for i in idxs])
        with torch.inference_mode():
            res = resize(batch, h, w, device=device).round_().clamp_(
                0, 255).to(torch.uint8).cpu().numpy()
        for j, i in enumerate(idxs):
            out[i] = res[j]
    return out


def decode_many(buffers: list) -> list:
    """Decode a batch of image buffers; None per undecodable entry.

    The C++ thread-pool path (native_decode_batch) decodes the whole batch
    in parallel outside the GIL — the data-loader hot path; entries it
    can't handle (exotic formats, no native lib) retry through the
    per-item `decode_bytes` PIL fallback."""
    native = native_decode_batch(buffers)
    if native is None:
        return [decode_bytes(b) for b in buffers]
    _count("native", sum(img is not None for img in native))
    # the batch call already proved the None entries native-undecodable —
    # retry them through PIL only, not through a second native probe
    return [img if img is not None else _pil_decode(buffers[i])
            for i, img in enumerate(native)]


def read_images(path: str, recursive: bool = False, sample_ratio: float = 1.0,
                inspect_zip: bool = True, resize_to: Optional[tuple] = None,
                drop_failures: bool = True, pattern: Optional[str] = None,
                seed: int = 0, on_error: Optional[str] = None,
                device="cuda") -> DataTable:
    """Read a directory/glob/zip of images into a table.

    Columns: `path`, `image`.  With resize_to=(H, W) `image` is a dense
    (N, H, W, 3) uint8 tensor — ALWAYS 3 channels, grayscale widened
    (the deterministic contract shared with `read_images_iter`).  Without
    resize_to, uniform-shape corpora produce a dense (N, H, W, C) tensor
    with ImageSchema metadata and mixed shapes fall back to an object
    column of per-image arrays.

    Failed decodes follow the `on_error` policy (core/pipeline.py):
    "skip" drops the row (the reference's per-row None filtering,
    ImageReader.scala:55-59), "fail" raises, "column" keeps every row —
    the bad row's image is an all-zero placeholder and the message lands
    in a `decode_error` object column (None for healthy rows), so one
    undecodable image no longer aborts or silently shrinks a batch.
    Default: the legacy `drop_failures` flag (True -> "skip",
    False -> "fail").  `device` is where `resize_to` resizes.
    """
    policy = _resolve_on_error(on_error, drop_failures)
    files = read_binary_files(path, recursive=recursive,
                              sample_ratio=sample_ratio,
                              inspect_zip=inspect_zip, pattern=pattern,
                              seed=seed)
    paths, images, errors = [], [], []
    skipped = 0
    decoded = decode_many(list(files["bytes"]))
    for p, img in zip(files["path"], decoded):
        if img is None:
            if policy == "skip":
                skipped += 1
                continue
            if policy == "fail":
                raise ValueError(f"could not decode image: {p}")
            images.append(None)  # placeholder filled once a shape is known
            paths.append(p)
            errors.append(f"could not decode image: {p}")
            continue
        images.append(img)
        paths.append(p)
        errors.append(None)
    # skipped rows are never silent at the run level: counter + event
    record_skipped_rows("read_images", skipped, "undecodable image")

    if policy == "column":
        shapes = [img.shape for img in images if img is not None]
        fill_shape = ((resize_to + (3,)) if resize_to is not None
                      else (shapes[0] if shapes else (1, 1, 3)))
        images = [np.zeros(fill_shape, np.uint8) if img is None else img
                  for img in images]

    if resize_to is not None and images:
        images = _resize_all(images, resize_to, device)

    shapes = {img.shape for img in images}
    if len(shapes) == 1 and images:
        arr = np.stack(images)
        meta = ColumnMeta(image=ImageSchema(
            height=arr.shape[1], width=arr.shape[2], channels=arr.shape[3]))
        table = DataTable({"path": object_column(paths), "image": arr})
        table.set_meta("image", meta)
    else:
        table = DataTable({"path": object_column(paths),
                           "image": object_column(images)})
    if policy == "column":
        table = table.with_column("decode_error", object_column(errors))
    return table


def service_decode_chunk(chunk: list) -> tuple:
    """Decode one `(path, bytes)` chunk to `([paths], [arrays|None])`:
    the module-level (graph-serializable) form of the decode stage, so
    `read_images_iter(service=...)` can ship it to data-service workers
    by import reference (data/graph.py).  Per-row `on_error` policy is
    NOT applied here: it stays on the consumer thread (`absorb`), so
    failures surface in row order whichever process decoded them."""
    return [p for p, _ in chunk], decode_many([b for _, b in chunk])


def _dense_batch(paths: list, images: list,
                 errors: Optional[list] = None) -> DataTable:
    arr = np.stack(images)
    table = DataTable({"path": object_column(paths), "image": arr})
    table.set_meta("image", ColumnMeta(image=ImageSchema(
        height=arr.shape[1], width=arr.shape[2], channels=arr.shape[3])))
    if errors is not None:
        table = table.with_column("decode_error", object_column(errors))
    return table


def read_images_iter(path: str, batch_size: int = 256,
                     recursive: bool = False, sample_ratio: float = 1.0,
                     inspect_zip: bool = True,
                     resize_to: Optional[tuple] = None,
                     drop_failures: bool = True,
                     pattern: Optional[str] = None,
                     seed: int = 0,
                     on_error: Optional[str] = None,
                     service=None,
                     deterministic: bool = True,
                     device="cuda") -> Iterator[DataTable]:
    """Stream a directory/glob/zip of images as dense fixed-shape batches.

    The out-of-core face of `read_images` (reference streams partitions,
    BinaryFileReader.scala:28-69): yields (path, image) tables of at most
    `batch_size` rows, decoding batch-at-a-time (the parallel C++ decoder)
    — peak residency is one batch of encoded buffers plus up to ~2 batches
    of decoded pixels, so corpus size is unbounded by host RAM.  Feed the
    result to `TPUModel.transform_batches` for streaming scoring.

    Every batch is dense (N, H, W, C) uint8: with resize_to=(H, W) decoded
    images are batch-resized on `device` to (H, W, 3), the same
    deterministic 3-channel contract as `read_images` — while without it
    all images must share one shape (a shape mismatch raises; streaming
    cannot re-group shapes after the fact the way the materializing reader
    does).

    Failed decodes follow `on_error` exactly like `read_images` — with
    the one streaming caveat that "column" without resize_to needs a
    decodable image (or resize_to) before the first failure, since the
    placeholder must match the stream's fixed shape.

    `service` splices the data service into the decode path: pass a
    `data.service.DataService` and the read + decode graph runs on its
    worker processes (`Dataset.distribute`), which see no card, while
    per-row policy, the resize on `device` and batch assembly stay in
    the consumer.  `deterministic=True` (default) keeps batch order
    byte-identical to local execution; False takes first-come dynamic
    sharding.
    """
    policy = _resolve_on_error(on_error, drop_failures)
    if batch_size <= 0:
        raise ValueError(f"batch_size must be positive, got {batch_size}")
    paths: list = []
    images: list = []
    errors: list = []
    first_shape: Optional[tuple] = None

    def decode_batch(chunk):
        # runs on the Dataset map workers: the NEXT batch decodes (C++
        # pool / PIL fallback) while the consumer resizes, assembles,
        # and the caller scores the current one.  Per-row policy checks
        # stay on the consumer thread so failures surface in row order.
        # The span is "image_decode" (the JAX reader books it as "host",
        # beside the scoring stage's own host work).
        with span_on(timings, "image_decode"):
            return [p for p, _ in chunk], decode_many([b for _, b in chunk])

    def absorb(batch_paths: list, decoded: list) -> None:
        nonlocal first_shape
        skipped = 0
        for p, img in zip(batch_paths, decoded):
            if img is None:
                if policy == "skip":
                    skipped += 1
                    continue
                if policy == "fail":
                    raise ValueError(f"could not decode image: {p}")
                if resize_to is not None:
                    img = np.zeros(resize_to + (3,), np.uint8)
                elif first_shape is not None:
                    img = np.zeros(first_shape, np.uint8)
                else:
                    raise ValueError(
                        f"on_error='column' placeholder for {p} needs a "
                        "known shape: pass resize_to or ensure the stream "
                        "starts with a decodable image")
                errors.append(f"could not decode image: {p}")
            else:
                errors.append(None)
            if resize_to is None:
                if first_shape is None:
                    first_shape = img.shape
                elif img.shape != first_shape:
                    raise ValueError(
                        f"streaming without resize_to needs uniform shapes; "
                        f"{p} is {img.shape}, stream started with "
                        f"{first_shape}")
            paths.append(p)
            images.append(img)
        # per decode-batch, on the consumer thread (row-order preserved)
        record_skipped_rows("read_images_iter", skipped,
                            "undecodable image")

    def flush(k: int) -> DataTable:
        nonlocal paths, images, errors
        batch, keep = images[:k], images[k:]
        batch_paths, paths = paths[:k], paths[k:]
        batch_errors, errors = errors[:k], errors[k:]
        images = keep
        return _dense_batch(
            batch_paths, _resize_all(batch, resize_to, device)
            if resize_to is not None else batch,
            batch_errors if policy == "column" else None)

    timings = active_timings()
    # Dataset graph over the file stream: enumeration + reads stay
    # sequential on the pulling thread (ordering contract), decode runs
    # on bounded parallel map workers — peak residency is `depth` decoded
    # batches plus the accumulation buffer, so corpora stay unbounded by
    # host RAM.  The depth knob (MMLSPARK_TPU_PREFETCH_DEPTH) pins the
    # lookahead when positive and hands it to the Autotuner when 0.
    source = Dataset.from_files(path, recursive=recursive,
                                sample_ratio=sample_ratio,
                                inspect_zip=inspect_zip, pattern=pattern,
                                seed=seed).batch(batch_size)
    if service is not None:
        # service path: the serializable module-level decode fn replaces
        # the span-instrumented closure (workers cannot see this run's
        # timings anyway), and the graph below this point runs on the
        # service's worker processes
        staged = (source
                  .map(service_decode_chunk, name="decode", span=None)
                  .distribute(service, deterministic=deterministic)
                  .iterator())
    else:
        staged = (source.map(decode_batch, name="decode", span=None)
                  .iterator())
    try:
        for batch_paths, decoded in staged:
            absorb(batch_paths, decoded)
            while len(images) >= batch_size:
                yield flush(batch_size)
        while images:
            yield flush(batch_size)
    finally:
        staged.close()
