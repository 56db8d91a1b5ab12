"""Build and load the host image decoder and the fused text hasher (the
port of `mmlspark_tpu/native_loader.py`).

The C++ decoder ships as source (`mmlspark_tpu_torch/native/decode.cpp`,
the port's own copy) and is compiled by `g++` at first use into
`mmlspark_tpu_torch/_build/` (git-ignored), or into
`MMLSPARK_TPU_NATIVE_CACHE` where that is set, then loaded with ctypes
once per process.  The library's name carries a digest of the source, so
an edited source never loads a stale build.  When the toolchain or the
codec libraries (libjpeg, libpng, zlib) are missing, `get_native_lib()`
returns None and the readers decode through PIL (`io/image_reader.py`);
`build_native()` raises instead, for a caller that must know which
decoder runs.

The fused text hasher (`native/text.cpp`, the port's own copy: tokenize,
stop-filter, hash and count in one C++ sweep) is a library of its own,
`libmmltext-<digest>.so`, linked with zlib alone, so a host without the
codec headers still builds it (`build_text()` raises, `get_text_lib()`
returns None, and the text chain then runs its Python stages).

Decoding and hashing are host work: nothing here touches the device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from mmlspark_tpu_torch import config

_PKG = os.path.dirname(os.path.abspath(__file__))
NATIVE_DIR = os.path.join(_PKG, "native")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("decode.cpp",)
LINK_LIBS = ("-ljpeg", "-lpng", "-lz")
TEXT_SOURCES = ("text.cpp",)
TEXT_LINK_LIBS = ("-lz",)

NATIVE_CACHE = config.register(
    "MMLSPARK_TPU_NATIVE_CACHE", default=None,
    doc="Directory for the compiled native (C++) decoder; default "
        "mmlspark_tpu_torch/_build/ (native_loader.py).")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False
_text_lib: Optional[ctypes.CDLL] = None
_text_failed = False


def source_paths(sources=SOURCES) -> list:
    return [os.path.join(NATIVE_DIR, s) for s in sources]


def _cache_dir() -> str:
    d = config.get("MMLSPARK_TPU_NATIVE_CACHE") or BUILD_DIR
    os.makedirs(d, exist_ok=True)
    return d


def _source_digest(sources=SOURCES) -> str:
    h = hashlib.sha256()
    for path in source_paths(sources):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(_cache_dir(), f"libmmldecode-{_source_digest()}.so")


def text_library_path() -> str:
    return os.path.join(_cache_dir(),
                        f"libmmltext-{_source_digest(TEXT_SOURCES)}.so")


def _build(so_path: str, sources, link_libs) -> str:
    if os.path.exists(so_path):
        return so_path
    tmp = f"{so_path}.{os.getpid()}.tmp"   # per process: builds may race
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-pthread", "-o", tmp,
           *source_paths(sources), *link_libs]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    os.replace(tmp, so_path)
    return so_path


def build_native() -> str:
    """Compile the decoder if needed and return the .so path; raises
    (`subprocess.CalledProcessError` with g++'s message, or `OSError`)
    when it cannot be built."""
    return _build(library_path(), SOURCES, LINK_LIBS)


def build_text() -> str:
    """Compile the fused text hasher (zlib only) if needed and return the
    .so path; raises as `build_native` does."""
    return _build(text_library_path(), TEXT_SOURCES, TEXT_LINK_LIBS)


def get_native_lib() -> Optional[ctypes.CDLL]:
    """The loaded decoder library, or None if it cannot be built."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            lib = ctypes.CDLL(build_native())
            lib.image_dims.restype = ctypes.c_int
            lib.image_dims.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int)]
            lib.decode_image.restype = ctypes.c_int
            lib.decode_image.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.decode_batch.restype = ctypes.c_int
            lib.decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int)]
            _lib = lib
        except Exception:
            _load_failed = True
    return _lib


def native_decode(data: bytes) -> Optional[np.ndarray]:
    """Decode JPEG/PNG bytes to an (H, W, C) BGR/gray uint8 array; None
    when the buffer is not decodable or the library is absent."""
    lib = get_native_lib()
    if lib is None:
        return None
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.image_dims(data, len(data), ctypes.byref(w), ctypes.byref(h),
                      ctypes.byref(c)) != 0:
        return None
    out = np.empty((h.value, w.value, c.value), np.uint8)
    if lib.decode_image(data, len(data), out.ctypes.data_as(ctypes.c_void_p),
                        w.value, h.value, c.value) != 0:
        return None
    return out


def native_decode_batch(buffers: list) -> Optional[list]:
    """Decode a batch of JPEG/PNG buffers on the library's C++ threads in
    one ctypes call; a list with None for undecodable entries, or None
    when the library is absent."""
    lib = get_native_lib()
    if lib is None:
        return None
    n = len(buffers)
    if n == 0:
        return []
    results: list = [None] * n
    idx: list = []
    dims: list = []
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    for i, data in enumerate(buffers):
        if lib.image_dims(data, len(data), ctypes.byref(w), ctypes.byref(h),
                          ctypes.byref(c)) == 0:
            idx.append(i)
            dims.append((w.value, h.value, c.value))
    if not idx:
        return results
    m = len(idx)
    outs = [np.empty((hh, ww, cc), np.uint8) for (ww, hh, cc) in dims]
    buf_arr = (ctypes.c_char_p * m)(*[buffers[i] for i in idx])
    len_arr = (ctypes.c_int64 * m)(*[len(buffers[i]) for i in idx])
    out_arr = (ctypes.c_void_p * m)(
        *[o.ctypes.data_as(ctypes.c_void_p).value for o in outs])
    w_arr = (ctypes.c_int * m)(*[d[0] for d in dims])
    h_arr = (ctypes.c_int * m)(*[d[1] for d in dims])
    c_arr = (ctypes.c_int * m)(*[d[2] for d in dims])
    status = (ctypes.c_int * m)()
    n_threads = min(m, os.cpu_count() or 1, 16)
    lib.decode_batch(buf_arr, len_arr, out_arr, w_arr, h_arr, c_arr,
                     m, n_threads, status)
    for j, i in enumerate(idx):
        if status[j] == 0:
            results[i] = outs[j]
    return results


def get_text_lib() -> Optional[ctypes.CDLL]:
    """The loaded text-hasher library, or None if it cannot be built."""
    global _text_lib, _text_failed
    if _text_lib is not None or _text_failed:
        return _text_lib
    with _lock:
        if _text_lib is not None or _text_failed:
            return _text_lib
        try:
            lib = ctypes.CDLL(build_text())
            lib.text_hash_count.restype = ctypes.c_int
            lib.text_hash_count.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int)),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte))]
            lib.text_hash_free.restype = None
            lib.text_hash_free.argtypes = [
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_ubyte)]
            _text_lib = lib
        except Exception:
            _text_failed = True
    return _text_lib


def native_text_hash(docs: list, stopwords: list, lowercase: bool,
                     lower_for_stop: bool, min_token_len: int,
                     num_features: int, binary: bool) -> Optional[tuple]:
    """Fused tokenize->stop->hash->count over raw document strings.

    Returns (rows, fallback_idx): `rows[i]` is the (slot_ids int32, vals
    float32) sparse row for doc i (None where i is in fallback_idx:
    non-ASCII documents the caller recomputes through the Python stages,
    which own the unicode tables), or None entirely when the library is
    absent.  `None` cells tokenize to [] (the Tokenizer contract).
    """
    lib = get_text_lib()
    if lib is None or num_features > 2**31 - 1:
        return None
    enc = [("" if d is None else str(d)).encode("utf-8") for d in docs]
    buf = b"".join(enc)
    offsets = np.zeros(len(enc) + 1, np.int64)
    np.cumsum([len(e) for e in enc], out=offsets[1:])
    senc = [s.encode("utf-8") for s in stopwords]
    sbuf = b"".join(senc)
    soff = np.zeros(len(senc) + 1, np.int64)
    np.cumsum([len(e) for e in senc], out=soff[1:])

    slots_p = ctypes.POINTER(ctypes.c_int)()
    vals_p = ctypes.POINTER(ctypes.c_float)()
    bounds_p = ctypes.POINTER(ctypes.c_int64)()
    status_p = ctypes.POINTER(ctypes.c_ubyte)()
    rc = lib.text_hash_count(
        buf, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(enc),
        sbuf, soff.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(senc),
        int(lowercase), int(lower_for_stop), int(min_token_len),
        int(num_features), int(binary),
        ctypes.byref(slots_p), ctypes.byref(vals_p), ctypes.byref(bounds_p),
        ctypes.byref(status_p))
    if rc != 0:
        return None
    try:
        n = len(enc)
        bounds = np.ctypeslib.as_array(bounds_p, shape=(n + 1,)).copy()
        total = int(bounds[-1])
        slots = (np.ctypeslib.as_array(slots_p, shape=(total,)).copy()
                 if total else np.zeros(0, np.int32))
        vals = (np.ctypeslib.as_array(vals_p, shape=(total,)).copy()
                if total else np.zeros(0, np.float32))
        status = (np.ctypeslib.as_array(status_p, shape=(n,)).copy()
                  if n else np.zeros(0, np.uint8))
    finally:
        lib.text_hash_free(slots_p, vals_p, bounds_p, status_p)
    fallback = np.nonzero(status)[0].tolist()
    fb = set(fallback)
    rows = [None if i in fb else (slots[bounds[i]:bounds[i + 1]],
                                  vals[bounds[i]:bounds[i + 1]])
            for i in range(n)]
    return rows, fallback
