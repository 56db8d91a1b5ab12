"""Build and load the host image decoder (the decode half of
`mmlspark_tpu/native_loader.py`).

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

Decoding is host work: nothing here touches the device.
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

NATIVE_CACHE = config.register(
    "MMLSPARK_TPU_NATIVE_CACHE", default=None,
    doc="Directory for the compiled native (C++) decoder; default "
        "mmlspark_tpu_torch/_build/ (native_loader.py).")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def source_paths() -> list:
    return [os.path.join(NATIVE_DIR, s) for s in SOURCES]


def _cache_dir() -> str:
    d = config.get("MMLSPARK_TPU_NATIVE_CACHE") or BUILD_DIR
    os.makedirs(d, exist_ok=True)
    return d


def _source_digest() -> str:
    h = hashlib.sha256()
    for path in source_paths():
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(_cache_dir(), f"libmmldecode-{_source_digest()}.so")


def build_native() -> str:
    """Compile the decoder if needed and return the .so path; raises
    (`subprocess.CalledProcessError` with g++'s message, or `OSError`)
    when it cannot be built."""
    so_path = library_path()
    if os.path.exists(so_path):
        return so_path
    tmp = f"{so_path}.{os.getpid()}.tmp"   # per process: builds may race
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-pthread", "-o", tmp,
           *source_paths(), *LINK_LIBS]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    os.replace(tmp, so_path)
    return so_path


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
