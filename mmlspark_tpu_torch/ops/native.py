"""Build and load the hand-written CUDA kernels.

Each source in `mmlspark_tpu_torch/csrc/` is compiled by `nvcc` for Hopper
(`sm_90a`) into a shared library with a plain C interface, at first use,
into `mmlspark_tpu_torch/_build/` (git-ignored).  The library's file name
carries a hash of its sources and flags, so an edited source never loads a
stale build.  `build()` starts one `nvcc` per source, all at once.

Every C entry point launches on the stream it is given, allocates nothing,
and returns `cudaGetLastError()`; `check()` turns a non-zero code into an
exception.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# library name -> {C function: argtypes}; every function returns an int
# (the cudaError_t of its launches)
SIGNATURES = {
    "flash_attention": {
        # q, k, v, out, lse, B, H, Sq, Sk, D, scale, causal, q_off, k_off,
        # dtype, stream
        "mmlspark_flash_forward": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _F, _I, _I, _I, _I, _P],
    },
    "flash_backward": {
        # q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, D, scale, causal,
        # q_off, k_off, dtype, stream
        "mmlspark_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _F, _I, _I, _I, _I, _P],
        # q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, D, scale, causal,
        # q_off, k_off, dtype, stream
        "mmlspark_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                   _I, _I, _I, _F, _I, _I, _I, _I, _P],
    },
    "decode_attention": {
        # q, k_cache, v_cache, visible, k_scale, v_scale, partials,
        # counters, out, m_out, l_out, B, L, H, D, span, scale, q_dtype,
        # cache_dtype, stream
        "mmlspark_sqa_forward": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _F, _I, _I, _P],
    },
}

_libs: dict = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (on PATH or under CUDA_HOME); the port's "
            "kernels are built from source at first use")
    return path


def library_path(name: str) -> str:
    """Where `name`'s shared library lives: keyed by a hash of the .cu
    source, every header in csrc/, and the compiler flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC, f"{name}.cu")] + sorted(
            glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names=tuple(SIGNATURES)) -> float:
    """Compile every library in `names` that is not built yet, one `nvcc`
    process per source, all started together.  Returns the seconds spent;
    raises with the compiler's output if any build fails.  The compiler's
    log (registers, shared memory, spills) stays beside each library."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for name in names:
        target = library_path(name)
        if os.path.exists(target):
            continue
        tmp = f"{target}.{os.getpid()}.tmp"
        log = open(target[:-3] + ".log", "w")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        jobs.append((name, target, tmp, log,
                     subprocess.Popen(cmd, stdout=log,
                                      stderr=subprocess.STDOUT)))
    failed = []
    for name, target, tmp, log, proc in jobs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, target)
        else:
            with open(log.name) as f:
                failed.append(f"{name} (nvcc exit {rc}):\n{f.read()}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(library_path(name))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(code: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
