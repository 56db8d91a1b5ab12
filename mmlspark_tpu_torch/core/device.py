"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: the default
is "cuda", and a default that finds no usable card raises instead of
quietly computing on the host.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch.device an entry point runs on; raises when CUDA is asked
    for (the default) and no card is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "host explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda | cpu)")
    return dev


@contextlib.contextmanager
def exact_f32() -> Iterator[None]:
    """TF32 off for cuDNN convolutions and cuBLAS matmuls inside the
    block, the caller's settings restored after it."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
