"""The one definition of the port's CPU test environment (the port of
`mmlspark_tpu/utils/testenv.py`, whose virtual CPU mesh is XLA's and has
no counterpart here).

The port's tests run on the CPU: no CUDA device visible, float32 as the
default dtype, every tensor made on the CPU.  `pin_cpu_test_env()` sets
that up; call it before anything initializes CUDA (hiding the card with
`CUDA_VISIBLE_DEVICES` is too late afterwards).  With
`MMLSPARK_TPU_TEST_PLATFORM=cuda` it leaves the card visible, for the
`cuda`-marked cases on a machine with one.
"""

from __future__ import annotations

import os

import torch

from mmlspark_tpu_torch import config


def configured_platform() -> str:
    """'cpu' or 'cuda' (MMLSPARK_TPU_TEST_PLATFORM)."""
    platform = str(config.get("MMLSPARK_TPU_TEST_PLATFORM")).lower()
    if platform not in ("cpu", "cuda"):
        raise ValueError(f"MMLSPARK_TPU_TEST_PLATFORM must be 'cpu' or "
                         f"'cuda', got {platform!r}")
    return platform


def budget_seconds() -> float:
    """The per-test duration alert budget (MMLSPARK_TPU_TEST_BUDGET_S)."""
    return float(config.get("MMLSPARK_TPU_TEST_BUDGET_S"))


def pin_cpu_test_env() -> torch.device:
    """Pin the CPU test environment and return the device tests use: on
    'cpu' no CUDA device is visible (unless CUDA was already
    initialized in this process, which this cannot undo), the default
    dtype is float32 and the default device the CPU."""
    torch.set_default_dtype(torch.float32)
    if configured_platform() == "cuda":
        return torch.device("cuda")
    if not torch.cuda.is_initialized():
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
    torch.set_default_device("cpu")
    return torch.device("cpu")
