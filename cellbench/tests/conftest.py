"""Tests of the benchmark harness.  Run them from the repository root:

    python -m pytest cellbench/tests -q -p no:cacheprovider

On a machine without a CUDA card the `cuda`-marked tests skip."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")
