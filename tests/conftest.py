"""Test config: force an 8-device virtual CPU mesh before JAX initializes.

Multi-chip hardware is not available in CI; sharding/collective tests run on
8 virtual CPU devices (the reference's analogue was local[*] Spark sessions,
SparkSessionFactory.scala:40-51 — all "distributed" tests single-host).
"""

import os

# MMLSPARK_TPU_TEST_PLATFORM=tpu runs the suite against the real chip
# (scripts/check.sh uses it for the TPU-gated perf floors); default is the
# 8-virtual-device CPU mesh.  Bootstrap read via os.environ: this gates JAX
# initialization, which must happen before the package (and its config
# registry) can be imported; the var is still declared in mmlspark_tpu.config.
_platform = os.environ.get("MMLSPARK_TPU_TEST_PLATFORM", "cpu")
if _platform == "cpu":
    # the ONE mesh definition shared with the pin-regeneration scripts —
    # committed pins are only valid when all of them compute identically
    from mmlspark_tpu.utils.testenv import pin_virtual_cpu_mesh
    pin_virtual_cpu_mesh()
else:
    os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: F401  (backend must initialize after the pinning above)

import numpy as np
import pytest


def pytest_configure(config):
    # tag-gated tests, the reference's Extended/LinuxOnly analogue
    # (TestBase.scala:16-24, tools/config.sh:119-141)
    config.addinivalue_line("markers", "slow: long-running (build/e2e) test")
    config.addinivalue_line(
        "markers", "budget(seconds): per-test duration alert budget "
        "override (compile-heavy distributed-autodiff tests)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the PyTorch port's CUDA "
        "kernels); skips on a host without one")
    config.addinivalue_line(
        "markers", "requires_env(*capabilities): skip (with the probe's "
        "reason) when the environment lacks a named capability — see "
        "tests/capabilities.py for the probe set")


def pytest_runtest_setup(item):
    """The capability gate (tests/capabilities.py): runs BEFORE fixture
    setup, so an unavailable capability skips the test without ever
    entering its (possibly expensive, certainly doomed) fixtures."""
    from capabilities import probe  # tests/ dir is on sys.path (conftest)
    for marker in item.iter_markers("requires_env"):
        for name in marker.args:
            available, reason = probe(name)
            if not available:
                pytest.skip(
                    f"environment capability {name!r} unavailable: {reason}")


# -- test-duration alert budgets (reference TestBase.scala:47-68,138-153:
# alert at >3s/test, >10s/suite; XLA compiles make those numbers 10x here,
# MMLSPARK_TPU_TEST_BUDGET_S overrides) -------------------------------------
from mmlspark_tpu import config as _mml_config

_TEST_BUDGET_S = float(_mml_config.TEST_BUDGET_S.current())
_over_budget: list = []


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_makereport(item, call):
    outcome = yield
    report = outcome.get_result()
    if report.when == "call":
        marker = item.get_closest_marker("budget")
        budget = _TEST_BUDGET_S
        if marker is not None:
            budget = float(marker.args[0] if marker.args
                           else marker.kwargs.get("seconds", _TEST_BUDGET_S))
        if report.duration > budget:
            _over_budget.append((report.nodeid, report.duration))


def pytest_terminal_summary(terminalreporter):
    if _over_budget:
        terminalreporter.section(
            f"tests over the {_TEST_BUDGET_S:.0f}s alert budget")
        for nodeid, duration in sorted(_over_budget, key=lambda t: -t[1]):
            terminalreporter.write_line(f"  ALERT {duration:7.1f}s  {nodeid}")


@pytest.fixture(autouse=True)
def _fresh_process_counters():
    """Process counters are global tallies (observe/metrics.py); without a
    per-test reset, a counter assertion's truth depends on which tests ran
    before it (the retry/breaker/checkpoint tests all bump the same
    namespace).  Zeroing at test START makes every assertion
    order-independent; run_telemetry additionally reports per-run DELTAS
    for the same reason."""
    from mmlspark_tpu.observe.metrics import reset_counters
    reset_counters()
    yield


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def small_table():
    from mmlspark_tpu import DataTable
    return DataTable({
        "numbers": np.arange(10, dtype=np.float32),
        "words": [f"w{i % 3}" for i in range(10)],
        "label": np.array([i % 2 for i in range(10)], dtype=np.int32),
        "feats": np.arange(30, dtype=np.float32).reshape(10, 3),
    })
