"""Opt-in device profiling (the port of `mmlspark_tpu/observe/profiler.py`).

    with mmlspark_tpu_torch.profile("/tmp/trace"):
        model.transform(table)

wraps `torch.profiler.profile` (host operators, and the card's kernels
and copies where a card is present) and writes a Chrome trace
(`trace.json`, loadable in Perfetto or chrome://tracing) into the
directory when the block exits: host dispatch against device kernel
time per step.  `annotate(name)` is a named host-side span inside an
active profile (`torch.profiler.record_function`); outside one it costs
the profiler's own inactive check.  The framework-side run record
(`run_telemetry`'s trace.json, observe/telemetry.py) uses the same
Perfetto timeline idiom, so the two dumps load side by side.
"""

from __future__ import annotations

import contextlib
import os

import torch

from mmlspark_tpu_torch.observe.logging import get_logger

TRACE_FILE = "trace.json"


def _activities() -> list:
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def profile(log_dir: str, *, record_shapes: bool = False):
    """Capture a host (+ device) trace of the block into
    `log_dir/trace.json`; yields the path.  A profiler that fails to
    start is logged, never swallowed: the block then runs untraced and
    the warning says so (a missing trace must not read as an idle
    card)."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    prof = None
    try:
        prof = torch.profiler.profile(activities=_activities(),
                                      record_shapes=record_shapes)
        prof.__enter__()
    except Exception as exc:
        get_logger("observe").warning(
            "torch.profiler failed to start (%r); the block runs "
            "untraced and no %s is written", exc, path)
        prof = None
    try:
        yield path
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(path)


def annotate(name: str):
    """Named host-side span, visible inside an active profile."""
    return torch.profiler.record_function(name)
