"""One run of one cell: the pieces found by name, the driver's window, the
metrics, the check of `correct`, and the result line.

A driver module (`drivers/<name>.py`) exposes `run(ctx) -> Outcome`; it
makes its inputs from `ctx.seed` through `harness/traffic.py`, measures
for `ctx.seconds`, and compares what the timed path produced with
`ctx.reference` (`harness/compare.py`).
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time
from types import ModuleType
from typing import Optional

from cellbench.harness import compare, manifest
from cellbench.harness.trace import breakdown

BANNED = ("jax", "jaxlib", "flax", "mmlspark_tpu")


@dataclasses.dataclass
class Context:
    workload: str
    config: dict
    traffic: dict
    reference: ModuleType
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object          # torch.device
    t_start: float          # perf_counter at process start


@dataclasses.dataclass
class Outcome:
    setup_s: float
    attempted: int
    failed: int
    end_to_end: dict        # name -> value
    record: dict            # what the per-layer readers read
    numbers: dict           # compared number -> (value, where)
    memory_peak_bytes: int


def banned_modules(modules) -> list:
    """Loaded modules whose top-level name (before the first dot) is a
    JAX package's, compared whole."""
    return sorted({m for m in modules if m.split(".")[0] in BANNED})


def context(workload: str, seed: int, seconds: float, trace: bool, device,
            t_start: float, root: str = manifest.ROOT) -> Context:
    """A cell's pieces, found by the names `BENCHMARK.json` gives."""
    cell = manifest.Manifest(root).workload(workload)
    return Context(workload, manifest.config(cell["config"]),
                   manifest.traffic(cell["traffic"]),
                   manifest.reference(cell["config"]),
                   manifest.limits(workload), seed, seconds, trace, device,
                   t_start)


def free_device() -> None:
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def execute(workload: str, seed: int, seconds: float, trace: bool, device,
            t_start: float, root: str = manifest.ROOT) -> tuple:
    """(the result line's object, the compared numbers with where each
    was read) of one run."""
    ctx = context(workload, seed, seconds, trace, device, t_start, root)
    out = manifest.driver(ctx.traffic["driver"]).run(ctx)
    return result(ctx, out, manifest.Manifest(root)), out.numbers


def result(ctx: Context, out: Outcome, bench: manifest.Manifest) -> dict:
    """The result line of a run's outcome: the cell's end-to-end metrics
    (`--trace 0`) or per-layer metrics (`--trace 1`, those whose reader
    finds something), the device, the breakdown of a traced run, and
    last the checks."""
    import torch
    correct, checks = compare.verdict(out.numbers, ctx.limits)
    metrics = {}
    if not ctx.trace:
        values = {**out.end_to_end, "setup_s": out.setup_s}
        for m in bench.end_to_end(ctx.workload):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in bench.per_layer(ctx.workload):
            value = manifest.metric_reader(m["name"]).read(out.record)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = torch.device(ctx.device)
    on_card = dev.type == "cuda"
    line = {
        "correct": bool(correct and out.failed == 0),
        "attempted": out.attempted, "failed": out.failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if on_card
                            else dev.type),
                   "count": bench.workload(ctx.workload)["chips"],
                   "memory_peak_bytes": out.memory_peak_bytes},
    }
    t = out.record.get("trace")
    if ctx.trace and t is not None:
        line["device"]["busy_s"] = t["busy_s"]
        line["device"]["window_s"] = t["window_s"]
        line["breakdown"] = breakdown(t)
    line["checks"] = checks
    return line


def check_lines(checks: dict, numbers: dict) -> list:
    """The last lines of standard error: each number, its limit, and the
    leaf or row it was read at."""
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r}; at "
            f"{numbers.get(name, (None, None))[1]})"
            for name, c in checks.items()]


def note(ctx: Context, what: str) -> None:
    """A line on standard error: seconds since the process started and
    what was just done (where set-up goes)."""
    import sys
    print(f"cellbench {time.perf_counter() - ctx.t_start:8.2f} s  {what}",
          file=sys.stderr, flush=True)


def peak_bytes(device) -> int:
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(dev))


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def snapshot(timings) -> dict:
    """A copy of a `PipelineTimings`' seconds and counts by phase."""
    return {"seconds": dict(timings.seconds), "counts": dict(timings.counts)}


def between(a: dict, b: dict) -> dict:
    """What a `PipelineTimings` gained from snapshot `a` to snapshot `b`."""
    return {key: {k: v - a.get(key, {}).get(k, 0)
                  for k, v in b[key].items()} for key in b}


def joined(*parts: dict) -> dict:
    """The sum of `between` parts."""
    out: dict = {"seconds": {}, "counts": {}}
    for part in parts:
        for key in out:
            for k, v in part.get(key, {}).items():
                out[key][k] = out[key].get(k, 0) + v
    return out


class Clean:
    """The window less its profiled span: a traced run's profiler slows the
    host, so its per-layer rates and phase timings are read over the rest
    of the window.  `mark(name, units)` records the time (after a
    synchronize), the units of work done and the phase timings at the
    window's opening ("open"), the profiler's start ("start") and stop
    ("stop"), and its close ("close")."""

    def __init__(self, device, timings):
        self.device, self.timings = device, timings
        self.marks: dict = {}

    def mark(self, name: str, units: float) -> float:
        sync(self.device)
        now = time.perf_counter()
        self.marks[name] = (now, units, snapshot(self.timings))
        return now

    def totals(self) -> tuple:
        """(seconds, units, phase timings) of the window less the span
        from "start" to "stop" (all of it from "start" on when the window
        closed before "stop")."""
        m = self.marks
        spans = [("open", "close")]
        if "start" in m:
            spans = [("open", "start")] + ([("stop", "close")]
                                           if "stop" in m else [])
        seconds = sum(m[b][0] - m[a][0] for a, b in spans)
        units = sum(m[b][1] - m[a][1] for a, b in spans)
        return seconds, units, joined(*(between(m[a][2], m[b][2])
                                        for a, b in spans))


def card_peaks(device) -> Optional[dict]:
    """The card's peaks (`costs/peaks.json`), None off the card or for a
    card the table does not list."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return manifest.peaks(torch.cuda.get_device_name(dev))
