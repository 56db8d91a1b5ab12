"""The device trace of a short steady part of a window, reduced.

`DeviceTrace` wraps `torch.profiler` with the CUDA activity alone (the
kernels, copies and memsets, and the runtime calls that launched them),
so that the host runs the traced steps at nearly its untraced pace; the
first profiler of a process is started once in set-up, where its
seconds of start-up fall.  `stop()` ends the trace inside the window;
`reduce()`, after the window, exports it to the run's temporary
directory, reads it, deletes it and keeps:

  * `busy_s`: the union of kernel, copy and memset intervals;
  * `window_s`: from the first device interval's start to the last one's
    end, on the trace's own clock (the same clock as `busy_s`);
  * `kernels`: {name: [count, seconds]} of every device operation;
  * `idle_gaps`: the longest gaps between device intervals, each named by
    the runtime call that launched the work ending it and that work.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")


class DeviceTrace:
    def __init__(self, with_device: bool):
        import torch
        acts = [torch.profiler.ProfilerActivity.CUDA if with_device
                else torch.profiler.ProfilerActivity.CPU]
        if with_device:
            warm = torch.profiler.profile(activities=acts)
            warm.start()
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            warm.stop()
        self._prof = torch.profiler.profile(activities=acts)
        self._stopped = False
        self.result: Optional[dict] = None

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> None:
        if not self._stopped:
            self._prof.stop()
            self._stopped = True

    def reduce(self) -> dict:
        self.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        self.result = reduce_events(events)
        return self.result


def _union(intervals: list) -> list:
    """Merged [start, end, the first event] of (start, end, event)."""
    merged: list = []
    for s, e, ev in sorted(intervals, key=lambda iv: iv[:2]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e, ev])
    return merged


def reduce_events(events: list, n_gaps: int = 10) -> dict:
    """Busy, window, kernels by name and the longest idle gaps of chrome
    trace events (times in microseconds in, seconds out)."""
    device, launcher = [], {}
    kernels: dict = {}
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        s, d = float(ev["ts"]), float(ev["dur"])
        corr = (ev.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            device.append((s, s + d, ev))
            k = kernels.setdefault(ev.get("name", "?"), [0, 0.0])
            k[0] += 1
            k[1] += d * 1e-6
        elif cat in HOST_CATS and corr is not None:
            launcher[corr] = ev.get("name", "?")
    if not device:
        return {"busy_s": 0.0, "window_s": 0.0, "kernels": kernels,
                "idle_gaps": []}
    merged = _union(device)
    busy = sum(e - s for s, e, _ in merged) * 1e-6
    window = (merged[-1][1] - merged[0][0]) * 1e-6
    gaps = sorted(((b[0] - a[1], i) for i, (a, b) in
                   enumerate(zip(merged, merged[1:]))), reverse=True)
    named = []
    for length, i in gaps[:n_gaps]:
        ev = merged[i + 1][2]
        call = launcher.get((ev.get("args") or {}).get("correlation"), "?")
        named.append([f"{call} then {ev.get('name', '?')}", length * 1e-6])
    return {"busy_s": busy, "window_s": window, "kernels": kernels,
            "idle_gaps": named}


def breakdown(trace: dict, n: int = 10) -> dict:
    """The result line's `breakdown`: the device operations that took most
    time and the longest idle gaps, each [name, seconds]."""
    ops = sorted(trace["kernels"].items(), key=lambda kv: -kv[1][1])[:n]
    return {"device_ops": [[name[:160], v[1]] for name, v in ops],
            "idle_gaps": [[name[:160], s] for name, s in
                          trace["idle_gaps"][:n]]}


def idle_percent(record: dict) -> Optional[float]:
    """100 x (1 - busy / window) of the traced part of the window."""
    t = record.get("trace")
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
