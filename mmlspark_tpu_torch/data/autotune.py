"""Depth autotuning for Dataset stages (the port of
`mmlspark_tpu/data/autotune.py`, the tf.data move).

Every parallel stage's `Prefetcher` keeps always-on counters: deliveries,
stalls (pulls that blocked on an unfinished item), stall seconds and queue
residency.  The `Autotuner` samples them every `interval` sink pulls and
turns the window deltas into depth decisions:

  * **widen the bottleneck**: the stage whose window stalled the consumer
    for the most wall time (stall fraction above WIDEN_STALL_FRAC) gets
    its staged window grown ~1.5x, up to MMLSPARK_TPU_DATA_MAX_DEPTH.  A
    deeper window admits more concurrent map workers (min(depth, pool
    width)), so this is both the depth and the worker-count lever.
  * **back off on slack**: a stage that never stalls and whose queue rides
    near-full (residency above NARROW_RESIDENCY_FRAC of capacity) shrinks
    by one, never below the floor (`DEPTH_FLOOR`).

Decisions are published while a telemetry run is active: per-stage
`data.<stage>.depth` / `.stall_frac` gauges and a `data.autotune` trace
event stream (cat="data").  The controller is pure arithmetic over
counter snapshots: tests drive it with synthetic stage stats.
"""

from __future__ import annotations

from typing import Optional

from mmlspark_tpu_torch import config
from mmlspark_tpu_torch.parallel.prefetch import DEPTH_FLOOR

AUTOTUNE_INTERVAL = config.register(
    "MMLSPARK_TPU_DATA_AUTOTUNE_INTERVAL", default=32, ptype=int,
    doc="Sink pulls between Dataset autotune decisions: each interval "
        "the tuner reads per-stage stall/residency counter windows and "
        "may widen the bottleneck stage or narrow a slack one.")

DATA_MAX_DEPTH = config.register(
    "MMLSPARK_TPU_DATA_MAX_DEPTH", default=64, ptype=int,
    doc="Ceiling on any autotuned Dataset stage's staged-window depth "
        "(bounds host RAM held in staged batches; pinned depths are "
        "not clamped).")

DATA_MAX_WORKERS = config.register(
    "MMLSPARK_TPU_DATA_MAX_WORKERS", default=16, ptype=int,
    doc="Thread-pool width of an autotuned map stage; effective "
        "concurrency is min(depth, this), so widening the staged window "
        "recruits more workers up to this cap.")


class Autotuner:
    """Depth controller over a Dataset iterator's tunable stages.

    `stages` is a list of handles exposing `.name` and `.runner`, where
    the runner has the Prefetcher tuning surface: `stats()`, `depth`,
    `max_depth`, `set_depth()`.  Call `tick()` once per sink delivery;
    every `interval` ticks it takes a `step()` (callable directly in
    tests, no wall-clock involved).
    """

    WIDEN_STALL_FRAC = 0.25     # >25% of pulls blocked -> starved consumer
    NARROW_STALL_FRAC = 0.05    # <5% blocked -> stage is keeping up
    NARROW_RESIDENCY_FRAC = 0.5  # queue >half full on average -> slack

    def __init__(self, stages, *, interval: Optional[int] = None,
                 floor: Optional[int] = None):
        from mmlspark_tpu_torch.observe.telemetry import active_run
        self._stages = list(stages)
        self._interval = max(1, int(
            interval if interval is not None
            else config.get("MMLSPARK_TPU_DATA_AUTOTUNE_INTERVAL")))
        self._floor = max(1, int(floor if floor is not None else DEPTH_FLOOR))
        self._pulls = 0
        self._last = {id(s): s.runner.stats() for s in self._stages}
        self._run = active_run()
        self.decisions: list = []  # every applied change, for inspection

    # -- cadence --------------------------------------------------------
    def tick(self) -> None:
        self._pulls += 1
        if self._pulls % self._interval == 0:
            self.step()

    # -- one decision ---------------------------------------------------
    def step(self) -> list:
        """Read each stage's counter window since the last step and apply
        at most one widen (the bottleneck) plus any back-offs; returns
        the decisions made this step."""
        windows = []
        for s in self._stages:
            cur = s.runner.stats()
            prev = self._last[id(s)]
            self._last[id(s)] = cur
            delta = {k: cur[k] - prev[k]
                     for k in ("deliveries", "stalls", "stall_s",
                               "residency")}
            if delta["deliveries"] <= 0:
                continue  # stage idle this window: no evidence either way
            stall_frac = delta["stalls"] / delta["deliveries"]
            residency_frac = (delta["residency"]
                              / (delta["deliveries"]
                                 * max(1, s.runner.depth)))
            windows.append((s, stall_frac, residency_frac, delta))
            if self._run is not None:
                self._run.gauge(f"data.{s.name}.depth", s.runner.depth)
                self._run.gauge(f"data.{s.name}.stall_frac",
                                round(stall_frac, 4))

        made = []
        # widen exactly one stage per step — the one the consumer lost the
        # most wall time to — so depth changes stay attributable and the
        # next window measures their effect in isolation
        starved = [(d["stall_s"], sf, s) for s, sf, _, d in windows
                   if sf > self.WIDEN_STALL_FRAC
                   and s.runner.depth < s.runner.max_depth]
        if starved:
            stall_s, sf, s = max(starved, key=lambda t: (t[0], t[1]))
            old = s.runner.depth
            new = s.runner.set_depth(old + max(1, old // 2))
            if new != old:
                made.append(self._publish(s, "widen", old, new, sf))
        for s, sf, rf, _ in windows:
            if (sf < self.NARROW_STALL_FRAC
                    and rf > self.NARROW_RESIDENCY_FRAC
                    and s.runner.depth > self._floor):
                old = s.runner.depth
                new = s.runner.set_depth(max(self._floor, old - 1))
                if new != old:
                    made.append(self._publish(s, "narrow", old, new, sf))
        self.decisions.extend(made)
        return made

    def _publish(self, stage, action: str, old: int, new: int,
                 stall_frac: float) -> dict:
        from mmlspark_tpu_torch.observe.trace import trace_event
        decision = {"stage": stage.name, "action": action, "unit": "depth",
                    "depth_from": old, "depth_to": new,
                    "stall_frac": round(stall_frac, 4)}
        trace_event("data.autotune", cat="data", **decision)
        if self._run is not None:
            self._run.gauge(f"data.{stage.name}.depth", new)
        return decision
