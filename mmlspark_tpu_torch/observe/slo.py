"""SLO compliance + multi-window burn-rate analytics over the serve timeline.

The serve drills already assert event SEQUENCES (shed ordering, failover
chains); what they cannot answer is the operator question "are we inside
our error budget, and how fast are we spending it?".  This module folds
the run's completion events into that answer:

  * per-lane compliance: each request completion is good (status ok, no
    deadline miss) or bad; compliance = good / total per priority lane
    against MMLSPARK_TPU_SLO_TARGET;
  * multi-window burn rates (Google SRE style): over a trailing window W,
    burn = error_rate_W / (1 - target) — burn 1.0 spends the budget
    exactly at sustainable rate, 14.4 spends 2% of a 30-day budget in an
    hour.  Two windows (fast 5m / slow 1h by default) so a page needs
    BOTH elevated: the fast window confirms it is still happening, the
    slow window confirms it is material;
  * alerts: one record per lane whose fast AND slow burns exceed
    MMLSPARK_TPU_SLO_BURN_ALERT, surfaced under `slo.alerts` in
    run_summary.json and replayed as `slo_alert` records in run.jsonl.

Completion sources, in preference order: fleet-level routing `finish`
events (one per request no matter how many dispatch attempts), falling
back to engine serve `finish` events for bare single-engine runs —
counting both would double every fleet request.
"""

from __future__ import annotations

from typing import Optional

from mmlspark_tpu_torch import config

SLO_TARGET = config.register(
    "MMLSPARK_TPU_SLO_TARGET", 0.99,
    "SLO analytics: target good-request fraction per priority lane "
    "(good = finished ok with no deadline miss); compliance and burn "
    "rates in run_summary's `slo` section are computed against this",
    ptype=float)
SLO_FAST_WINDOW_S = config.register(
    "MMLSPARK_TPU_SLO_FAST_WINDOW_S", 300.0,
    "SLO analytics: fast burn-rate window (seconds) — the 'is it still "
    "happening' half of the multi-window alert condition", ptype=float)
SLO_SLOW_WINDOW_S = config.register(
    "MMLSPARK_TPU_SLO_SLOW_WINDOW_S", 3600.0,
    "SLO analytics: slow burn-rate window (seconds) — the 'is it "
    "material' half of the multi-window alert condition", ptype=float)
SLO_BURN_ALERT = config.register(
    "MMLSPARK_TPU_SLO_BURN_ALERT", 14.4,
    "SLO analytics: burn-rate threshold that BOTH windows must exceed "
    "to emit an alert (14.4 = the SRE-book 2%%-of-monthly-budget-in-an-"
    "hour paging condition)", ptype=float)


def _completions(serve_events: list, routing_events: list) -> list[dict]:
    """Normalise completion samples: [{ts, lane, ok, status}].

    Routing `finish` events are the fleet-level truth (one per request);
    serve `finish` events are the fallback for bare engines.  `ok` folds
    deadline misses in: an answer after its deadline spent budget."""
    out = []
    finishes = [e for e in routing_events if e.get("event") == "finish"]
    source = finishes if finishes else \
        [e for e in serve_events if e.get("event") == "finish"]
    for e in source:
        status = str(e.get("status", "")).lower()
        out.append({
            "ts": float(e.get("ts", 0.0) or 0.0),
            "lane": str(e.get("priority", "default") or "default"),
            "ok": status == "ok" and not e.get("deadline_miss"),
            "status": status,
        })
    return out


def _burn(samples: list[dict], now: float, window_s: float,
          target: float) -> Optional[float]:
    """error_rate over the trailing window, as a multiple of the
    sustainable rate (1 - target).  None when the window saw nothing."""
    recent = [s for s in samples if s["ts"] >= now - window_s]
    if not recent:
        return None
    err = sum(1 for s in recent if not s["ok"]) / len(recent)
    budget = max(1.0 - target, 1e-9)
    return err / budget


def compute_slo(serve_events: list, routing_events: list, *,
                now: float, target: Optional[float] = None) -> dict:
    """The run's SLO rollup (module docstring): per-lane compliance +
    5m/1h burn rates + alerts.  Pure over the event lists — report.py
    and the tests feed it synthetic timelines directly."""
    samples = _completions(serve_events or [], routing_events or [])
    if not samples:
        return {}
    target = float(SLO_TARGET.current()) if target is None else float(target)
    fast_s = float(SLO_FAST_WINDOW_S.current())
    slow_s = float(SLO_SLOW_WINDOW_S.current())
    threshold = float(SLO_BURN_ALERT.current())
    lanes: dict[str, list[dict]] = {}
    for s in samples:
        lanes.setdefault(s["lane"], []).append(s)
    endpoints: dict[str, dict] = {}
    alerts: list[dict] = []
    for lane in sorted(lanes):
        ls = lanes[lane]
        ok = sum(1 for s in ls if s["ok"])
        compliance = ok / len(ls)
        burn_fast = _burn(ls, now, fast_s, target)
        burn_slow = _burn(ls, now, slow_s, target)
        endpoints[lane] = {
            "requests": len(ls),
            "ok": ok,
            "compliance": round(compliance, 6),
            "met": compliance >= target,
            "burn_fast": None if burn_fast is None else round(burn_fast, 4),
            "burn_slow": None if burn_slow is None else round(burn_slow, 4),
        }
        if (burn_fast is not None and burn_fast >= threshold
                and burn_slow is not None and burn_slow >= threshold):
            alerts.append({
                "endpoint": lane,
                "burn_fast": round(burn_fast, 4),
                "burn_slow": round(burn_slow, 4),
                "threshold": threshold,
                "window_fast_s": fast_s,
                "window_slow_s": slow_s,
            })
    return {
        "target": target,
        "windows": {"fast_s": fast_s, "slow_s": slow_s},
        "endpoints": endpoints,
        "alerts": alerts,
    }
