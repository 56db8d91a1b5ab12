"""Run-report diagnostic: replay a run.jsonl into the human answer to
"what did that run actually do, and what bounded it" (the port of
`mmlspark_tpu/observe/report.py`; it reads the run records the port's
`run_telemetry` writes, which carry the JAX package's keys).

    python -m mmlspark_tpu_torch.observe.report <run_dir_or_run.jsonl> \
        [--top N] [--format text|json]

`--format json` prints the structured report itself (one JSON object,
every section machine-readable) — the CI-consumption mode; the default
text rendering is for humans.

Sections (each a structured field of `build_report`, rendered by
`render_report` — so tools can consume the dict while humans read the
text):

  * **stage attribution + bottleneck verdict** — the run's thread-seconds
    per pipeline phase, replayed through the SAME PipelineTimings verdict
    logic the live `pipeline_timing()` block uses (observe/spans.py), so
    the offline answer can never drift from the online one;
  * **top-N slowest steps** — per-step/batch/segment spans ranked by
    duration, with their attrs (the "what did step 1234 do" query);
  * **recompiles** — `cat="compile"` events: every new shape class the
    run paid for, in order;
  * **roofline** — the per-program cost table (observe/costmodel.py):
    FLOPs, bytes accessed, per-step time, MFU / HBM-bandwidth
    utilization, and the compute/bandwidth/host-bound verdict for every
    program the run counted;
  * **numerics** — the health timeline (observe/numerics.py): probe
    summaries, loss spikes/divergence, non-finite detections;
  * **resilience timeline** — retries, breaker transitions, chaos
    injections, preemption/resume, ordered by timestamp;
  * **counters** — the run's counter deltas.

This module is a CLI whose product is stdout text (raw print()).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Iterable, Optional

from mmlspark_tpu_torch.observe.spans import PipelineTimings

# span cats ranked in the slowest-steps table: the per-item work units
STEP_CATS = ("step", "batch", "segment", "bucket")


def load_run(path: str) -> list[dict]:
    """Parse a run.jsonl (or a run directory containing one).  Torn tails
    are expected — a preempted run stops mid-line — so undecodable lines
    are skipped, never raised on (the checkpoint-validation posture)."""
    if os.path.isdir(path):
        path = os.path.join(path, "run.jsonl")
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn tail of a killed run
    return events


def _stage_timings(events: Iterable[dict]) -> Optional[PipelineTimings]:
    """Rebuild the run's PipelineTimings from its stage_timings event so
    the bottleneck verdict is computed by spans.py's own logic."""
    seconds = None
    for ev in events:
        if ev.get("type") == "stage_timings":
            seconds = ev.get("seconds", {})
    if seconds is None:
        return None
    timings = PipelineTimings()
    timings.seconds.update({k: float(v) for k, v in seconds.items()})
    return timings


def build_report(events: list[dict], top: int = 5,
                 source: Optional[str] = None) -> dict:
    """The structured report over a parsed event list.  `source` (the
    run directory, when known) widens the `requests` section to every
    shard under it — a fleet run writes one run.jsonl per process, and
    the waterfalls only stitch across them."""
    spans = [e for e in events if e.get("type") == "span"]
    instants = [e for e in events if e.get("type") == "event"]
    counters = {}
    wall_s = None
    for ev in events:
        if ev.get("type") == "counters":
            counters = ev.get("deltas", {})
        elif ev.get("type") == "run_end":
            wall_s = ev.get("wall_s")
    if wall_s is None and (spans or instants):  # torn run: best effort
        wall_s = max(e["ts"] + e.get("dur", 0.0)
                     for e in spans + instants)

    timings = _stage_timings(events)
    steps = sorted((s for s in spans if s.get("cat") in STEP_CATS),
                   key=lambda s: -s["dur"])
    recompiles = [e for e in instants if e.get("cat") == "compile"]
    resilience = sorted((e for e in instants + spans
                         if e.get("cat") == "resilience"),
                        key=lambda e: e["ts"])
    numerics = sorted(
        (e for e in instants
         if e.get("cat") == "numerics"
         or str(e.get("name", "")).startswith("numerics.")),
        key=lambda e: e["ts"])
    from mmlspark_tpu_torch.observe.trace import aggregate_spans
    return {
        "wall_s": wall_s,
        "events": len(events),
        "stage_seconds": dict(timings.seconds) if timings else {},
        "bottleneck": timings.bottleneck() if timings else None,
        "span_aggregates": aggregate_spans(spans),
        "slowest_steps": steps[:top],
        "recompiles": recompiles,
        "programs": _programs(events),
        "numerics": numerics,
        "resilience": resilience,
        "requests": _requests(events, top, source),
        "slo_alerts": [e for e in events
                       if e.get("type") == "slo_alert"],
        "counters": counters,
    }


def _requests(events: list[dict], top: int,
              source: Optional[str]) -> dict:
    """The distributed-tracing section: top-N slowest request waterfalls
    (observe/assemble.py).  Cross-process runs shard their timelines one
    run.jsonl per process; given the run DIRECTORY we stitch every shard
    under it, torn or missing shards degrading to notes — a crashed
    worker's half-written shard must never sink the report."""
    from mmlspark_tpu_torch.observe.assemble import assemble, assemble_dir
    if source is not None and os.path.isdir(source):
        asm = assemble_dir(source)
    else:
        asm = assemble(events)
    return {
        "total": len(asm["waterfalls"]),
        "orphans": len(asm["orphans"]),
        "degraded": asm["degraded"],
        "slowest": asm["waterfalls"][:max(0, top)],
    }


def _programs(events: list[dict]) -> dict:
    """The per-program roofline table: the sealed `programs` event when
    the run finished cleanly; for a torn run, a degraded table rebuilt
    from the `program_cost` events (costs without times)."""
    table = {}
    for ev in events:
        if ev.get("type") == "programs":
            table = ev.get("programs", {})
    if table:
        return table
    for ev in events:
        if ev.get("type") == "event" and ev.get("name") == "program_cost":
            a = ev.get("attrs", {})
            key = f"{a.get('where')}:{a.get('program')}"
            table[key] = {
                "where": a.get("where"), "program": a.get("program"),
                "flops": a.get("flops"),
                "bytes_accessed": a.get("bytes_accessed"),
                "executions": 0, "span_s": 0.0,
                "step_s": a.get("probe_step_s"), "step_basis": "probe",
                "mfu": None, "hbm_bw_util": None, "bound": None,
                "verdict": None,
            }
    return table


def _attrs_str(attrs: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in attrs.items())


def render_report(report: dict) -> str:
    """The human text for a built report."""
    lines = ["== mmlspark_tpu run report =="]
    if report["wall_s"] is not None:
        lines.append(f"wall: {report['wall_s']:.3f}s over "
                     f"{report['events']} events")

    lines.append("")
    lines.append("-- stage attribution (thread-seconds) --")
    if report["stage_seconds"]:
        total = sum(report["stage_seconds"].values()) or 1.0
        for stage, s in sorted(report["stage_seconds"].items(),
                               key=lambda kv: -kv[1]):
            lines.append(f"  {stage:<10} {s:9.4f}s  {100 * s / total:5.1f}%")
        lines.append(f"  bottleneck verdict: {report['bottleneck']}")
    else:
        lines.append("  (no stage timings recorded)")

    lines.append("")
    lines.append(f"-- top {len(report['slowest_steps'])} slowest steps --")
    for s in report["slowest_steps"]:
        lines.append(f"  {s['dur'] * 1e3:9.2f}ms  {s['name']:<16} "
                     f"@{s['ts']:.3f}s  {_attrs_str(s.get('attrs', {}))}")
    if not report["slowest_steps"]:
        lines.append("  (no step/batch/segment spans)")

    lines.append("")
    lines.append(f"-- recompiles ({len(report['recompiles'])}) --")
    for e in report["recompiles"]:
        lines.append(f"  @{e['ts']:.3f}s {e['name']} "
                     f"{_attrs_str(e.get('attrs', {}))}")
    if not report["recompiles"]:
        lines.append("  (none recorded)")

    lines.append("")
    progs = report.get("programs", {})
    lines.append(f"-- roofline: compiled programs ({len(progs)}) --")
    for key in sorted(progs):
        p = progs[key]
        flops = p.get("flops")
        step_s = p.get("step_s")
        parts = [f"  {key}"]
        parts.append(f"    {p.get('executions', 0)} execution(s)"
                     + (f", {step_s * 1e3:.3f} ms/step "
                        f"({p.get('step_basis')})" if step_s else ""))
        if flops:
            parts.append(
                f"    {flops:.3e} FLOPs, "
                + (f"{p['bytes_accessed']:.3e} bytes"
                   if p.get("bytes_accessed") else "bytes n/a")
                + (f", AI {p['arithmetic_intensity']:g}"
                   if p.get("arithmetic_intensity") else ""))
        util = []
        if p.get("mfu") is not None:
            util.append(f"MFU {p['mfu']:.4f}")
        if p.get("hbm_bw_util") is not None:
            util.append(f"HBM bw {p['hbm_bw_util']:.4f}")
        verdict = p.get("verdict")
        parts.append("    " + (", ".join(util) + ", " if util else "")
                     + f"verdict: {verdict if verdict else 'unknown (no device peaks)'}")
        lines.extend(parts)
    if not progs:
        lines.append("  (no program costs captured)")

    lines.append("")
    numerics = report.get("numerics", [])
    lines.append(f"-- numerics health ({len(numerics)}) --")
    for e in numerics:
        lines.append(f"  @{e['ts']:.3f}s {e['name']} "
                     f"{_attrs_str(e.get('attrs', {}))}")
    if not numerics:
        lines.append("  (no probes recorded)")

    lines.append("")
    lines.append(f"-- resilience timeline ({len(report['resilience'])}) --")
    for e in report["resilience"]:
        lines.append(f"  @{e['ts']:.3f}s {e['name']} "
                     f"{_attrs_str(e.get('attrs', {}))}")
    if not report["resilience"]:
        lines.append("  (no retries / preemptions / chaos)")

    req = report.get("requests") or {}
    if req.get("total") or req.get("orphans") or req.get("degraded"):
        lines.append("")
        lines.append(f"-- requests: slowest traces "
                     f"({len(req.get('slowest', []))} of "
                     f"{req.get('total', 0)}, "
                     f"{req.get('orphans', 0)} orphaned) --")
        for w in req.get("slowest", []):
            stages = " ".join(
                f"{name}={dur * 1e3:.2f}ms"
                for name, dur in sorted((w.get("stages") or {}).items(),
                                        key=lambda kv: -kv[1]))
            flags = []
            if w.get("degraded"):
                flags.append("DEGRADED")
            if w.get("tail"):
                flags.append(f"tail:{w['tail']}")
            lines.append(
                f"  {w['trace'][:16]}  {w.get('wall_s', 0) * 1e3:9.2f}ms  "
                f"{w.get('status') or '?':<8} x{w.get('attempts', 1)}  "
                f"{stages}"
                + (("  [" + " ".join(flags) + "]") if flags else ""))
        for note in req.get("degraded", []):
            lines.append(f"  (degraded: {note})")

    alerts = report.get("slo_alerts") or []
    if alerts:
        lines.append("")
        lines.append(f"-- SLO burn alerts ({len(alerts)}) --")
        for a in alerts:
            lines.append(
                f"  {a.get('endpoint')}: burn fast={a.get('burn_fast')} "
                f"slow={a.get('burn_slow')} "
                f"(threshold {a.get('threshold')})")

    if report["counters"]:
        lines.append("")
        lines.append("-- counter deltas --")
        for name in sorted(report["counters"]):
            lines.append(f"  {name:<32} {report['counters'][name]:g}")
    return "\n".join(lines)


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mmlspark_tpu_torch.observe.report",
        description="Replay a run.jsonl into the human run diagnostic.")
    parser.add_argument("run", help="run directory or run.jsonl path")
    parser.add_argument("--top", type=int, default=5,
                        help="slowest steps to list (default 5)")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text",
                        help="json prints the structured report dict "
                             "(machine-readable, for CI)")
    args = parser.parse_args(argv)
    events = load_run(args.run)
    if not events:
        print(f"no events in {args.run}")
        return 1
    report = build_report(events, top=args.top, source=args.run)
    if args.format == "json":
        print(json.dumps(report, indent=2, sort_keys=True, default=str))
    else:
        print(render_report(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
