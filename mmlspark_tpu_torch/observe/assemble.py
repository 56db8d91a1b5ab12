"""Stitch per-process telemetry shards into per-request trace waterfalls.

Every tier of a fleet — router, prefill replicas, the handoff bus, decode
replicas, data-service workers — streams its own run.jsonl shard with its
own span-id space (per-tracer counters: ids COLLIDE across shards and
across two runs in one process).  The only cross-shard join key is the
TraceContext trace id (observe/trace.py) that each traced record carries.
This module does the join:

  * `load_shard_set` reads a directory (or explicit path list) of JSONL
    shards, torn-tail tolerant per file; a missing or unreadable shard
    becomes a degraded note — never a raise — so a crashed worker still
    yields a report;
  * `assemble` groups trace-carrying records by trace id and replays
    each group into a waterfall of CONTIGUOUS stage segments (queue →
    prefill → handoff → decode), closed by the fleet-level finish.
    Contiguity is the point: stage durations sum to the end-to-end wall
    by construction, so attribution is never "percentages of something
    else".  Stage transitions come from the timeline events the serving
    stack already records (admit/dispatch/failover, kv begin/spliced,
    join, finish); a failover re-opens the queue stage, and every
    dispatch attempt is kept so one trace id shows both the failed and
    the byte-exact retried attempt;
  * records whose trace id has no root `admit` anywhere in the shard set
    (parent shard lost, torn stream) land in an orphan quarantine keyed
    by trace id — counted and inspectable, never silently dropped and
    never able to corrupt a real waterfall;
  * sampling: head-sampled or tail-promoted traces keep their full
    segment/timeline detail; the rest keep only the stage rollup, which
    is what holds tracing under the overhead pin at high request rates.

`tracez_payload` runs the same assembly over the live ring for the
`/tracez` endpoint and report.py's `requests` section.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Iterable, Optional

# (record type, event) pairs that open a new waterfall stage; everything
# between two transitions is attributed to the stage the first one opened
_STAGE_OPEN = {
    ("routing", "admit"): "queue",
    ("routing", "dispatch"): "prefill",
    ("routing", "failover"): "queue",     # re-queued at head
    ("serve", "admit"): "queue",          # bare engine (no router tier)
    ("serve", "join"): "decode",          # colocated seat
    ("serve", "remote_join"): "decode",   # decode-tier splice seat
    ("handoff", "begin"): "handoff",
    ("handoff", "spliced"): "decode",
    ("data_service", "admit"): "data_service",
}

_FINISH = {("routing", "finish"), ("serve", "finish"),
           ("data_service", "finish")}


def parse_jsonl(path: str) -> tuple[list[dict], Optional[str]]:
    """One shard file → (records, degraded note or None).  A torn final
    line (the writer died mid-record) is expected and silently dropped;
    corruption ANYWHERE else is surfaced in the note."""
    try:
        with open(path, "r") as f:
            lines = f.read().splitlines()
    except OSError as e:
        return [], f"unreadable shard {path}: {e}"
    records, bad = [], 0
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            if i == len(lines) - 1:
                continue  # torn tail
            bad += 1
            continue
        if isinstance(rec, dict):
            records.append(rec)
    note = f"{bad} corrupt mid-file line(s) in {path}" if bad else None
    return records, note


def load_shard_set(source) -> dict:
    """Read a shard set — a directory (every *.jsonl under it) or an
    explicit iterable of paths — into one record list.

    Each record is tagged `_shard` with its shard's identity, taken from
    the shard's run_start record (pid + wall-clock start): pids recycle
    and span ids restart per tracer, so (pid, wall_time) is what keeps
    two runs in one process distinguishable.  Returns {records, shards,
    degraded}; missing shards degrade, they never raise."""
    if isinstance(source, (str, os.PathLike)):
        root = os.fspath(source)
        if os.path.isdir(root):
            paths = sorted(glob.glob(os.path.join(root, "**", "*.jsonl"),
                                     recursive=True))
            degraded = [] if paths else [f"no shards under {root}"]
        else:
            paths, degraded = [], [f"missing shard dir {root}"]
    else:
        paths, degraded = [os.fspath(p) for p in source], []
    records, shards = [], []
    for path in paths:
        if not os.path.exists(path):
            degraded.append(f"missing shard {path}")
            continue
        recs, note = parse_jsonl(path)
        if note:
            degraded.append(note)
        key = path
        for r in recs:
            if r.get("type") == "run_start":
                key = f"{r.get('pid')}:{r.get('wall_time')}"
                break
        for r in recs:
            r["_shard"] = key
        shards.append({"path": path, "shard": key, "records": len(recs)})
        records.extend(recs)
    return {"records": records, "shards": shards, "degraded": degraded}


def _what(rec: dict) -> Optional[str]:
    """The record's event name: serving timelines use `event`,
    data-service ones use `kind`."""
    return rec.get("event") or rec.get("kind")


def _trace_ids(rec: dict) -> list[str]:
    """Every trace id a record carries: the timeline records put `trace`
    at top level, spans/events put it in attrs, batch-level records
    (prefill chunks) carry a `traces` list."""
    out = []
    attrs = rec.get("attrs") if isinstance(rec.get("attrs"), dict) else {}
    for v in (rec.get("trace"), attrs.get("trace")):
        if isinstance(v, str) and v:
            out.append(v)
    for v in (rec.get("traces"), attrs.get("traces")):
        if isinstance(v, (list, tuple)):
            out.extend(t for t in v if isinstance(t, str) and t)
    return out


def _waterfall(tid: str, recs: list[dict]) -> dict:
    """Replay one trace's records (ts order) into contiguous stage
    segments.  See module docstring for the contiguity argument."""
    recs = sorted(recs, key=lambda r: float(r.get("ts", 0.0) or 0.0))
    admit = next(r for r in recs
                 if _what(r) == "admit")  # caller guarantees one
    finishes = [r for r in recs if (r.get("type"), _what(r))
                in _FINISH]
    # the fleet-level routing finish outranks per-attempt engine ones
    terminal = next((r for r in finishes if r.get("type") == "routing"),
                    finishes[-1] if finishes else None)
    t_admit = float(admit.get("ts", 0.0) or 0.0)
    t_end = float(terminal.get("ts", t_admit)) if terminal \
        else float(recs[-1].get("ts", t_admit) or t_admit)
    segments: list[dict] = []
    stage, t_open, attempt = None, t_admit, 1
    for rec in recs:
        ts = float(rec.get("ts", 0.0) or 0.0)
        if terminal is not None and ts > t_end:
            break
        key = (rec.get("type"), _what(rec))
        nxt = _STAGE_OPEN.get(key)
        if nxt is None:
            continue
        if key == ("routing", "dispatch"):
            try:
                attempt = max(attempt, int(rec.get("attempt", attempt)))
            except (TypeError, ValueError):
                pass
        if stage is not None and ts > t_open:
            segments.append({"stage": stage, "t0": round(t_open, 6),
                             "t1": round(ts, 6),
                             "dur": round(ts - t_open, 6),
                             "attempt": attempt})
        stage, t_open = nxt, max(ts, t_open)
    if stage is not None and t_end > t_open:
        segments.append({"stage": stage, "t0": round(t_open, 6),
                         "t1": round(t_end, 6),
                         "dur": round(t_end - t_open, 6),
                         "attempt": attempt})
    stages: dict[str, float] = {}
    for seg in segments:
        stages[seg["stage"]] = round(
            stages.get(seg["stage"], 0.0) + seg["dur"], 6)
    sampled = bool(admit.get("sampled", True))
    tail = (terminal or {}).get("tail")
    wf = {
        "trace": tid,
        "wall_s": round(t_end - t_admit, 6),
        "status": (terminal or {}).get("status"),
        "lane": admit.get("priority") or (terminal or {}).get("priority"),
        "attempts": attempt,
        "sampled": sampled,
        "tail": tail,
        "stages": stages,
        "stages_sum_s": round(sum(stages.values()), 6),
        "records": len(recs),
        "degraded": terminal is None,
    }
    if sampled or tail:
        # full detail only for head-sampled or tail-promoted traces
        wf["segments"] = segments
        wf["timeline"] = [
            {"ts": round(float(r.get("ts", 0.0) or 0.0), 6),
             "type": r.get("type"),
             "what": _what(r) or r.get("name"),
             **({"shard": r["_shard"]} if "_shard" in r else {})}
            for r in recs]
    return wf


def assemble(records: Iterable[dict],
             degraded: Optional[list] = None) -> dict:
    """Records (any mix of shards, any order) → {waterfalls, orphans,
    degraded}.  Waterfalls sort slowest-first — the /tracez contract."""
    by_trace: dict[str, list[dict]] = {}
    for rec in records:
        for tid in _trace_ids(rec):
            by_trace.setdefault(tid, []).append(rec)
    waterfalls, orphans = [], {}
    for tid, recs in by_trace.items():
        if any(_what(r) == "admit" for r in recs):
            waterfalls.append(_waterfall(tid, recs))
        else:
            tss = [float(r.get("ts", 0.0) or 0.0) for r in recs]
            orphans[tid] = {
                "records": len(recs),
                "types": sorted({str(r.get("type")) for r in recs}),
                "shards": sorted({r["_shard"] for r in recs
                                  if "_shard" in r}),
                "first_ts": round(min(tss), 6) if tss else None,
                "last_ts": round(max(tss), 6) if tss else None,
            }
    waterfalls.sort(key=lambda w: w["wall_s"], reverse=True)
    return {"waterfalls": waterfalls, "orphans": orphans,
            "degraded": list(degraded or [])}


def assemble_dir(source) -> dict:
    """load_shard_set + assemble in one call (report.py's entry point)."""
    shard_set = load_shard_set(source)
    out = assemble(shard_set["records"], degraded=shard_set["degraded"])
    out["shards"] = shard_set["shards"]
    return out


def tracez_payload(run, top: int = 10) -> dict:
    """The /tracez response: slowest assembled waterfalls from the live
    run's ring (every timeline record is in the ring, so no file I/O on
    the serving path)."""
    if run is None:
        return {"error": "no active telemetry run", "requests": []}
    out = assemble(run.tracer.records())
    return {
        "total": len(out["waterfalls"]),
        "orphans": len(out["orphans"]),
        "requests": out["waterfalls"][:max(0, int(top))],
    }
