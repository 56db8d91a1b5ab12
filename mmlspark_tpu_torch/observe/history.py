"""Persistent bench history: rolling baselines + regression verdicts
(the port of `mmlspark_tpu/observe/history.py`; the store's format is
the JAX package's, so one store serves both).

    python -m mmlspark_tpu_torch.observe.history ingest bench_out.json
    python -m mmlspark_tpu_torch.observe.history check  bench_out.json --strict
    python -m mmlspark_tpu_torch.observe.history show

A bench emits one JSON line per metric; nothing else remembers the run
before it, so a 20% regression between invocations is invisible unless
a human diffs files.  This module is the memory: an append-only JSONL
store of every ingested bench record, a noise-tolerant rolling baseline
per (metric, field), and a verdict per fresh record against its
baseline.

  * **Store** — one JSON object per line, `{"kind": "bench", "run_id",
    "ingested_at", "record": {...}}`, append-only (history is never
    rewritten).  Torn/partial lines — a killed ingest, a half-synced
    file — are skipped and counted, never raised on.
  * **Baselines** — per (metric, field): the median of the last
    `BASELINE_WINDOW` runs' values.  Tolerance is
    `max(rel_tol, mad_k * 1.4826 * MAD / |median|)` — the measured
    run-to-run noise widens the band, so a jittery metric does not page
    and a stable one stays tight.
  * **Verdicts** — `regression` / `improvement` when the fresh value
    leaves the band in the metric's bad/good direction (directions are
    inferred from field names: rates/MFU/accuracy up, milliseconds and
    overheads down), `ok` inside it, `new` with no baseline yet.

`check` computes verdicts WITHOUT appending (report-only unless
`--strict`); `ingest` appends after judging, so the next run's baseline
includes this one.

This module is a CLI whose product is stdout text (raw print()), as
observe/report.py is.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Iterable, Optional

from mmlspark_tpu_torch import config
from mmlspark_tpu_torch.observe.logging import get_logger

BENCH_HISTORY = config.BENCH_HISTORY

DEFAULT_STORE = ".bench_history.jsonl"
BASELINE_WINDOW = 8     # runs per rolling baseline
DEFAULT_REL_TOL = 0.10  # the floor of the tolerance band
MAD_K = 4.0             # noise widening: k * 1.4826 * MAD / |median|

# verdict directions by field-name shape; fields matching neither are
# tracked in the store but get no verdict (attribution fields like
# stage_*_s and link_* ride bench lines without being quality claims)
_HIGHER = ("value", "mfu", "device_mfu", "accuracy", "agreement",
           "hbm_bw_util")
_HIGHER_SUFFIX = ("_per_sec", "_per_chip", "_speedup", "_agreement",
                  "_accuracy", "_images_per_sec", "_tokens_per_sec")
_LOWER = ("telemetry_overhead", "trace_overhead", "train_wall_s")
_LOWER_SUFFIX = ("_step_ms", "_ms")


def direction(field: str) -> Optional[int]:
    """+1 higher-is-better, -1 lower-is-better, None untracked."""
    if field in _HIGHER or field.endswith(_HIGHER_SUFFIX):
        return 1
    if field in _LOWER or field.endswith(_LOWER_SUFFIX):
        return -1
    return None


def default_store() -> str:
    return BENCH_HISTORY.current() or DEFAULT_STORE


def load_history(path: str) -> list[dict]:
    """Parse the store; undecodable/foreign lines are skipped (logged),
    never raised on — a torn tail must not take down the check that
    exists to catch regressions."""
    entries: list[dict] = []
    skipped = 0
    if not os.path.exists(path):
        return entries
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                entry = json.loads(line)
            except json.JSONDecodeError:
                skipped += 1
                continue
            if not isinstance(entry, dict) or \
                    not isinstance(entry.get("record"), dict) or \
                    "metric" not in entry["record"]:
                skipped += 1
                continue
            entries.append(entry)
    if skipped:
        get_logger("observe.history").warning(
            "%s: skipped %d torn/foreign line(s)", path, skipped)
    return entries


def load_bench_records(path: str) -> list[dict]:
    """Parse a bench output capture (JSON lines; non-JSON noise like
    backend warnings is skipped) into its metric records."""
    records = []
    stream = sys.stdin if path == "-" else open(path)
    try:
        for line in stream:
            line = line.strip()
            if not line or not line.startswith("{"):
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) and "metric" in rec:
                records.append(rec)
    finally:
        if stream is not sys.stdin:
            stream.close()
    return records


def append_records(path: str, records: Iterable[dict],
                   meta: Optional[dict] = None) -> int:
    """Append one ingest (all `records` share a run_id); returns it."""
    history = load_history(path)
    run_id = 1 + max((e.get("run_id", 0) for e in history), default=0)
    with open(path, "a") as f:
        for rec in records:
            entry = {"kind": "bench", "run_id": run_id,
                     "ingested_at": round(time.time(), 3),
                     "record": rec}
            if meta:
                entry["meta"] = meta
            f.write(json.dumps(entry, sort_keys=True) + "\n")
    return run_id


def _series(history: list[dict], metric: str, field: str) -> list[float]:
    """The field's per-run series (newest last), one value per run_id."""
    by_run: dict = {}
    for e in history:
        rec = e["record"]
        if rec.get("metric") != metric:
            continue
        v = rec.get(field)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            by_run[e.get("run_id", 0)] = float(v)
    return [by_run[r] for r in sorted(by_run)]


def _median(xs: list[float]) -> float:
    ys = sorted(xs)
    n = len(ys)
    return ys[n // 2] if n % 2 else (ys[n // 2 - 1] + ys[n // 2]) / 2


def baseline(history: list[dict], metric: str, field: str,
             window: int = BASELINE_WINDOW) -> Optional[dict]:
    """{'median', 'mad', 'n'} over the last `window` runs, or None."""
    series = _series(history, metric, field)[-window:]
    if not series:
        return None
    med = _median(series)
    mad = _median([abs(x - med) for x in series])
    return {"median": med, "mad": mad, "n": len(series)}


def judge(history: list[dict], records: list[dict],
          rel_tol: float = DEFAULT_REL_TOL,
          mad_k: float = MAD_K) -> list[dict]:
    """Verdict rows for fresh bench `records` against the store."""
    rows = []
    for rec in records:
        metric = rec.get("metric")
        for field in sorted(rec):
            d = direction(field)
            v = rec.get(field)
            if d is None or not isinstance(v, (int, float)) \
                    or isinstance(v, bool):
                continue
            base = baseline(history, metric, field)
            if base is None or not base["median"]:
                rows.append({"metric": metric, "field": field,
                             "value": v, "baseline": None,
                             "ratio": None, "verdict": "new"})
                continue
            med = base["median"]
            tol = max(rel_tol, mad_k * 1.4826 * base["mad"] / abs(med))
            ratio = v / med
            delta = d * (ratio - 1.0)  # positive = better
            verdict = ("improvement" if delta > tol
                       else "regression" if delta < -tol else "ok")
            rows.append({"metric": metric, "field": field, "value": v,
                         "baseline": round(med, 6),
                         "ratio": round(ratio, 4), "tol": round(tol, 4),
                         "verdict": verdict})
    return rows


def render_verdicts(rows: list[dict]) -> str:
    lines = ["== bench history verdicts =="]
    flagged = [r for r in rows if r["verdict"] in ("regression",
                                                   "improvement")]
    for r in rows:
        mark = {"regression": "!!", "improvement": "++",
                "ok": "  ", "new": " ?"}[r["verdict"]]
        base = ("baseline n/a" if r["baseline"] is None else
                f"baseline {r['baseline']:g} ratio {r['ratio']:.3f} "
                f"tol {r['tol']:.3f}")
        lines.append(f"  {mark} {r['verdict']:<11} "
                     f"{r['metric']}.{r['field']}: {r['value']:g} "
                     f"({base})")
    lines.append(f"  {len(rows)} tracked field(s), "
                 f"{sum(1 for r in rows if r['verdict'] == 'regression')} "
                 f"regression(s), "
                 f"{sum(1 for r in rows if r['verdict'] == 'improvement')} "
                 f"improvement(s)")
    if not flagged:
        lines.append("  quiet: every tracked field within its baseline "
                     "band")
    return "\n".join(lines)


def render_store(history: list[dict]) -> str:
    lines = ["== bench history =="]
    if not history:
        return "== bench history ==\n  (empty store)"
    runs = sorted({e.get("run_id", 0) for e in history})
    metrics = sorted({e["record"].get("metric") for e in history})
    lines.append(f"  {len(history)} record(s) over {len(runs)} run(s)")
    for metric in metrics:
        lines.append(f"  {metric}:")
        fields = sorted({f for e in history
                         if e["record"].get("metric") == metric
                         for f in e["record"] if direction(f) is not None})
        for field in fields:
            base = baseline(history, metric, field)
            if base is None:
                continue
            arrow = {1: "^", -1: "v"}[direction(field)]
            lines.append(f"    {field:<36} median {base['median']:g} "
                         f"(mad {base['mad']:g}, n={base['n']}, "
                         f"better {arrow})")
    return "\n".join(lines)


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mmlspark_tpu_torch.observe.history",
        description="Append-only bench history: rolling baselines + "
                    "regression/improvement verdicts.")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name, doc in (("ingest", "judge against the store, then append"),
                      ("check", "judge only — the store is not touched")):
        p = sub.add_parser(name, help=doc)
        p.add_argument("bench", help="bench output capture "
                                     "(JSON lines; '-' = stdin)")
        p.add_argument("--store", default=None)
        p.add_argument("--rel-tol", type=float, default=DEFAULT_REL_TOL)
        p.add_argument("--strict", action="store_true",
                       help="exit 1 when any tracked field regresses")
        p.add_argument("--format", choices=("text", "json"),
                       default="text")
    p = sub.add_parser("show", help="render the store's baselines")
    p.add_argument("--store", default=None)
    args = parser.parse_args(argv)

    store = args.store or default_store()
    history = load_history(store)
    if args.cmd == "show":
        print(render_store(history))
        return 0

    records = load_bench_records(args.bench)
    if not records:
        print(f"no bench records in {args.bench}")
        return 1
    rows = judge(history, records, rel_tol=args.rel_tol)
    if args.cmd == "ingest":
        run_id = append_records(store, records)
        print(f"ingested {len(records)} record(s) into {store} "
              f"as run {run_id}")
    if args.format == "json":
        print(json.dumps(rows, indent=2, sort_keys=True))
    else:
        print(render_verdicts(rows))
    regressions = sum(1 for r in rows if r["verdict"] == "regression")
    return 1 if (args.strict and regressions) else 0


if __name__ == "__main__":
    sys.exit(main())
