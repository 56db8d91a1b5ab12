"""Service worker: execute serialized graph splits, stream elements (the
port of `mmlspark_tpu/data/service/worker.py`).

`WorkerCore` is the mode-agnostic engine: given a graph spec it builds
each assigned split with `graph.build_range` and yields `(seq, element)`
pairs.  Two runners wrap it:

  * the in-process runner (dispatcher.py `InprocWorker`) pumps the core
    cooperatively on the consumer thread: deterministic, thread-free,
    what drills and the CPU tests use;
  * this module's `main()` is the process runner: started by
    `transport.spawn_worker` (with no card visible), it connects back to
    the dispatcher, says hello, then loops over frames: `graph` installs
    the plan, `split` streams its elements back (`elem` frames with
    per-attempt sequence numbers, each element as numpy arrays and
    Python values, never tensors) followed by `split_end` carrying the
    element count and the split's per-stage `Prefetcher.stats()`
    counters, which the dispatcher republishes as `data.service.w<k>.*`
    gauges.

Fault injection for chaos drills rides the environment
(`MMLSPARK_TPU_DATA_SERVICE_CHAOS=crash:<n>|slow:<seconds>`): crash
hard-exits once the worker has produced more than `n` elements (the
unacked-split re-dispatch path), slow throttles each element (the
autoscaler and stall path).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

from mmlspark_tpu_torch.data import graph


class WorkerChaos:
    """Parsed per-worker fault plan (carried by the environment for
    process workers, fed by the injector for in-process ones)."""

    __slots__ = ("crash_at", "slow_s")

    def __init__(self, crash_at: Optional[int] = None,
                 slow_s: float = 0.0):
        self.crash_at = crash_at
        self.slow_s = slow_s

    @staticmethod
    def from_env(value: str) -> "WorkerChaos":
        chaos = WorkerChaos()
        for part in value.split(","):
            part = part.strip()
            if part.startswith("crash:"):
                chaos.crash_at = int(part.split(":", 1)[1])
            elif part.startswith("slow:"):
                chaos.slow_s = float(part.split(":", 1)[1])
        return chaos


class WorkerCore:
    """Executes splits of one graph; counts every produced element, so
    chaos anchors ("crash at element k") are deterministic."""

    def __init__(self, spec: dict, *, sync: bool = False):
        self.spec = spec
        self.sync = sync
        self.produced = 0
        self.last_stats: dict[str, dict] = {}

    def run_split(self, start: int, stop: int) -> Iterator[tuple]:
        ds = graph.build_range(self.spec, start, stop, sync=self.sync)
        seq = 0
        with ds.iterator(autotune=False) as it:
            for obj in it:
                yield seq, obj
                seq += 1
                self.produced += 1
            self.last_stats = {s.name: dict(s.runner.stats())
                               for s in it.stages
                               if hasattr(s.runner, "stats")}


def to_wire(obj):
    """An element as it crosses the socket: tensors (inside lists, tuples
    and dicts too) become numpy arrays, so the pickled payload is what a
    JAX worker sends and the consumer never unpickles a tensor."""
    if isinstance(obj, (list, tuple)):
        items = [to_wire(x) for x in obj]
        return items if isinstance(obj, list) else tuple(items)
    if isinstance(obj, dict):
        return {k: to_wire(v) for k, v in obj.items()}
    numpy = getattr(obj, "numpy", None)
    if numpy is not None and hasattr(obj, "detach"):
        return obj.detach().cpu().numpy()
    return obj


def _recv_json(sock, buf) -> dict:
    from mmlspark_tpu_torch.data.service import transport
    while True:
        for frame in buf.frames():
            if frame[0] == "json":
                return frame[1]
        data = sock.recv(1 << 16)
        if not data:
            raise transport.TransportError("dispatcher closed connection")
        buf.feed(data)


def _serve(sock, worker_id: int, chaos: WorkerChaos) -> None:
    from mmlspark_tpu_torch.data.service import transport
    from mmlspark_tpu_torch.resilience.clock import get_clock
    buf = transport.FrameBuffer()
    transport.send_json(sock, {"t": "hello", "worker": worker_id})
    core: Optional[WorkerCore] = None
    trace_id: Optional[str] = None   # the session's trace context,
    #   carried on graph/split frames; echoed on split_end/err so the
    #   process's production joins the session's waterfall
    while True:
        msg = _recv_json(sock, buf)
        kind = msg.get("t")
        ctx = msg.get("trace")
        if isinstance(ctx, dict) and isinstance(ctx.get("id"), str):
            trace_id = ctx["id"]
        if kind == "stop":
            return
        if kind == "graph":
            core = WorkerCore(msg["spec"], sync=bool(msg.get("sync")))
            continue
        if kind != "split":
            raise transport.TransportError(f"unexpected message {kind!r}")
        if core is None:
            raise transport.TransportError("split before graph")
        split_id = int(msg["id"])
        try:
            n = 0
            for seq, obj in core.run_split(int(msg["start"]),
                                           int(msg["stop"])):
                if chaos.slow_s > 0:
                    get_clock().sleep(chaos.slow_s)
                if (chaos.crash_at is not None
                        and core.produced > chaos.crash_at):
                    os._exit(17)  # chaos worker_crash: die unacked
                transport.send_elem(sock, split_id, seq, to_wire(obj))
                n += 1
            end = {"t": "split_end", "id": split_id, "n": n,
                   "produced": core.produced, "stats": core.last_stats}
            if trace_id is not None:
                end["trace"] = trace_id
            transport.send_json(sock, end)
        except Exception as e:  # deterministic graph errors: report, die
            err = {"t": "err", "id": split_id,
                   "msg": f"{type(e).__name__}: {e}"}
            if trace_id is not None:
                err["trace"] = trace_id
            transport.send_json(sock, err)
            return


def main(argv: Optional[list] = None) -> int:
    import argparse

    from mmlspark_tpu_torch import config
    from mmlspark_tpu_torch.data.service import transport
    from mmlspark_tpu_torch.resilience.retry import RetryPolicy

    parser = argparse.ArgumentParser(prog="mmlspark_tpu_torch-data-worker")
    parser.add_argument("--connect", required=True,
                        help="dispatcher host:port")
    parser.add_argument("--id", type=int, required=True)
    args = parser.parse_args(argv)
    host, port = args.connect.rsplit(":", 1)
    chaos = WorkerChaos.from_env(
        config.get("MMLSPARK_TPU_DATA_SERVICE_CHAOS") or "")
    policy = RetryPolicy.from_config(name="data.service.connect")
    sock = policy.call(lambda: transport.connect(host, int(port)))
    try:
        _serve(sock, args.id, chaos)
    except (transport.TransportError, OSError):
        return 1
    finally:
        try:
            sock.close()
        except OSError:
            pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
