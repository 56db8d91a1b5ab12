"""Dispatcher side of the data service: the split ledger and the worker
fleet (the port of `mmlspark_tpu/data/service/dispatcher.py`).

A `ServiceSession` executes one iteration of one serialized graph for one
consumer.  The output stream is cut into fixed-size *splits* (contiguous
element ranges `[i*S, (i+1)*S)`), and the ledger drives them through
pending -> assigned -> done, at most one split in flight per worker.
Because a split's contents are a pure function of (graph, range)
(graph.build_range), any worker can produce any split, which makes both
scheduling modes and crash recovery cheap:

  * **dynamic** (first-come): elements surface in arrival order, the
    highest throughput, in an order that depends on worker timing;
  * **deterministic**: elements are reassembled in split-index order
    from per-split buffers, so the epoch is byte-identical to local
    execution however many workers raced to produce it.

Exactly-once under crashes: workers tag every element with a
per-(split, attempt) sequence number and the ledger keeps a received
cursor per split.  When a worker dies (socket EOF, process exit, or a
chaos `worker_crash`), its unacked split is re-queued whole and the
already-received prefix is dropped on redelivery: no row is duplicated
or lost.  Worker health feeds per-worker circuit breakers
(`data.service.w<k>`), replacements draw from a bounded respawn budget,
and every lifecycle step lands in the run summary's `data_service`
timeline and the `data.service.*` counters and gauges.

Two worker kinds share `WorkerCore`: `ProcWorker` wraps a spawned
process streaming frames over a non-blocking socket (all raw socket and
subprocess work is in transport.py), and `InprocWorker` pumps the core
cooperatively on the consumer thread, deterministic and thread-free.  A
worker that cannot start raises `DataServiceError` at the start timeout;
the session never falls back to local execution.  The whole session is
single-threaded: `selectors` polling from the consumer's pulls, no
background threads, so every pull must come from one thread.
"""

from __future__ import annotations

import selectors
from collections import deque
from typing import Optional

from mmlspark_tpu_torch import config
from mmlspark_tpu_torch.data.service.worker import WorkerCore
from mmlspark_tpu_torch.observe.metrics import inc_counter
from mmlspark_tpu_torch.observe.spans import monotonic
from mmlspark_tpu_torch.observe.telemetry import active_run
from mmlspark_tpu_torch.observe.trace import mint_context, trace_event
from mmlspark_tpu_torch.resilience.breaker import (CircuitOpenError,
                                                   get_breaker)
from mmlspark_tpu_torch.resilience.chaos import get_injector


class DataServiceError(RuntimeError):
    """The service cannot make progress (workers exhausted, graph
    failed deterministically, or startup timed out)."""


class DataService:
    """Configuration + worker-id allocator for service sessions.  One
    DataService can back many iterators; each `session()` owns its
    worker set (sharded across consumers by split index)."""

    def __init__(self, *, workers: Optional[int] = None,
                 mode: Optional[str] = None,
                 split_elems: Optional[int] = None,
                 max_workers: Optional[int] = None,
                 respawns: Optional[int] = None):
        w = (int(config.get("MMLSPARK_TPU_DATA_SERVICE_WORKERS"))
             if workers is None else int(workers))
        self.autoscale = w == 0
        self.workers = 1 if self.autoscale else max(1, w)
        self.mode = (mode if mode is not None
                     else str(config.get("MMLSPARK_TPU_DATA_SERVICE_MODE")))
        if self.mode not in ("process", "inproc"):
            raise ValueError(f"unknown service mode {self.mode!r}")
        self.split_elems = max(1, int(
            config.get("MMLSPARK_TPU_DATA_SERVICE_SPLIT_ELEMS")
            if split_elems is None else split_elems))
        self.max_workers = max(self.workers, int(
            config.get("MMLSPARK_TPU_DATA_SERVICE_MAX_WORKERS")
            if max_workers is None else max_workers))
        self.respawns = max(0, int(
            config.get("MMLSPARK_TPU_DATA_SERVICE_RESPAWNS")
            if respawns is None else respawns))
        self._next_worker_id = 0

    def alloc_worker_id(self) -> int:
        wid = self._next_worker_id
        self._next_worker_id += 1
        return wid

    def session(self, spec: dict, **kwargs) -> "ServiceSession":
        return ServiceSession(self, spec, **kwargs)


class _Split:
    __slots__ = ("index", "start", "stop", "state", "worker", "received",
                 "consumed", "n", "attempts")

    def __init__(self, index: int, start: int, stop: int):
        self.index = index
        self.start = start
        self.stop = stop
        self.state = "pending"     # pending -> assigned -> done
        self.worker = None
        self.received = 0          # dedup cursor across attempts
        self.consumed = 0          # handed to the consumer
        self.n: Optional[int] = None
        self.attempts = 0


class InprocWorker:
    """Cooperative in-process worker: same WorkerCore as a subprocess,
    pumped a few elements at a time from the consumer thread.  Chaos
    faults come straight from the active injector."""

    mode = "inproc"

    def __init__(self, worker_id: int, spec: dict):
        self.worker_id = worker_id
        self.core = WorkerCore(spec, sync=True)
        self.alive = True
        self.ready = True
        self.split: Optional[_Split] = None
        self.slow_factor = 1
        self._gen = None

    def assign(self, split: _Split) -> None:
        self.split = split
        self._gen = self.core.run_split(split.start, split.stop)

    def pump(self, session: "ServiceSession", budget: int) -> None:
        if not self.alive or self._gen is None:
            return
        injector = get_injector()
        for _ in range(max(1, budget // max(1, self.slow_factor))):
            if injector is not None:
                for f in injector.data_faults_due(self.worker_id,
                                                  self.core.produced):
                    if f.kind == "worker_slow":
                        self.slow_factor = max(1, int(f.factor))
                    elif f.kind == "worker_crash":
                        self.stop()
                        session._on_dead(self, "chaos worker_crash")
                        return
            split = self.split
            try:
                seq, obj = next(self._gen)
            except StopIteration:
                self.split = None
                self._gen = None
                session._on_split_end(self, split, None,
                                      self.core.last_stats)
                return
            except Exception as e:
                self.stop()
                session._on_error(self, f"{type(e).__name__}: {e}")
                return
            session._on_elem(self, split, seq, obj)
            if self.split is None:
                return

    def stop(self) -> None:
        self.alive = False
        self.ready = False
        if self._gen is not None:
            self._gen.close()
            self._gen = None


class ProcWorker:
    """A spawned worker subprocess and its dispatcher-side socket."""

    mode = "process"

    def __init__(self, worker_id: int, proc):
        self.worker_id = worker_id
        self.proc = proc
        self.conn = None            # attached when its hello arrives
        self.buf = None
        self.produced = 0           # lifetime count relayed at split_end
        self.alive = True
        self.ready = False          # hello seen + graph sent
        self.split: Optional[_Split] = None
        self.trace_wire = None      # session TraceContext wire form

    def attach(self, conn, buf) -> None:
        self.conn = conn
        self.buf = buf

    def _send(self, msg: dict) -> None:
        from mmlspark_tpu_torch.data.service import transport
        self.conn.setblocking(True)
        try:
            transport.send_json(self.conn, msg)
        finally:
            self.conn.setblocking(False)

    def send_graph(self, spec: dict, trace=None) -> None:
        self.trace_wire = trace
        msg = {"t": "graph", "spec": spec, "sync": False}
        if trace is not None:
            msg["trace"] = trace
        self._send(msg)
        self.ready = True

    def assign(self, split: _Split) -> None:
        self.split = split
        msg = {"t": "split", "id": split.index,
               "start": split.start, "stop": split.stop}
        if self.trace_wire is not None:
            # the trace context rides every worker frame: the worker
            # echoes its id on split_end, tying subprocess production
            # back to the session's waterfall
            msg["trace"] = self.trace_wire
        self._send(msg)

    def stop(self) -> None:
        self.alive = False
        self.ready = False
        if self.conn is not None:
            try:
                self._send({"t": "stop"})
            except OSError:
                pass
            try:
                self.conn.close()
            except OSError:
                pass
            self.conn = None
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5)
            except Exception:
                self.proc.kill()
                self.proc.wait(timeout=5)


class ServiceSession:
    """One consumer's live stream over the worker fleet (see module
    docstring for the scheduling/recovery model)."""

    MAX_SPLIT_ATTEMPTS = 5

    def __init__(self, service: DataService, spec: dict, *,
                 deterministic: bool = True, consumer_index: int = 0,
                 num_consumers: int = 1,
                 split_elems: Optional[int] = None):
        if not (0 <= consumer_index < num_consumers):
            raise ValueError(
                f"consumer_index {consumer_index} out of range for "
                f"{num_consumers} consumers")
        self.service = service
        self.spec = spec
        self.deterministic = deterministic
        self.consumer_index = consumer_index
        self.num_consumers = num_consumers
        self.split_elems = max(1, int(split_elems if split_elems is not None
                                      else service.split_elems))
        self.target_workers = service.workers
        self.offset = 0             # fast-forward: first element to produce
        self._started = False
        self._closed = False
        self._error: Optional[str] = None
        self._workers: list = []
        self._splits: dict[int, _Split] = {}
        self._redispatch: deque = deque()
        self._next_index = consumer_index
        self._end_index: Optional[int] = None
        self._ready: deque = deque()              # dynamic mode
        self._det_buf: dict[int, deque] = {}      # deterministic mode
        self._cursor = consumer_index
        self._respawns_left = service.respawns
        self._spawned = 0
        self._redispatches = 0
        self._delivered = 0
        self._counters = {"deliveries": 0, "stalls": 0,
                          "stall_s": 0.0, "residency": 0}
        self._run = active_run()
        self.trace = None           # minted at start() when tracing is on
        self._selector = None
        self._server = None
        self._port: Optional[int] = None
        self._deadline: Optional[float] = None

    # -- telemetry ------------------------------------------------------
    def _event(self, kind: str, **fields) -> None:
        inc_counter(f"data.service.{kind}")
        if self.trace is not None:
            fields.setdefault("trace", self.trace.trace_id)
            fields.setdefault("sampled", self.trace.sampled)
        payload = {"kind": kind, **fields}
        trace_event(f"data.service.{kind}", cat="data", **fields)
        if self._run is not None:
            self._run.record_data_service(payload)

    def _worker_gauges(self, worker, stats: dict) -> None:
        if self._run is None:
            return
        ns = f"data.service.w{worker.worker_id}"
        self._run.gauge(f"{ns}.produced", worker_produced(worker))
        for stage, st in (stats or {}).items():
            for key in ("deliveries", "stalls"):
                if key in st:
                    self._run.gauge(f"{ns}.{stage}.{key}", st[key])

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        if self._started:
            return
        self._started = True
        # one trace per session: the data tier is its own root span in
        # the fleet waterfall (kind "admit" opens it, "finish" closes it)
        self.trace = mint_context()
        self._deadline = monotonic() + float(
            config.get("MMLSPARK_TPU_DATA_SERVICE_START_TIMEOUT"))
        if self.service.mode == "process":
            from mmlspark_tpu_torch.data.service import transport
            self._selector = selectors.DefaultSelector()
            self._server, self._port = transport.listen()
            self._selector.register(self._server, selectors.EVENT_READ,
                                    None)
        for _ in range(self.target_workers):
            self._spawn()
        self._event("session_start", mode=self.service.mode,
                    workers=self.target_workers,
                    deterministic=self.deterministic,
                    split_elems=self.split_elems, offset=self.offset,
                    consumer=self.consumer_index,
                    consumers=self.num_consumers)
        if self.trace is not None:
            self._event("admit", mode=self.service.mode,
                        workers=self.target_workers)
        self._maybe_dispatch()

    def fast_forward(self, n: int) -> bool:
        """Shift the dispatch origin by `n` elements (snapshot resume).
        Only before the first pull, and only for an unsharded consumer —
        offsets are counted in this consumer's own element stream."""
        if self._started or self.num_consumers != 1 or n <= 0:
            return False
        self.offset += int(n)
        self._event("resume", offset=self.offset)
        return True

    def _chaos_env(self, worker_id: int) -> dict:
        injector = get_injector()
        if injector is None:
            return {}
        parts = []
        for f in injector.data_faults_for(worker_id):
            if f.kind == "worker_crash":
                parts.append(f"crash:{f.at_elem}")
            elif f.kind == "worker_slow":
                parts.append(f"slow:{max(1, int(f.factor)) * 0.001}")
        if not parts:
            return {}
        return {"MMLSPARK_TPU_DATA_SERVICE_CHAOS": ",".join(parts)}

    def _spawn(self) -> None:
        wid = self.service.alloc_worker_id()
        self._spawned += 1
        if self.service.mode == "inproc":
            self._workers.append(InprocWorker(wid, self.spec))
        else:
            from mmlspark_tpu_torch.data.service import transport
            proc = transport.spawn_worker(wid, "127.0.0.1", self._port,
                                          env=self._chaos_env(wid))
            self._workers.append(ProcWorker(wid, proc))

    def _alive(self) -> list:
        return [w for w in self._workers if w.alive]

    def scale(self, n: int) -> int:
        """Resize the fleet toward `n` workers (the Autotuner's lever,
        via ServiceConsumer.set_depth).  Growth spawns immediately;
        shrink retires idle workers and defers busy ones."""
        n = max(1, min(int(n), self.service.max_workers))
        if not self._started:
            self.target_workers = n
            return n
        old = self.target_workers
        if n != old:
            self.target_workers = n
            self._event("scale", workers_from=old, workers_to=n)
        self._reconcile()
        return self.target_workers

    def _reconcile(self) -> None:
        alive = self._alive()
        while len(alive) < self.target_workers:
            self._spawn()
            alive = self._alive()
        extra = len(alive) - self.target_workers
        for w in alive:
            if extra <= 0:
                break
            if w.split is None:
                self._stop_worker(w)
                extra -= 1

    def _stop_worker(self, worker) -> None:
        """Stop a worker, its socket leaving the selector first: a closed
        socket left registered would collide with the next connection
        that reuses its descriptor number."""
        conn = getattr(worker, "conn", None)
        if conn is not None and self._selector is not None:
            try:
                self._selector.unregister(conn)
            except (KeyError, ValueError):
                pass
        worker.stop()

    # -- ledger ---------------------------------------------------------
    def _split_for(self, index: int) -> _Split:
        s = self._splits.get(index)
        if s is None:
            base = self.offset + index * self.split_elems
            s = _Split(index, base, base + self.split_elems)
            self._splits[index] = s
        return s

    def _open_count(self) -> int:
        return sum(1 for s in self._splits.values()
                   if s.n is None or s.consumed < s.n)

    def _next_split(self) -> Optional[_Split]:
        while self._redispatch:
            s = self._redispatch.popleft()
            if s.state == "pending":
                return s
        window = max(4, 2 * max(1, len(self._alive())))
        if self._open_count() >= window:
            return None
        index = self._next_index
        if self._end_index is not None and index > self._end_index:
            return None
        self._next_index += self.num_consumers
        return self._split_for(index)

    def _maybe_dispatch(self) -> None:
        self._reconcile()
        for w in self._workers:
            if not (w.alive and w.ready) or w.split is not None:
                continue
            breaker = get_breaker(f"data.service.w{w.worker_id}")
            try:
                breaker.allow()
            except CircuitOpenError:
                continue
            s = self._next_split()
            if s is None:
                return
            s.state = "assigned"
            s.worker = w
            s.attempts += 1
            try:
                w.assign(s)
            except OSError:
                self._on_dead(w, "assign failed")
                continue
            self._event("dispatch", split=s.index, worker=w.worker_id,
                        start=s.start, stop=s.stop, attempt=s.attempts)

    # -- worker callbacks ----------------------------------------------
    def _on_elem(self, worker, split, seq: int, obj) -> None:
        if isinstance(split, int):
            split = self._splits.get(split)
        if split is None:
            return
        if seq < split.received:
            inc_counter("data.service.dup_dropped")
            return
        if seq > split.received:
            self._on_dead(worker, f"sequence gap on split {split.index}")
            return
        split.received += 1
        if self.deterministic:
            self._det_buf.setdefault(split.index, deque()).append(obj)
        else:
            self._ready.append((split.index, obj))

    def _on_split_end(self, worker, split, n: Optional[int],
                      stats) -> None:
        if isinstance(split, int):
            split = self._splits.get(split)
        if split is None:
            return
        if n is None:
            n = split.received
        if worker.split is split:
            worker.split = None
        split.state = "done"
        split.n = int(n)
        get_breaker(f"data.service.w{worker.worker_id}").record_success()
        self._worker_gauges(worker, stats)
        self._event("split_end", split=split.index,
                    worker=worker.worker_id, n=split.n)
        if split.n < split.stop - split.start:
            end = split.index
            if self._end_index is None or end < self._end_index:
                self._end_index = end
        self._maybe_dispatch()

    def _on_error(self, worker, msg: str) -> None:
        # deterministic graph failure: re-dispatch would just repeat it
        self._error = msg
        self._event("worker_error", worker=worker.worker_id, error=msg)

    def _on_dead(self, worker, reason: str) -> None:
        if not worker.alive and worker.split is None:
            return
        worker.alive = False
        worker.ready = False
        s = worker.split
        worker.split = None
        get_breaker(f"data.service.w{worker.worker_id}").record_failure()
        self._event("worker_dead", worker=worker.worker_id, reason=reason,
                    split=None if s is None else s.index)
        if s is not None and s.state == "assigned":
            s.state = "pending"
            s.worker = None
            if s.attempts >= self.MAX_SPLIT_ATTEMPTS:
                self._error = (f"split {s.index} failed "
                               f"{s.attempts} times (last: {reason})")
                return
            self._redispatches += 1
            self._redispatch.append(s)
            self._event("redispatch", split=s.index, received=s.received)
        if not self._alive():
            if self._respawns_left > 0:
                self._respawns_left -= 1
                self._event("respawn", remaining=self._respawns_left)
                self._spawn()
            else:
                self._error = self._error or (
                    f"all workers dead (last: {reason}), "
                    "respawn budget exhausted")
        self._maybe_dispatch()

    # -- pumping --------------------------------------------------------
    def _pump(self, timeout_s: float) -> None:
        if self.service.mode == "inproc":
            for w in list(self._workers):
                if w.alive and w.split is not None:
                    w.pump(self, budget=4)
            return
        self._pump_sockets(timeout_s)

    def _pump_sockets(self, timeout_s: float) -> None:
        from mmlspark_tpu_torch.data.service import transport
        for key, _ in self._selector.select(timeout_s):
            if key.fileobj is self._server:
                conn = transport.accept(self._server, 0.0)
                if conn is not None:
                    buf = transport.FrameBuffer()
                    self._selector.register(conn, selectors.EVENT_READ,
                                            [None, buf])
                continue
            conn, slot = key.fileobj, key.data
            data = transport.recv_ready(conn)
            dead = data is None
            if data:
                slot[1].feed(data)
                try:
                    for frame in slot[1].frames():
                        self._on_frame(conn, slot, frame)
                except transport.TransportError:
                    dead = True
            if dead:
                self._selector.unregister(conn)
                try:
                    conn.close()
                except OSError:
                    pass
                w = slot[0]
                if w is not None and w.alive:
                    w.conn = None
                    self._on_dead(w, "connection lost")
        # a worker that died before (or without) connecting never
        # produces a socket event — poll the processes directly
        for w in self._workers:
            if (w.alive and w.conn is None
                    and w.proc.poll() is not None):
                self._on_dead(w, f"exited {w.proc.returncode} "
                                 "before connecting")

    def _on_frame(self, conn, slot, frame) -> None:
        worker = slot[0]
        if frame[0] == "elem":
            if worker is not None:
                self._on_elem(worker, frame[1], frame[2], frame[3])
            return
        msg = frame[1]
        kind = msg.get("t")
        if kind == "hello":
            wid = int(msg.get("worker", -1))
            for w in self._workers:
                if w.worker_id == wid and w.conn is None and w.alive:
                    w.attach(conn, slot[1])
                    slot[0] = w
                    w.send_graph(self.spec,
                                 None if self.trace is None
                                 else self.trace.to_wire())
                    self._maybe_dispatch()
                    return
            return
        if worker is None:
            return
        if kind == "split_end":
            worker.produced = int(msg.get("produced", 0))
            self._on_split_end(worker, int(msg["id"]), int(msg["n"]),
                               msg.get("stats") or {})
        elif kind == "err":
            self._on_error(worker, str(msg.get("msg", "worker error")))

    # -- consuming ------------------------------------------------------
    def _buffered(self) -> int:
        if self.deterministic:
            return sum(len(d) for d in self._det_buf.values())
        return len(self._ready)

    def _det_pop(self):
        while True:
            s = self._splits.get(self._cursor)
            if s is None:
                return _PENDING
            if s.n is not None and s.consumed >= s.n:
                # split fully consumed (possibly empty): advance cursor
                self._det_buf.pop(self._cursor, None)
                self._cursor += self.num_consumers
                self._maybe_dispatch()
                continue
            buf = self._det_buf.get(self._cursor)
            if not buf:
                return _PENDING
            obj = buf.popleft()
            s.consumed += 1
            return obj

    def _dyn_pop(self):
        if not self._ready:
            return _PENDING
        index, obj = self._ready.popleft()
        s = self._splits.get(index)
        if s is not None:
            s.consumed += 1
        self._maybe_dispatch()
        return obj

    def _finished(self) -> bool:
        if self._end_index is None:
            return False
        if self.deterministic:
            return self._cursor > self._end_index
        if self._ready:
            return False
        # splits past the end produce nothing by construction; every
        # split at or below it must be done and fully drained
        return all(s.n is not None and s.consumed >= s.n
                   for s in self._splits.values()
                   if s.index <= self._end_index)

    def next_element(self):
        if self._closed:
            raise StopIteration
        self.start()
        pop = self._det_pop if self.deterministic else self._dyn_pop
        stalled = False
        t0 = 0.0
        while True:
            if self._error is not None:
                raise DataServiceError(self._error)
            obj = pop()
            if obj is not _PENDING:
                self._counters["deliveries"] += 1
                self._counters["residency"] += self._buffered()
                self._delivered += 1
                return obj
            if self._finished():
                raise StopIteration
            if not stalled:
                stalled = True
                t0 = monotonic()
                self._counters["stalls"] += 1
            if not self._alive() and self._error is None:
                # _on_dead respawns or sets the error when the fleet
                # empties; reaching here without either is a stuck state
                self._error = "no live workers and nothing buffered"
                continue
            self._pump(0.05)
            if stalled:
                self._counters["stall_s"] += monotonic() - t0
                t0 = monotonic()
            if (self._deadline is not None and self._delivered == 0
                    and not self._buffered()
                    and monotonic() > self._deadline):
                raise DataServiceError(
                    "no worker produced data before "
                    "MMLSPARK_TPU_DATA_SERVICE_START_TIMEOUT")

    # -- stats / shutdown ----------------------------------------------
    def stats(self) -> dict:
        c = dict(self._counters)
        c["stall_s"] = round(c["stall_s"], 6)
        return c

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for w in self._workers:
            try:
                self._stop_worker(w)
            except Exception:
                pass
        if self._selector is not None:
            try:
                self._selector.close()
            except Exception:
                pass
            self._selector = None
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass
            self._server = None
        if self._started:
            self._event("session_end", delivered=self._delivered,
                        splits=sum(1 for s in self._splits.values()
                                   if s.state == "done"),
                        workers_spawned=self._spawned,
                        redispatches=self._redispatches)
            if self.trace is not None:
                self._event("finish",
                            status="error" if self._error else "ok",
                            delivered=self._delivered)


_PENDING = object()


def worker_produced(worker) -> int:
    core = getattr(worker, "core", None)  # inproc: read the core directly
    return (core.produced if core is not None
            else getattr(worker, "produced", 0))
