"""The KV handoff bus: fault-tolerant cache transfer between tiers (the
port of `mmlspark_tpu/serve/handoff.py`).

A disaggregated fleet splits the replicas behind one Router into a
PREFILL tier and a DECODE tier.  A prefill replica runs admission and
(chunked) prefill only; when a cohort's prefill finishes, the engine
hands the batch to this bus instead of seating it
(`ServingEngine.handoff_export`), and each engine request ends with
status `handoff`.  The bus ships every request's finished KV cache row —
model dtype or int8, whatever layout the tier runs — to a decode replica
as chunk-granular PAGES over the transport's type ``K`` frames
(`data/service/transport.py`), where `ServingEngine.splice_remote` seats
it through `merge_cache_rows` and decodes it to completion.  Greedy
output equals the colocated fleet's: the decode attempt replays nothing,
it resumes from the exact cache rows prefill produced.  The pages are
`serialize_cache_row`'s, the JAX package's wire bytes, so a page the
JAX prefill tier writes splices into the port's decode tier and back.
A page is copied from the card to the host once, when it is framed
(`CacheRowPages`), so a row's copies spread over the ticks its transfer
takes; the decode side's merge copies the row onto its card.

The handoff is a FAULT DOMAIN, not a best-effort copy:

  * every page frame carries (request id, page index, byte length,
    crc32) and is acked individually; a bit-flip on the wire fails the
    crc AT PARSE TIME on the decode side and nacks the transfer
  * a transfer that stops moving for `timeout_s` (resilience-clock
    seconds) fails on the sender's watchdog; a prefill replica that
    crashes mid-transfer fails every transfer it was sending
  * ANY transfer failure re-queues the router request for re-prefill
    elsewhere under the router's `RetryBudget` — the same failover path
    a replica crash takes, so a lost handoff never amplifies load
    unboundedly, and the retried request re-prefills from the prompt
    (exact final output)
  * the decode side splices ONLY after the last page validates, and
    re-checks the request deadline at splice: a request whose deadline
    expired while its pages were in flight is cancelled (`kv_cancel`),
    lands a `serve.route.cancel` event in the routing timeline, and
    refunds nothing to the retry budget

Transport is real loopback TCP, but both endpoints of every link are
pumped from the Router's single scheduler pass (`pump()`), so the whole
protocol — sends, acks, stalls, timeouts — runs under a `VirtualClock`
with zero sleeps, and page pushes are PIPELINED behind the prefill
tier's compute: up to `pages_per_tick` pages move per router tick while
the next chunk prefills (the `overlap` stat: the share of ticks with a
transfer in flight in which the prefill tier also computed).

Chaos (`resilience/chaos.py`, `Fault._HANDOFF_KINDS`, read through
`get_injector()`) acts on the wire itself: `handoff_torn` bit-flips one
page frame, `handoff_stall` freezes the sender, and
`prefill_crash_mid_transfer` crashes the sending replica after its first
page — the receiving side only ever sees the damage.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from mmlspark_tpu_torch.data.service.transport import (FrameBuffer,
                                                       TransportError,
                                                       accept, connect,
                                                       encode_json,
                                                       encode_page, listen,
                                                       recv_ready)
from mmlspark_tpu_torch.models.generate import (CacheRowPages,
                                                deserialize_cache_row)
from mmlspark_tpu_torch.observe.logging import get_logger
from mmlspark_tpu_torch.observe.metrics import inc_counter
from mmlspark_tpu_torch.observe.telemetry import active_run
from mmlspark_tpu_torch.observe.trace import TraceContext, trace_event
from mmlspark_tpu_torch.resilience.breaker import CircuitOpenError
from mmlspark_tpu_torch.resilience.chaos import get_injector
from mmlspark_tpu_torch.serve.request import TIMEOUT


class _Endpoint:
    """One side of a handoff link: a non-blocking socket plus a
    userspace send queue (flushed until EAGAIN each pump — a full kernel
    buffer never blocks the scheduler thread) and an incremental frame
    parser for whatever the peer sent."""

    def __init__(self, sock):
        sock.setblocking(False)
        self.sock = sock
        self.buf = FrameBuffer()
        self.out = bytearray()
        self.alive = True

    def queue(self, frame: bytes) -> None:
        self.out.extend(frame)

    def flush(self) -> bool:
        """Push queued bytes until the kernel buffer fills; True when
        any moved."""
        sent = False
        while self.out and self.alive:
            try:
                n = self.sock.send(self.out)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self.alive = False
                break
            if n <= 0:
                break
            del self.out[:n]
            sent = True
        return sent

    def poll(self) -> bool:
        """Drain whatever the peer sent into the frame buffer; True when
        bytes arrived."""
        if not self.alive:
            return False
        data = recv_ready(self.sock)
        if data is None:
            self.alive = False
            return False
        if data:
            self.buf.feed(data)
            return True
        return False

    def close(self) -> None:
        self.alive = False
        try:
            self.sock.close()
        except OSError:
            pass


class _Link:
    """One prefill->decode TCP pair: the sender socket lives with the
    prefill replica, the receiver socket with the decode replica; both
    are pumped by the bus."""

    def __init__(self, prefill: str, decode: str):
        self.prefill = prefill
        self.decode = decode
        srv, port = listen()
        try:
            sock = connect("127.0.0.1", port, timeout_s=5.0)
            conn = accept(srv, timeout_s=5.0)
        finally:
            srv.close()
        if conn is None:
            sock.close()
            raise TransportError(
                f"handoff link {prefill}->{decode} failed to accept")
        self.sender = _Endpoint(sock)
        self.receiver = _Endpoint(conn)

    def close(self) -> None:
        self.sender.close()
        self.receiver.close()


class _Transfer:
    """Sender-side state for one in-flight KV handoff."""

    __slots__ = ("rid", "rr", "prefill", "decode", "probe", "bucket",
                 "lane", "pages", "bytes_total", "next_page", "acked",
                 "started", "last_activity", "stall_until", "torn_page",
                 "torn_done", "crash_after", "crash_fired")

    def __init__(self, rid, rr, prefill, decode, probe, bucket, lane,
                 pages, now):
        self.rid = rid
        self.rr = rr
        self.prefill = prefill
        self.decode = decode
        self.probe = probe
        self.bucket = bucket
        self.lane = lane
        self.pages = pages           # CacheRowPages: framed on demand
        self.bytes_total = pages.nbytes()
        self.next_page = 0
        self.acked: set[int] = set()
        self.started = now
        self.last_activity = now
        self.stall_until = 0.0       # chaos: withhold pages until then
        self.torn_page: Optional[int] = None  # chaos: bit-flip this page
        self.torn_done = False
        self.crash_after = False     # chaos: crash sender after page 0
        self.crash_fired = False


class HandoffBus:
    """All KV transfers of one disaggregated fleet (module docstring).

    Owned by the Router; `pump()` runs inside the router's `_tick()`
    right after the replica ticks, so transfer progress, acks, splices,
    and watchdogs advance in lockstep with the scheduler — and page
    pushes overlap the prefill tier's next chunk of compute."""

    def __init__(self, router, *, timeout_s: float = 10.0,
                 pages_per_tick: int = 4):
        self._router = router
        self.timeout_s = max(1e-3, float(timeout_s))
        self.pages_per_tick = max(1, int(pages_per_tick))
        self._links: dict[tuple, _Link] = {}
        for p in router._prefill_reps:
            for d in router._decode_reps:
                self._links[(p.name, d.name)] = _Link(p.name, d.name)
        self.transfers: dict[int, _Transfer] = {}
        # decode side: partially received transfers, keyed by
        # (decode replica, router request id)
        self._partials: dict[tuple, dict] = {}
        # spliced engine requests awaiting the sender-side kv_spliced
        # handler (same process; the attempt object can't ride the wire)
        self._spliced_reqs: dict[int, tuple] = {}
        self._seq = 0                # transfers begun (chaos index, 1-based)
        self._spliced = 0
        self._retries = 0
        self._cancelled = 0
        self._bytes = 0
        self._pages = 0
        self._ticks_transfer = 0
        self._ticks_overlap = 0
        self._run = active_run()
        self._log = get_logger("serve")

    # -- accounting --------------------------------------------------------
    def _record(self, event: str, **fields) -> None:
        if self._run is not None:
            self._run.record_handoff({"event": event, **fields})
        trace_event(f"serve.handoff.{event}", cat="serve", **fields)
        inc_counter(f"serve.handoff.{event}")

    def _gauge(self) -> None:
        if self._run is None:
            return
        # exported by observe/export.py as the Prometheus gauges
        # mmlspark_tpu_handoff_{bytes,inflight,retries,overlap}
        self._run.gauge("handoff.bytes", self._bytes)
        self._run.gauge("handoff.inflight", len(self.transfers))
        self._run.gauge("handoff.retries", self._retries)
        if self._ticks_transfer:
            self._run.gauge("handoff.overlap",
                            self._ticks_overlap / self._ticks_transfer)

    def stats(self) -> dict:
        return {"links": len(self._links),
                "in_flight": len(self.transfers),
                "receiving": len(self._partials),
                "transfers": self._seq,
                "spliced": self._spliced,
                "retries": self._retries,
                "cancelled_at_splice": self._cancelled,
                "bytes_sent": self._bytes,
                "pages_sent": self._pages,
                "overlap": (round(self._ticks_overlap
                                  / self._ticks_transfer, 4)
                            if self._ticks_transfer else None)}

    def transfers_from(self, prefill_name: str) -> int:
        """In-flight transfers still owed by one prefill replica (its
        SIGTERM drain waits on this reaching zero)."""
        n = sum(1 for t in self.transfers.values()
                if t.prefill == prefill_name)
        n += sum(1 for (p, d), link in self._links.items()
                 if p == prefill_name and link.sender.out)
        return n

    # -- export: the prefill engine hands a finished cohort over -----------
    def make_export(self, prefill_name: str):
        """The `ServingEngine.handoff_export` callback for one prefill
        replica (wired at Router construction)."""
        def export(*, bucket, lane, reqs, src, tok_h, caches):
            self._export(prefill_name, bucket, lane, reqs, src, tok_h,
                         caches)
        return export

    def _export(self, prefill_name, bucket, lane, reqs, src, tok_h,
                caches) -> None:
        now = self._router.now()
        rep = self._router._by_name[prefill_name]
        chunk = max(1, int(rep.engine.cfg.cache_chunk))
        for j, req in zip(src, reqs):
            rr = self._router._rr_for_attempt(req)
            if rep.probe is req:
                self._router._prefill_probe_done(
                    rep, missed=rr is None or now > rr.deadline)
            if rr is None or rr.finished:
                continue
            self._begin(rr, prefill_name, bucket, lane, int(tok_h[j]),
                        caches, j, chunk, now)

    def _pick_decode(self) -> Optional[tuple]:
        """Least-loaded routable decode replica, else the first replica
        due a half-open probe (the spliced attempt IS the probe)."""
        healthy = [r for r in self._router._decode_reps if r.routable()]
        if healthy:
            return min(healthy, key=lambda r: r.load_tokens()), False
        for r in self._router._decode_reps:
            if r.probe_due():
                try:
                    r.breaker.allow()   # enter half-open for this probe
                except CircuitOpenError:
                    continue
                return r, True
        return None

    def _begin(self, rr, prefill_name, bucket, lane, first_tok, caches,
               row, chunk, now) -> None:
        self._seq += 1
        picked = self._pick_decode()
        if picked is None:
            self._record("no_decode", request=rr.id, prefill=prefill_name)
            self._router._handoff_failed(rr, "no_decode", now)
            return
        dec, probe = picked
        pages = CacheRowPages(caches, row, chunk)
        t = _Transfer(rr.id, rr, prefill_name, dec.name, probe, bucket,
                      lane, pages, now)
        inj = get_injector()
        if inj is not None:
            for f in inj.handoff_faults_due(self._seq):
                if f.kind == "handoff_torn":
                    t.torn_page = len(pages) - 1
                elif f.kind == "handoff_stall":
                    t.stall_until = now + float(f.seconds)
                elif f.kind == "prefill_crash_mid_transfer":
                    t.crash_after = True
        self.transfers[rr.id] = t
        link = self._links[(prefill_name, dec.name)]
        header = {
            "t": "kv_begin", "req": rr.id, "from": prefill_name,
            "lane": lane, "bucket": bucket, "pages": len(pages),
            "bytes": t.bytes_total, "first_tok": first_tok,
            "max_new": rr.max_new_tokens, "deadline": rr.deadline,
            "prompt": [int(x) for x in rr.prompt.tolist()]}
        if rr.trace is not None:
            # the trace context rides the wire with the cache header: the
            # decode-side splice resumes the SAME trace id (new attempt
            # span), so the fleet waterfall shows one request end to end
            header["trace"] = rr.trace.to_wire()
        link.sender.queue(encode_json(header))
        self._record("begin", request=rr.id, prefill=prefill_name,
                     decode=dec.name, pages=len(pages),
                     bytes=t.bytes_total, probe=probe,
                     **self._router._trace_fields(rr))

    # -- the per-tick pump -------------------------------------------------
    def pump(self, now: float, compute_worked: bool = False) -> bool:
        """Advance every transfer: push pages (bounded per tick — the
        pipelining that overlaps transfer with prefill compute), deliver
        and validate on the decode side, splice completed transfers,
        drain acks, and run both watchdogs."""
        worked = False
        moving = bool(self.transfers)
        for t in list(self.transfers.values()):
            worked |= self._push_pages(t, now)
        for link in self._links.values():
            worked |= link.sender.flush()
        for link in self._links.values():
            worked |= self._pump_receiver(link, now)
        worked |= self._retry_splices(now)
        for link in self._links.values():
            worked |= link.receiver.flush()
        for link in self._links.values():
            worked |= self._pump_sender(link, now)
        worked |= self._watchdogs(now)
        if moving:
            self._ticks_transfer += 1
            if compute_worked:
                self._ticks_overlap += 1
        if worked:
            self._gauge()
        return worked

    def _push_pages(self, t: _Transfer, now: float) -> bool:
        if t.stall_until and now < t.stall_until:
            return False
        link = self._links[(t.prefill, t.decode)]
        pushed = False
        for _ in range(self.pages_per_tick):
            if t.next_page >= len(t.pages):
                break
            data = t.pages[t.next_page]
            frame = encode_page(t.rid, t.next_page, data)
            if t.torn_page == t.next_page and not t.torn_done:
                # chaos: one bit on the wire — the decode side's crc32
                # must catch it and nack the whole transfer
                t.torn_done = True
                frame = bytearray(frame)
                frame[-1] ^= 0xFF
                frame = bytes(frame)
            link.sender.queue(frame)
            t.next_page += 1
            t.last_activity = now
            self._bytes += len(data)
            self._pages += 1
            pushed = True
            if t.crash_after and not t.crash_fired:
                # chaos: the sending replica dies with its FIRST page on
                # the wire and the rest still owed; the watchdog sweep
                # fails every transfer it was sending and the requests
                # re-prefill elsewhere
                t.crash_fired = True
                self._router._by_name[t.prefill].crash(
                    "chaos: prefill crashed mid-transfer")
                break
        return pushed

    # -- decode side -------------------------------------------------------
    def _pump_receiver(self, link: _Link, now: float) -> bool:
        ep = link.receiver
        worked = ep.poll()
        while True:
            it = ep.buf.frames()
            try:
                for frame in it:
                    worked = True
                    self._on_receiver_frame(link, frame, now)
                break
            except TransportError as e:
                # a torn or corrupt page: the bad frame is already
                # consumed — nack the transfer and keep parsing
                worked = True
                rid = getattr(e, "request_id", None)
                self._record("page_rejected", request=rid,
                             decode=link.decode, error=str(e))
                if rid is not None:
                    self._partials.pop((link.decode, rid), None)
                    ep.queue(encode_json({"t": "kv_nack", "req": rid,
                                          "error": str(e)}))
        return worked

    def _retry_splices(self, now: float) -> bool:
        """A completed transfer can be waiting for a free decode slot;
        retry the splice every tick (deadline re-checked each time)."""
        worked = False
        for key in list(self._partials):
            p = self._partials.get(key)
            if p is None or not p.get("ready"):
                continue
            link = self._links.get((p["meta"]["from"], key[0]))
            if link is not None:
                worked |= self._try_splice(link, key, p, now)
        return worked

    def _on_receiver_frame(self, link: _Link, frame: tuple,
                           now: float) -> None:
        kind = frame[0]
        if kind == "json":
            msg = frame[1]
            mt = msg.get("t")
            if mt == "kv_begin":
                self._partials[(link.decode, msg["req"])] = {
                    "meta": msg, "pages": {}, "last": now, "ready": False}
            elif mt == "kv_drop":
                key = (link.decode, msg["req"])
                p = self._partials.get(key)
                if p is not None and p["meta"]["from"] == msg.get("from"):
                    del self._partials[key]
            return
        if kind != "page":
            return
        rid, idx, data = frame[1], frame[2], frame[3]
        key = (link.decode, rid)
        p = self._partials.get(key)
        if p is None:
            return                     # stale page from a dropped transfer
        p["pages"][idx] = data
        p["last"] = now
        link.receiver.queue(encode_json(
            {"t": "kv_ack", "req": rid, "page": idx}))
        if len(p["pages"]) >= int(p["meta"]["pages"]):
            p["ready"] = True
            self._try_splice(link, key, p, now)

    def _try_splice(self, link: _Link, key: tuple, p: dict,
                    now: float) -> bool:
        """All pages validated: re-check the deadline, then seat the row
        on the decode engine.  Engine backpressure (no free slot) leaves
        the transfer resident and retries next tick."""
        meta = p["meta"]
        rid = meta["req"]
        if key[1] != rid or key not in self._partials:
            return False
        if float(meta["deadline"]) <= now:
            del self._partials[key]
            link.receiver.queue(encode_json(
                {"t": "kv_cancel", "req": rid,
                 "reason": "deadline_at_splice"}))
            return True
        rep = self._router._by_name[link.decode]
        if not rep.engine.alive or rep.faulted:
            del self._partials[key]
            link.receiver.queue(encode_json(
                {"t": "kv_nack", "req": rid,
                 "error": "decode replica unavailable"}))
            return True
        try:
            caches = deserialize_cache_row(
                [p["pages"][i] for i in range(int(meta["pages"]))])
        except (ValueError, KeyError, OSError) as e:
            del self._partials[key]
            link.receiver.queue(encode_json(
                {"t": "kv_nack", "req": rid,
                 "error": f"page decode failed: {e}"}))
            return True
        # rehydrate the trace context from the wire header: the decode
        # attempt continues the SAME trace id as a new attempt span
        ctx = TraceContext.from_wire(meta.get("trace"))
        req = rep.engine.splice_remote(
            np.asarray(meta["prompt"], dtype=np.int32),
            int(meta["max_new"]), float(meta["deadline"]),
            int(meta["first_tok"]), caches,
            lane=meta.get("lane", "primary"),
            trace=None if ctx is None else ctx.child(attempt=ctx.attempt + 1))
        if req is None:
            # decode batch full; keep the pages resident and tell the
            # sender we are alive so its watchdog holds off
            p["last"] = now
            link.receiver.queue(encode_json({"t": "kv_wait", "req": rid}))
            return False
        del self._partials[key]
        self._spliced_reqs[rid] = (link.decode, req)
        link.receiver.queue(encode_json({"t": "kv_spliced", "req": rid}))
        return True

    # -- sender side: acks and outcomes ------------------------------------
    def _pump_sender(self, link: _Link, now: float) -> bool:
        ep = link.sender
        worked = ep.poll()
        while True:
            it = ep.buf.frames()
            try:
                for frame in it:
                    worked = True
                    if frame[0] == "json":
                        self._on_sender_msg(frame[1], now)
                break
            except TransportError:
                worked = True          # control channel noise; drop frame
        return worked

    def _on_sender_msg(self, msg: dict, now: float) -> None:
        mt = msg.get("t")
        rid = msg.get("req")
        t = self.transfers.get(rid)
        if mt == "kv_ack":
            if t is not None:
                t.acked.add(int(msg["page"]))
                t.last_activity = now
        elif mt == "kv_wait":
            if t is not None:
                t.last_activity = now
        elif mt == "kv_nack":
            if t is not None:
                self._fail(t, f"page_rejected: {msg.get('error', '')}",
                           now, notify_receiver=False)
        elif mt == "kv_spliced":
            self._on_spliced(rid, now)
        elif mt == "kv_cancel":
            self._on_cancel(rid, msg.get("reason", ""), now)

    def _on_spliced(self, rid: int, now: float) -> None:
        t = self.transfers.pop(rid, None)
        picked = self._spliced_reqs.pop(rid, None)
        if picked is None:
            return
        decode_name, att = picked
        rep = self._router._by_name[decode_name]
        if t is None or t.rr.finished:
            rep.engine.cancel_request(att, "fleet request already finished")
            return
        rr = t.rr
        rep.routed += 1
        att.listener = rr._notify
        rr.attempts.append((decode_name, att))
        rr._notify()
        if t.probe:
            rep.probe = att
            self._router._count("probes")
        self._spliced += 1
        wall = max(0.0, now - t.started)
        self._router.estimator.observe_handoff(t.bucket, wall)
        if self._run is not None:
            self._run.observe_hist("serve.handoff_transfer_s", wall)
            # fleet-level TTFT: the decode seat resumes with prefill's
            # first token already in hand, so splice time IS first-token
            # time for a disaggregated request
            self._run.observe_hist("serve.ttft_s", now - rr.arrival)
        self._record("splice", request=rid, prefill=t.prefill,
                     decode=decode_name, pages=len(t.pages),
                     bytes=t.bytes_total, wall_s=round(wall, 6),
                     **self._router._trace_fields(rr))
        self._router._record_routing("handoff_splice", request=rid,
                                     replica=decode_name,
                                     attempt=len(rr.attempts))

    def _on_cancel(self, rid: int, reason: str, now: float) -> None:
        """Deadline expired while the pages were in flight: the request
        is dead on arrival.  Lands a `serve.route.cancel` routing event
        and touches the retry budget NOT AT ALL — a request that could
        never finish must not spend retry tokens."""
        t = self.transfers.pop(rid, None)
        if t is None:
            return
        self._cancelled += 1
        self._record("cancel_at_splice", request=rid, prefill=t.prefill,
                     decode=t.decode, reason=reason)
        rr = t.rr
        if rr.finished:
            return
        router = self._router
        if rr in router._live:
            router._live.remove(rr)
        router._record_routing("cancel", request=rid,
                               reason=reason or "deadline_at_splice",
                               replica=t.decode)
        router._complete(rr, TIMEOUT, "deadline expired at splice")

    # -- failure / watchdogs -----------------------------------------------
    def _fail(self, t: _Transfer, reason: str, now: float,
              notify_receiver: bool = True) -> None:
        """Transfer lost: tell the receiver to drop its pages (unless
        the sender is the casualty — a dead sender sends nothing) and
        re-queue the router request for re-prefill under the retry
        budget."""
        self.transfers.pop(t.rid, None)
        self._retries += 1
        self._record("transfer_failed", request=t.rid, prefill=t.prefill,
                     decode=t.decode, reason=reason,
                     pages_sent=t.next_page, pages_acked=len(t.acked),
                     **self._router._trace_fields(t.rr))
        if notify_receiver:
            link = self._links.get((t.prefill, t.decode))
            if link is not None and link.sender.alive:
                link.sender.queue(encode_json(
                    {"t": "kv_drop", "req": t.rid, "from": t.prefill}))
        rr = t.rr
        if rr.finished:
            return
        self._router._handoff_failed(rr, reason, now)

    def _watchdogs(self, now: float) -> bool:
        worked = False
        for t in list(self.transfers.values()):
            if t.rid not in self.transfers:
                continue
            pre = self._router._by_name[t.prefill]
            dec = self._router._by_name[t.decode]
            if pre.crashed or not pre.engine.alive:
                self._fail(t, "prefill_crash", now, notify_receiver=False)
                worked = True
            elif dec.faulted or dec.draining or not dec.engine.alive:
                self._fail(t, "decode_unavailable", now)
                worked = True
            elif now - t.last_activity > self.timeout_s:
                self._fail(t, "handoff_stalled", now)
                worked = True
        horizon = 2.0 * self.timeout_s
        for key, p in list(self._partials.items()):
            if now - p["last"] > horizon:
                # orphaned pages from a sender that died silently — the
                # sender-side watchdog already re-queued the request
                del self._partials[key]
                self._record("partial_dropped", request=p["meta"]["req"],
                             decode=key[0])
                worked = True
        return worked

    # -- lifecycle ---------------------------------------------------------
    def drop_for(self, rr) -> bool:
        """Withdraw any transfer for a finished/cancelled fleet request
        (the router's drain-timeout sweep)."""
        t = self.transfers.pop(rr.id, None)
        if t is None:
            return False
        link = self._links.get((t.prefill, t.decode))
        if link is not None and link.sender.alive:
            link.sender.queue(encode_json(
                {"t": "kv_drop", "req": t.rid, "from": t.prefill}))
        self._record("transfer_dropped", request=t.rid, prefill=t.prefill,
                     decode=t.decode)
        return True

    def idle(self) -> bool:
        return (not self.transfers and not self._partials
                and not self._spliced_reqs
                and all(not l.sender.out and not l.receiver.out
                        for l in self._links.values()))

    def close(self) -> None:
        for link in self._links.values():
            link.close()
