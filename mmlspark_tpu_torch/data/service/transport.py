"""The data service's one transport module: sockets and worker spawn (the
port of `mmlspark_tpu/data/service/transport.py`), also what the serving
tiers' KV handoff rides.

Wire format — length-prefixed frames on a localhost TCP stream, byte for
byte the JAX package's:

    [4B big-endian length][1B type][payload]

Type ``J``: a JSON control message `{"t": kind, ...}` (sorted keys):
handshake (`hello`), plan delivery (`graph`), work assignment (`split`),
completion (`split_end` with the element count and stage stats), a
worker-side failure (`err`), shutdown (`stop`).
Type ``E``: one ready data-service element — `[4B split][4B seq]` + the
pickled payload (numpy arrays and Python values, never tensors).
Sequence numbers are per (split, attempt), which is what lets the
dispatcher drop redelivered elements after a crash re-dispatch.
Type ``K``: one KV-cache page of the prefill->decode handoff —
`[4B request id][4B chunk index][4B byte length][4B crc32]` + raw page
bytes.  The crc is validated at parse time: a bit-flipped page surfaces
as a typed `TransportError` (carrying `request_id` / `page_index`)
instead of a silently corrupt cache splice, and the bad frame is
consumed first so the stream stays parseable — one torn page fails one
transfer, not the whole link.

Reads on the dispatcher's side are non-blocking (`recv_ready` +
`FrameBuffer`), so one consumer thread can pump every worker;
`read_frame` is the blocking read with a bounded wall deadline.  Workers
use plain blocking sockets.  `spawn_worker` starts a worker process
(`python -m mmlspark_tpu_torch.data.service.worker`) with
`CUDA_VISIBLE_DEVICES=""`: a worker decodes and shapes host data and
never creates a context on a card.
"""

from __future__ import annotations

import json
import os
import pickle
import socket
import struct
import subprocess
import sys
import zlib
from typing import Iterator, Optional

from mmlspark_tpu_torch.observe.spans import monotonic

_HDR = struct.Struct(">IB")
_ELEM = struct.Struct(">II")     # split, seq
_PAGE = struct.Struct(">IIII")  # request id, chunk index, byte len, crc32
_TYPE_JSON = 0x4A   # 'J'
_TYPE_ELEM = 0x45   # 'E'
_TYPE_PAGE = 0x4B   # 'K'
_MAX_FRAME = 1 << 31


class TransportError(ConnectionError):
    """Framing/peer failure on a connection (a ConnectionError, so retry
    policies treat it as retryable).  Page-integrity failures set
    `request_id`/`page_index` so the caller can fail ONE transfer instead
    of the whole link."""

    def __init__(self, message: str, *, request_id: Optional[int] = None,
                 page_index: Optional[int] = None):
        super().__init__(message)
        self.request_id = request_id
        self.page_index = page_index


def encode_json(msg: dict) -> bytes:
    payload = json.dumps(msg, sort_keys=True).encode("utf-8")
    return _HDR.pack(len(payload) + 1, _TYPE_JSON) + payload


def send_json(sock: socket.socket, msg: dict) -> None:
    sock.sendall(encode_json(msg))


def send_elem(sock: socket.socket, split: int, seq: int, obj) -> None:
    """One element frame: the split, the element's sequence number within
    this attempt at the split, then the pickled element."""
    payload = _ELEM.pack(split, seq) + pickle.dumps(
        obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_HDR.pack(len(payload) + 1, _TYPE_ELEM) + payload)


def encode_page(request_id: int, page_index: int, data: bytes) -> bytes:
    """One KV page frame: the (request id, chunk index, byte length,
    crc32) header the handoff protocol acks against, then the raw page.
    Encoding is split from sending so a single-threaded pump can queue
    frames on a non-blocking socket."""
    payload = _PAGE.pack(request_id, page_index, len(data),
                         zlib.crc32(data)) + data
    return _HDR.pack(len(payload) + 1, _TYPE_PAGE) + payload


class FrameBuffer:
    """Incremental frame parser: `feed` raw bytes, iterate `frames()`.
    Frames come out as ("json", dict), ("elem", split, seq, obj) or
    ("page", request_id, page_index, data) — page frames crc-validated
    at parse time (a failed page raises `TransportError` AFTER consuming
    the frame, so iteration can resume on the next frame)."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> None:
        self._buf.extend(data)

    def pending(self) -> int:
        return len(self._buf)

    def frames(self) -> Iterator[tuple]:
        while True:
            if len(self._buf) < _HDR.size:
                return
            length, ftype = _HDR.unpack_from(self._buf)
            if not (1 <= length <= _MAX_FRAME):
                raise TransportError(f"bad frame length {length}")
            end = _HDR.size + length - 1
            if len(self._buf) < end:
                return
            payload = bytes(self._buf[_HDR.size:end])
            del self._buf[:end]
            if ftype == _TYPE_JSON:
                yield ("json", json.loads(payload.decode("utf-8")))
            elif ftype == _TYPE_PAGE:
                yield self._page(payload)
            elif ftype == _TYPE_ELEM:
                if len(payload) < _ELEM.size:
                    raise TransportError(
                        f"truncated element header ({len(payload)}B)")
                split, seq = _ELEM.unpack_from(payload)
                yield ("elem", split, seq,
                       pickle.loads(payload[_ELEM.size:]))
            else:
                raise TransportError(f"unknown frame type {ftype:#x}")

    @staticmethod
    def _page(payload: bytes) -> tuple:
        if len(payload) < _PAGE.size:
            raise TransportError(
                f"truncated page header ({len(payload)}B)")
        rid, idx, blen, crc = _PAGE.unpack_from(payload)
        data = payload[_PAGE.size:]
        if len(data) != blen:
            raise TransportError(
                f"torn page {idx} for request {rid}: header says {blen}B, "
                f"frame carries {len(data)}B",
                request_id=rid, page_index=idx)
        if zlib.crc32(data) != crc:
            raise TransportError(
                f"page {idx} for request {rid} failed crc32",
                request_id=rid, page_index=idx)
        return ("page", rid, idx, data)


def read_frame(sock: socket.socket, buf: FrameBuffer,
               timeout_s: float) -> tuple:
    """Blocking read of exactly ONE frame with a bounded wall deadline.
    A stalled peer surfaces as `TransportError` ('stalled') instead of a
    hang, and a peer that closes mid-frame as `TransportError` ('torn')
    instead of a silent short read.  Bytes past the first frame stay in
    `buf`."""
    deadline = monotonic() + max(1e-3, float(timeout_s))
    while True:
        for frame in buf.frames():
            return frame
        remaining = deadline - monotonic()
        if remaining <= 0:
            raise TransportError(
                f"frame read stalled: no complete frame within "
                f"{timeout_s:.3f}s ({buf.pending()}B buffered)")
        sock.settimeout(remaining)
        try:
            data = sock.recv(1 << 16)
        except socket.timeout:
            continue
        except OSError as e:
            raise TransportError(f"peer failed mid-frame: {e}") from e
        if not data:
            raise TransportError(
                f"torn frame: peer closed with {buf.pending()}B of an "
                f"incomplete frame buffered")
        buf.feed(data)


def listen(host: str = "127.0.0.1") -> tuple[socket.socket, int]:
    """Bind an ephemeral port; returns (server_sock, port)."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, 0))
    srv.listen(64)
    return srv, srv.getsockname()[1]


def accept(server: socket.socket,
           timeout_s: float) -> Optional[socket.socket]:
    """Accept one connection (None on timeout).  Accepted connections
    come back non-blocking with NODELAY."""
    server.settimeout(timeout_s)
    try:
        conn, _ = server.accept()
    except (socket.timeout, BlockingIOError, InterruptedError):
        return None
    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    conn.setblocking(False)
    return conn


def connect(host: str, port: int, timeout_s: float = 10.0) -> socket.socket:
    """Blocking connect (one attempt; callers retry)."""
    try:
        sock = socket.create_connection((host, port), timeout=timeout_s)
    except OSError as e:
        raise TransportError(f"connect {host}:{port} failed: {e}") from e
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.settimeout(None)
    return sock


def recv_ready(sock: socket.socket) -> Optional[bytes]:
    """Drain whatever is available on a non-blocking socket.  Returns
    b"" when nothing is pending, bytes when data arrived, None when the
    peer closed or reset."""
    chunks = []
    while True:
        try:
            data = sock.recv(1 << 16)
        except (BlockingIOError, InterruptedError):
            break
        except OSError:
            return None
        if not data:
            return None if not chunks else b"".join(chunks)
        chunks.append(data)
        if len(data) < (1 << 16):
            break
    return b"".join(chunks)


def spawn_worker(worker_id: int, host: str, port: int, *,
                 env: Optional[dict] = None) -> subprocess.Popen:
    """Launch one service worker process that connects back to the
    dispatcher at host:port, importing the consumer's copy of the package.
    The worker sees no card (`CUDA_VISIBLE_DEVICES=""`): it decodes and
    shapes host data and must never create a CUDA context.  Its stderr goes to
    `MMLSPARK_TPU_DATA_SERVICE_WORKER_LOG/worker-<k>.log` when that knob
    names a directory, else to /dev/null."""
    import mmlspark_tpu_torch
    from mmlspark_tpu_torch import config
    wenv = dict(os.environ)
    wenv["CUDA_VISIBLE_DEVICES"] = ""
    # the worker imports the consumer's copy of the package, wherever the
    # consumer found it (a checkout on sys.path, not only an install)
    root = os.path.dirname(os.path.dirname(
        os.path.abspath(mmlspark_tpu_torch.__file__)))
    wenv["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in wenv.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    # gauges emitted inside the worker get a per-worker namespace so N
    # workers reporting into one metrics backend never collide
    wenv["MMLSPARK_TPU_DATA_SERVICE_WORKER_NS"] = \
        f"data.service.w{worker_id}"
    wenv.update(env or {})
    log_dir = str(config.get("MMLSPARK_TPU_DATA_SERVICE_WORKER_LOG")
                  or "")
    stderr = subprocess.DEVNULL
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        stderr = open(os.path.join(log_dir, f"worker-{worker_id}.log"),
                      "ab")
    try:
        return subprocess.Popen(
            [sys.executable, "-m", "mmlspark_tpu_torch.data.service.worker",
             "--connect", f"{host}:{port}", "--id", str(worker_id)],
            stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
            stderr=stderr, env=wenv)
    finally:
        if stderr is not subprocess.DEVNULL:
            stderr.close()   # the child holds its own descriptor
