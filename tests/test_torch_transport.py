"""The port's transport framing (mmlspark_tpu_torch/data/service/
transport.py) against the JAX package's, on the CPU: the page-frame cases
of tests/test_data_service.py as port cases, and, for the same seeded
payloads, frame bytes equal to the JAX module's and a flipped bit failing
the crc at parse in both packages."""

import select
import socket
import struct
import zlib

import numpy as np
import pytest

from mmlspark_tpu.data.service import transport as jax_transport
from mmlspark_tpu_torch.data.service import transport
from mmlspark_tpu_torch.data.service.transport import (FrameBuffer,
                                                       TransportError,
                                                       encode_json,
                                                       encode_page,
                                                       read_frame)


def test_page_frame_roundtrips_with_crc():
    buf = FrameBuffer()
    payload = bytes(range(256)) * 3
    buf.feed(encode_page(7, 2, payload))
    frames = list(buf.frames())
    assert frames == [("page", 7, 2, payload)]
    assert buf.pending() == 0


def test_bit_flipped_page_rejected_and_stream_resumes():
    """A corrupt page fails crc32 AT PARSE TIME with the request/page
    identity attached, the bad frame is consumed, and the NEXT frame
    parses cleanly."""
    bad = bytearray(encode_page(9, 0, b"x" * 64))
    bad[-1] ^= 0xFF
    buf = FrameBuffer()
    buf.feed(bytes(bad))
    buf.feed(encode_json({"t": "kv_ack", "req": 9}))
    with pytest.raises(TransportError, match="crc32") as ei:
        list(buf.frames())
    assert ei.value.request_id == 9 and ei.value.page_index == 0
    assert list(buf.frames()) == [("json", {"t": "kv_ack", "req": 9})]


def test_truncated_page_header_and_torn_length_rejected():
    hdr = struct.Struct(">IB")
    page = struct.Struct(">IIII")
    data = b"y" * 10
    payload = page.pack(3, 1, 99, zlib.crc32(data)) + data
    buf = FrameBuffer()
    buf.feed(hdr.pack(len(payload) + 1, 0x4B) + payload)
    with pytest.raises(TransportError, match="torn page"):
        list(buf.frames())
    buf2 = FrameBuffer()
    buf2.feed(hdr.pack(4 + 1, 0x4B) + b"zzzz")
    with pytest.raises(TransportError, match="truncated page header"):
        list(buf2.frames())


def test_read_frame_bounded_timeout_and_torn_close():
    a, b = socket.socketpair()
    try:
        with pytest.raises(TransportError, match="stalled"):
            read_frame(a, FrameBuffer(), timeout_s=0.05)
        b.sendall(encode_json({"ok": 1}))
        assert read_frame(a, FrameBuffer(), 1.0) == ("json", {"ok": 1})
        frame = encode_json({"big": "x" * 64})
        b.sendall(frame[:7])
        b.close()
        with pytest.raises(TransportError, match="torn frame"):
            read_frame(a, FrameBuffer(), 1.0)
    finally:
        a.close()


def _payloads(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
            for n in rng.integers(0, 4096, 6)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frames_are_the_jax_wire_bytes(seed):
    """Page and JSON frames byte-equal to the JAX module's for the same
    payloads, and each package parses the other's stream."""
    rng = np.random.default_rng(seed + 100)
    msgs = [{"t": "kv_begin", "req": int(rng.integers(1 << 20)),
             "prompt": rng.integers(0, 64, 5).tolist(), "deadline": 1.5,
             "from": "p0", "lane": "primary"},
            {"t": "kv_ack", "req": 3, "page": 1}]
    pages = [(int(rng.integers(1 << 31)), i, data)
             for i, data in enumerate(_payloads(seed))]
    ours = b"".join([encode_json(m) for m in msgs]
                    + [encode_page(*p) for p in pages])
    theirs = b"".join([jax_transport.encode_json(m) for m in msgs]
                      + [jax_transport.encode_page(*p) for p in pages])
    assert ours == theirs
    want = [("json", m) for m in msgs] + [("page", *p) for p in pages]
    for parser in (FrameBuffer(), jax_transport.FrameBuffer()):
        parser.feed(theirs if isinstance(parser, FrameBuffer) else ours)
        assert list(parser.frames()) == want


@pytest.mark.parametrize("bit", [0, 7, 12345])
def test_flipped_bit_fails_crc_in_both_packages(bit):
    data = _payloads(4)[2] + b"\x00" * 2048
    frame = bytearray(encode_page(11, 4, data))
    frame[len(frame) - len(data) + bit // 8 % len(data)] ^= 1 << (bit % 8)
    for parser, error in ((FrameBuffer(), TransportError),
                          (jax_transport.FrameBuffer(),
                           jax_transport.TransportError)):
        parser.feed(bytes(frame))
        with pytest.raises(error, match="crc32") as ei:
            list(parser.frames())
        assert (ei.value.request_id, ei.value.page_index) == (11, 4)


def test_element_frames_wait_for_the_data_service():
    """Type E frames (the data service's elements, once refused here)
    decode as the JAX module's: `[4B split][4B seq]` + the pickled
    element; a frame too short for its header is a TransportError (a
    dead link to the dispatcher), not a struct error."""
    import pickle
    hdr = struct.Struct(">IB")
    payload = struct.pack(">II", 3, 5) + pickle.dumps(("p", [1, 2]))
    buf = FrameBuffer()
    buf.feed(hdr.pack(len(payload) + 1, 0x45) + payload)
    assert list(buf.frames()) == [("elem", 3, 5, ("p", [1, 2]))]
    buf.feed(hdr.pack(5, 0x45) + b"\x00" * 4)
    with pytest.raises(TransportError, match="truncated element header"):
        list(buf.frames())
    assert callable(transport.spawn_worker)


def test_listen_connect_accept_and_recv_ready():
    srv, port = transport.listen()
    try:
        sock = transport.connect("127.0.0.1", port, timeout_s=5.0)
        conn = transport.accept(srv, timeout_s=5.0)
    finally:
        srv.close()
    try:
        assert transport.recv_ready(conn) == b""
        sock.sendall(encode_page(1, 0, b"abc"))
        assert select.select([conn], [], [], 5.0)[0]
        buf = FrameBuffer()
        buf.feed(transport.recv_ready(conn))
        assert list(buf.frames()) == [("page", 1, 0, b"abc")]
        sock.close()
        assert select.select([conn], [], [], 5.0)[0]
        assert transport.recv_ready(conn) is None
    finally:
        conn.close()
