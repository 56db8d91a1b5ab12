"""The port's remote and SQL readers (`io/remote.py`, `io/sql.py`) and
the resilience layer under them (`resilience/retry.py`, `net.py`) against
the JAX package's, on the CPU.

A local HTTP fixture serves one in-memory object store through plain HTTP
with a MANIFEST, the GCS JSON listing API and the S3 ListObjectsV2 API;
both packages point their endpoint knobs (the same names) at it, so the
listings, pagination and downloads run for real on loopback.  Listings
and bytes must be equal; the retry schedule runs on each package's
VirtualClock with no wall-clock sleeps.
"""

import io
import json
import sqlite3
import threading
import urllib.error
import urllib.parse
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
from PIL import Image

from mmlspark_tpu import config as jax_config
from mmlspark_tpu.io import files as jfiles
from mmlspark_tpu.io import image_reader as jreader
from mmlspark_tpu.io import remote as jremote
from mmlspark_tpu.io import sql as jsql
from mmlspark_tpu_torch import config
from mmlspark_tpu_torch.io import files, remote, sql
from mmlspark_tpu_torch.io.image_reader import read_images
from mmlspark_tpu_torch.observe.metrics import get_counter, reset_counters
from mmlspark_tpu_torch.resilience.breaker import (CircuitOpenError,
                                                   reset_breakers)
from mmlspark_tpu_torch.resilience.chaos import reset_chaos
from mmlspark_tpu_torch.resilience.clock import VirtualClock, set_clock
from mmlspark_tpu_torch.resilience.net import fetch_url
from mmlspark_tpu_torch.resilience.retry import (RetryBudgetExceeded,
                                                 RetryPolicy,
                                                 retry_after_hint,
                                                 retryable_status)


def _png(value, side=4):
    buf = io.BytesIO()
    Image.new("RGB", (side, side), (value, value // 2, 255 - value)).save(
        buf, "PNG")
    return buf.getvalue()


def _zip(entries: dict) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for name, data in entries.items():
            zf.writestr(name, data)
    return buf.getvalue()


OBJECTS = {
    "imgs/a.png": _png(10), "imgs/b.png": _png(200),
    "imgs/c d.png": _png(90),
    "imgs/notes.txt": b"not an image",
    "imgs/pair.zip": _zip({"z1.png": _png(60), "z2.png": _png(120)}),
}
MANIFEST = "\n".join(["# the store"] + sorted(OBJECTS)) + "\n"
FLAKY = {"remaining": 0, "code": 503, "retry_after": "1"}


class _Store(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def _send(self, data: bytes, code: int = 200, headers=()):
        self.send_response(code)
        for k, v in headers:
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802 (stdlib naming)
        parsed = urllib.parse.urlparse(self.path)
        path = urllib.parse.unquote(parsed.path)
        qs = urllib.parse.parse_qs(parsed.query)
        names = sorted(OBJECTS)
        if path == "/storage/v1/b/bkt/o":       # GCS: one-item pages
            names = [n for n in names if n.startswith(qs["prefix"][0])]
            page = int(qs.get("pageToken", ["0"])[0])
            body = {"items": [{"name": names[page]}]}
            if page + 1 < len(names):
                body["nextPageToken"] = str(page + 1)
            return self._send(json.dumps(body).encode())
        if path.startswith("/storage/v1/b/bkt/o/") and qs.get("alt") == [
                "media"]:
            return self._send(OBJECTS[path[len("/storage/v1/b/bkt/o/"):]])
        if path == "/bkt" and qs.get("list-type") == ["2"]:   # S3: pairs
            names = [n for n in names if n.startswith(qs["prefix"][0])]
            start = int(qs.get("continuation-token", ["0"])[0])
            nxt = (f"<NextContinuationToken>{start + 2}"
                   "</NextContinuationToken>"
                   if start + 2 < len(names) else "")
            return self._send((
                '<?xml version="1.0"?><ListBucketResult xmlns='
                '"http://s3.amazonaws.com/doc/2006-03-01/">'
                + "".join(f"<Contents><Key>{n}</Key></Contents>"
                          for n in names[start:start + 2])
                + nxt + "</ListBucketResult>").encode())
        if path.startswith("/bkt/") and path[5:] in OBJECTS:
            return self._send(OBJECTS[path[5:]])
        if path.startswith("/flaky/") and FLAKY["remaining"] > 0:
            FLAKY["remaining"] -= 1
            return self._send(b"", FLAKY["code"],
                              [("Retry-After", FLAKY["retry_after"])])
        for root in ("/files/", "/flaky/"):
            if path == root + "MANIFEST":
                return self._send(MANIFEST.encode())
            if path.startswith(root) and path[len(root):] in OBJECTS:
                return self._send(OBJECTS[path[len(root):]])
        return self._send(b"missing", 404)


@pytest.fixture(scope="module")
def server():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Store)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_port}"
    for registry in (config, jax_config):
        registry.set("MMLSPARK_TPU_GCS_ENDPOINT", base)
        registry.set("MMLSPARK_TPU_S3_ENDPOINT", base)
    yield base
    for registry in (config, jax_config):
        registry.set("MMLSPARK_TPU_GCS_ENDPOINT", None)
        registry.set("MMLSPARK_TPU_S3_ENDPOINT", None)
    httpd.shutdown()
    httpd.server_close()


@pytest.fixture
def clock():
    clock = VirtualClock()
    previous = set_clock(clock)
    reset_counters()
    reset_breakers()
    reset_chaos()
    yield clock
    set_clock(previous)
    reset_breakers()
    reset_chaos()
    reset_counters()


SOURCES = ["{s}/files/", "{s}/files/imgs/b.png", "gs://bkt/imgs/",
           "s3://bkt/imgs/", "s3://bkt/imgs/p"]
KWARGS = [{}, {"pattern": "*.png", "inspect_zip": False},
          {"sample_ratio": 0.5, "seed": 3}]


def test_is_remote_matches_jax():
    for path in ("http://x/", "https://x/a", "gs://b/p", "s3://b/p",
                 "/tmp/x", "file:///tmp/x", "relative/dir"):
        assert remote.is_remote(path) == jremote.is_remote(path)


@pytest.mark.parametrize("source", SOURCES)
def test_listings_match_jax(server, source):
    url = source.format(s=server)
    assert remote.list_remote_files(url) == jremote.list_remote_files(url)
    assert remote.list_remote_files(url, pattern="*.zip") == \
        jremote.list_remote_files(url, pattern="*.zip")


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("kw", KWARGS)
def test_paths_and_bytes_match_jax(server, source, kw):
    url = source.format(s=server)
    got = list(files.iter_binary_files(url, **kw))
    ref = list(jfiles.iter_binary_files(url, **kw))
    assert got == ref


def test_http_directory_expands_zips_and_keeps_spaces(server):
    got = dict(files.iter_binary_files(f"{server}/files/"))
    assert got[f"{server}/files/imgs/pair.zip/z2.png"] == _png(120)
    assert got[f"{server}/files/imgs/c d.png"] == OBJECTS["imgs/c d.png"]
    assert len(got) == 6
    table = files.read_binary_files(f"{server}/files/", pattern="*.txt")
    assert list(table["bytes"]) == [b"not an image"]


def test_read_images_over_http_matches_jax(server):
    kw = dict(pattern="*.png", inspect_zip=True)
    got = read_images(f"{server}/files/", device="cpu", **kw)
    ref = jreader.read_images(f"{server}/files/", **kw)
    assert list(got["path"]) == list(ref["path"])
    np.testing.assert_array_equal(got["image"], ref["image"])
    assert got["image"].shape == (3, 4, 4, 3)


def test_flaky_endpoint_recovers_on_retry_after(server, clock):
    FLAKY.update(remaining=2, code=503, retry_after="1")
    got = dict(files.iter_binary_files(f"{server}/flaky/imgs/b.png"))
    assert got == {f"{server}/flaky/imgs/b.png": OBJECTS["imgs/b.png"]}
    assert get_counter("remote.fetch.retries") == 2
    assert get_counter("remote.fetch.recovered") == 1
    assert clock.sleeps == [1.0, 1.0]
    FLAKY.update(remaining=1, code=429, retry_after="2.5")
    got = dict(files.iter_binary_files(f"{server}/flaky/", pattern="a.png"))
    assert list(got) == [f"{server}/flaky/imgs/a.png"]
    assert clock.sleeps[-1] == 2.5


def test_other_4xx_fails_fast(server, clock):
    with pytest.raises(urllib.error.HTTPError):
        list(files.iter_binary_files(f"{server}/files/imgs/missing.png"))
    assert get_counter("remote.fetch.attempts") == 1
    assert clock.sleeps == []
    assert not retryable_status(404) and retryable_status(503)
    assert retryable_status(408) and retryable_status(429)


def test_chaos_network_faults_are_absorbed(server, clock):
    config.set("MMLSPARK_TPU_CHAOS_SEED", 7)
    config.set("MMLSPARK_TPU_CHAOS_NET_ERROR_RATE", 0.3)
    config.set("MMLSPARK_TPU_BREAKER_THRESHOLD", 0)
    reset_chaos()
    try:
        got = dict(files.iter_binary_files(f"{server}/files/",
                                           pattern="*.png",
                                           inspect_zip=False))
        assert got[f"{server}/files/imgs/a.png"] == OBJECTS["imgs/a.png"]
        assert get_counter("chaos.net_errors") > 0
        assert get_counter("remote.fetch.retries") == \
            get_counter("chaos.net_errors")
    finally:
        config.set("MMLSPARK_TPU_CHAOS_SEED", None)
        config.set("MMLSPARK_TPU_CHAOS_NET_ERROR_RATE", None)
        config.set("MMLSPARK_TPU_BREAKER_THRESHOLD", None)


def test_circuit_breaker_cuts_off_a_dead_endpoint(server, clock):
    config.set("MMLSPARK_TPU_BREAKER_THRESHOLD", 3)
    config.set("MMLSPARK_TPU_RETRY_MAX_ATTEMPTS", 2)
    FLAKY.update(remaining=10 ** 6, code=503, retry_after="0")
    try:
        with pytest.raises(RetryBudgetExceeded):   # 2 failures
            fetch_url(f"{server}/flaky/imgs/a.png")
        with pytest.raises(CircuitOpenError):      # the 3rd opens it
            fetch_url(f"{server}/flaky/imgs/a.png")
        assert get_counter("remote.fetch.attempts") == 3
        with pytest.raises(CircuitOpenError):      # refused at once
            fetch_url(f"{server}/flaky/imgs/a.png")
    finally:
        FLAKY["remaining"] = 0
        config.set("MMLSPARK_TPU_BREAKER_THRESHOLD", None)
        config.set("MMLSPARK_TPU_RETRY_MAX_ATTEMPTS", None)


def test_retry_policy_budgets_and_jitter(clock):
    calls = []

    def flaky():
        calls.append(1)
        raise TimeoutError("slow")

    policy = RetryPolicy(max_attempts=4, base_s=1.0, max_backoff_s=3.0,
                         total_deadline_s=100.0, seed=5)
    with pytest.raises(RetryBudgetExceeded) as info:
        policy.call(flaky)
    assert info.value.attempts == 4 and len(calls) == 4
    assert len(clock.sleeps) == 3
    assert all(0 <= s <= c for s, c in zip(clock.sleeps, (1.0, 2.0, 3.0)))
    with pytest.raises(ValueError):
        policy.call(lambda: int("x"))        # a bug, not a fault
    tight = RetryPolicy(max_attempts=10, base_s=50.0, max_backoff_s=50.0,
                        total_deadline_s=1.0, seed=1)
    with pytest.raises(RetryBudgetExceeded, match="deadline"):
        tight.call(flaky)
    seen = []
    deadline = RetryPolicy(attempt_deadline_s=0.5, seed=0)
    assert deadline.call(lambda timeout: seen.append(timeout) or 7) == 7
    assert seen == [0.5]
    from_cfg = RetryPolicy.from_config(name="x", max_attempts=2)
    assert (from_cfg.max_attempts, from_cfg.base_s, from_cfg.name) == \
        (2, 0.5, "x")


def test_retry_after_hint_reads_seconds_only():
    def err(code, value):
        return urllib.error.HTTPError("u", code, "m",
                                      {"Retry-After": value}, None)
    assert retry_after_hint(err(503, "2")) == 2.0
    assert retry_after_hint(err(429, " 0.5 ")) == 0.5
    assert retry_after_hint(err(503, "Wed, 21 Oct 2015 07:28:00 GMT")) is None
    assert retry_after_hint(err(500, "2")) is None
    assert retry_after_hint(TimeoutError()) is None


@pytest.fixture
def sqlite_db(tmp_path):
    path = str(tmp_path / "t.db")
    conn = sqlite3.connect(path)
    conn.execute("CREATE TABLE pts (x REAL, n INTEGER, name TEXT, note TEXT,"
                 " hole INTEGER)")
    conn.executemany(
        "INSERT INTO pts VALUES (?, ?, ?, ?, ?)",
        [(i * 0.5, i, f"row{i}", None if i % 3 == 0 else f"n{i}",
          None if i == 4 else i) for i in range(10)])
    conn.commit()
    conn.close()
    return path


def _same_table(got, ref):
    assert got.columns == ref.columns
    for c in got.columns:
        a, b = got[c], np.asarray(ref[c])
        assert a.dtype == b.dtype, c
        if a.dtype == object:
            assert list(a) == list(b)
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("query", ["SELECT * FROM pts",
                                   "SELECT x, name FROM pts WHERE n < 0",
                                   "SELECT n, hole FROM pts WHERE n > ?"])
def test_read_sql_matches_jax(sqlite_db, query):
    params = (2,) if "?" in query else None
    _same_table(sql.read_sql(query, sqlite_db, params),
                jsql.read_sql(query, sqlite_db, params))


def test_iter_sql_batches_match_jax(sqlite_db):
    got = list(sql.iter_sql("SELECT * FROM pts", sqlite_db, batch_rows=4))
    ref = list(jsql.iter_sql("SELECT * FROM pts", sqlite_db, batch_rows=4))
    assert [t.num_rows for t in got] == [4, 4, 2]
    for g, r in zip(got, ref):
        _same_table(g, r)
    conn = sqlite3.connect(sqlite_db)
    try:         # a caller's connection is used, not closed
        assert sql.read_sql("SELECT n FROM pts", conn).num_rows == 10
        assert sql.read_sql("SELECT n FROM pts",
                            lambda: sqlite3.connect(sqlite_db)).num_rows == 10
        conn.execute("SELECT 1")
    finally:
        conn.close()
    with pytest.raises(ValueError, match="batch_rows"):
        next(sql.iter_sql("SELECT 1", sqlite_db, batch_rows=0))
