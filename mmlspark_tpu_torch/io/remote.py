"""Remote binary-file sources: http(s)://, gs://, s3:// ingestion (the
port of `mmlspark_tpu/io/remote.py`).

The counterpart of the reference's remote-FS readers (HDFS/WASB
enumeration in BinaryFileReader.scala:28-69, AzureBlobReader.scala:12-47).
The semantics mirror `io/files.py`: enumerate, filter by pattern,
subsample by `sample_ratio`, expand zip archives, and stream one file's
bytes at a time.

Listing protocols:
  * ``http(s)://host/path/file``    - a single object.
  * ``http(s)://host/path/``        - a directory: fetches ``MANIFEST``
    (newline-separated relative paths, the zoo repo layout).
  * ``gs://bucket/prefix``          - GCS JSON API listing
    (``storage/v1/b/{bucket}/o?prefix=``); optional OAuth bearer token
    from the config registry.
  * ``s3://bucket/prefix``          - S3 ListObjectsV2 (XML); anonymous /
    public buckets only (no SigV4 signing).

Every fetch runs under the resilience layer (`resilience/net.py`
`fetch_url`): backoff retries with `Retry-After` honoured on 429/503,
fail-fast on other 4xx, and a per-host circuit breaker.  The endpoints
are the JAX package's config variables, which is also how the tests drive
these paths against a local HTTP fixture.
"""

from __future__ import annotations

import fnmatch
import io
import json
import posixpath
import urllib.parse
import xml.etree.ElementTree as ET
import zipfile
from typing import Iterator, Optional

import numpy as np

from mmlspark_tpu_torch import config
from mmlspark_tpu_torch.resilience.net import fetch_url

_GCS_ENDPOINT = config.register(
    "MMLSPARK_TPU_GCS_ENDPOINT", "https://storage.googleapis.com",
    "GCS API endpoint (override for emulators/tests)")
_GCS_TOKEN = config.register(
    "MMLSPARK_TPU_GCS_TOKEN", None,
    "OAuth2 bearer token for GCS requests (None = anonymous)")
_S3_ENDPOINT = config.register(
    "MMLSPARK_TPU_S3_ENDPOINT", "https://s3.amazonaws.com",
    "S3 API endpoint (override for emulators/tests)")
_TIMEOUT = config.register(
    "MMLSPARK_TPU_REMOTE_TIMEOUT_S", 30.0,
    "per-request connect/read timeout for remote sources", ptype=float)


def is_remote(path: str) -> bool:
    return urllib.parse.urlparse(path).scheme in ("http", "https", "gs",
                                                  "s3")


def _fetch(url: str, headers: Optional[dict] = None) -> bytes:
    """Download under the resilience policy layer: chunked bounded reads
    with a per-request timeout (a stalled link raises instead of wedging
    the ingestion loop), retry/backoff for transient failures, and the
    per-host circuit breaker (resilience/net.py)."""
    return fetch_url(url, headers=headers,
                     timeout=config.get("MMLSPARK_TPU_REMOTE_TIMEOUT_S"))


def _gcs_headers() -> dict:
    token = config.get("MMLSPARK_TPU_GCS_TOKEN")
    return {"Authorization": f"Bearer {token}"} if token else {}


def _list_http(url: str) -> list[tuple[str, str]]:
    """[(display_path, fetch_url)] for an http(s) source."""
    if not url.endswith("/"):
        return [(url, url)]
    manifest = _fetch(urllib.parse.urljoin(url, "MANIFEST")).decode()
    out = []
    for rel in manifest.splitlines():  # newline-separated: paths may
        rel = rel.strip()              # contain spaces
        if not rel or rel.startswith("#"):
            continue
        out.append((urllib.parse.urljoin(url, rel),
                    urllib.parse.urljoin(url, urllib.parse.quote(rel))))
    return out


def _list_gcs(url: str) -> list[tuple[str, str]]:
    parsed = urllib.parse.urlparse(url)
    bucket, prefix = parsed.netloc, parsed.path.lstrip("/")
    endpoint = config.get("MMLSPARK_TPU_GCS_ENDPOINT").rstrip("/")
    names, page = [], None
    while True:
        qs = {"prefix": prefix, "fields": "items(name),nextPageToken"}
        if page:
            qs["pageToken"] = page
        listing = json.loads(_fetch(
            f"{endpoint}/storage/v1/b/{urllib.parse.quote(bucket)}/o?"
            + urllib.parse.urlencode(qs), headers=_gcs_headers()).decode())
        names += [item["name"] for item in listing.get("items", [])]
        page = listing.get("nextPageToken")
        if not page:
            break
    return [(f"gs://{bucket}/{n}",
             f"{endpoint}/storage/v1/b/{urllib.parse.quote(bucket)}/o/"
             f"{urllib.parse.quote(n, safe='')}?alt=media") for n in names]


def _list_s3(url: str) -> list[tuple[str, str]]:
    parsed = urllib.parse.urlparse(url)
    bucket, prefix = parsed.netloc, parsed.path.lstrip("/")
    endpoint = config.get("MMLSPARK_TPU_S3_ENDPOINT").rstrip("/")
    names, token = [], None
    while True:
        qs = {"list-type": "2", "prefix": prefix}
        if token:
            qs["continuation-token"] = token
        root = ET.fromstring(_fetch(
            f"{endpoint}/{urllib.parse.quote(bucket)}?"
            + urllib.parse.urlencode(qs)).decode())
        ns = root.tag.partition("}")[0] + "}" if "}" in root.tag else ""
        names += [c.findtext(f"{ns}Key") for c in root.iter(f"{ns}Contents")]
        token = root.findtext(f"{ns}NextContinuationToken")
        if not token:
            break
    return [(f"s3://{bucket}/{n}",
             f"{endpoint}/{urllib.parse.quote(bucket)}/"
             f"{urllib.parse.quote(n)}") for n in names]


def list_remote_files(path: str,
                      pattern: Optional[str] = None) -> list[tuple[str, str]]:
    """[(display_path, fetch_url)], name-filtered like `list_files`."""
    scheme = urllib.parse.urlparse(path).scheme
    if scheme in ("http", "https"):
        entries = _list_http(path)
    elif scheme == "gs":
        entries = _list_gcs(path)
    elif scheme == "s3":
        entries = _list_s3(path)
    else:
        raise ValueError(f"unsupported remote scheme: {path!r}")
    if pattern:
        entries = [(p, u) for p, u in entries
                   if fnmatch.fnmatch(posixpath.basename(p), pattern)]
    return sorted(entries)


def iter_remote_binary_files(path: str, sample_ratio: float = 1.0,
                             inspect_zip: bool = True,
                             pattern: Optional[str] = None,
                             seed: int = 0) -> Iterator[tuple[str, bytes]]:
    """Remote twin of `iter_binary_files`: stream (path, bytes) with
    identical sample_ratio / zip-expansion / pattern semantics.  One
    file's bytes resident at a time; zip entries are sampled per ENTRY,
    exactly as the local reader (FileUtilities.scala:93-138).  One
    deliberate difference: zips are detected by the ``.zip`` extension —
    content-sniffing a remote object would force downloading files that
    per-file sampling would otherwise skip entirely."""
    if not 0.0 <= sample_ratio <= 1.0:
        raise ValueError(f"sample_ratio must be in [0,1], got {sample_ratio}")
    rng = np.random.default_rng(seed)
    scheme = urllib.parse.urlparse(path).scheme
    headers = _gcs_headers() if scheme == "gs" else {}
    for display, url in list_remote_files(path, pattern):
        if inspect_zip and display.lower().endswith(".zip"):
            data = _fetch(url, headers=headers)
            with zipfile.ZipFile(io.BytesIO(data)) as zf:
                for info in zf.infolist():
                    if info.is_dir():
                        continue
                    if sample_ratio < 1.0 and rng.random() > sample_ratio:
                        continue
                    yield f"{display}/{info.filename}", zf.read(info)
            continue
        if sample_ratio < 1.0 and rng.random() > sample_ratio:
            continue
        yield display, _fetch(url, headers=headers)
