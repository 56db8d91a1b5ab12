"""The one raw-HTTP seam of the port (the port of
`mmlspark_tpu/resilience/net.py`): every urlopen lives here.

`http_get` is where the chaos injector hooks in (`on_request`) and where
chunked reads and per-request timeouts are enforced.  `fetch_url` adds the
retry policy and the per-host circuit breaker; `io/remote.py` uses it.
"""

from __future__ import annotations

import io
import urllib.parse
import urllib.request
from typing import Optional

from mmlspark_tpu_torch.resilience.breaker import get_breaker
from mmlspark_tpu_torch.resilience.chaos import get_injector
from mmlspark_tpu_torch.resilience.retry import RetryPolicy

_CHUNK = 1 << 20  # 1 MiB read granularity


def http_get(url: str, headers: Optional[dict] = None,
             timeout: Optional[float] = None) -> bytes:
    """One chunked GET with a per-request timeout; no retries — policy
    belongs to the caller (`fetch_url`).  Chaos faults inject here, below
    the policy layer, so retries/breakers see them exactly like real ones."""
    get_injector().on_request(url)
    req = urllib.request.Request(url, headers=headers or {})
    buf = io.BytesIO()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        while True:
            chunk = r.read(_CHUNK)
            if not chunk:
                break
            buf.write(chunk)
    return buf.getvalue()


def fetch_url(url: str, headers: Optional[dict] = None,
              timeout: Optional[float] = None,
              policy: Optional[RetryPolicy] = None,
              breaker_key: Optional[str] = None) -> bytes:
    """`http_get` under a retry policy and the host's circuit breaker.

    `breaker_key` defaults to the URL's netloc, so every caller hitting
    the same host shares one breaker regardless of which layer it sits in.
    """
    policy = policy or RetryPolicy.from_config(name="remote.fetch")
    breaker = get_breaker(breaker_key
                          or urllib.parse.urlparse(url).netloc or url)

    def attempt(timeout: Optional[float] = timeout) -> bytes:
        # the policy passes timeout= only when attempt_deadline_s is set;
        # otherwise the caller's per-request timeout stands
        return http_get(url, headers=headers, timeout=timeout)

    return policy.call(attempt, breaker=breaker)
