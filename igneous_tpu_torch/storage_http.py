"""The HTTP exchange under the gs:// and s3:// clients.

The port's own copy of ``igneous_tpu/storage_http.py``: urllib only, with
the retry schedule of ``retry.RetryPolicy`` on connection errors and on
``RETRYABLE_STATUS`` (408, 429 and 5xx); every retry ticks
``retries.storage_http``.
"""

from __future__ import annotations

import dataclasses
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, Optional, Tuple

from .retry import RETRYABLE_STATUS, RetryPolicy, default_policy


class HttpError(Exception):
  def __init__(self, status: int, url: str, body: bytes = b""):
    self.status = status
    self.url = url
    self.body = body
    super().__init__(f"HTTP {status} for {url}: {body[:200]!r}")


def request(
  method: str,
  url: str,
  headers: Optional[Dict[str, str]] = None,
  data: Optional[bytes] = None,
  timeout: float = 60.0,
  retries: Optional[int] = None,
  allow_status: Tuple[int, ...] = (),
  policy: Optional[RetryPolicy] = None,
) -> Tuple[int, Dict[str, str], bytes]:
  """One HTTP exchange with retries: (status, headers, body).

  404 and 416 return (callers map them to None or empty), as does any
  status in ``allow_status`` (the GCS resumable PUT's 308); any other
  status that is not retryable raises ``HttpError``; retryable statuses
  and connection errors retry on ``policy`` (default: ``default_policy()``),
  then raise. ``retries`` overrides the policy's attempt count."""
  pol = policy or default_policy()
  if retries is not None and retries != pol.attempts:
    pol = dataclasses.replace(pol, attempts=retries)
  retry_iter = pol.retries("storage_http")
  last_exc: Optional[Exception] = None
  while True:
    req = urllib.request.Request(
      url, data=data, method=method, headers=dict(headers or {})
    )
    try:
      with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
      body = e.read()
      if e.code in (404, 416) or e.code in allow_status:
        return e.code, dict(e.headers or {}), body
      if e.code not in RETRYABLE_STATUS:
        raise HttpError(e.code, url, body) from None
      last_exc = HttpError(e.code, url, body)
    except (urllib.error.URLError, ConnectionError, TimeoutError) as e:
      last_exc = e
    if next(retry_iter, None) is None:  # attempts or sleep budget spent
      raise last_exc


def quote_path(segment: str) -> str:
  return urllib.parse.quote(segment, safe="")
