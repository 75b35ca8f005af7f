"""gs:// over the GCS JSON API, on urllib.

The port's own copy of ``igneous_tpu/storage_gcs.py``: media downloads
(``alt=media``, Range for partial reads), simple media uploads, resumable
sessions at or above ``IGNEOUS_GCS_RESUMABLE_THRESHOLD`` bytes (8 MiB) in
``IGNEOUS_GCS_UPLOAD_CHUNK`` pieces (8 MiB), paginated listing, delete and
stat, every request through ``storage_http.request`` and its retries.

Endpoint: ``GCS_ENDPOINT_URL`` or ``STORAGE_EMULATOR_HOST``, else Google's.
Auth: a CloudVolume-style ``google-secret.json`` (in
``$GOOGLE_APPLICATION_CREDENTIALS`` or ``secrets.secrets_dir()``) holding a
static ``{"token": ...}`` or a service-account key, whose RS256 JWT needs
the ``cryptography`` package (imported only there); else anonymous.
"""

from __future__ import annotations

import base64
import json
import os
import time
from typing import Iterator, Optional

from . import secrets
from .analysis import knobs
from .retry import default_policy
from .storage_http import HttpError, quote_path, request

_SCOPE = "https://www.googleapis.com/auth/devstorage.read_write"


def _resumable_threshold() -> int:
  return knobs.get_int("IGNEOUS_GCS_RESUMABLE_THRESHOLD")


def _upload_chunk() -> int:
  return knobs.get_int("IGNEOUS_GCS_UPLOAD_CHUNK")


def _b64url(data: bytes) -> bytes:
  return base64.urlsafe_b64encode(data).rstrip(b"=")


# process-wide token cache keyed by service account: every CloudFiles
# builds a backend, and each would otherwise run the OAuth exchange
_TOKEN_CACHE: dict = {}


class _GoogleAuth:
  """Bearer-token provider from CloudVolume-style secret files."""

  def __init__(self):
    self._secret = self._load_secret()

  @staticmethod
  def _load_secret() -> Optional[dict]:
    paths = [
      os.environ.get("GOOGLE_APPLICATION_CREDENTIALS", ""),
      os.path.join(secrets.secrets_dir(), "google-secret.json"),
    ]
    for p in paths:
      if p and os.path.exists(p):
        with open(p) as f:
          return json.load(f)
    return None

  def header(self) -> dict:
    tok = self.token()
    return {"Authorization": f"Bearer {tok}"} if tok else {}

  def token(self) -> Optional[str]:
    if self._secret is None:
      return None
    if "token" in self._secret:  # static token (emulators, proxies)
      return self._secret["token"]
    if self._secret.get("type") == "service_account":
      key = self._secret.get("client_email", "")
      tok, expiry = _TOKEN_CACHE.get(key, (None, 0.0))
      if tok is None or time.time() > expiry - 60:
        tok, expiry = self._exchange_jwt()
        _TOKEN_CACHE[key] = (tok, expiry)
      return tok
    return None

  def _exchange_jwt(self):
    """RS256-signed JWT -> bearer token at the key's token_uri."""
    try:
      from cryptography.hazmat.primitives import hashes, serialization
      from cryptography.hazmat.primitives.asymmetric import padding
    except ImportError as e:
      raise ImportError(
        "gs:// service-account auth signs an RS256 JWT and needs the "
        "'cryptography' package: pip install igneous-tpu[gcs] "
        "(static {'token': ...} secrets and anonymous access work "
        "without it)"
      ) from e

    now = int(time.time())
    header = _b64url(json.dumps({"alg": "RS256", "typ": "JWT"}).encode())
    claims = _b64url(json.dumps({
      "iss": self._secret["client_email"],
      "scope": _SCOPE,
      "aud": self._secret["token_uri"],
      "iat": now,
      "exp": now + 3600,
    }).encode())
    signing_input = header + b"." + claims
    key = serialization.load_pem_private_key(
      self._secret["private_key"].encode(), password=None
    )
    sig = key.sign(signing_input, padding.PKCS1v15(), hashes.SHA256())
    assertion = (signing_input + b"." + _b64url(sig)).decode()
    body = (
      "grant_type=urn%3Aietf%3Aparams%3Aoauth%3Agrant-type%3Ajwt-bearer"
      f"&assertion={assertion}"
    ).encode()
    status, _hdrs, resp = request(
      "POST", self._secret["token_uri"], data=body,
      headers={"Content-Type": "application/x-www-form-urlencoded"},
    )
    if status != 200:
      raise HttpError(status, self._secret["token_uri"], resp)
    payload = json.loads(resp)
    return payload["access_token"], time.time() + float(
      payload.get("expires_in", 3600)
    )


class GCSBackend:
  """gs://bucket/prefix (the storage backend interface: put, get,
  get_range, exists, delete, size, list)."""

  def __init__(self, path: str):
    bucket, _, prefix = path.partition("/")
    self.bucket = bucket
    self.prefix = prefix.strip("/")
    self.endpoint = (
      os.environ.get("GCS_ENDPOINT_URL")
      or os.environ.get("STORAGE_EMULATOR_HOST")
      or "https://storage.googleapis.com"
    ).rstrip("/")
    if "://" not in self.endpoint:
      self.endpoint = "http://" + self.endpoint
    self.auth = _GoogleAuth()
    self.retry = default_policy()

  def _req(self, method, url, **kw):
    return request(method, url, policy=self.retry, **kw)

  def _name(self, key: str) -> str:
    return f"{self.prefix}/{key}" if self.prefix else key

  def _obj_url(self, key: str, media: bool = False) -> str:
    url = (
      f"{self.endpoint}/storage/v1/b/{quote_path(self.bucket)}/o/"
      f"{quote_path(self._name(key))}"
    )
    return url + "?alt=media" if media else url

  def put(self, key: str, data: bytes):
    if len(data) >= _resumable_threshold():
      return self._put_resumable(key, data)
    url = (
      f"{self.endpoint}/upload/storage/v1/b/{quote_path(self.bucket)}/o"
      f"?uploadType=media&name={quote_path(self._name(key))}"
    )
    status, _h, body = self._req(
      "POST", url, data=data,
      headers={"Content-Type": "application/octet-stream", **self.auth.header()},
    )
    if status != 200:
      raise HttpError(status, url, body)

  def _put_resumable(self, key: str, data: bytes):
    """Resumable session: POST to open, PUT chunks with Content-Range."""
    url = (
      f"{self.endpoint}/upload/storage/v1/b/{quote_path(self.bucket)}/o"
      f"?uploadType=resumable&name={quote_path(self._name(key))}"
    )
    status, hdrs, body = self._req(
      "POST", url, data=b"",
      headers={"X-Upload-Content-Length": str(len(data)), **self.auth.header()},
    )
    if status != 200:
      raise HttpError(status, url, body)
    session = hdrs.get("Location") or hdrs.get("location")
    if not session:
      raise HttpError(status, url, b"resumable session missing Location")
    total = len(data)
    step = _upload_chunk()
    for start in range(0, total, step):
      chunk = data[start : start + step]
      end = start + len(chunk) - 1
      status, _h, body = self._req(
        "PUT", session, data=chunk,
        headers={"Content-Range": f"bytes {start}-{end}/{total}",
                 **self.auth.header()},
        allow_status=(308,),
      )
      # 308: chunk accepted, the session goes on; 200/201: the last chunk
      if status not in (200, 201, 308):
        raise HttpError(status, session, body)

  def get(self, key: str) -> Optional[bytes]:
    status, _h, body = self._req(
      "GET", self._obj_url(key, media=True), headers=self.auth.header()
    )
    return None if status == 404 else body

  def get_range(self, key: str, start: int, length: int) -> Optional[bytes]:
    status, _h, body = self._req(
      "GET", self._obj_url(key, media=True),
      headers={"Range": f"bytes={start}-{start + length - 1}", **self.auth.header()},
    )
    if status == 404:
      return None
    if status == 416:  # start past the end: the file backend's empty read
      return b""
    return body

  def exists(self, key: str) -> bool:
    status, _h, _b = self._req("GET", self._obj_url(key), headers=self.auth.header())
    return status == 200

  def delete(self, key: str):
    self._req("DELETE", self._obj_url(key), headers=self.auth.header())

  def size(self, key: str) -> Optional[int]:
    status, _h, body = self._req("GET", self._obj_url(key), headers=self.auth.header())
    if status != 200:
      return None
    return int(json.loads(body)["size"])

  def list(self, prefix: str = "") -> Iterator[str]:
    token = None
    full_prefix = self._name(prefix)
    strip = len(self.prefix) + 1 if self.prefix else 0
    while True:
      url = (
        f"{self.endpoint}/storage/v1/b/{quote_path(self.bucket)}/o"
        f"?prefix={quote_path(full_prefix)}"
      )
      if token:
        url += f"&pageToken={quote_path(token)}"
      status, _h, body = self._req("GET", url, headers=self.auth.header())
      if status != 200:
        raise HttpError(status, url, body)
      payload = json.loads(body)
      for item in payload.get("items", []):
        yield item["name"][strip:]
      token = payload.get("nextPageToken")
      if not token:
        return
