"""s3:// over the S3 REST API, on urllib, with SigV4 signing.

The port's own copy of ``igneous_tpu/storage_s3.py``: GET (with Range),
PUT, multipart uploads at or above ``IGNEOUS_S3_MULTIPART_THRESHOLD`` bytes
(64 MiB) in ``IGNEOUS_S3_MULTIPART_CHUNK`` parts (32 MiB), HEAD, DELETE and
ListObjectsV2 with continuation tokens, path-style, every request through
``storage_http.request`` and its retries.

Credentials: ``AWS_ACCESS_KEY_ID``/``AWS_SECRET_ACCESS_KEY``, else a
CloudVolume-style ``aws-secret.json`` in ``secrets.secrets_dir()``; without
them requests go unsigned. Endpoint: ``S3_ENDPOINT_URL`` or
``AWS_ENDPOINT_URL``, else the regional AWS URL (``AWS_DEFAULT_REGION``,
us-east-1).
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import json
import os
import re
import urllib.parse
from typing import Iterator, List, Optional, Tuple
from xml.sax.saxutils import unescape as xml_unescape

from . import secrets
from .analysis import knobs
from .retry import default_policy
from .storage_http import HttpError, request


def _multipart_threshold() -> int:
  return knobs.get_int("IGNEOUS_S3_MULTIPART_THRESHOLD")


def _multipart_chunk() -> int:
  return knobs.get_int("IGNEOUS_S3_MULTIPART_CHUNK")


def _load_creds() -> Tuple[Optional[str], Optional[str]]:
  akey = os.environ.get("AWS_ACCESS_KEY_ID")
  skey = os.environ.get("AWS_SECRET_ACCESS_KEY")
  if akey and skey:
    return akey, skey
  path = os.path.join(secrets.secrets_dir(), "aws-secret.json")
  if os.path.exists(path):
    with open(path) as f:
      blob = json.load(f)
    return (
      blob.get("AWS_ACCESS_KEY_ID") or blob.get("access_key_id"),
      blob.get("AWS_SECRET_ACCESS_KEY") or blob.get("secret_access_key"),
    )
  return None, None


class SigV4:
  """AWS Signature Version 4 over hmac and hashlib."""

  def __init__(self, access_key: str, secret_key: str, region: str,
               service: str = "s3"):
    self.access_key = access_key
    self.secret_key = secret_key
    self.region = region
    self.service = service

  def _signature(self, method: str, path: str, query: str, signed: dict,
                 payload_hash: str, amz_date: str, datestamp: str) -> Tuple[str, str]:
    """The signature over an exact header set, shared by ``sign`` and
    ``verify`` so a server recomputes it from what it received."""
    canonical_query = "&".join(
      sorted(
        f"{urllib.parse.quote(k, safe='')}={urllib.parse.quote(v, safe='')}"
        for k, v in urllib.parse.parse_qsl(query, keep_blank_values=True)
      )
    )
    signed_names = sorted(h.lower() for h in signed)
    canonical_headers = "".join(
      f"{name}:{str(signed[next(h for h in signed if h.lower() == name)]).strip()}\n"
      for name in signed_names
    )
    signed_headers = ";".join(signed_names)
    # the canonical URI is the path as sent (already quoted once by _url)
    canonical_request = "\n".join([
      method, path or "/", canonical_query,
      canonical_headers, signed_headers, payload_hash,
    ])
    scope = f"{datestamp}/{self.region}/{self.service}/aws4_request"
    string_to_sign = "\n".join([
      "AWS4-HMAC-SHA256", amz_date, scope,
      hashlib.sha256(canonical_request.encode()).hexdigest(),
    ])

    def _hmac(key: bytes, msg: str) -> bytes:
      return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k = _hmac(f"AWS4{self.secret_key}".encode(), datestamp)
    k = _hmac(k, self.region)
    k = _hmac(k, self.service)
    k = _hmac(k, "aws4_request")
    signature = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()
    return signature, signed_headers

  def sign(self, method: str, url: str, headers: dict, payload: bytes) -> dict:
    parsed = urllib.parse.urlsplit(url)
    now = datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    payload_hash = hashlib.sha256(payload or b"").hexdigest()

    headers = dict(headers)
    headers["Host"] = parsed.netloc
    headers["x-amz-date"] = amz_date
    headers["x-amz-content-sha256"] = payload_hash
    signature, signed_headers = self._signature(
      method, parsed.path, parsed.query, headers, payload_hash, amz_date, datestamp,
    )
    scope = f"{datestamp}/{self.region}/{self.service}/aws4_request"
    headers["Authorization"] = (
      f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
      f"SignedHeaders={signed_headers}, Signature={signature}"
    )
    del headers["Host"]  # urllib sets it
    return headers

  def verify(self, method: str, path: str, query: str, wire_headers,
             payload: bytes) -> bool:
    """The server's check: recompute the signature from the request as
    received."""
    auth = wire_headers.get("Authorization", "")
    m = re.match(
      r"AWS4-HMAC-SHA256 Credential=([^/]+)/(\d{8})/([^/]+)/([^/]+)/"
      r"aws4_request, SignedHeaders=([a-z0-9;-]+), Signature=([0-9a-f]{64})",
      auth,
    )
    if not m:
      return False
    _access, datestamp, _region, _svc, signed_names, signature = m.groups()
    signed = {}
    for name in signed_names.split(";"):
      val = wire_headers.get(name)
      if val is None:
        return False
      signed[name] = val
    payload_hash = hashlib.sha256(payload or b"").hexdigest()
    if signed.get("x-amz-content-sha256") not in (payload_hash, None):
      return False
    expect, _ = self._signature(
      method, path, query, signed, payload_hash,
      signed.get("x-amz-date", ""), datestamp,
    )
    return hmac.compare_digest(expect, signature)


class S3Backend:
  """s3://bucket/prefix, path-style (the storage backend interface: put,
  get, get_range, exists, delete, size, list)."""

  def __init__(self, path: str):
    bucket, _, prefix = path.partition("/")
    self.bucket = bucket
    self.prefix = prefix.strip("/")
    self.region = os.environ.get("AWS_DEFAULT_REGION", "us-east-1")
    self.endpoint = (
      os.environ.get("S3_ENDPOINT_URL")
      or os.environ.get("AWS_ENDPOINT_URL")
      or f"https://s3.{self.region}.amazonaws.com"
    ).rstrip("/")
    if "://" not in self.endpoint:
      self.endpoint = "http://" + self.endpoint
    akey, skey = _load_creds()
    self.signer = SigV4(akey, skey, self.region) if akey and skey else None
    self.retry = default_policy()

  def _name(self, key: str) -> str:
    return f"{self.prefix}/{key}" if self.prefix else key

  def _url(self, key: str, query: str = "") -> str:
    path = urllib.parse.quote(f"/{self.bucket}/{self._name(key)}")
    return f"{self.endpoint}{path}" + (f"?{query}" if query else "")

  def _request(self, method, url, headers=None, data=None):
    headers = dict(headers or {})
    if self.signer is not None:
      headers = self.signer.sign(method, url, headers, data or b"")
    return request(method, url, headers=headers, data=data, policy=self.retry)

  def put(self, key: str, data: bytes):
    if len(data) >= _multipart_threshold():
      return self._put_multipart(key, data)
    status, _h, body = self._request("PUT", self._url(key), data=data)
    if status != 200:
      raise HttpError(status, self._url(key), body)

  def _put_multipart(self, key: str, data: bytes):
    url = self._url(key, "uploads")
    status, _h, body = self._request("POST", url, data=b"")
    if status != 200:
      raise HttpError(status, url, body)
    m = re.search(rb"<UploadId>([^<]+)</UploadId>", body)
    if not m:
      raise HttpError(status, url, b"no UploadId in response")
    upload_id = urllib.parse.quote(m.group(1).decode())
    etags: List[Tuple[int, str]] = []
    step = _multipart_chunk()
    for part, start in enumerate(range(0, len(data), step), start=1):
      purl = self._url(key, f"partNumber={part}&uploadId={upload_id}")
      status, hdrs, body = self._request("PUT", purl, data=data[start : start + step])
      if status != 200:
        # abort, so that the store reclaims the parts
        self._request("DELETE", self._url(key, f"uploadId={upload_id}"))
        raise HttpError(status, purl, body)
      etags.append((part, hdrs.get("ETag") or hdrs.get("etag") or ""))
    xml = (
      "<CompleteMultipartUpload>"
      + "".join(f"<Part><PartNumber>{n}</PartNumber><ETag>{etag}</ETag></Part>"
                for n, etag in etags)
      + "</CompleteMultipartUpload>"
    ).encode()
    curl = self._url(key, f"uploadId={upload_id}")
    status, _h, body = self._request("POST", curl, data=xml)
    # S3 may answer a failed assembly with 200 and an <Error> body
    if status != 200 or b"<Error>" in body:
      raise HttpError(status, curl, body)

  def get(self, key: str) -> Optional[bytes]:
    status, _h, body = self._request("GET", self._url(key))
    return None if status == 404 else body

  def get_range(self, key: str, start: int, length: int) -> Optional[bytes]:
    status, _h, body = self._request(
      "GET", self._url(key), headers={"Range": f"bytes={start}-{start + length - 1}"},
    )
    if status == 404:
      return None
    if status == 416:
      return b""
    return body

  def exists(self, key: str) -> bool:
    status, _h, _b = self._request("HEAD", self._url(key))
    return status == 200

  def delete(self, key: str):
    self._request("DELETE", self._url(key))

  def size(self, key: str) -> Optional[int]:
    status, hdrs, _b = self._request("HEAD", self._url(key))
    if status != 200:
      return None
    cl = hdrs.get("Content-Length") or hdrs.get("content-length")
    return int(cl) if cl is not None else None

  def list(self, prefix: str = "") -> Iterator[str]:
    token = None
    full_prefix = self._name(prefix)
    strip = len(self.prefix) + 1 if self.prefix else 0
    while True:
      # encoding-type=url: keys arrive percent-encoded, and unquote is the
      # exact inverse (a literal '%' in a key survives)
      query = ("encoding-type=url&list-type=2&prefix="
               + urllib.parse.quote(full_prefix, safe=""))
      if token:
        query += "&continuation-token=" + urllib.parse.quote(token, safe="")
      url = f"{self.endpoint}{urllib.parse.quote(f'/{self.bucket}')}?{query}"
      status, _h, body = self._request("GET", url)
      if status != 200:
        raise HttpError(status, url, body)
      for m in re.finditer(rb"<Key>([^<]*)</Key>", body):
        yield urllib.parse.unquote(xml_unescape(m.group(1).decode()))[strip:]
      trunc = re.search(rb"<IsTruncated>true</IsTruncated>", body)
      nxt = re.search(rb"<NextContinuationToken>([^<]+)</NextContinuationToken>", body)
      if not trunc or not nxt:
        return
      token = xml_unescape(nxt.group(1).decode())
