"""The write envelope: digests of stored outputs, quarantine, verify-after-write.

The port's own copy of ``igneous_tpu/integrity.py``, with its formats, so
that each package audits the other's layers:

* Every task-output put records a blake2b-128 digest of the stored wire
  bytes (after compression) in manifest sidecars under
  ``<layer>/integrity/manifests/<top-level dir>/``. Records are buffered
  per layer (``IGNEOUS_INTEGRITY_BATCH``, 256) and flushed as write-once
  ``seg_w<pid>_<seq>.jsonl`` segments; a merge keeps the record with the
  latest ``ts``. ``IGNEOUS_INTEGRITY=off`` writes the bytes alone.
* A corrupt read files a record under ``integrity/quarantine/`` at once
  and ticks the ``integrity.*`` counters; quarantine never raises.
* ``IGNEOUS_INTEGRITY_VERIFY_AFTER_WRITE=1`` reads every put back and
  raises ``CorruptChunkError`` before the put returns when the digests
  differ.

Exempt: the ``integrity/`` sidecars themselves, ``info`` and
``provenance*`` (rewritten in place), and ``.json``/``.jsonl`` keys.
``tasks/audit.py`` checks a layer against these manifests.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from hashlib import blake2b
from typing import Dict, List, Optional

from . import telemetry
from .secrets import env_flag, env_number

INTEGRITY_PREFIX = "integrity"


def digest_hex(data) -> str:
  """blake2b-128 hex of the stored wire bytes (the chunk cache's digest
  family)."""
  return blake2b(bytes(data), digest_size=16).hexdigest()


class CorruptChunkError(Exception):
  """A stored object failed decode or digest verification. Not an
  ``IOError``: callers that tolerate missing chunks (fill_missing) must
  not tolerate corrupt ones."""

  def __init__(self, cloudpath: str, key: str, reason: str,
               expected: Optional[str] = None, actual: Optional[str] = None):
    self.cloudpath = cloudpath
    self.key = key
    self.reason = reason
    self.expected = expected
    self.actual = actual
    msg = f"corrupt object {key} in {cloudpath}: {reason}"
    if expected is not None:
      msg += f" (expected digest {expected}, got {actual})"
    super().__init__(msg)


def enabled() -> bool:
  return env_flag("IGNEOUS_INTEGRITY", True)


def exempt(key: str) -> bool:
  """True for keys the envelope does not cover (see the module docstring)."""
  if key.startswith(INTEGRITY_PREFIX + "/"):
    return True
  base = os.path.basename(key)
  if base in ("info", "provenance") or base.startswith("provenance"):
    return True
  return base.endswith(".json") or base.endswith(".jsonl")


class ManifestRecorder:
  """Buffers (stored key -> digest) records per layer and flushes them as
  write-once JSONL segments, one per top-level directory of the keys (the
  mip directory of an image layer). One per process; thread-safe."""

  def __init__(self):
    self._lock = threading.Lock()
    self._buf: Dict[str, List[dict]] = {}
    self._seq = 0

  def record(self, cloudpath: str, stored_key: str, payload: bytes) -> Optional[str]:
    """Buffer the record of a completed put: its digest, or None when the
    key is exempt or the envelope is off."""
    if not enabled() or exempt(stored_key):
      return None
    dig = digest_hex(payload)
    rec = {"key": stored_key, "digest": dig, "n": len(payload),
           "ts": round(time.time(), 6)}
    telemetry.incr("integrity.records", 1)
    flush_now = None
    cloudpath = cloudpath.rstrip("/")
    with self._lock:
      buf = self._buf.setdefault(cloudpath, [])
      buf.append(rec)
      if len(buf) >= max(1, env_number("IGNEOUS_INTEGRITY_BATCH", 256, int)):
        flush_now, self._buf[cloudpath] = buf, []
    if flush_now:
      self._write_segments(cloudpath, flush_now, swallow=False)
    return dig

  def flush(self, cloudpath: Optional[str] = None, swallow: bool = False):
    """Write the buffered records (of one layer, or all). ``swallow``: the
    exit backstop's mode, which drops a layer whose file:// root is gone
    and ignores write errors."""
    with self._lock:
      if cloudpath is not None:
        path = cloudpath.rstrip("/")
        items = [(path, self._buf.pop(path, []))]
      else:
        items = list(self._buf.items())
        self._buf = {}
    for path, records in items:
      if not records or (swallow and _file_root_gone(path)):
        continue
      self._write_segments(path, records, swallow=swallow)

  def _write_segments(self, cloudpath: str, records: List[dict], swallow: bool):
    from .storage import CloudFiles

    groups: Dict[str, List[dict]] = {}
    for rec in records:
      top = rec["key"].split("/", 1)[0] if "/" in rec["key"] else "_root"
      groups.setdefault(top, []).append(rec)
    try:
      cf = CloudFiles(cloudpath)
      for top, recs in groups.items():
        with self._lock:
          self._seq += 1
          seq = self._seq
        name = f"{INTEGRITY_PREFIX}/manifests/{top}/seg_w{os.getpid()}_{seq:06d}.jsonl"
        body = "".join(json.dumps(r, sort_keys=True) + "\n" for r in recs)
        cf.put(name, body.encode("utf8"), compress=None)
        telemetry.incr("integrity.manifest_segments", 1)
    except Exception:
      if not swallow:
        raise


def _file_root_gone(cloudpath: str) -> bool:
  from .storage import extract_path

  pth = extract_path(cloudpath)
  return pth.protocol == "file" and not os.path.isdir(pth.path)


_RECORDER = ManifestRecorder()


def record_put(cloudpath: str, stored_key: str, payload: bytes, backend=None):
  """The storage layer's hook after a successful write: record the
  manifest entry and, under ``IGNEOUS_INTEGRITY_VERIFY_AFTER_WRITE``, read
  the object back and raise unless its digest matches."""
  dig = _RECORDER.record(cloudpath, stored_key, payload)
  if dig is None or backend is None:
    return
  if not env_flag("IGNEOUS_INTEGRITY_VERIFY_AFTER_WRITE", False):
    return
  back = backend.get(stored_key)
  actual = digest_hex(back) if back is not None else None
  if actual != dig:
    telemetry.incr("integrity.verify_failed", 1)
    quarantine(cloudpath, stored_key, "verify-after-write mismatch")
    raise CorruptChunkError(
      cloudpath, stored_key, "verify-after-write mismatch", expected=dig, actual=actual,
    )


def flush_all(swallow: bool = False):
  """Write every buffered manifest record (a worker on exit, an audit
  before it reads)."""
  _RECORDER.flush(swallow=swallow)


def flush(cloudpath: str):
  _RECORDER.flush(cloudpath)


atexit.register(flush_all, True)


def load_manifest(cloudpath: str, prefix: Optional[str] = None) -> Dict[str, dict]:
  """{stored key -> record} merged from the manifest segments (of one
  top-level directory with ``prefix``), the latest ``ts`` winning."""
  from .storage import CloudFiles

  cf = CloudFiles(cloudpath)
  base = f"{INTEGRITY_PREFIX}/manifests/"
  if prefix:
    base += prefix.strip("/") + "/"
  out: Dict[str, dict] = {}
  for seg in sorted(cf.list(base)):
    if not seg.endswith(".jsonl"):
      continue
    raw = cf.get(seg)
    if raw is None:
      continue
    for line in raw.splitlines():
      if not line.strip():
        continue
      rec = json.loads(line)
      prev = out.get(rec["key"])
      if prev is None or rec["ts"] >= prev["ts"]:
        out[rec["key"]] = rec
  return out


_QUARANTINE_LOCK = threading.Lock()
_QUARANTINE_SEQ = 0


def quarantine(cloudpath: str, key: str, reason: str):
  """File a corrupt object's key under ``integrity/quarantine/``, one
  record a file, written at once; never raises."""
  global _QUARANTINE_SEQ
  if not enabled():
    return
  from .storage import CloudFiles

  telemetry.incr("integrity.quarantined", 1)
  with _QUARANTINE_LOCK:
    _QUARANTINE_SEQ += 1
    seq = _QUARANTINE_SEQ
  rec = {"key": key, "reason": reason, "ts": round(time.time(), 6)}
  try:
    CloudFiles(cloudpath).put(
      f"{INTEGRITY_PREFIX}/quarantine/q_w{os.getpid()}_{seq:06d}.jsonl",
      (json.dumps(rec, sort_keys=True) + "\n").encode("utf8"),
      compress=None,
    )
  except Exception:
    pass


def load_quarantine(cloudpath: str) -> List[dict]:
  from .storage import CloudFiles

  cf = CloudFiles(cloudpath)
  out = []
  for seg in sorted(cf.list(f"{INTEGRITY_PREFIX}/quarantine/")):
    raw = cf.get(seg)
    if raw is None:
      continue
    out.extend(json.loads(line) for line in raw.splitlines() if line.strip())
  return out
