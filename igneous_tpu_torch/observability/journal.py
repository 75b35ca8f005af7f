"""Durable fleet event journal: JSONL segments on the storage layer.

Workers append batches of span records + a cumulative metrics snapshot
as immutable segment objects under ``<queue>/journal/`` (any CloudFiles
path — a shared filesystem next to an fq:// queue, or a bucket prefix
for SQS fleets via ``IGNEOUS_JOURNAL``). Segments are write-once and
worker-unique, so no coordination is needed; ``igneous fleet`` merges
them after the fact.

Flush triggers: a time interval (``IGNEOUS_JOURNAL_FLUSH_SEC``, default
30), lease-round boundaries, a lifecycle drain request (StopFlag.set
marks the journal dirty; the poll loop's next ``maybe_flush`` writes),
and process exit (the CLI worker arms an atexit last-will so even a
crashing worker leaves its final batch behind).

Record kinds (one JSON object per line):

  {"kind": "span", "worker": ..., "trace": ..., "span": ..., "parent":
   ..., "name": ..., "ts": ..., "dur": ..., ...attrs}
  {"kind": "counters", "worker": ..., "ts": ..., "event": ...,
   "counters": {...}, "timers": {...}, "gauges": {...}}

The port's own copy of ``igneous_tpu/observability/journal.py``: the same
segment names, record kinds and encoding, so either package's ``fleet``
commands read the other's segments.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Iterable, Iterator, List, Optional

from . import metrics, trace

from .. import secrets as knobs

FLUSH_SEC_ENV = "IGNEOUS_JOURNAL_FLUSH_SEC"
PATH_ENV = "IGNEOUS_JOURNAL"
COMPRESS_ENV = "IGNEOUS_JOURNAL_COMPRESS"
DEFAULT_FLUSH_SEC = 30.0

_GZIP_MAGIC = b"\x1f\x8b"


def compression_enabled() -> bool:
  return knobs.get_bool(COMPRESS_ENV)


def encode_segment(data: bytes) -> bytes:
  """Segment bytes as written: gzip when ``IGNEOUS_JOURNAL_COMPRESS=1``
  (mtime pinned to 0 so identical content is identical bytes),
  plain JSONL otherwise. Segment names stay ``*.jsonl`` either way; the
  read side sniffs the gzip magic, so mixed journals (campaign enabled
  compression midway) merge fine."""
  if not compression_enabled():
    return data
  import gzip
  import io

  buf = io.BytesIO()
  with gzip.GzipFile(fileobj=buf, mode="wb", mtime=0) as gz:
    gz.write(data)
  return buf.getvalue()


def decode_segment(data: bytes) -> bytes:
  """Inverse of :func:`encode_segment`, keyed on magic bytes rather than
  the env — readers never need to know how the writer was configured."""
  if data[:2] == _GZIP_MAGIC:
    import gzip

    try:
      return gzip.decompress(data)
    except OSError:
      return data
  return data

# extra-record providers: callables returning a list of record dicts to
# append to every flushed segment (the device plane's utilization ledger
# rides along this way — journal.py stays ignorant of who contributes)
_RECORD_PROVIDERS: list = []
# poll hooks: cheap callables invoked from maybe_flush_active (the
# between-tasks cadence every worker loop already has) — the profiler
# trigger poll lives here so solo AND batched workers both see it
_POLL_HOOKS: list = []


def register_record_provider(fn) -> None:
  if fn not in _RECORD_PROVIDERS:
    _RECORD_PROVIDERS.append(fn)


def register_poll_hook(fn) -> None:
  if fn not in _POLL_HOOKS:
    _POLL_HOOKS.append(fn)


def default_worker_id() -> str:
  host = socket.gethostname().split(".")[0] or "worker"
  return f"{host}-{os.getpid()}"


def journal_path_for(queue, spec: Optional[str] = None) -> Optional[str]:
  """Resolve where a worker's journal lives: ``IGNEOUS_JOURNAL`` wins;
  fq:// queues get a ``journal/`` sibling of queue/leased/dlq on the same
  filesystem; other backends (SQS has no storage) need the env."""
  env = knobs.get_str(PATH_ENV)
  if env:
    return env
  path = getattr(queue, "path", None)  # FileQueue
  if path:
    return f"file://{path}/journal"
  if spec:
    if spec.startswith("fq://"):
      return f"file://{os.path.abspath(os.path.expanduser(spec[5:]))}/journal"
    if "://" not in spec:
      return f"file://{os.path.abspath(os.path.expanduser(spec))}/journal"
  return None


class Journal:
  """Append-only segment writer for one worker process."""

  def __init__(self, cloudpath: str, worker_id: Optional[str] = None,
               flush_interval: Optional[float] = None):
    self.cloudpath = cloudpath
    self.worker_id = worker_id or default_worker_id()
    if flush_interval is None:
      flush_interval = knobs.get_float(FLUSH_SEC_ENV)
    self.flush_interval = float(flush_interval)
    self._lock = threading.Lock()
    self._seq = 0  # guarded-by: self._lock
    self._last_flush = time.monotonic()  # guarded-by: self._lock
    self._dirty = threading.Event()  # drain requested: flush ASAP
    self.segments_written = 0  # guarded-by: self._lock
    # register the self-health keys so the Prometheus exposition carries
    # igneous_journal_segments_total/..._flush_failed_total from the
    # moment a journal exists — a writer that NEVER lands a segment is
    # exactly the dead-journal case the fleet health plane must see
    metrics.incr("journal.segments", 0)
    metrics.incr("journal.flush_failed", 0)

  def last_flush_age(self) -> float:
    """Seconds since the last flush attempt (Prometheus self-health:
    ``igneous_journal_last_flush_age_seconds``)."""
    return time.monotonic() - self._last_flush

  # -- write side -----------------------------------------------------------

  def mark_dirty(self) -> None:
    """Request an out-of-band flush (lifecycle drain, round boundary);
    safe to call from signal handlers — it only sets an event."""
    self._dirty.set()

  def maybe_flush(self, event: Optional[str] = None) -> bool:
    """Flush if the interval elapsed or a flush was requested. Cheap when
    neither holds (one monotonic read). Called from poll loops between
    tasks."""
    if not self._dirty.is_set():
      if time.monotonic() - self._last_flush < self.flush_interval:
        return False
    return self.flush(event=event)

  def flush(self, event: Optional[str] = None) -> bool:
    """Write one segment with all pending spans + a metrics snapshot.
    Skips the write when there is nothing new and no ``event`` to record.
    Returns True when a segment landed."""
    extra_records = []
    for provider in list(_RECORD_PROVIDERS):
      try:
        extra_records.extend(provider() or ())
      except Exception:
        metrics.incr("journal.provider_failed")
    with self._lock:
      self._dirty.clear()
      spans = trace.drain_spans()
      self._last_flush = time.monotonic()
      if not spans and not extra_records and event is None:
        return False
      lines = []
      snap = {
        "kind": "counters", "worker": self.worker_id, "ts": time.time(),
        "event": event or "interval",
        "counters": metrics.counters_snapshot(),
        "timers": metrics.timer_totals(),
        "gauges": metrics.gauges_snapshot(),
      }
      dropped = trace.dropped_spans()
      if dropped:
        snap["spans_dropped"] = dropped
      lines.append(json.dumps(snap))
      for rec in spans:
        rec = dict(rec)
        rec["kind"] = "span"
        rec["worker"] = self.worker_id
        lines.append(json.dumps(rec))
      for rec in extra_records:
        rec = dict(rec)
        rec.setdefault("kind", "span")
        rec["worker"] = self.worker_id
        lines.append(json.dumps(rec))
      name = f"{self.worker_id}-{self._seq:06d}.jsonl"
      self._seq += 1
      data = encode_segment(("\n".join(lines) + "\n").encode("utf8"))
    try:
      from ..storage import CloudFiles

      CloudFiles(self.cloudpath).put(name, data, compress=None)
    except Exception:
      # observability must never kill a healthy worker; the batch is
      # gone but the next flush carries the cumulative counters anyway
      metrics.incr("journal.flush_failed")
      return False
    with self._lock:
      self.segments_written += 1
    metrics.incr("journal.segments")
    # rollup maintenance rides the flush cadence: every N segments the
    # worker folds its OWN raw segments (worker-unique names, so no
    # coordination) into <journal>/rollup/ — `fleet status` stays
    # O(windows) even on long campaigns
    from . import rollup

    rollup.maybe_self_compact(self)
    return True

  def write_records(self, records: Iterable[dict],
                    event: Optional[str] = None) -> Optional[str]:
    """Write one segment holding ``records`` verbatim (plus worker/kind
    defaults) — the health engine's emission path for ``health.*``
    events. Returns the segment name, or None when the put failed."""
    with self._lock:
      lines = []
      for rec in records:
        rec = dict(rec)
        rec.setdefault("kind", "span")
        rec.setdefault("worker", self.worker_id)
        if event is not None:
          rec.setdefault("event", event)
        lines.append(json.dumps(rec))
      if not lines:
        return None
      name = f"{self.worker_id}-{self._seq:06d}.jsonl"
      self._seq += 1
      data = encode_segment(("\n".join(lines) + "\n").encode("utf8"))
    try:
      from ..storage import CloudFiles

      CloudFiles(self.cloudpath).put(name, data, compress=None)
    except Exception:
      metrics.incr("journal.flush_failed")
      return None
    with self._lock:
      self.segments_written += 1
    metrics.incr("journal.segments")
    return name


# -- process-wide active journal ---------------------------------------------

_ACTIVE: Optional[Journal] = None
_LAST_WILL = {"armed": False, "fired": False}


def set_active(journal: Optional[Journal]) -> None:
  global _ACTIVE
  _ACTIVE = journal


def get_active() -> Optional[Journal]:
  return _ACTIVE


def maybe_flush_active(event: Optional[str] = None) -> None:
  j = _ACTIVE
  if j is not None:
    for hook in list(_POLL_HOOKS):
      try:
        hook(j)
      except Exception:
        metrics.incr("journal.poll_hook_failed")
    j.maybe_flush(event=event)


def flush_active(event: Optional[str] = None) -> None:
  j = _ACTIVE
  if j is not None:
    j.flush(event=event)


def request_flush() -> None:
  """Signal-handler-safe: mark the active journal dirty so the next
  ``maybe_flush`` (poll loop, round boundary) writes the pending batch."""
  j = _ACTIVE
  if j is not None:
    j.mark_dirty()


def install_last_will(extra: Optional[dict] = None) -> None:
  """Arm an atexit hook: whatever kills this worker (unhandled exception,
  sys.exit, normal return), the final counters line + journal batch land.
  Re-arms the fire guard each call — a process hosting several worker
  runs (tests, notebooks) gets one last will per run, not per process —
  while the atexit registration itself stays singular."""
  _LAST_WILL["fired"] = False
  if _LAST_WILL["armed"]:
    return
  _LAST_WILL["armed"] = True
  import atexit

  atexit.register(fire_last_will, "atexit", extra or {})


def fire_last_will(event: str = "exit", extra: Optional[dict] = None) -> None:
  if _LAST_WILL["fired"]:
    return
  _LAST_WILL["fired"] = True
  try:
    metrics.emit_counters(event=event, **(extra or {}))
  finally:
    flush_active(event=event)


def disarm_last_will(flush: bool = True) -> None:
  """Clean-exit path: the journal's final segment still lands, but no
  counters line prints (healthy workers keep their historical stdout)."""
  _LAST_WILL["fired"] = True
  if flush:
    flush_active(event="exit")


# -- read side ----------------------------------------------------------------


def is_raw_segment(key: str) -> bool:
  """Top-level ``*.jsonl`` objects are raw worker segments; everything
  in a subdirectory (``rollup/`` compactions, ``health/`` flag files)
  belongs to other subsystems and must not merge as span records."""
  return "/" not in key and key.endswith(".jsonl")


def list_segments(cloudpath: str) -> List[str]:
  """Sorted raw segment names under a journal path."""
  from ..storage import CloudFiles

  try:
    return sorted(k for k in CloudFiles(cloudpath).list() if is_raw_segment(k))
  except Exception:
    return []


def read_records(cloudpath: str,
                 keys: Optional[Iterable[str]] = None) -> Iterator[dict]:
  """Iterate every record of every raw segment under a journal path
  (order: segment name, then line order — i.e. per-worker
  chronological). ``keys`` restricts to specific segments (the rollup
  merge path reads only uncovered ones)."""
  from ..storage import CloudFiles

  cf = CloudFiles(cloudpath)
  if keys is None:
    keys = list_segments(cloudpath)
  for key in keys:
    data = cf.get(key)
    if data is None:
      continue
    data = decode_segment(data)
    for line in data.decode("utf8", errors="replace").splitlines():
      line = line.strip()
      if not line:
        continue
      try:
        rec = json.loads(line)
      except ValueError:
        continue
      rec.setdefault("segment", key)
      yield rec


def segment_count(cloudpath: str) -> int:
  return len(list_segments(cloudpath))
