"""Journal rollup compaction: fold raw segments into windowed records.

The journal is write-optimized — every worker appends small JSONL
segments and ``igneous fleet`` re-reads ALL of them on every call. At
fleet scale that read is O(segments) and grows without bound. Rollups
make the read side O(windows): raw segments fold into a few compact
records under ``<journal>/rollup/`` and then become GC-able
(``igneous fleet gc``, ``IGNEOUS_JOURNAL_RETAIN``).

Rollup file layout (``rollup/<actor>-<millis>-<seq>.jsonl``), one JSON
object per line:

  {"kind": "rollup_manifest", "actor": ..., "ts": ...,
   "covers": {"<segment>": <last record ts>, ...}}
  {"kind": "rollup", "window": [start, end], "ts_min": ..., "ts_max": ...,
   "stages": {name: {"count": n, "sum": s, "durs": [...capped...]}},
   "workers": {worker_id: last_seen_ts},
   "tasks": [<verbatim task span records>]}
  {"kind": "counters", ...}   # latest cumulative snapshot per worker

Design invariants:

* **No coordination.** Workers self-compact only their OWN segments
  (segment names are worker-unique), so concurrent self-compaction never
  races. An admin ``igneous fleet compact`` may cover anything uncovered;
  the read side resolves double coverage deterministically — rollup files
  are visited in sorted order and a file whose ``covers`` intersect an
  already-accepted file is skipped whole — so a worker/admin race can
  never double-count a segment.
* **Exactness where it matters.** Task spans are kept VERBATIM (they are
  the minority of spans but carry trace ids, workers, errors — everything
  ``fleet top``/health detectors need); stage spans collapse to
  count/sum plus up to ``IGNEOUS_ROLLUP_MAX_SAMPLES`` duration samples
  per stage per window, so count/total stay exact and p50/p95 only
  become approximate past the cap. Counters snapshots are cumulative per
  worker, so re-emitting the latest one per worker loses nothing.
* **Mixable.** ``load_effective`` merges rollup records with raw records
  from segments no rollup covers, so readers see one consistent view
  mid-compaction.

The port's own copy of ``igneous_tpu/observability/rollup.py``: either
package compacts, reads and collects the other's journal.
"""

from __future__ import annotations

import json
import math
import os
import socket
import time
from typing import Dict, List, Optional, Tuple

from . import journal as journal_mod
from . import metrics

from ..analysis import knobs

ROLLUP_PREFIX = "rollup/"
WINDOW_SEC_ENV = "IGNEOUS_ROLLUP_WINDOW_SEC"
MAX_SAMPLES_ENV = "IGNEOUS_ROLLUP_MAX_SAMPLES"
EVERY_ENV = "IGNEOUS_ROLLUP_EVERY"
RETAIN_ENV = "IGNEOUS_JOURNAL_RETAIN"

DEFAULT_WINDOW_SEC = 60.0
DEFAULT_MAX_SAMPLES = 512
DEFAULT_EVERY = 16        # worker self-compaction: every N segments
DEFAULT_RETAIN_SEC = 3600.0

_SEQ = [0]  # per-process uniqueness suffix for rollup file names


def window_sec() -> float:
  return knobs.get_float(WINDOW_SEC_ENV)


def max_samples() -> int:
  return knobs.get_int(MAX_SAMPLES_ENV)


def self_compact_every() -> int:
  """Worker self-compaction cadence in segments (0 disables)."""
  return knobs.get_int(EVERY_ENV)


def retain_sec() -> float:
  return knobs.get_float(RETAIN_ENV)


def default_actor() -> str:
  host = socket.gethostname().split(".")[0] or "compactor"
  return f"compactor-{host}-{os.getpid()}"


# -- read side ----------------------------------------------------------------


def load_rollups(cloudpath: str) -> Tuple[List[dict], Dict[str, float]]:
  """(rollup records, covered segments) under a journal path.

  Files are visited in sorted key order; a file whose manifest claims a
  segment an earlier file already covers is skipped entirely, so double
  coverage (admin compact racing worker self-compaction) degrades to
  "one of them wins" instead of double counting."""
  from ..storage import CloudFiles

  cf = CloudFiles(cloudpath)
  try:
    keys = sorted(k for k in cf.list(ROLLUP_PREFIX))
  except Exception:
    return [], {}
  records: List[dict] = []
  covered: Dict[str, float] = {}
  for key in keys:
    data = cf.get(key)
    if data is None:
      continue
    data = journal_mod.decode_segment(data)
    recs = []
    for line in data.decode("utf8", errors="replace").splitlines():
      line = line.strip()
      if not line:
        continue
      try:
        recs.append(json.loads(line))
      except ValueError:
        continue
    manifest = next(
      (r for r in recs if r.get("kind") == "rollup_manifest"), None
    )
    if manifest is None:
      continue
    covers = manifest.get("covers") or {}
    if any(seg in covered for seg in covers):
      metrics.incr("rollup.overlap_skipped")
      continue
    for seg, last_ts in covers.items():
      covered[seg] = float(last_ts or 0.0)
    for rec in recs:
      if rec.get("kind") == "rollup_manifest":
        continue
      rec.setdefault("segment", key)
      records.append(rec)
  return records, covered


def load_effective(cloudpath: str) -> List[dict]:
  """Rollup records plus raw records from segments no rollup covers —
  the O(windows) read path for ``fleet status|top``, ``queue_eta`` and
  the health engine (``fleet trace`` still reads raw segments: per-span
  detail never makes it into a rollup)."""
  records, covered = load_rollups(cloudpath)
  raw_keys = [
    k for k in journal_mod.list_segments(cloudpath) if k not in covered
  ]
  records.extend(journal_mod.read_records(cloudpath, keys=raw_keys))
  return records


# -- compaction ---------------------------------------------------------------


def _fold_span(windows: dict, rec: dict, wsec: float, cap: int) -> None:
  ts, dur = rec.get("ts"), rec.get("dur")
  if ts is None or dur is None:
    return  # fleet.status skips these too: folding them would disagree
  ts, dur = float(ts), float(dur)
  wkey = int(math.floor(ts / wsec))
  w = windows.get(wkey)
  if w is None:
    w = windows[wkey] = {
      "window": [wkey * wsec, (wkey + 1) * wsec],
      "ts_min": ts, "ts_max": ts + dur,
      "stages": {}, "workers": {}, "tasks": [],
    }
  w["ts_min"] = min(w["ts_min"], ts)
  w["ts_max"] = max(w["ts_max"], ts + dur)
  worker = rec.get("worker")
  if worker:
    w["workers"][worker] = max(w["workers"].get(worker, 0.0), ts + dur)
  if rec.get("name") == "task":
    t = dict(rec)
    t.pop("segment", None)
    t.pop("kind", None)
    w["tasks"].append(t)
    return
  name = rec.get("name", "span")
  st = w["stages"].get(name)
  if st is None:
    st = w["stages"][name] = {"count": 0, "sum": 0.0, "durs": []}
  st["count"] += 1
  st["sum"] += dur
  if len(st["durs"]) < cap:
    st["durs"].append(dur)


def compact(
  cloudpath: str,
  actor: Optional[str] = None,
  only_worker: Optional[str] = None,
  window: Optional[float] = None,
  samples_cap: Optional[int] = None,
  min_segments: int = 1,
) -> dict:
  """Fold uncovered raw segments into one new rollup file.

  ``only_worker`` restricts to that worker's own segments (the
  coordination-free self-compaction path); the admin CLI compacts
  everything uncovered. Returns a summary dict; ``segments_compacted``
  is 0 when there was nothing (or too little) to do."""
  from ..storage import CloudFiles

  wsec = float(window) if window else window_sec()
  cap = int(samples_cap) if samples_cap else max_samples()
  actor = actor or default_actor()

  _, covered = load_rollups(cloudpath)
  segs = [k for k in journal_mod.list_segments(cloudpath) if k not in covered]
  if only_worker:
    segs = [k for k in segs if k.startswith(only_worker + "-")]
  if len(segs) < max(int(min_segments), 1):
    return {"segments_compacted": 0, "windows": 0, "rollup_key": None}

  windows: dict = {}
  latest_counters: Dict[str, dict] = {}
  latest_device: Dict[str, dict] = {}
  seg_last_ts: Dict[str, float] = {k: 0.0 for k in segs}
  for rec in journal_mod.read_records(cloudpath, keys=segs):
    seg = rec.get("segment")
    ts = rec.get("ts")
    if seg in seg_last_ts and ts is not None:
      seg_last_ts[seg] = max(seg_last_ts[seg], float(ts))
    kind = rec.get("kind")
    if kind == "counters":
      worker = rec.get("worker", "local")
      prev = latest_counters.get(worker)
      if prev is None or rec.get("ts", 0) >= prev.get("ts", 0):
        c = dict(rec)
        c.pop("segment", None)
        latest_counters[worker] = c
    elif kind == "device":
      # device utilization ledgers are CUMULATIVE per worker,
      # so — like counters — re-emitting only the latest loses nothing
      worker = rec.get("worker", "local")
      prev = latest_device.get(worker)
      if prev is None or rec.get("ts", 0) >= prev.get("ts", 0):
        d = dict(rec)
        d.pop("segment", None)
        latest_device[worker] = d
    elif kind == "span":
      _fold_span(windows, rec, wsec, cap)

  lines = [json.dumps({
    "kind": "rollup_manifest", "actor": actor, "ts": time.time(),
    "window_sec": wsec, "covers": seg_last_ts,
  })]
  for wkey in sorted(windows):
    w = windows[wkey]
    w["kind"] = "rollup"
    lines.append(json.dumps(w))
  for worker in sorted(latest_counters):
    lines.append(json.dumps(latest_counters[worker]))
  for worker in sorted(latest_device):
    lines.append(json.dumps(latest_device[worker]))

  _SEQ[0] += 1
  name = f"{ROLLUP_PREFIX}{actor}-{int(time.time() * 1000):013d}-{_SEQ[0]:04d}.jsonl"
  data = journal_mod.encode_segment(("\n".join(lines) + "\n").encode("utf8"))
  CloudFiles(cloudpath).put(name, data, compress=None)
  metrics.incr("rollup.compactions")
  metrics.incr("rollup.segments_folded", len(segs))
  return {
    "segments_compacted": len(segs),
    "windows": len(windows),
    "rollup_key": name,
  }


def maybe_self_compact(journal: "journal_mod.Journal") -> Optional[dict]:
  """Worker-side hook: every ``IGNEOUS_ROLLUP_EVERY`` segments, fold this
  worker's own raw segments. Never raises — compaction is maintenance,
  not correctness."""
  every = self_compact_every()
  if every <= 0 or journal.segments_written == 0:
    return None
  if journal.segments_written % every != 0:
    return None
  try:
    return compact(
      journal.cloudpath, actor=journal.worker_id,
      only_worker=journal.worker_id, min_segments=2,
    )
  except Exception:
    metrics.incr("rollup.self_compact_failed")
    return None


# -- garbage collection -------------------------------------------------------


def gc(cloudpath: str, retain: Optional[float] = None,
       now: Optional[float] = None) -> dict:
  """Delete raw segments that a rollup covers AND whose newest record is
  older than the retention window (``IGNEOUS_JOURNAL_RETAIN``, default
  1h). Uncovered segments are never touched — compaction first, GC
  second. ``fleet trace`` loses per-span detail for GC'd history; the
  retention window is exactly the operator's trace-debuggability horizon."""
  from ..storage import CloudFiles

  retain = retain_sec() if retain is None else float(retain)
  now = time.time() if now is None else now
  _, covered = load_rollups(cloudpath)
  cf = CloudFiles(cloudpath)
  deleted = 0
  kept = 0
  for seg in journal_mod.list_segments(cloudpath):
    last_ts = covered.get(seg)
    if last_ts is None:
      kept += 1
      continue
    if now - last_ts >= retain:
      cf.delete(seg)
      deleted += 1
    else:
      kept += 1
  if deleted:
    metrics.incr("rollup.segments_gced", deleted)
  return {"deleted": deleted, "kept": kept, "retain_sec": retain}
