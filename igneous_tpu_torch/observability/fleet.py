"""Fleet-level aggregation over merged journal segments.

The read half of the journal: ``igneous fleet status|trace|top`` load
every worker's segments from the bucket and answer the questions tqdm
bars cannot — where does fleet wall-clock go per stage (p50/p95), how
much of it is stall vs work, which tasks are slowest, how many zombie
fences / DLQ promotions fired, and what is one task's full lineage.

The port's own copy of ``igneous_tpu/observability/fleet.py``.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Iterable, Iterator, List, Optional

from . import journal as journal_mod

# stage timer names whose spans measure waiting, not work: the stall
# ratio `igneous fleet status` reports is stall_time / (stall + work)
STALL_MARKERS = ("stall_s", "queue.wait")


def load(journal_path: str) -> List[dict]:
  """Every RAW record (all segments, rollup coverage ignored) — the
  per-span detail path (`fleet trace`, Perfetto export)."""
  return list(journal_mod.read_records(journal_path))


def load_effective(journal_path: str) -> List[dict]:
  """Rollup records + raw records from uncovered segments — the
  O(windows) aggregate path (`fleet status|top|check|watch`,
  ``queue_eta``). Identical to :func:`load` when no rollups exist."""
  from . import rollup

  return rollup.load_effective(journal_path)


def _percentile(sorted_vals: List[float], q: float) -> float:
  if not sorted_vals:
    return 0.0
  idx = min(int(q * (len(sorted_vals) - 1) + 0.5), len(sorted_vals) - 1)
  return sorted_vals[idx]


def _is_stall(name: str) -> bool:
  return any(m in name for m in STALL_MARKERS)


def status(records: Iterable[dict]) -> dict:
  """Merged fleet aggregates: per-stage p50/p95/total, stall ratio,
  counter totals (zombie/DLQ/retries), workers seen, task throughput.

  Accepts raw span/counters records AND ``rollup`` records (windowed
  compactions) interchangeably: rollups carry exact per-stage count/sum
  plus capped duration samples, so totals/counts match the raw view
  exactly and percentiles match whenever the sample cap wasn't hit."""
  # per stage: [count, sum, samples] — raw spans contribute 1/dur/dur,
  # rollup stages contribute their exact count/sum + capped samples
  stage_stats: dict = defaultdict(lambda: [0, 0.0, []])
  task_spans = []
  workers = set()
  counters_by_worker: dict = {}
  ts_min, ts_max = None, None

  def _take_span_times(ts, dur):
    nonlocal ts_min, ts_max
    ts_min = ts if ts_min is None else min(ts_min, ts)
    ts_max = max(ts_max or 0.0, ts + dur)

  def _take_task(rec):
    ts, dur = rec.get("ts"), rec.get("dur")
    if ts is None or dur is None:
      return
    if rec.get("worker"):
      workers.add(rec["worker"])
    _take_span_times(ts, dur)
    st = stage_stats["task"]
    st[0] += 1
    st[1] += float(dur)
    st[2].append(float(dur))
    task_spans.append(rec)

  for rec in records:
    kind = rec.get("kind")
    if kind == "rollup":
      if rec.get("ts_min") is not None:
        _take_span_times(rec["ts_min"], 0.0)
      if rec.get("ts_max") is not None:
        _take_span_times(rec["ts_max"], 0.0)
      for wid in (rec.get("workers") or {}):
        workers.add(wid)
      for name, s in (rec.get("stages") or {}).items():
        st = stage_stats[name]
        st[0] += int(s.get("count", 0))
        st[1] += float(s.get("sum", 0.0))
        st[2].extend(float(d) for d in s.get("durs", ()))
      for t in rec.get("tasks") or ():
        _take_task(t)
      continue
    worker = rec.get("worker", "local")
    workers.add(worker)
    if kind == "counters":
      # cumulative per process: the LAST snapshot per worker is the truth
      prev = counters_by_worker.get(worker)
      if prev is None or rec.get("ts", 0) >= prev.get("ts", 0):
        counters_by_worker[worker] = rec
      continue
    if kind != "span":
      continue
    ts, dur = rec.get("ts"), rec.get("dur")
    if ts is None or dur is None:
      continue
    name = rec.get("name", "span")
    if name == "task":
      _take_task(rec)
      continue
    _take_span_times(ts, dur)
    st = stage_stats[name]
    st[0] += 1
    st[1] += float(dur)
    st[2].append(float(dur))

  stages = {}
  stall_total = work_total = 0.0
  for name, (count, total, samples) in stage_stats.items():
    samples.sort()
    if count == len(samples):
      # no sample cap bit: recompute from the sorted list so the output
      # is bit-identical whether the spans arrived raw or via rollups
      total = sum(samples)
    stages[name] = {
      "count": count,
      "total_s": round(total, 3),
      "p50_ms": round(_percentile(samples, 0.50) * 1e3, 2),
      "p95_ms": round(_percentile(samples, 0.95) * 1e3, 2),
    }
    if _is_stall(name):
      stall_total += total
    elif name != "task":  # task spans contain the stage spans; don't double
      work_total += total

  counters: dict = defaultdict(int)
  for rec in counters_by_worker.values():
    for k, v in (rec.get("counters") or {}).items():
      counters[k] += v

  window = (ts_max - ts_min) if ts_min is not None else 0.0
  tasks_ok = [r for r in task_spans if not r.get("error")]
  return {
    "workers": sorted(workers),
    "window_sec": round(window, 2),
    "tasks": len(task_spans),
    "tasks_failed": len(task_spans) - len(tasks_ok),
    "tasks_per_sec": round(len(tasks_ok) / window, 3) if window > 0 else None,
    "stall_ratio": (
      round(stall_total / (stall_total + work_total), 3)
      if stall_total + work_total > 0 else None
    ),
    "stages": dict(sorted(stages.items())),
    "zombie_fences": sum(
      v for k, v in counters.items() if k.startswith("zombie.")
    ),
    "dlq_promoted": counters.get("dlq.promoted", 0),
    "tasks_failed_counter": counters.get("tasks.failed", 0),
    "counters": dict(sorted(counters.items())),
  }


def iter_task_spans(records: Iterable[dict]) -> Iterator[dict]:
  """Task span records from raw segments AND rollup windows (rollups
  keep task spans verbatim, so both views yield identical records)."""
  for r in records:
    kind = r.get("kind")
    if kind == "rollup":
      for t in r.get("tasks") or ():
        yield t
    elif kind == "span" and r.get("name") == "task":
      yield r


def slowest_tasks(records: Iterable[dict], n: int = 10) -> List[dict]:
  """``igneous fleet top``: the n slowest task executions, by trace."""
  tasks = [r for r in iter_task_spans(records) if r.get("dur") is not None]
  tasks.sort(key=lambda r: -r["dur"])
  out = []
  for rec in tasks[:n]:
    out.append({
      "trace_id": rec.get("trace"),
      "task": rec.get("task", "?"),
      "dur_s": round(rec["dur"], 3),
      "worker": rec.get("worker", "local"),
      "attempt": rec.get("attempt"),
      "error": rec.get("error"),
    })
  return out


def trace_records(records: Iterable[dict], trace_id: str) -> List[dict]:
  """Every span of one trace, time-ordered (the merged lineage)."""
  spans = [
    r for r in records
    if r.get("kind", "span") == "span" and r.get("trace") == trace_id
  ]
  spans.sort(key=lambda r: (r.get("ts") or 0.0))
  return spans


def render_trace(spans: List[dict]) -> List[str]:
  """One text line per span, children indented under their parent —
  the terminal view of `igneous fleet trace` (the Perfetto export is the
  graphical one)."""
  by_id = {r.get("span"): r for r in spans if r.get("span")}

  def depth(rec, seen=()):
    parent = rec.get("parent")
    if not parent or parent not in by_id or parent in seen:
      return 0
    return 1 + depth(by_id[parent], seen + (rec.get("span"),))

  t0 = min((r.get("ts") or 0.0) for r in spans) if spans else 0.0
  lines = []
  for rec in spans:
    pad = "  " * depth(rec)
    extras = []
    if rec.get("attempt") is not None:
      extras.append(f"attempt={rec['attempt']}")
    if rec.get("task"):
      extras.append(rec["task"])
    if rec.get("error"):
      extras.append(f"ERROR={rec['error']}")
    if rec.get("worker"):
      extras.append(f"@{rec['worker']}")
    lines.append(
      f"{(rec.get('ts', 0.0) - t0) * 1e3:9.1f}ms "
      f"{pad}{rec.get('name', 'span')} "
      f"[{(rec.get('dur') or 0.0) * 1e3:.1f}ms]"
      + (" " + " ".join(extras) if extras else "")
    )
  return lines


def worker_rates(records: Iterable[dict], window_sec: Optional[float] = None,
                 now: Optional[float] = None) -> dict:
  """Per-worker throughput (successful task spans per BUSY second, i.e.
  1/mean task duration) mined from the journal — the relative-speed
  signal behind throughput-weighted partitioning (in the JAX package):
  ``page_partition(weights=...)`` hands a slow host proportionally less
  of the page table up front, and the campaign runner projects a range
  lease's tail against the fleet p95 of these rates to decide when to
  speculate. Busy-time (not wall-clock) rates, so an idle-but-fast
  worker isn't mistaken for a straggler. ``window_sec`` restricts to
  recent spans (skew-guarded like :func:`journal_throughput`)."""
  now = time.time() if now is None else now
  per: dict = defaultdict(lambda: [0, 0.0])  # worker -> [n_ok, busy_s]
  for rec in iter_task_spans(records):
    if rec.get("error"):
      continue
    ts, dur = rec.get("ts"), rec.get("dur")
    if ts is None or dur is None or dur <= 0:
      continue
    if window_sec is not None:
      if ts < now - window_sec or ts > now + CLOCK_SKEW_TOLERANCE_SEC:
        continue
    acc = per[rec.get("worker") or "local"]
    acc[0] += 1
    acc[1] += float(dur)
  return {
    w: n / busy for w, (n, busy) in per.items() if n > 0 and busy > 0
  }


# a segment timestamped further than this into the future is a skewed
# worker clock, not data: counting it would stretch the throughput
# window to a time that hasn't happened yet
CLOCK_SKEW_TOLERANCE_SEC = 300.0


def journal_throughput(journal_path: str, window_sec: float = 600.0,
                       now: Optional[float] = None) -> Optional[dict]:
  """Fleet tasks/sec derived from recent journal task spans (the
  ``queue status --eta`` journal path), reading rollups + uncovered raw
  segments (O(windows), not O(all segments)). None when no segments
  exist, when no task span falls inside the window (empty or expired —
  the fleet stopped more than ``window_sec`` ago), or when every
  in-window span is clock-skewed into the future — callers fall back to
  live sampling in each case."""
  now = time.time() if now is None else now
  durs = []
  ts_min = ts_max = None
  records = load_effective(journal_path)
  if not records:
    return None
  for rec in iter_task_spans(records):
    if rec.get("error"):
      continue
    ts = rec.get("ts")
    if ts is None or ts < now - window_sec:
      continue  # expired: finished before the window opened
    if ts > now + CLOCK_SKEW_TOLERANCE_SEC:
      continue  # skewed worker clock: a "future" task proves nothing
    durs.append(rec)
    end = ts + (rec.get("dur") or 0.0)
    ts_min = ts if ts_min is None else min(ts_min, ts)
    ts_max = end if ts_max is None else max(ts_max, end)
  if not durs or ts_max is None or ts_max <= ts_min:
    return None
  window = ts_max - ts_min
  return {
    "tasks": len(durs),
    "window_sec": round(window, 2),
    "tasks_per_sec": len(durs) / window,
  }
