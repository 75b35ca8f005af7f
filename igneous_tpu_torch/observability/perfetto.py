"""Perfetto / Chrome-trace export of journal span records.

Produces the Trace Event Format JSON that both ``chrome://tracing`` and
https://ui.perfetto.dev open directly: one complete ("ph": "X") event per
span, grouped into one Perfetto "process" row per worker. Used by
``igneous fleet trace <trace_id> -o trace.json`` for single-task deep
dives and by the CI soak to leave a browsable artifact behind.

The port's own copy of ``igneous_tpu/observability/perfetto.py``.
"""

from __future__ import annotations

import json
from typing import Iterable, Optional

_META_KEYS = {"kind", "segment", "worker", "trace", "span", "parent",
              "name", "ts", "dur"}


def chrome_trace(records: Iterable[dict],
                 trace_id: Optional[str] = None) -> dict:
  """Span records (journal dicts or trace.drain_spans output) → Trace
  Event Format. ``trace_id`` filters to one trace; None exports all."""
  events = []
  pids = {}  # worker -> pid
  device_tids = {}  # (pid, device label) -> tid
  serve_tids = {}   # (pid, layer) -> tid
  t0 = None

  spans = [
    r for r in records
    if r.get("kind", "span") == "span" and "ts" in r and "dur" in r
    and (trace_id is None or r.get("trace") == trace_id)
  ]
  for rec in spans:
    if t0 is None or rec["ts"] < t0:
      t0 = rec["ts"]
  t0 = t0 or 0.0

  for rec in spans:
    worker = rec.get("worker", "local")
    pid = pids.setdefault(worker, len(pids) + 1)
    args = {k: v for k, v in rec.items() if k not in _META_KEYS}
    args["trace_id"] = rec.get("trace")
    args["span_id"] = rec.get("span")
    if rec.get("parent"):
      args["parent_span_id"] = rec["parent"]
    name = rec.get("name", "span")
    if name.startswith("device.") and rec.get("device"):
      # device telemetry: kernel/transfer spans render on one
      # dedicated track per physical device inside the worker row, so
      # compile/execute/h2d intervals read as a device timeline instead
      # of vanishing into whichever task trace triggered them. tids
      # 10000+ keep clear of the per-trace task rows below.
      tid = device_tids.setdefault(
        (pid, rec["device"]), 10_000 + len(device_tids)
      )
    elif name.startswith("serve.") and rec.get("layer"):
      # serving tier: request/fetch/decode spans render on one
      # track per served layer — a layer's request timeline reads
      # contiguously instead of scattering across per-trace rows (every
      # request is its own trace). tids 20000+ stay clear of both the
      # device tracks and the hashed task rows.
      tid = serve_tids.setdefault(
        (pid, rec["layer"]), 20_000 + len(serve_tids)
      )
    else:
      # one row per trace inside the worker keeps concurrent tasks from
      # visually stacking into one another
      tid = abs(hash(rec.get("trace", ""))) % 10_000
    events.append({
      "name": name,
      "cat": "igneous",
      "ph": "X",
      "ts": (rec["ts"] - t0) * 1e6,          # microseconds
      "dur": max(rec["dur"], 0.0) * 1e6,
      "pid": pid,
      "tid": tid,
      "args": args,
    })

  for worker, pid in pids.items():
    events.append({
      "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
      "args": {"name": f"worker {worker}"},
    })
  for (pid, dev), tid in device_tids.items():
    events.append({
      "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
      "args": {"name": f"device {dev}"},
    })
  for (pid, layer), tid in serve_tids.items():
    events.append({
      "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
      "args": {"name": f"serve {layer}"},
    })

  return {
    "traceEvents": events,
    "displayTimeUnit": "ms",
    "otherData": {"exporter": "igneous fleet", "epoch_s": t0},
  }


def dump(records: Iterable[dict], path: str,
         trace_id: Optional[str] = None) -> int:
  """Write the chrome trace JSON to ``path``; returns the event count."""
  doc = chrome_trace(records, trace_id=trace_id)
  with open(path, "w") as f:
    json.dump(doc, f)
  return len(doc["traceEvents"])
