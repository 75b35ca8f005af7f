"""Prometheus text exposition of the process metrics.

Three consumption modes, all fed by the same snapshot:

  * ``render()`` — the text format (version 0.0.4) as a string;
  * ``write_textfile(path)`` — atomic write for the node-exporter
    textfile collector (``IGNEOUS_METRICS_TEXTFILE``);
  * ``start_http_server(port)`` — a daemon-thread ``/metrics`` endpoint
    served from the worker poll loop (``IGNEOUS_METRICS_PORT`` or
    ``igneous execute --metrics-port``).

Metric mapping: int counters → ``igneous_<name>_total`` counters, timers
→ ``igneous_<name>_seconds`` histograms (log-scale buckets + _sum/_count),
gauges → ``igneous_<name>`` gauges. Names are sanitized to the Prometheus
charset; the original dotted name survives as a ``name`` label-free
comment.

The port's own copy of ``igneous_tpu/observability/prom.py``: the same
metric names, buckets and lines.
"""

from __future__ import annotations

import math
import os
import re
import threading
from typing import Optional

from . import metrics

from ..analysis import knobs

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
PORT_ENV = "IGNEOUS_METRICS_PORT"
TEXTFILE_ENV = "IGNEOUS_METRICS_TEXTFILE"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _sanitize(name: str) -> str:
  out = _NAME_RE.sub("_", name)
  if not out or not (out[0].isalpha() or out[0] == "_"):
    out = "_" + out
  return out


def _fmt(value: float) -> str:
  if value != value or math.isinf(value):  # NaN/Inf never serialized
    return "0"
  if float(value).is_integer():
    return str(int(value))
  return repr(float(value))


def render() -> str:
  """The full exposition: counters, timer histograms, gauges."""
  lines = []

  for name, value in sorted(metrics.counters_snapshot().items()):
    metric = f"igneous_{_sanitize(name)}_total"
    lines.append(f"# TYPE {metric} counter")
    lines.append(f"{metric} {_fmt(value)}")

  histos = metrics.histograms_snapshot()
  for name, totals in sorted(metrics.timer_totals().items()):
    metric = f"igneous_{_sanitize(name)}_seconds"
    lines.append(f"# TYPE {metric} histogram")
    h = histos.get(name)
    if h is not None:
      cum = 0
      for bound, count in zip(h["bounds"], h["buckets"]):
        cum += count
        lines.append(f'{metric}_bucket{{le="{_fmt(bound)}"}} {cum}')
      cum += h["buckets"][-1]
      lines.append(f'{metric}_bucket{{le="+Inf"}} {cum}')
    lines.append(f"{metric}_sum {_fmt(totals['sum'])}")
    lines.append(f"{metric}_count {totals['count']}")

  for name, value in sorted(metrics.gauges_snapshot().items()):
    metric = f"igneous_{_sanitize(name)}"
    lines.append(f"# TYPE {metric} gauge")
    lines.append(f"{metric} {_fmt(value)}")

  for name, value in sorted(_self_health_gauges().items()):
    metric = f"igneous_{_sanitize(name)}"
    lines.append(f"# TYPE {metric} gauge")
    lines.append(f"{metric} {_fmt(value)}")

  return "\n".join(lines) + "\n"


def _self_health_gauges() -> dict:
  """Journal/worker self-health, computed at scrape time: a dead journal
  writer must itself be alertable, so the exposition carries the live
  flush age and span backlog whenever a journal is active (the
  companion counters — igneous_journal_segments_total,
  igneous_journal_flush_failed_total — register at journal creation).
  ``igneous_worker_up`` doubles as the liveness gauge: present while
  the worker process answers scrapes, absent (stale in Prometheus)
  once it stops."""
  from . import journal as journal_mod
  from . import trace

  j = journal_mod.get_active()
  if j is None:
    return {}
  return {
    "journal_last_flush_age_seconds": round(j.last_flush_age(), 3),
    "journal_pending_spans": float(trace.pending_spans()),
    "worker_up": 1.0,
  }


def write_textfile(path: Optional[str] = None) -> Optional[str]:
  """Atomic write for the textfile collector; returns the path written
  (env ``IGNEOUS_METRICS_TEXTFILE`` when not given), or None if unset."""
  path = path or knobs.get_str(TEXTFILE_ENV)
  if not path:
    return None
  tmp = f"{path}.tmp.{os.getpid()}"
  with open(tmp, "w") as f:
    f.write(render())
  os.replace(tmp, path)
  return path


class _MetricsServer:
  def __init__(self, port: int):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
      def do_GET(self):  # noqa: N802 - stdlib API
        if self.path.rstrip("/") not in ("", "/metrics"):
          self.send_response(404)
          self.end_headers()
          return
        body = render().encode("utf8")
        self.send_response(200)
        self.send_header("Content-Type", CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

      def log_message(self, *args):  # quiet: one line per scrape is noise
        pass

    self.httpd = ThreadingHTTPServer(("0.0.0.0", port), Handler)
    self.port = self.httpd.server_address[1]
    self._thread = threading.Thread(
      target=self.httpd.serve_forever, daemon=True, name="ig-metrics"
    )
    self._thread.start()

  def stop(self):
    self.httpd.shutdown()
    self.httpd.server_close()


_SERVER: Optional[_MetricsServer] = None
_SERVER_LOCK = threading.Lock()


def start_http_server(port: Optional[int] = None) -> Optional[int]:
  """Serve ``/metrics`` on ``port`` (0 picks a free one; None reads
  ``IGNEOUS_METRICS_PORT``, absent/empty disables). Returns the bound
  port or None. Idempotent per process."""
  global _SERVER
  if port is None:
    raw = knobs.raw(PORT_ENV) or ""
    if not raw:
      return None
    try:
      port = int(raw)
    except ValueError:
      return None
    if port < 0:
      return None
  with _SERVER_LOCK:
    if _SERVER is not None:
      return _SERVER.port
    try:
      _SERVER = _MetricsServer(int(port))
    except OSError:
      metrics.incr("metrics.port_bind_failed")
      return None
    return _SERVER.port


def stop_http_server() -> None:
  global _SERVER
  with _SERVER_LOCK:
    if _SERVER is not None:
      _SERVER.stop()
      _SERVER = None
