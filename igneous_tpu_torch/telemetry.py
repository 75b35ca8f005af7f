"""Wall-clock stage timers and counters for one process.

The downsample path (download, h2d, kernel, d2h, upload), the CCL path
(tasks.ccl, ops.ccl) and the mesh path (tasks.mesh, ops.mesh) time their
stages here so a caller can split a task's wall time. ``stage`` only reads
the host clock; the device stages synchronise where they end (ops.pooling,
ops.ccl, ops.mesh). ``add`` counts work items (the mesh path's labels and
faces, the chunk cache's hits and misses). ``observe`` adds a duration
measured elsewhere to a stage (the staged pipeline's stall seconds), and
``gauge_max`` keeps the highest value a gauge has shown (its buffer's
bytes in flight).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict

_LOCK = threading.Lock()
_STAGES: Dict[str, list] = {}
_COUNTS: Dict[str, int] = {}
_GAUGES: Dict[str, float] = {}


@contextmanager
def stage(name: str):
  t0 = time.perf_counter()
  try:
    yield
  finally:
    observe(name, time.perf_counter() - t0)


def observe(name: str, seconds: float) -> None:
  with _LOCK:
    acc = _STAGES.setdefault(name, [0.0, 0])
    acc[0] += seconds
    acc[1] += 1


def add(name: str, n: int) -> None:
  with _LOCK:
    _COUNTS[name] = _COUNTS.get(name, 0) + int(n)


def gauge_max(name: str, value: float) -> None:
  with _LOCK:
    if value > _GAUGES.get(name, float("-inf")):
      _GAUGES[name] = value


def gauges() -> Dict[str, float]:
  """{gauge: highest value} since the last reset."""
  with _LOCK:
    return dict(_GAUGES)


def counters() -> Dict[str, int]:
  """{counter: total} since the last reset."""
  with _LOCK:
    return dict(_COUNTS)


def snapshot() -> Dict[str, dict]:
  """{stage: {"seconds": total, "count": entries}} since the last reset."""
  with _LOCK:
    return {k: {"seconds": v[0], "count": v[1]} for k, v in _STAGES.items()}


def reset() -> None:
  with _LOCK:
    _STAGES.clear()
    _COUNTS.clear()
    _GAUGES.clear()
