"""Wall-clock stage timers for one process.

The downsample path (download, h2d, kernel, d2h, upload) and the CCL path
(tasks.ccl, ops.ccl) time their stages here so a caller can split a task's
wall time. ``stage`` only reads the host clock; the device stages
synchronise where they end (ops.pooling, ops.ccl).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict

_LOCK = threading.Lock()
_STAGES: Dict[str, list] = {}


@contextmanager
def stage(name: str):
  t0 = time.perf_counter()
  try:
    yield
  finally:
    dt = time.perf_counter() - t0
    with _LOCK:
      acc = _STAGES.setdefault(name, [0.0, 0])
      acc[0] += dt
      acc[1] += 1


def snapshot() -> Dict[str, dict]:
  """{stage: {"seconds": total, "count": entries}} since the last reset."""
  with _LOCK:
    return {k: {"seconds": v[0], "count": v[1]} for k, v in _STAGES.items()}


def reset() -> None:
  with _LOCK:
    _STAGES.clear()
