"""The drain request of a task stream.

The port's own copy of ``StopFlag`` from ``igneous_tpu/lifecycle.py``:
``LocalTaskQueue(drain_flag=...)`` and the staged pipeline check it
between tasks and in every blocking stage wait, so a set flag stops
admission, lets the uploads in flight finish and returns with
``drained=True``.
"""

from __future__ import annotations

import threading
from typing import Optional


class StopFlag:
  """Thread-safe drain request; records the first reason it was set."""

  def __init__(self):
    self._event = threading.Event()
    self._lock = threading.Lock()
    self.reason: Optional[str] = None  # guarded by self._lock

  def set(self, reason: str = "stop"):
    with self._lock:
      if self.reason is None:
        self.reason = reason
    self._event.set()

  def is_set(self) -> bool:
    return self._event.is_set()

  def wait(self, timeout: Optional[float] = None) -> bool:
    return self._event.wait(timeout)
