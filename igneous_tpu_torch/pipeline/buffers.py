"""Bounded, byte-budgeted hand-off between pipeline stages.

The port's own copy of ``igneous_tpu/pipeline/buffers.py``. The queue
bounds memory, not items: a producer reserves an item's bytes before it
starts the work (a prefetch thread waits before it downloads a cutout
there is no room for), and the consumer releases them once the item
leaves the pipeline. Stall seconds on both sides and the bytes in flight
go to telemetry (stages ``pipeline.<name>.producer_stall_s`` and
``pipeline.<name>.consumer_stall_s``, gauges ``pipeline.<name>.bytes``
and ``pipeline.<name>.depth``).

``interrupt(flag)`` wires a ``lifecycle.StopFlag`` (or anything with
``is_set()``) into every blocking wait: once it is set, blocked producers
and consumers wake and raise ``PipelineInterrupted``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from .. import telemetry


class PipelineInterrupted(Exception):
  """A blocking buffer wait was woken by the drain flag."""


class BoundedBuffer:
  """FIFO with a byte budget. One item may exceed the budget when the
  buffer is empty, so a single oversized cutout still flows."""

  def __init__(self, budget_bytes: int, name: str = "buffer"):
    self.budget = max(int(budget_bytes), 1)
    self.name = name
    self._lock = threading.Lock()
    self._not_full = threading.Condition(self._lock)
    self._not_empty = threading.Condition(self._lock)
    self._items: deque = deque()  # guarded by self._lock
    self._bytes_held = 0  # acquired weight, producers mid-work included
    self._closed = False
    self._flag = None
    # budget is granted in the order producers were submitted: a younger
    # producer must never starve the oldest one, which the consumer waits on
    self._seq_next = 0
    self._seq_grant = 0

  def interrupt(self, flag) -> None:
    """Attach a drain flag; waits poll it and raise PipelineInterrupted
    once it is set."""
    with self._lock:
      self._flag = flag

  def _interrupted(self) -> bool:
    return self._flag is not None and self._flag.is_set()

  def _wait(self, cond: threading.Condition, pred, stall_stage: str):
    """Wait under the lock for ``pred()``, timing the stall."""
    if pred():
      return
    t0 = time.perf_counter()
    while not pred():
      if self._interrupted():
        telemetry.observe(stall_stage, time.perf_counter() - t0)
        raise PipelineInterrupted(self.name)
      if self._closed:
        break
      cond.wait(timeout=0.1)
    telemetry.observe(stall_stage, time.perf_counter() - t0)

  # -- producer side --------------------------------------------------------

  def reserve_seq(self) -> int:
    """This producer's place in the grant order; call it from the thread
    that submits producers, in item order."""
    with self._lock:
      seq = self._seq_next
      self._seq_next += 1
      return seq

  def acquire(self, nbytes: int, seq: Optional[int] = None) -> None:
    """Reserve ``nbytes`` of budget before producing the item; blocks
    while the buffer is full and earlier producers wait."""
    nbytes = max(int(nbytes), 0)
    with self._not_full:
      if seq is None:
        seq = self._seq_next
        self._seq_next += 1
      try:
        self._wait(
          self._not_full,
          lambda: self._seq_grant == seq and (
            self._bytes_held == 0 or self._bytes_held + nbytes <= self.budget
          ),
          f"pipeline.{self.name}.producer_stall_s",
        )
        self._bytes_held += nbytes
        telemetry.gauge_max(f"pipeline.{self.name}.bytes", self._bytes_held)
      finally:
        # the grant advances on an interrupted wait too, so producers
        # behind an abandoned one never block for ever
        if self._seq_grant == seq:
          self._seq_grant = seq + 1
          self._not_full.notify_all()

  def put(self, item) -> None:
    """Enqueue an item whose bytes were acquired."""
    with self._lock:
      self._items.append(item)
      telemetry.gauge_max(f"pipeline.{self.name}.depth", len(self._items))
      self._not_empty.notify()

  def release(self, nbytes: int) -> None:
    """Return ``nbytes`` of budget (the item left the pipeline, or its
    producer failed)."""
    with self._not_full:
      self._bytes_held -= max(int(nbytes), 0)
      self._not_full.notify_all()

  # -- consumer side --------------------------------------------------------

  def get(self):
    """The next item; blocks until one arrives, or returns None once the
    buffer is closed and empty."""
    with self._not_empty:
      self._wait(
        self._not_empty,
        lambda: bool(self._items) or self._closed,
        f"pipeline.{self.name}.consumer_stall_s",
      )
      return self._items.popleft() if self._items else None

  def close(self) -> None:
    """No more puts; blocked consumers take what remains, then None."""
    with self._lock:
      self._closed = True
      self._not_empty.notify_all()
      self._not_full.notify_all()

  @property
  def bytes_held(self) -> int:
    with self._lock:
      return self._bytes_held

  def __len__(self) -> int:
    with self._lock:
      return len(self._items)
