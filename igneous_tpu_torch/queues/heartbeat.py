"""Lease heartbeats: renew visibility while work executes.

The port's own copy of ``igneous_tpu/queues/heartbeat.py``. The visibility
timeout detects dead workers, but a LONG timeout makes detection slow
while a SHORT one double-executes any task slower than the lease. Workers
run with a short ``--lease-sec`` and a daemon thread renews every tracked
lease at ``interval`` (default lease/3, ``IGNEOUS_HEARTBEAT_SEC``), so
long mesh and skeleton tasks still run exactly once.

Renewal goes through ``queue.renew(lease_id, seconds)``: fq:// renames the
lease (the token CHANGES; this class maps each tracked token to its
current one), sqs:// changes the message's visibility (token stable). A
queue without ``renew`` disables the heartbeat. A range member's renewal
reaches ``FileQueue._range_renew``, which first serves a pending steal
claim on the range, so a thief waits at most one interval.

A renewal refused with StaleLeaseError means this worker became a zombie
for that lease; the lease is dropped from tracking and recorded in
``self.lost`` (the later delete is fenced by the queue anyway).
"""

from __future__ import annotations

import threading
from typing import Optional

from ..analysis import racecheck
from .filequeue import StaleLeaseError


class LeaseHeartbeat:
  """Renews tracked leases on a daemon thread.

  Usage::

    hb = LeaseHeartbeat(queue, lease_seconds)
    with hb:
      key = hb.track(lease_id)      # start renewing
      ... execute ...
      queue.delete(hb.untrack(key))  # current token; renewing stops

  ``interval=None`` resolves IGNEOUS_HEARTBEAT_SEC, then lease/3;
  ``interval <= 0`` disables (track/untrack become identity pass-throughs).
  """

  def __init__(self, queue, lease_seconds: float,
               interval: Optional[float] = None):
    if interval is None:
      from .. import secrets

      interval = secrets.heartbeat_seconds()
    if interval is None:
      interval = max(float(lease_seconds) / 3.0, 0.01)
    self.queue = queue
    self.lease_seconds = float(lease_seconds)
    self.interval = float(interval)
    self.enabled = self.interval > 0 and hasattr(queue, "renew")
    self.renewals = 0
    self._lock = threading.Lock()
    self.lost = racecheck.guard(  # guarded-by: self._lock
      set(), self._lock, "LeaseHeartbeat.lost")
    # token at track() time -> current token
    self._current = racecheck.guard(  # guarded-by: self._lock
      {}, self._lock, "LeaseHeartbeat._current")
    self._stop = threading.Event()
    self._thread: Optional[threading.Thread] = None

  def track(self, lease_id):
    """Begin renewing ``lease_id``; returns the key for current()/untrack().
    Idempotent: re-tracking an already-tracked lease (a pre-leased batch
    member tracked again at round start) keeps the renewed current token
    instead of clobbering it with the stale original."""
    if self.enabled:
      with self._lock:
        self._current.setdefault(lease_id, lease_id)
    return lease_id

  def current(self, key):
    """The lease's current token (== key until a renewal re-timestamps it)."""
    with self._lock:
      return self._current.get(key, key)

  def untrack(self, key):
    """Stop renewing; returns the current token for the final delete/nack."""
    with self._lock:
      return self._current.pop(key, key)

  def beat(self):
    """One renewal pass over every tracked lease (called by the thread;
    public so tests can step it deterministically)."""
    with self._lock:
      keys = list(self._current)
    for key in keys:
      # hold the lock across the renew so an untrack cannot interleave
      # with the token swap and hand the caller a dead token
      with self._lock:
        cur = self._current.get(key)
        if cur is None:
          continue
        try:
          new_id = self.queue.renew(cur, self.lease_seconds)
        except StaleLeaseError:
          # zombie for this lease: stop renewing; the fenced delete path
          # (and the task's new owner) take it from here
          self._current.pop(key, None)
          self.lost.add(key)
          continue
        except Exception:
          # transient renew failure (an SQS 503, say): the lease has
          # interval << lease_seconds of slack, so the next beat retries
          continue
        self.renewals += 1
        self._current[key] = new_id

  def _run(self):
    while not self._stop.wait(self.interval):
      self.beat()

  def start(self):
    if not self.enabled or self._thread is not None:
      return self
    self._stop.clear()
    self._thread = threading.Thread(
      target=self._run, daemon=True, name="lease-heartbeat"
    )
    self._thread.start()
    return self

  def stop(self):
    self._stop.set()
    if self._thread is not None:
      self._thread.join(timeout=5.0)
      self._thread = None

  __enter__ = start

  def __exit__(self, *exc):
    self.stop()
    return False
