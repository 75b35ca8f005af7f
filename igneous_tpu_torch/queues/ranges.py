"""Range leases: a contiguous run of grid tasks held as ONE queue message.

The port's own copy of ``igneous_tpu/queues/ranges.py``. A regular-grid
campaign is index-addressable: task i is fully determined by its grid
coordinate. Leasing K such tasks one message at a time costs K queue
round trips; a *range lease* moves the whole run in one: the FileQueue
segment file (``seg_<segid>_<count>.jsonl``) IS the lease unit.

Per-task semantics survive through sub-task accounting:

* :class:`RangeSub` is the worker-side handle for ONE member. Every queue
  op (``delete``/``nack``/``release``/``renew``/``delivery_count``)
  accepts it wherever a classic lease token is accepted, so the shared
  poll loop and the lease batcher run unmodified over ranges.
* partial completion **acks a sub-range**: each ack rewrites the lease
  file minus the completed index, so an expiry recycles only what is
  still unfinished;
* a mid-range failure **splits the lease**: the failed index is carved
  out as a classic single-task lease with inherited attempt metadata, so
  only that index retries (and only it can dead-letter);
* heartbeat renewal re-timestamps the ONE underlying lease, with a
  freshness guard so K tracked members don't trigger K renames per beat.

The mutable state (current token, surviving entries, deadline) lives
here; the filesystem mechanics live on the owning queue
(``FileQueue._range_*``).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional


class RangeSub:
  """Handle for one member of a :class:`RangeLease`. Accepted anywhere a
  classic lease token is (queue delete/nack/release/renew), hashable so
  heartbeats and round bookkeeping can track it like a token string."""

  __slots__ = ("parent", "index")

  def __init__(self, parent: "RangeLease", index: int):
    self.parent = parent
    self.index = int(index)

  def mark_started(self):
    """Record that work on this member has begun (see
    :meth:`RangeLease.mark_started`)."""
    self.parent.mark_started(self.index)

  def __repr__(self):
    return f"RangeSub({self.parent.segid[:8]}:{self.index})"


class RangeLease:
  """A leased contiguous (or split-survivor) set of task indices backed
  by one queue message. ``entries`` holds only the *surviving* members —
  acked/nacked/released indices leave it, and lease expiry recycles
  exactly what remains."""

  def __init__(self, queue, token: str, segid: str,
               entries: Dict[int, str], deadline: float):
    self.queue = queue
    self.token = token          # current lease token (renewals rotate it)
    self.segid = segid          # stable across rewrites; keys attempt meta
    self.entries = dict(entries)  # index -> serialized payload, pending only
    self.deadline = float(deadline)
    self.started = set()        # members whose execution has begun
    self.lock = threading.RLock()

  # -- shape ----------------------------------------------------------------

  @property
  def start(self) -> Optional[int]:
    with self.lock:
      return min(self.entries) if self.entries else None

  @property
  def end(self) -> Optional[int]:
    """Exclusive end of the surviving index set."""
    with self.lock:
      return max(self.entries) + 1 if self.entries else None

  def __len__(self) -> int:
    with self.lock:
      return len(self.entries)

  def subs(self) -> List[RangeSub]:
    with self.lock:
      return [RangeSub(self, i) for i in sorted(self.entries)]

  def __repr__(self):
    with self.lock:
      return (
        f"RangeLease({self.segid[:8]}, n={len(self.entries)}, "
        f"[{self.start}:{self.end}])"
      )

  # -- per-member ops (delegate to the owning queue) ------------------------

  def ack(self, index: int) -> bool:
    """Complete one member: the sub-range shrinks, the completion
    tallies, and expiry can no longer recycle this index. Zombie-fenced
    like a classic delete (False + ``zombie.delete`` when stale)."""
    return self.queue._range_ack(self, index)

  def ack_many(self, indices) -> Dict[int, bool]:
    """Complete several members with ONE lease-file rewrite."""
    return self.queue._range_ack_many(self, indices)

  def nack(self, index: int, reason: str = "", requeue: bool = False):
    """Fail one member: it splits out of the range as a classic
    single-task lease carrying the range's delivery count, so only this
    index retries (or dead-letters when exhausted)."""
    return self.queue._range_nack(self, index, reason, requeue=requeue)

  def release(self, indices=None):
    """Return members (all surviving ones when ``indices`` is None) to
    the queue immediately as a fresh segment."""
    return self.queue._range_release(self, indices)

  def heartbeat_renew(self, seconds: float):
    """Extend the shared lease. The underlying token rotates internally;
    callers keep using their RangeSub handles unchanged. Raises
    StaleLeaseError once the range expired or fully completed."""
    return self.queue._range_renew(self, seconds)

  def mark_started(self, index: int):
    """Record that work on a member has begun. Work stealing carves only
    UNSTARTED members off a claimed range, so marking keeps work in
    flight from going to a thief. A worker that never marks still
    converges (a member granted away mid-run fences its late ack), only
    less efficiently."""
    with self.lock:
      self.started.add(int(index))

  def unstarted(self) -> List[int]:
    """Surviving members no one has begun: the stealable tail."""
    with self.lock:
      return sorted(set(self.entries) - self.started)
