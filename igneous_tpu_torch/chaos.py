"""Deterministic fault injection for storage and queues.

The port's own copy of ``igneous_tpu/chaos.py``. Every containment path of
the port (lease recycling, delivery counting, dead letters, retries,
idempotent re-execution) exists because object stores and queues fail;
these seeded wrappers make the failures reproducible:

  * failed puts (transient 503s, or a crash between compute and upload
    that may leave part of a task's output behind);
  * corrupted gets (a flipped byte; gzip's CRC turns it into a loud task
    failure, never silent bad voxels);
  * 503 storms on any operation;
  * dropped or late lease deletes (a completed task whose ack never lands
    is delivered again: at-least-once's canonical duplicate);
  * permanent faults on chosen keys (poison tasks that must end in the
    dead-letter queue, not in an endless retry loop);
  * silent corruption at rest (a torn or bit-flipped put that reports
    success, which only the integrity audit finds).

Each decision hashes ``(seed, op, key, occurrence)`` with sha256, never
the clock or a shared generator, so one seed gives one fault schedule per
key whatever the threads do, and the same schedule as the JAX package's.

  cfg = ChaosConfig(seed=7, put_fail=0.2, get_corrupt=0.1)
  with chaos_storage(cfg):        # wraps every backend CloudFiles builds
    ... run the pipeline ...

  q = ChaosQueue(FileQueue(...), cfg)   # queue-side faults

Transient faults stop after ``max_faults_per_key`` occurrences per
(op, key), so a run under chaos converges; ``permanent`` names key
substrings that fail every time.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from . import telemetry
from .storage_http import HttpError


class ChaosWorkerCrash(Exception):
  """A simulated process death mid-operation: no retry layer may absorb it;
  only the queue's redelivery recovers."""


@dataclass
class ChaosConfig:
  """Fault rates are probabilities in [0, 1], evaluated per operation.

  seed: names the schedule; the same seed gives the same faults.
  put_fail: transient 503 on put.
  get_corrupt: flip a byte of a get's payload (transient).
  storm: transient 503 on any operation (get, put, list, exists, size,
    delete).
  crash_put: ``ChaosWorkerCrash`` on put: compute done, upload partial,
    worker gone. Only a redelivery recovers.
  torn_write: the put succeeds but only a prefix of the bytes lands.
  bit_flip: the put succeeds with one bit flipped at rest.
  corrupt_key_re: torn_write and bit_flip fire only on keys this regex
    matches (empty: every key).
  drop_delete: the queue's delete is dropped (the ack is lost; the task is
    delivered again once its lease expires).
  clock_skew: a lease is granted already expired, so its renewals and its
    delete must be fenced.
  stalled_worker: the worker acks only after its lease expired and the
    task was reissued; the late ack must be fenced.
  max_faults_per_key: transient faults per (op, key) before that seam
    heals.
  permanent: keys containing this substring fail every time.
  """

  seed: int = 0
  put_fail: float = 0.0
  get_corrupt: float = 0.0
  storm: float = 0.0
  crash_put: float = 0.0
  drop_delete: float = 0.0
  clock_skew: float = 0.0
  stalled_worker: float = 0.0
  torn_write: float = 0.0
  bit_flip: float = 0.0
  corrupt_key_re: str = ""
  max_faults_per_key: int = 2
  permanent: str = ""
  # occurrence counters per (op, key): instance state, so two configs
  # never share a schedule
  _counts: dict = field(default_factory=dict, repr=False)
  _faults: dict = field(default_factory=dict, repr=False)
  # (op, key) pairs corrupted at rest: what an audit must find
  injected: list = field(default_factory=list, repr=False)

  def roll(self, op: str, key: str) -> float:
    """The uniform [0, 1) draw of this (op, key) occurrence."""
    n = self._counts[(op, key)] = self._counts.get((op, key), 0) + 1
    h = hashlib.sha256(f"{self.seed}:{op}:{key}:{n}".encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0**64

  def should_fault(self, op: str, key: str, rate: float) -> bool:
    """One decision: a permanent key always faults; a transient fault
    fires on the seeded roll until the (op, key) budget is spent."""
    if self.permanent and self.permanent in key:
      telemetry.incr(f"chaos.{op}.permanent")
      self._trace_event(op, key)
      return True
    if rate <= 0.0:
      return False
    spent = self._faults.get((op, key), 0)
    if spent >= self.max_faults_per_key:
      return False
    if self.roll(op, key) < rate:
      self._faults[(op, key)] = spent + 1
      telemetry.incr(f"chaos.{op}")
      self._trace_event(op, key)
      return True
    return False

  @staticmethod
  def _trace_event(op: str, key: str):
    """Mark the fault on the active task's trace, so ``fleet trace`` shows
    why a delivery failed (nothing outside a sampled trace)."""
    from .observability import trace

    trace.event(f"chaos.{op}", key=key[-80:])


class ChaosStorage:
  """A storage backend wrapper that injects faults (the interface of the
  backend it wraps, so it stacks under ``CloudFiles`` unnoticed)."""

  def __init__(self, inner, config: ChaosConfig, path: str = ""):
    self.inner = inner
    self.config = config
    self.path = path

  def _storm(self, op: str, key: str):
    if self.config.should_fault(f"storm.{op}", key, self.config.storm):
      raise HttpError(503, f"chaos://{self.path}/{key}", b"injected storm")

  def put(self, key: str, data: bytes):
    if self.config.should_fault("crash_put", key, self.config.crash_put):
      raise ChaosWorkerCrash(
        f"worker crashed between compute and upload of {key!r}"
      )
    if self.config.should_fault("put", key, self.config.put_fail):
      raise HttpError(503, f"chaos://{self.path}/{key}", b"injected put fail")
    self._storm("put", key)
    data = self._corrupt_at_rest(key, data)
    return self.inner.put(key, data)

  def _corrupt_at_rest(self, key: str, data: bytes) -> bytes:
    """Silent corruption: the bytes that land differ from the writer's,
    but the put succeeds. The write envelope records the writer's digest
    (``CloudFiles`` computes it above this wrapper), so an audit finds it."""
    cfg = self.config
    if (cfg.torn_write <= 0.0 and cfg.bit_flip <= 0.0) or len(data) < 2:
      return data
    if cfg.corrupt_key_re:
      import re

      if not re.search(cfg.corrupt_key_re, key):
        return data
    if cfg.should_fault("torn_write", key, cfg.torn_write):
      cfg.injected.append(("torn_write", key))
      return data[: max(1, len(data) // 2)]
    if cfg.should_fault("bit_flip", key, cfg.bit_flip):
      cfg.injected.append(("bit_flip", key))
      i = len(data) // 2
      return data[:i] + bytes([data[i] ^ 0x10]) + data[i + 1:]
    return data

  def get(self, key: str):
    self._storm("get", key)
    data = self.inner.get(key)
    if data is not None and self.config.should_fault(
      "corrupt", key, self.config.get_corrupt
    ):
      # a byte flipped mid-payload: gzip's CRC and the codecs' headers make
      # it a loud decode failure
      i = len(data) // 2
      data = data[:i] + bytes([data[i] ^ 0xFF]) + data[i + 1:]
    return data

  def get_range(self, key: str, start: int, length: int):
    self._storm("get", key)
    return self.inner.get_range(key, start, length)

  def exists(self, key: str) -> bool:
    self._storm("exists", key)
    return self.inner.exists(key)

  def delete(self, key: str):
    self._storm("delete", key)
    return self.inner.delete(key)

  def size(self, key: str):
    self._storm("size", key)
    return self.inner.size(key)

  def list(self, prefix: str = ""):
    self._storm("list", prefix)
    return self.inner.list(prefix)


class ChaosQueue:
  """A queue wrapper that injects control-plane faults. It delegates
  everything; ``delete`` may be dropped (a lost ack gives a duplicate
  delivery), which idempotent tasks absorb byte for byte."""

  def __init__(self, inner, config: ChaosConfig):
    self.inner = inner
    self.config = config

  def _backdate_lease(self, lease_id: str):
    """Rename an fq:// lease so its deadline has passed: the stand-in for
    a worker whose lease clock is wrong. Returns the back-dated token, or
    None where the backend has no lease files or the lease was recycled."""
    import os
    import time

    lease_dir = getattr(self.inner, "lease_dir", None)
    if lease_dir is None or "--" not in str(lease_id):
      return None
    name = str(lease_id).split("--", 1)[1]
    stale = f"{time.time() - 0.001:.3f}--{name}"
    try:
      os.rename(
        os.path.join(lease_dir, lease_id), os.path.join(lease_dir, stale)
      )
    except FileNotFoundError:
      return None
    return stale

  def lease(self, seconds: float = 600):
    got = self.inner.lease(seconds)
    if got is None:
      return None
    task, lease_id = got
    name = str(lease_id).split("--", 1)[-1]
    if self.config.should_fault("clock_skew", name, self.config.clock_skew):
      stale = self._backdate_lease(lease_id)
      if stale is not None:
        lease_id = stale  # every later renew or delete on it is fenced
    return task, lease_id

  def delete(self, lease_id: str):
    # keyed by the task's name after the lease prefix, so the deliveries
    # of one task share an occurrence counter
    name = str(lease_id).split("--", 1)[-1]
    if self.config.should_fault(
      "drop_delete", name, self.config.drop_delete
    ):
      return  # the ack is lost: the lease expires and the task returns
    if self.config.should_fault(
      "stalled_worker", name, self.config.stalled_worker
    ):
      # the worker woke after its lease expired: the fenced delete refuses
      # the late ack and the task goes to a live worker
      stale = self._backdate_lease(lease_id)
      if stale is not None:
        return self.inner.delete(stale)
    return self.inner.delete(lease_id)

  def poll(self, *args, **kw):
    """The shared worker loop with this wrapper as its queue (the inner
    queue's ``poll`` would hand ``poll_loop`` the unwrapped queue and skip
    the faults)."""
    from .queues.filequeue import poll_loop

    kw.pop("tally", None)
    return poll_loop(self, *args, **kw)

  def __getattr__(self, attr):
    return getattr(self.inner, attr)


class chaos_storage:
  """Context manager: every backend ``CloudFiles`` builds while it is
  active is wrapped in ``ChaosStorage(config)``. One storm at a time: it
  does not nest."""

  def __init__(self, config: ChaosConfig):
    self.config = config

  def __enter__(self):
    from . import storage

    storage.set_backend_wrapper(
      lambda backend, pth: ChaosStorage(backend, self.config, str(pth))
    )
    return self.config

  def __exit__(self, *exc):
    from . import storage

    storage.set_backend_wrapper(None)
    return False
