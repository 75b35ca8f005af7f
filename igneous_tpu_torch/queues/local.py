"""In-process / multi-process task execution.

``LocalTaskQueue`` mirrors ``igneous_tpu/queues/local.py``: inserting tasks
executes them at once, each round-tripped through the JSON wire format.
At ``parallel=1`` the stream runs through the staged pipeline
(``pipeline.run_tasks_pipelined``: downloads prefetch ahead, compute stays
in task order on the caller's thread, chunk encodes and puts run on a
pool), byte for byte what the serial loop writes; ``IGNEOUS_PIPELINE=off``
restores the serial loop. ``parallel > 1`` spawns worker processes, never
forks: a forked child of a process that has initialised CUDA cannot use
the device. Each spawned worker opens its own CUDA context and loads the
kernels again, so one worker per card is the rule on a GPU.
"""

from __future__ import annotations

import functools
import multiprocessing as mp
from typing import Iterable, Optional

from .filequeue import failure_reason, iter_tasks
from .registry import deserialize, serialize


def _execute_payload(payload: str) -> bool:
  from ..observability import trace

  task = deserialize(payload)
  with trace.task_span(task, queue="LocalTaskQueue"):
    task.execute()
  return True


def _execute_payload_contained(payload: str, max_deliveries: int):
  """Up to ``max_deliveries`` attempts; returns (payload, None) on success
  or (payload, failure reason) of the last attempt."""
  last = None
  for _ in range(max(int(max_deliveries), 1)):
    try:
      _execute_payload(payload)
      return payload, None
    except Exception as e:  # noqa: BLE001 - recorded as a dead letter
      last = failure_reason(e)
  return payload, last


def _worker_init(device: str) -> None:
  from ..device import set_device

  set_device(device)


class LocalTaskQueue:
  """Executes tasks on insert; parallel > 1 uses a spawn process pool.

  ``max_deliveries`` gives each task that many attempts; a task that
  still fails goes to ``self.dead_letters`` (payload and failure reason)
  instead of ending the insert. The default (None) is fail-fast: the
  first exception propagates. ``drain_flag`` (anything with
  ``is_set()``): once set, the task in flight finishes, the rest are left
  unexecuted and ``self.drained`` is True (the spawn pool checks it as
  each result arrives and stops the workers). ``self.pipeline_stats``
  holds the staged runner's counts of the last pipelined insert."""

  def __init__(self, parallel: int = 1, max_deliveries: Optional[int] = None,
               drain_flag=None):
    self.parallel = max(int(parallel), 1)
    self.inserted = 0
    self.completed = 0
    self.max_deliveries = (
      None if not max_deliveries or int(max_deliveries) <= 0
      else int(max_deliveries)
    )
    self.dead_letters: list = []
    self.drain_flag = drain_flag
    self.drained = False
    self.pipeline_stats: Optional[dict] = None

  def _draining(self) -> bool:
    if self.drain_flag is not None and self.drain_flag.is_set():
      self.drained = True
    return self.drained

  def _record_dead_letter(self, payload: str, error: str):
    from .. import telemetry

    self.dead_letters.append({"payload": payload, "error": error})
    telemetry.incr("dlq.promoted", 1)

  def insert(self, tasks: Iterable, total=None):
    del total  # accepted for call compatibility; local execution needs no count
    if self.parallel == 1:
      from ..pipeline import config as pipeline_config

      if pipeline_config.enabled(default=True):
        return self._insert_pipelined(tasks)
    payloads = (serialize(t) for t in iter_tasks(tasks))
    if self.parallel == 1:
      for payload in payloads:
        if self._draining():
          break
        self.inserted += 1
        if self.max_deliveries is None:
          _execute_payload(payload)
        else:
          _p, err = _execute_payload_contained(payload, self.max_deliveries)
          if err is not None:
            self._record_dead_letter(payload, err)
            continue
        self.completed += 1
      return
    from ..device import get_device

    ctx = mp.get_context("spawn")
    with ctx.Pool(
      self.parallel, initializer=_worker_init, initargs=(str(get_device()),)
    ) as pool:
      if self.max_deliveries is None:
        for _ in pool.imap_unordered(_execute_payload, payloads, chunksize=1):
          self.inserted += 1
          self.completed += 1
          if self._draining():
            break  # the pool's exit terminates; unconsumed payloads stay
        return
      runner = functools.partial(
        _execute_payload_contained, max_deliveries=self.max_deliveries
      )
      for payload, err in pool.imap_unordered(runner, payloads, chunksize=1):
        self.inserted += 1
        if err is not None:
          self._record_dead_letter(payload, err)
        else:
          self.completed += 1
        if self._draining():
          break

  def _insert_pipelined(self, tasks: Iterable):
    """``parallel=1`` insert through the staged pipeline, with the serial
    loop's semantics: tasks round-trip through the wire format,
    ``inserted`` and ``completed`` count the same way, a drain stops
    admission and finishes the work in flight, fail-fast raises the first
    failure after the uploads in flight have joined, and
    ``max_deliveries`` retries a failure solo before dead-lettering it."""
    from ..pipeline import run_tasks_pipelined

    def stream():
      for t in iter_tasks(tasks):
        payload = serialize(t)
        self.inserted += 1
        yield deserialize(payload)

    def on_complete(task):
      self.completed += 1

    on_error = None
    if self.max_deliveries is not None:
      def on_error(task, exc):
        payload = serialize(task)
        if self.max_deliveries <= 1:
          self._record_dead_letter(payload, failure_reason(exc))
          return
        # the pipelined attempt spent one delivery; the rest run solo
        _p, err = _execute_payload_contained(payload, self.max_deliveries - 1)
        if err is not None:
          self._record_dead_letter(payload, err)
        else:
          self.completed += 1

    self.pipeline_stats = run_tasks_pipelined(
      stream(), drain_flag=self.drain_flag,
      on_error=on_error, on_complete=on_complete,
    )
    if self.pipeline_stats["drained"]:
      self.drained = True
