"""In-process / multi-process task execution.

``LocalTaskQueue`` mirrors ``igneous_tpu/queues/local.py``: inserting tasks
executes them at once, each round-tripped through the JSON wire format,
optionally across N spawned worker processes. Spawn, never fork: a forked
child of a process that has initialised CUDA cannot use the device. Each
spawned worker opens its own CUDA context and loads the kernels again, so
one worker per card is the rule on a GPU.
"""

from __future__ import annotations

import multiprocessing as mp
from typing import Iterable

from .registry import deserialize, serialize


def _execute_payload(payload: str) -> bool:
  deserialize(payload).execute()
  return True


def _worker_init(device: str) -> None:
  from ..device import set_device

  set_device(device)


class LocalTaskQueue:
  """Executes tasks on insert; parallel > 1 uses a spawn process pool."""

  def __init__(self, parallel: int = 1):
    self.parallel = max(int(parallel), 1)
    self.inserted = 0
    self.completed = 0

  def insert(self, tasks: Iterable, total=None):
    del total  # accepted for call compatibility; local execution needs no count
    payloads = (serialize(t) for t in self._iter(tasks))
    if self.parallel == 1:
      for payload in payloads:
        self.inserted += 1
        _execute_payload(payload)
        self.completed += 1
      return
    from ..device import get_device

    ctx = mp.get_context("spawn")
    with ctx.Pool(
      self.parallel, initializer=_worker_init, initargs=(str(get_device()),)
    ) as pool:
      for _ in pool.imap_unordered(_execute_payload, payloads, chunksize=1):
        self.inserted += 1
        self.completed += 1

  @staticmethod
  def _iter(tasks):
    if hasattr(tasks, "__iter__") and not isinstance(tasks, (str, bytes, dict)):
      return iter(tasks)
    return iter([tasks])
