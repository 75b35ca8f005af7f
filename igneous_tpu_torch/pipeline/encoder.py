"""Parallel chunk encode/upload with deterministic bytes.

The port's own copy of ``igneous_tpu/pipeline/encoder.py``'s
``UploadTicket``, ``EncodePool``, ``SerialSink``, ``shared_encode_pool``,
``shared_io_pool`` and ``shared_prefetch_pool``. Each chunk is encoded and
compressed independently (gzip with ``mtime=0``), so the bytes of every
stored object are a function of its voxels alone: the pool's width and
scheduling change which object lands first, never what lands.

Work is grouped under tickets. A caller joins its ticket before it reports
success, and a failed put re-raises at the join. The widths come from
``pipeline/config.py``: ``IGNEOUS_PIPELINE_ENCODE_THREADS`` encode threads
(default ``min(8, cores)``), ``IGNEOUS_PIPELINE_IO_THREADS`` chunk get/put
threads (default ``min(8, 2 * cores)``), and as many prefetch threads, or
``IGNEOUS_PIPELINE_PREFETCH`` where that is more.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
import time
from typing import Callable, List, Optional

from .. import telemetry
from ..observability import trace
from . import config


class UploadTicket:
  """Tracks the in-flight uploads of one task (or one batch)."""

  def __init__(self, pool: "EncodePool"):
    self._pool = pool
    self._lock = threading.Lock()
    self._futures: List[cf.Future] = []  # guarded-by: self._lock

  def submit(self, fn: Callable[[], None]) -> None:
    # the submitting thread's trace context rides onto the pool thread:
    # the chunk's encode and put (and its storage spans) stay its task's
    ctx = trace.current()
    sampled = ctx is not None and ctx.sampled

    def timed():
      # thread-seconds of encode + put, summed over the pool's threads
      with telemetry.stage("encode_upload"):
        if not sampled:
          fn()
          return
        with trace.activate(ctx):
          t0 = time.perf_counter()
          try:
            fn()
          finally:
            telemetry.observe("pipeline.encode_upload.s", time.perf_counter() - t0)

    fut = self._pool._submit(timed)
    with self._lock:
      self._futures.append(fut)

  def join(self) -> None:
    """Wait for every upload of this ticket; re-raise the first failure
    after letting the rest finish, so no thread still writes while the
    caller unwinds."""
    with self._lock:
      futures, self._futures = self._futures, []
    first_error = None
    for fut in futures:
      try:
        fut.result()
      except BaseException as e:  # noqa: BLE001 - re-raised below
        if first_error is None:
          first_error = e
    if first_error is not None:
      raise first_error


class EncodePool:
  """Persistent encode/upload worker pool (one a process:
  ``shared_encode_pool``)."""

  def __init__(self):
    self._ex = cf.ThreadPoolExecutor(
      max_workers=config.encode_threads(), thread_name_prefix="igt-pipeline-encode"
    )

  def _submit(self, fn) -> cf.Future:
    return self._ex.submit(fn)

  def ticket(self) -> UploadTicket:
    return UploadTicket(self)


class SerialSink:
  """The sink of a synchronous caller: submit runs at once. It keeps the
  upload code the same for pipelined and serial execution."""

  def submit(self, fn: Callable[[], None]) -> None:
    fn()

  def join(self) -> None:
    pass


_SHARED: Optional[EncodePool] = None
_SHARED_IO: Optional[cf.ThreadPoolExecutor] = None
_SHARED_PREFETCH: Optional[cf.ThreadPoolExecutor] = None
_SHARED_LOCK = threading.Lock()


def shared_encode_pool() -> EncodePool:
  global _SHARED
  with _SHARED_LOCK:
    if _SHARED is None:
      _SHARED = EncodePool()
    return _SHARED


def shared_io_pool() -> cf.ThreadPoolExecutor:
  """Threads for single chunk gets and puts (the passthrough transfer's
  stored-byte reads)."""
  global _SHARED_IO
  with _SHARED_LOCK:
    if _SHARED_IO is None:
      _SHARED_IO = cf.ThreadPoolExecutor(
        max_workers=config.io_threads(), thread_name_prefix="igt-pipeline-io"
      )
    return _SHARED_IO


def shared_prefetch_pool() -> cf.ThreadPoolExecutor:
  """Threads for whole-cutout downloads, apart from ``shared_io_pool``: a
  cutout download fans its chunk reads out to threads of its own, so
  these never wait on themselves."""
  global _SHARED_PREFETCH
  with _SHARED_LOCK:
    if _SHARED_PREFETCH is None:
      _SHARED_PREFETCH = cf.ThreadPoolExecutor(
        max_workers=max(config.io_threads(), config.prefetch_depth()),
        thread_name_prefix="igt-pipeline-prefetch",
      )
    return _SHARED_PREFETCH
