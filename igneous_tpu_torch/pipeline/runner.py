"""The staged task runner: download(i+1) ∥ compute(i) ∥ encode/upload(i-1).

The port's own copy of ``igneous_tpu/pipeline/runner.py``. A task's wall
is storage and codec work wrapped around a much shorter kernel, so the
runner overlaps the three over a stream of tasks, for every task that
publishes a ``StagePlan``:

  prefetch pool ──> BoundedBuffer ──> compute (caller thread) ──> encode/
  (download+decode)  (byte budget)    (the card)                  upload pool

Rules the scheduler keeps:

  * **Bytes**: the stages call the code serial execution calls
    (``Volume.download``, the pooling kernels, ``Volume.upload`` through a
    sink); scheduling changes when bytes are made, never which.
  * **Order and the card**: compute runs in task order on the caller's
    thread, the only thread that touches the card (the launch counters
    are written there only). Prefetch threads run numpy and storage only.
  * **Write barriers**: a task that reads a (layer, mip) with writes in
    flight, or that publishes no plan, waits for every upload in flight.
    Two writers of one (layer, mip) also wait for each other unless both
    prove their writes chunk aligned: such writers touch disjoint chunk
    objects and keep pipelining.
  * **Completion**: a task counts as executed only once its upload ticket
    has joined; a failed put is that task's failure.
  * **Drain**: a set ``StopFlag`` stops admission, wakes every blocked
    stage wait, lets the uploads in flight finish and returns with
    ``drained=True``. Puts are atomic, so nothing half-written remains.

The reference's per-task trace spans (``trace.record_for_task``,
``trace.task_span``) belong to its observability plane, which the port
does not have; stage timers and counters go to ``telemetry``.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Iterable, Optional

from .. import chunk_cache, telemetry
from ..observability import trace
from . import config
from .buffers import BoundedBuffer, PipelineInterrupted
from .encoder import SerialSink, shared_encode_pool, shared_prefetch_pool


class StagePlan:
  """How one task splits into pipeline stages.

  ``download()`` → payload; ``compute(payload)`` → outputs;
  ``upload(outputs, sink)`` routes every chunk encode and put through
  ``sink`` (an ``UploadTicket`` when pipelined, ``SerialSink`` solo).
  ``reads`` and ``writes`` are sets of (layer path, mip) for the
  barriers; ``nbytes_hint`` is the decoded payload's size, which the
  byte budget reserves before the download starts.

  ``aligned_writes=True`` asserts that every write of the plan is chunk
  aligned or clipped at the volume's bounds, so that it may overlap other
  aligned writers of the same (layer path, mip). Leave it False unless
  alignment is proven.
  """

  __slots__ = (
    "download", "compute", "upload", "reads", "writes", "nbytes_hint",
    "aligned_writes",
  )

  def __init__(self, download, compute, upload, reads=(), writes=(),
               nbytes_hint: int = 0, aligned_writes: bool = False):
    self.download = download
    self.compute = compute
    self.upload = upload
    self.reads = frozenset(reads)
    self.writes = frozenset(writes)
    self.nbytes_hint = int(nbytes_hint)
    self.aligned_writes = bool(aligned_writes)


def stage_plan_of(task) -> Optional[StagePlan]:
  """A task's plan, or None: the task runs solo. Callers route a planning
  failure to the solo path, where the error surfaces with the task's
  own context."""
  planner = getattr(task, "stage_plan", None)
  if planner is None:
    return None
  return planner()


def _plan_or_none(task) -> Optional[StagePlan]:
  try:
    return stage_plan_of(task)
  except Exception:  # noqa: BLE001 - the solo path raises it again
    return None


class _Member:
  __slots__ = ("task", "plan", "future", "nbytes", "ticket", "t_admit")

  def __init__(self, task, plan):
    self.task = task
    self.plan = plan
    self.future = None
    self.nbytes = 0
    self.ticket = None
    self.t_admit = time.time()


def run_tasks_pipelined(
  tasks: Iterable,
  drain_flag=None,
  memory_target: Optional[int] = None,
  on_error: Optional[Callable] = None,
  on_complete: Optional[Callable] = None,
) -> dict:
  """Run a task stream through the staged pipeline.

  ``on_error(task, exc)``: when given, a failed task is reported there and
  the stream goes on (``LocalTaskQueue(max_deliveries=...)``); without it
  the first failure re-raises once the uploads in flight have joined.
  ``on_complete(task)``: called after a task's uploads joined.
  Returns ``{"executed", "staged", "solo", "failed", "drained"}``.
  """
  stats = {"executed": 0, "staged": 0, "solo": 0, "failed": 0, "drained": False}
  if not config.use_threads():
    return _run_tasks_inorder(tasks, stats, drain_flag, on_error, on_complete)
  io_pool = shared_prefetch_pool()
  encode_pool = shared_encode_pool()
  buffer = BoundedBuffer(
    config.memory_budget_bytes(memory_target=memory_target), name="prefetch"
  )
  if drain_flag is not None:
    buffer.interrupt(drain_flag)

  it = iter(tasks)
  lookahead: deque = deque()  # members admitted, in task order
  uploading: deque = deque()  # members whose ticket is outstanding
  pending_writes: dict = {}  # (path, mip) -> members uploading to it
  pending_rmw: dict = {}  # the part from plans without proven alignment

  def draining() -> bool:
    if drain_flag is not None and drain_flag.is_set():
      stats["drained"] = True
    return stats["drained"]

  def refcount_add(table, keys):
    for key in keys:
      table[key] = table.get(key, 0) + 1

  def refcount_remove(table, keys):
    for key in keys:
      n = table.get(key, 0) - 1
      if n <= 0:
        table.pop(key, None)
      else:
        table[key] = n

  def writes_add(member):
    refcount_add(pending_writes, member.plan.writes)
    if not member.plan.aligned_writes:
      refcount_add(pending_rmw, member.plan.writes)

  def writes_remove(member):
    refcount_remove(pending_writes, member.plan.writes)
    if not member.plan.aligned_writes:
      refcount_remove(pending_rmw, member.plan.writes)

  def join_member(member):
    """Join one member's uploads and count its completion or failure."""
    try:
      with telemetry.stage("pipeline.upload_join_s"):
        member.ticket.join()
    except Exception as e:  # noqa: BLE001 - routed to on_error or re-raised
      writes_remove(member)
      # a failed ticket may still have landed some chunk objects
      chunk_cache.invalidate_writes(member.plan.writes)
      buffer.release(member.nbytes)
      stats["failed"] += 1
      telemetry.incr("pipeline.tasks.failed", 1)
      if on_error is None:
        raise
      on_error(member.task, e)
      return
    writes_remove(member)
    chunk_cache.invalidate_writes(member.plan.writes)
    buffer.release(member.nbytes)
    stats["executed"] += 1
    stats["staged"] += 1
    # the task's span: admitted → every byte landed (the stage spans of
    # the observe() sites nest under the same execution root)
    trace.record_for_task(
      member.task, "task", member.t_admit,
      time.time() - member.t_admit, mode="pipelined",
    )
    if on_complete is not None:
      on_complete(member.task)

  def upload_barrier():
    while uploading:
      join_member(uploading.popleft())

  def fail_member(member, exc):
    stats["failed"] += 1
    telemetry.incr("pipeline.tasks.failed", 1)
    if on_error is None:
      raise exc
    on_error(member.task, exc)

  def submit_download(member):
    hint = member.plan.nbytes_hint
    member.nbytes = hint
    # the grant order is fixed here, on the caller's thread in task order,
    # so a younger download can never starve the one compute waits on
    seq = buffer.reserve_seq()
    ctx = trace.task_context(member.task)

    def work():
      # the prefetch thread runs under the member's trace, so its
      # download and stall spans are ITS task's
      with trace.activate(ctx):
        buffer.acquire(hint, seq=seq)
        try:
          t0 = time.perf_counter()
          payload = member.plan.download()
          telemetry.observe("pipeline.download.s", time.perf_counter() - t0)
          return payload
        except BaseException:
          buffer.release(hint)
          raise

    member.future = io_pool.submit(work)

  def conflicts(member) -> bool:
    if member.plan is None:
      return True
    if any(key in pending_writes for key in member.plan.reads):
      return True
    # a writer that cannot prove alignment must not overlap any writer of
    # the same (path, mip), and no writer may overlap such a one
    if any(key in pending_rmw for key in member.plan.writes):
      return True
    if not member.plan.aligned_writes:
      return any(key in pending_writes for key in member.plan.writes)
    return False

  try:
    depth = config.prefetch_depth()
    done = False
    while not done or lookahead:
      if draining():
        break
      # keep up to `depth` downloads in flight; admission stops at the
      # first task that must wait at a barrier
      while not done and len(lookahead) < depth + 1:
        if lookahead and (
          lookahead[-1].plan is None or lookahead[-1].future is None
        ):
          break
        try:
          task = next(it)
        except StopIteration:
          done = True
          break
        member = _Member(task, _plan_or_none(task))
        lookahead.append(member)
        if member.plan is not None and not conflicts(member):
          writes_add(member)
          submit_download(member)

      if not lookahead:
        break

      member = lookahead.popleft()

      if member.plan is None:
        # solo: a full barrier, since it may read or write anything
        upload_barrier()
        if draining():
          break
        try:
          with trace.task_span(member.task, mode="solo"):
            member.task.execute()
        except Exception as e:  # noqa: BLE001
          fail_member(member, e)
        else:
          stats["executed"] += 1
          stats["solo"] += 1
          if on_complete is not None:
            on_complete(member.task)
        continue

      if member.future is None:
        # admitted with a conflict: the barrier, then its download
        upload_barrier()
        if draining():
          break
        writes_add(member)
        submit_download(member)

      # at most `depth` tickets ride along
      while len(uploading) > depth:
        join_member(uploading.popleft())

      try:
        with telemetry.stage("pipeline.download_wait_s"):
          payload = member.future.result()
      except PipelineInterrupted:
        writes_remove(member)
        break
      except Exception as e:  # noqa: BLE001
        writes_remove(member)
        fail_member(member, e)
        continue

      try:
        with trace.activate(trace.task_context(member.task)):
          t0 = time.perf_counter()
          outputs = member.plan.compute(payload)
          telemetry.observe("pipeline.compute.s", time.perf_counter() - t0)
          member.ticket = encode_pool.ticket()
          t0 = time.perf_counter()
          member.plan.upload(outputs, member.ticket)
          telemetry.observe("pipeline.upload_submit.s", time.perf_counter() - t0)
      except Exception as e:  # noqa: BLE001
        if member.ticket is not None:
          try:
            member.ticket.join()
          except Exception:  # noqa: BLE001 - the first error wins
            pass
        writes_remove(member)
        buffer.release(member.nbytes)
        fail_member(member, e)
        continue

      # the upload closures keep the payload alive (chunk cutouts are views
      # of it), so its whole reservation stays held until the ticket joins
      uploading.append(member)

  finally:
    # the drain and the normal exit share one join: every submitted upload
    # lands or becomes its member's failure; no thread writes after return
    drain_error = None
    while uploading:
      try:
        join_member(uploading.popleft())
      except Exception as e:  # noqa: BLE001
        if drain_error is None:
          drain_error = e
    # abandoned prefetches: wait for each to settle, then free its budget
    for member in lookahead:
      if member.future is not None:
        try:
          member.future.result()
          buffer.release(member.nbytes)
        except Exception:  # noqa: BLE001 - the task never ran; no failure
          pass
        writes_remove(member)
    if drain_error is not None:
      raise drain_error

  return stats


def _run_tasks_inorder(tasks, stats, drain_flag, on_error, on_complete) -> dict:
  """The one-core mode: the same stage plans, in order, on a serial sink.
  With no threads to stall, its stage times are pure work."""
  sink = SerialSink()
  for task in tasks:
    if drain_flag is not None and drain_flag.is_set():
      stats["drained"] = True
      break
    plan = _plan_or_none(task)
    try:
      with trace.task_span(task, mode="inorder"):
        if plan is None:
          task.execute()
          stats["solo"] += 1
        else:
          t0 = time.perf_counter()
          payload = plan.download()
          t1 = time.perf_counter()
          telemetry.observe("pipeline.download.s", t1 - t0)
          outputs = plan.compute(payload)
          t2 = time.perf_counter()
          telemetry.observe("pipeline.compute.s", t2 - t1)
          plan.upload(outputs, sink)
          telemetry.observe("pipeline.upload_submit.s", time.perf_counter() - t2)
          stats["staged"] += 1
    except Exception as e:  # noqa: BLE001
      stats["failed"] += 1
      telemetry.incr("pipeline.tasks.failed", 1)
      if on_error is None:
        raise
      on_error(task, e)
      continue
    stats["executed"] += 1
    if on_complete is not None:
      on_complete(task)
  return stats


def execute_with_sink(task) -> None:
  """A solo task's chunk encodes and puts on the shared pool, joined
  before it returns, when ``IGNEOUS_PIPELINE`` is on; else ``execute()``."""
  plan = stage_plan_of(task)
  if plan is None or not config.enabled(default=False) or not config.use_threads():
    task.execute()
    return
  ticket = shared_encode_pool().ticket()
  t0 = time.perf_counter()
  payload = plan.download()
  t1 = time.perf_counter()
  telemetry.observe("pipeline.download.s", t1 - t0)
  outputs = plan.compute(payload)
  t2 = time.perf_counter()
  telemetry.observe("pipeline.compute.s", t2 - t1)
  try:
    plan.upload(outputs, ticket)
    telemetry.observe("pipeline.upload_submit.s", time.perf_counter() - t2)
  finally:
    ticket.join()
