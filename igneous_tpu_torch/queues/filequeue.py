"""Lease-based filesystem task queue (``fq://``).

The port's own copy of ``igneous_tpu/queues/filequeue.py``, file for file
compatible with it: a queue written by either package is leased, renewed,
acked, nacked, dead-lettered and repaired by the other's. At-least-once
delivery with a visibility timeout: a leased task that is not deleted
within its lease returns to the pool; workers pick a random task among
the first 100 to avoid lease contention; completions are tallied 1 byte
per task. All state is plain files, so any shared POSIX filesystem works
as the control plane across machines.

Layout under the queue directory:

* ``queue/`` pending tasks: classic ``<uuid>.json`` files (one payload
  each) and segments ``seg_<segid>_<count>.jsonl`` (one
  ``<index>\\t<payload>`` line per task, written by ``insert_batch``);
* ``leased/`` the same files renamed ``<deadline>--<name>``;
* ``meta/<name>`` per-task (per-segid for segments) delivery count and
  the last failure reasons;
* ``dlq/`` tasks that exhausted ``max_deliveries`` (segments expand into
  one ``task_<segid>_<index>.json`` per member);
* ``insertions`` and ``completions`` one byte per task;
* ``spec/`` straggler speculation: ``pair_<segid>.json`` per speculated
  range, ``done_<pair>_<index>`` first-resolution markers (O_EXCL) and
  ``side_<pair>_<segid>`` lineage markers of its splits; the twin's and
  the original's meta carry ``spec`` (``{"pair", "side"}``);
  ``speculation_won`` and ``speculation_fenced`` one byte per index;
* ``steal/<segid>.claim`` a thief's claim on a held range, serviced by
  the holder's next renewal.

A segment leases as ONE :class:`~.ranges.RangeLease` whose members ack,
nack, release and renew one by one (``ranges``). ``spec/`` and ``steal/``
exist only once something speculated or stole, so a queue that never did
keeps the plain layout.
"""

from __future__ import annotations

import json
import os
import random
import re
import time
import uuid
from typing import Dict, Iterable, List, Optional, Tuple

from .. import telemetry
from .. import secrets as knobs
from ..secrets import env_number
from .ranges import RangeLease, RangeSub
from .registry import RegisteredTask, deserialize, serialize

LEASE_SEP = "--"
CONTENTION_WINDOW = 100
MAX_RECORDED_FAILURES = 5  # per-task failure-reason ring (meta file bound)

SEG_PREFIX = "seg_"
SEG_SUFFIX = ".jsonl"
DEFAULT_QUEUE_SHARDS = 16
DEFAULT_SEG_TASKS = 1024
DEFAULT_RECYCLE_SEC = 5.0
DEFAULT_SPECULATE_MIN_TASKS = 1
DEFAULT_SPECULATE_MAX_TWINS = 4
DEFAULT_SPECULATE_MIN_HELD_SEC = 0.0
DEFAULT_STEAL_MIN_TASKS = 2
DEFAULT_STEAL_MIN_HELD_SEC = 2.0
DEFAULT_STEAL_FRACTION = 0.5
DEFAULT_STEAL_CLAIM_TTL_SEC = 300.0

# mid-range failures and DLQ expansions carve per-index classic files
_CARVE_RE = re.compile(r"^task_([0-9a-f]+)_(\d+)\.json$")


def seg_parse(name: str) -> Optional[Tuple[str, int]]:
  """``seg_<segid>_<count>.jsonl`` → (segid, count); None for classic
  per-task file names. The count in the NAME is the task count in the
  file (maintained across ack rewrites), so depth reads never open
  segment files."""
  if not name.startswith(SEG_PREFIX) or not name.endswith(SEG_SUFFIX):
    return None
  parts = name[len(SEG_PREFIX):-len(SEG_SUFFIX)].rsplit("_", 1)
  if len(parts) != 2:
    return None
  try:
    return parts[0], int(parts[1])
  except ValueError:
    return None


def seg_name(segid: str, count: int) -> str:
  return f"{SEG_PREFIX}{segid}_{int(count)}{SEG_SUFFIX}"


def _name_tasks(name: str) -> int:
  """Tasks a queue/lease file name represents (lease prefixes allowed)."""
  parsed = seg_parse(name.split(LEASE_SEP, 1)[-1])
  return parsed[1] if parsed else 1


def _seg_content(entries) -> str:
  return "".join(f"{int(i)}\t{p}\n" for i, p in entries)


class TaskDeadlineError(Exception):
  """A task overran its per-delivery wall-clock deadline (poll_loop)."""


class StaleLeaseError(Exception):
  """The lease behind a renew/delete no longer belongs to this worker: it
  expired, or the queue re-issued the task to someone else. The worker is
  a *zombie* for that task and must stop acting on it (tasks are
  idempotent; the current owner completes it)."""


def iter_tasks(tasks):
  """Normalize an insert() argument to an iterator of single tasks.
  Strings/bytes/dicts are single payloads, not collections."""
  if hasattr(tasks, "__iter__") and not isinstance(tasks, (str, bytes, dict)):
    return iter(tasks)
  return iter([tasks])


def failure_reason(exc: BaseException) -> str:
  """The one-line failure record shared by every containment path
  (poll_loop, the lease batcher, LocalTaskQueue), so dead letters read
  alike."""
  msg = str(exc)
  return f"{type(exc).__name__}: {msg}" if msg else type(exc).__name__


def run_with_deadline(fn, deadline_seconds: Optional[float]):
  """Run ``fn()`` with a wall-clock deadline. On overrun, raises
  TaskDeadlineError so the caller's failure bookkeeping (nack → DLQ)
  takes over. The overrunning call keeps executing on an abandoned
  daemon thread (it cannot be killed safely), which is sound because
  tasks are idempotent and the lease it held stays failed."""
  if not deadline_seconds or deadline_seconds <= 0:
    return fn()
  import threading

  result = {}

  def body():
    try:
      result["value"] = fn()
    except BaseException as e:  # noqa: BLE001 - relayed to the caller
      result["error"] = e

  t = threading.Thread(target=body, daemon=True)
  t.start()
  t.join(deadline_seconds)
  if t.is_alive():
    raise TaskDeadlineError(
      f"task exceeded its {deadline_seconds:.1f}s deadline"
    )
  if "error" in result:
    raise result["error"]
  return result.get("value")


def poll_loop(
  queue,
  lease_seconds: float = 600,
  verbose: bool = False,
  stop_fn=None,
  max_backoff_window: float = 30.0,
  before_fn=None,
  after_fn=None,
  task_deadline_seconds: Optional[float] = None,
  heartbeat_seconds: Optional[float] = None,
  drain_flag=None,
):
  """The worker loop of every queue backend: lease → execute → delete
  until ``stop_fn`` says stop (``stop_fn=None`` polls forever, sleeping
  with bounded backoff when empty).

  A task that raises (or overruns ``task_deadline_seconds``) is nacked
  with its reason where the backend supports it, which feeds the
  delivery bookkeeping that moves repeat offenders to the DLQ; otherwise
  its lease recycles on the visibility timeout. A heartbeat renews the
  held lease every ``heartbeat_seconds`` (default lease/3,
  ``IGNEOUS_HEARTBEAT_SEC``; <= 0 disables), so long tasks outlive a
  short lease without running twice. ``drain_flag`` (anything with
  ``is_set()``): the task in flight finishes and no new lease is taken.

  Each task runs through ``pipeline.execute_with_sink``: with
  ``IGNEOUS_PIPELINE=1`` its chunk encodes and puts thread on the shared
  pool, joined before the lease is deleted.

  Each delivery runs inside ``trace.task_span`` (its queue wait, attempt
  and the spans of its stages, storage and device work, under the
  payload's trace). The active journal flushes between tasks on its
  interval or a drain request, and once more whenever the loop ends."""
  from ..observability import journal as journal_mod
  from ..observability import trace
  from ..pipeline import execute_with_sink
  from .heartbeat import LeaseHeartbeat

  def draining() -> bool:
    return drain_flag is not None and drain_flag.is_set()

  def attempt_of(lease_id) -> Optional[int]:
    # fq:// persists delivery counts; SQS reports ApproximateReceiveCount
    try:
      if hasattr(queue, "delivery_count"):
        return int(queue.delivery_count(lease_id))
      if getattr(queue, "last_receive_count", 0):
        return int(queue.last_receive_count)
    except Exception:
      pass
    return None

  def idle(seconds: float):
    # wake early when a drain request lands mid-backoff
    if drain_flag is not None and hasattr(drain_flag, "wait"):
      drain_flag.wait(seconds)
    else:
      time.sleep(seconds)

  backoff = 1.0
  executed = 0
  try:
   with LeaseHeartbeat(queue, lease_seconds, interval=heartbeat_seconds) as hb:
    while True:
      # the interval's or a drain request's flush, between tasks: the
      # poll loop is the worker's main thread, so no flusher thread
      journal_mod.maybe_flush_active()
      if draining():
        return executed
      if stop_fn is not None and stop_fn(executed=executed, empty=False):
        return executed
      leased = queue.lease(lease_seconds)
      if leased is None:
        if stop_fn is not None and stop_fn(executed=executed, empty=True):
          return executed
        if draining():
          return executed
        idle(backoff + random.random())
        backoff = min(backoff * 2, max_backoff_window)
        continue
      backoff = 1.0
      task, lease_id = leased
      if isinstance(lease_id, RangeSub):
        # stealing carves only UNSTARTED members; this one is in flight
        lease_id.mark_started()
      key = hb.track(lease_id)
      if verbose:
        print(f"Executing {task!r}")
      try:
        if before_fn:
          before_fn(task)
        with trace.task_span(task, attempt=attempt_of(lease_id),
                             queue=type(queue).__name__):
          run_with_deadline(lambda: execute_with_sink(task), task_deadline_seconds)
        if after_fn:
          after_fn(task)
      except Exception as e:
        # the lease stays: the task recycles after its timeout
        # (at-least-once); nack records the reason and dead-letters an
        # exhausted task
        if verbose:
          import traceback

          traceback.print_exc()
        telemetry.incr("tasks.failed", 1)
        current = hb.untrack(key)
        if hasattr(queue, "nack"):
          queue.nack(current, failure_reason(e))
        continue
      # untrack returns the CURRENT token (renewals re-timestamp fq://
      # lease names); delete is fenced against stale tokens, so a
      # zombie's late ack never completes a re-issued task
      queue.delete(hb.untrack(key))
      executed += 1
  finally:
    # whatever ends the loop, the pending span batch lands
    journal_mod.flush_active(event="drain" if draining() else "poll_exit")


class FileQueue:
  def __init__(self, path: str, max_deliveries: Optional[int] = None,
               worker_id: Optional[str] = None):
    """``max_deliveries``: after this many deliveries (leases), a task
    that fails again is quarantined in ``dlq/`` instead of recycling.
    None (default) retries forever. ``worker_id`` names this consumer in
    segment lease metadata (``holder``); default ``<host>-<pid>``."""
    if path.startswith("fq://"):
      path = path[len("fq://"):]
    self.path = os.path.abspath(os.path.expanduser(path))
    self.queue_dir = os.path.join(self.path, "queue")
    self.lease_dir = os.path.join(self.path, "leased")
    self.dlq_dir = os.path.join(self.path, "dlq")
    self.meta_dir = os.path.join(self.path, "meta")
    # the survival sidecars, made at their first use
    self.spec_dir = os.path.join(self.path, "spec")
    self.steal_dir = os.path.join(self.path, "steal")
    self._worker_id = worker_id
    self.max_deliveries = (
      None if not max_deliveries or int(max_deliveries) <= 0
      else int(max_deliveries)
    )
    for d in (self.queue_dir, self.lease_dir, self.dlq_dir, self.meta_dir):
      os.makedirs(d, exist_ok=True)
    # cached pending index (lease picks from here instead of a listdir
    # per acquisition) and the recycle-scan throttle
    self._pending_cache: Optional[List[str]] = None
    self._last_recycle = 0.0

  @property
  def worker_id(self) -> str:
    if self._worker_id is None:
      # the journal's worker id, so the health plane's flags name holders
      from ..observability.journal import default_worker_id

      self._worker_id = default_worker_id()
    return self._worker_id

  # -- per-task attempt metadata --------------------------------------------

  def _meta_path(self, name: str) -> str:
    return os.path.join(self.meta_dir, name)

  @staticmethod
  def _meta_key(name_or_lease: str) -> str:
    """Meta file key for a queue/lease/dlq name. Segments key on the
    segid (``seg_<segid>``) so ack rewrites, which change the count in
    the file name, never orphan the delivery-count record."""
    name = str(name_or_lease).split(LEASE_SEP, 1)[-1]
    parsed = seg_parse(name)
    return f"{SEG_PREFIX}{parsed[0]}" if parsed else name

  def _read_meta(self, name: str) -> dict:
    try:
      with open(self._meta_path(name)) as f:
        return json.load(f)
    except (FileNotFoundError, ValueError):
      return {"deliveries": 0, "failures": []}

  def _write_meta(self, name: str, meta: dict):
    tmp = os.path.join(self.path, f".tmp-meta-{uuid.uuid4().hex}")
    try:
      with open(tmp, "w") as f:
        json.dump(meta, f)
      os.replace(tmp, self._meta_path(name))
    except BaseException:
      # a failed write must not leave .tmp-* files next to the counters
      try:
        os.remove(tmp)
      except FileNotFoundError:
        pass
      raise

  def _drop_meta(self, name: str):
    try:
      os.remove(self._meta_path(name))
    except FileNotFoundError:
      pass

  def _record_failure(self, name: str, reason: str) -> dict:
    meta = self._read_meta(name)
    meta.setdefault("failures", []).append({
      "time": time.time(), "error": str(reason)[:2000],
    })
    meta["failures"] = meta["failures"][-MAX_RECORDED_FAILURES:]
    self._write_meta(name, meta)
    return meta

  def delivery_count(self, name_or_lease) -> int:
    """Deliveries so far of a task (by queue file name, lease id or range
    member): the fq:// analogue of SQS's ApproximateReceiveCount. Range
    members report their segment's count until a failure carves them out."""
    if isinstance(name_or_lease, RangeSub):
      key = f"{SEG_PREFIX}{name_or_lease.parent.segid}"
    else:
      key = self._meta_key(name_or_lease)
    return int(self._read_meta(key).get("deliveries", 0))

  def _exhausted(self, name: str) -> bool:
    return (
      self.max_deliveries is not None
      and self.delivery_count(name) >= self.max_deliveries
    )

  # -- dead-letter queue ----------------------------------------------------

  def _quarantine_to_dlq(self, src_path: str, name: str, reason: str):
    """Move a task file into dlq/. The meta file stays: it holds the
    delivery count and failure reasons that ``dlq_ls`` reports."""
    self._record_failure(name, reason)
    try:
      os.rename(src_path, os.path.join(self.dlq_dir, name))
    except FileNotFoundError:
      return  # another worker moved it first
    telemetry.incr("dlq.promoted", 1)

  @property
  def dlq_count(self) -> int:
    return len(os.listdir(self.dlq_dir))

  def dlq_ls(self) -> List[dict]:
    """One record per quarantined task: name, payload (JSON string),
    delivery count, and the recorded failure reasons (newest last)."""
    out = []
    for name in sorted(os.listdir(self.dlq_dir)):
      try:
        with open(os.path.join(self.dlq_dir, name)) as f:
          payload = f.read()
      except FileNotFoundError:
        continue
      meta = self._read_meta(name)
      out.append({
        "name": name,
        "payload": payload,
        "deliveries": int(meta.get("deliveries", 0)),
        "failures": meta.get("failures", []),
      })
    return out

  def dlq_retry(self, names: Optional[Iterable[str]] = None) -> int:
    """Return quarantined tasks to rotation (all, or just ``names``) with
    their delivery counts reset to a fresh budget."""
    if names is None:
      names = sorted(os.listdir(self.dlq_dir))
    n = 0
    for name in names:
      src = os.path.join(self.dlq_dir, name)
      try:
        os.rename(src, os.path.join(self.queue_dir, name))
      except FileNotFoundError:
        continue
      meta = self._read_meta(name)
      meta["deliveries"] = 0
      self._write_meta(name, meta)
      n += 1
    self._pending_cache = None
    return n

  def dlq_purge(self) -> int:
    """Drop all quarantined tasks (and their metadata). Irreversible."""
    n = 0
    for name in list(os.listdir(self.dlq_dir)):
      try:
        os.remove(os.path.join(self.dlq_dir, name))
        n += 1
      except FileNotFoundError:
        continue
      finally:
        self._drop_meta(name)
    return n

  # -- counters -------------------------------------------------------------

  def _tally(self, counter: str, n: int = 1):
    with open(os.path.join(self.path, counter), "ab") as f:
      f.write(b"\x01" * n)

  def _count(self, counter: str) -> int:
    try:
      return os.path.getsize(os.path.join(self.path, counter))
    except FileNotFoundError:
      return 0

  @property
  def inserted(self) -> int:
    return self._count("insertions")

  @property
  def completed(self) -> int:
    return self._count("completions")

  @property
  def speculation_won(self) -> int:
    """Crash-safe count of pair indices the TWIN resolved first."""
    return self._count("speculation_won")

  @property
  def speculation_fenced(self) -> int:
    """Crash-safe count of pair indices the ORIGINAL resolved first."""
    return self._count("speculation_fenced")

  @property
  def enqueued(self) -> int:
    """Tasks in rotation (queued + leased), read from file names only."""
    return (
      sum(_name_tasks(n) for n in os.listdir(self.queue_dir))
      + sum(_name_tasks(n) for n in os.listdir(self.lease_dir))
    )

  @property
  def leased(self) -> int:
    return sum(_name_tasks(n) for n in os.listdir(self.lease_dir))

  @property
  def queue_files(self) -> int:
    """Files backing the pending pool: O(shards) for a batch insert."""
    return len(os.listdir(self.queue_dir))

  def lease_ages(self) -> List[float]:
    """Seconds until each outstanding lease expires (negative = overdue,
    recycled on the next poll)."""
    now = time.time()
    out = []
    for name in os.listdir(self.lease_dir):
      try:
        out.append(float(name.split(LEASE_SEP, 1)[0]) - now)
      except ValueError:
        continue
    return sorted(out)

  @property
  def stale_leases(self) -> int:
    """Leases past expiry that no poll has recycled yet."""
    return sum(1 for age in self.lease_ages() if age < 0)

  @property
  def backlog(self) -> int:
    """Work remaining (queued + leased, DLQ excluded)."""
    return self.enqueued

  def depth_snapshot(self) -> dict:
    leased = self.leased
    return {
      "inserted": self.inserted,
      "enqueued": self.enqueued,
      "leased": leased,
      "completed": self.completed,
      "backlog": self.backlog,
      "dlq": self.dlq_count,
      "stale_leases": self.stale_leases,
    }

  def reset_deliveries(self) -> int:
    """Zero the delivery count of every task still in rotation, so a
    ``max_deliveries`` budget starts fresh. DLQ'd tasks keep theirs
    (``dlq_retry`` grants fresh budgets)."""
    n = 0
    quarantined = set(os.listdir(self.dlq_dir))
    for name in list(os.listdir(self.meta_dir)):
      if name in quarantined:
        continue
      meta = self._read_meta(name)
      if not meta.get("deliveries"):
        continue
      meta["deliveries"] = 0
      self._write_meta(name, meta)
      n += 1
    return n

  def fsck(self, repair: bool = False) -> dict:
    """Consistency audit: undeserializable task files (the check lease()
    applies), unparseable lease names, counter drift. With repair=True,
    malformed files move to ``<queue>/quarantine/`` and bad-name leases
    with valid payloads recycle into the queue."""
    problems = {"malformed_tasks": [], "bad_lease_names": [],
                "counter_drift": (self.inserted - self.completed
                                  - self.enqueued - self.dlq_count)}
    quarantine_dir = os.path.join(self.path, "quarantine")

    def payload_ok(path: str):
      """None if a worker raced us; else (valid, contents)."""
      try:
        with open(path) as f:
          contents = f.read()
      except FileNotFoundError:
        return None
      try:
        deserialize(contents)
        return (True, contents)
      except Exception:
        return (False, contents)

    def quarantine(path: str, name: str):
      os.makedirs(quarantine_dir, exist_ok=True)
      try:
        os.rename(path, os.path.join(quarantine_dir, name))
      except FileNotFoundError:
        pass

    def segment_ok(path: str, count: int):
      """None if raced; else whether every line deserializes and the
      task count in the name matches the file."""
      try:
        entries = self._read_segment(path)
      except FileNotFoundError:
        return None
      except Exception:
        return False
      if len(entries) != count:
        return False
      try:
        for _i, p in entries:
          deserialize(p)
      except Exception:
        return False
      return True

    for name in list(os.listdir(self.queue_dir)):
      path = os.path.join(self.queue_dir, name)
      parsed = seg_parse(name)
      if parsed is not None:
        ok = segment_ok(path, parsed[1])
        if ok is None or ok:
          continue
      else:
        result = payload_ok(path)
        if result is None or result[0]:
          continue
      problems["malformed_tasks"].append(name)
      if repair:
        quarantine(path, name)

    for name in list(os.listdir(self.lease_dir)):
      try:
        float(name.split(LEASE_SEP, 1)[0])
        continue
      except ValueError:
        pass
      problems["bad_lease_names"].append(name)
      if repair:
        path = os.path.join(self.lease_dir, name)
        result = payload_ok(path)
        if result is not None and result[0]:
          try:
            os.rename(path, os.path.join(self.queue_dir, name))
          except FileNotFoundError:
            pass
        elif result is not None:
          quarantine(path, name)
    return problems

  def is_empty(self) -> bool:
    return self.enqueued == 0

  def rezero(self):
    for counter in ("insertions", "completions"):
      try:
        os.remove(os.path.join(self.path, counter))
      except FileNotFoundError:
        pass

  # -- segment I/O ----------------------------------------------------------

  def _write_file(self, dirpath: str, name: str, content: str):
    """tmp-write + atomic rename; a failed write leaves no tmp file."""
    tmp = os.path.join(self.path, f".tmp-{uuid.uuid4().hex}")
    try:
      with open(tmp, "w") as f:
        f.write(content)
      os.replace(tmp, os.path.join(dirpath, name))
    except BaseException:
      try:
        os.remove(tmp)
      except FileNotFoundError:
        pass
      raise

  @staticmethod
  def _read_segment(path: str) -> List[Tuple[int, str]]:
    """Segment file → [(task_index, payload)]. Raises FileNotFoundError
    on lease races; malformed lines raise ValueError for fsck."""
    entries = []
    with open(path) as f:
      for line in f:
        line = line.rstrip("\n")
        if not line:
          continue
        idx, payload = line.split("\t", 1)
        entries.append((int(idx), payload))
    return entries

  def _copy_meta(self, src_segid: str, dst_segid: str):
    """A split inherits its parent segment's attempt record, so per-task
    DLQ attribution survives any number of splits. Pair membership rides
    along too: a twin's tail split off at the batch cap (or a stolen or
    released remainder) must still route its acks through the
    first-resolution markers, else both copies of an index would tally.
    Holder identity does not copy: the split lands pending."""
    meta = self._read_meta(f"{SEG_PREFIX}{src_segid}")
    meta.pop("holder", None)
    meta.pop("leased_at", None)
    if not meta.get("spec") and self._spec_active():
      spec = self._spec_of(src_segid)   # heals a clobbered orig meta
      if spec is not None:
        meta["spec"] = spec
    if meta.get("deliveries") or meta.get("failures") or meta.get("spec"):
      self._write_meta(f"{SEG_PREFIX}{dst_segid}", meta)
    spec = meta.get("spec")
    if isinstance(spec, dict) and spec.get("pair"):
      # lineage marker: the pair's done markers must outlive this
      # descendant, or a lingering copy would tally again after GC
      try:
        fd = os.open(
          self._spec_path(f"side_{spec['pair']}_{dst_segid}"),
          os.O_CREAT | os.O_WRONLY,
        )
        os.close(fd)
      except OSError:
        pass

  # -- producer -------------------------------------------------------------

  def insert(self, tasks: Iterable, total: Optional[int] = None):
    """Classic one-file-per-task insert."""
    del total
    n = 0
    for task in iter_tasks(tasks):
      payload = serialize(task)
      name = f"{uuid.uuid4().hex}.json"
      tmp = os.path.join(self.path, f".tmp-{name}")
      try:
        with open(tmp, "w") as f:
          f.write(payload)
        os.replace(tmp, os.path.join(self.queue_dir, name))
      except BaseException:
        try:
          os.remove(tmp)
        except FileNotFoundError:
          pass
        raise
      n += 1
    self._tally("insertions", n)
    self._pending_cache = None
    return n

  def insert_batch(self, tasks: Iterable, total: Optional[int] = None):
    """Segment insert: tasks land in files of up to
    ``IGNEOUS_QUEUE_SEG_TASKS`` (1024) tasks each. A known ``total``
    sizes segments so the batch spreads over ``IGNEOUS_QUEUE_SHARDS``
    (16) files; unknown totals stream at the cap.
    ``IGNEOUS_QUEUE_SEG_TASKS=0`` falls back to the classic layout."""
    seg_cap = env_number("IGNEOUS_QUEUE_SEG_TASKS", DEFAULT_SEG_TASKS, int)
    if seg_cap <= 0:
      return self.insert(tasks, total=total)
    shards = max(
      env_number("IGNEOUS_QUEUE_SHARDS", DEFAULT_QUEUE_SHARDS, int)
      or DEFAULT_QUEUE_SHARDS, 1,
    )
    if total:
      seg_size = min(max(-(-int(total) // shards), 1), seg_cap)
    else:
      seg_size = seg_cap
    base = self.inserted   # global task indices continue across batches
    n = 0
    chunk: List[Tuple[int, str]] = []

    def flush():
      nonlocal chunk
      if chunk:
        self._write_file(
          self.queue_dir, seg_name(uuid.uuid4().hex, len(chunk)),
          _seg_content(chunk),
        )
        chunk = []

    for task in iter_tasks(tasks):
      payload = task if isinstance(task, str) else serialize(task)
      chunk.append((base + n, payload))
      n += 1
      if len(chunk) >= seg_size:
        flush()
    flush()
    self._tally("insertions", n)
    self._pending_cache = None
    return n

  # -- consumer -------------------------------------------------------------

  def _recycle_expired(self, force: bool = False) -> int:
    """Return expired leases to rotation, at most one scan per
    ``IGNEOUS_QUEUE_RECYCLE_SEC`` (5; 0 scans every call) unless
    ``force``. A lease that expires on an exhausted task dead-letters
    it. Returns the number of files returned to the pool."""
    now = time.time()
    if not force:
      interval = env_number(
        "IGNEOUS_QUEUE_RECYCLE_SEC", DEFAULT_RECYCLE_SEC, float
      )
      if interval > 0 and now - self._last_recycle < interval:
        return 0
    self._last_recycle = now
    n = 0
    for name in os.listdir(self.lease_dir):
      try:
        deadline = float(name.split(LEASE_SEP, 1)[0])
      except ValueError:
        continue
      if deadline >= now:
        continue
      orig = name.split(LEASE_SEP, 1)[1]
      src = os.path.join(self.lease_dir, name)
      if self._exhausted(orig):
        # the worker that held this lease died (or never acked): the
        # expiry is the failure signal of its final delivery
        reason = (
          f"lease expired after delivery {self.delivery_count(orig)} "
          f"(worker lost or task hung)"
        )
        parsed = seg_parse(orig)
        if parsed:
          self._expire_segment_to_dlq(src, parsed[0], reason)
        else:
          self._quarantine_to_dlq(src, orig, reason)
        continue
      try:
        os.rename(src, os.path.join(self.queue_dir, orig))
      except FileNotFoundError:
        continue  # another worker recycled it first
      n += 1
      if self._pending_cache is not None:
        self._pending_cache.append(orig)
    if os.path.isdir(self.spec_dir) or os.path.isdir(self.steal_dir):
      self._survival_gc(now)
    return n

  def _expire_segment_to_dlq(self, src: str, segid: str, reason: str):
    """An exhausted segment quarantines per index: every surviving member
    becomes its own ``dlq/task_<segid>_<idx>.json`` carrying the shared
    attempt record. Names are deterministic, so a racing double expansion
    is idempotent; dlq files land before the lease file goes."""
    try:
      entries = self._read_segment(src)
    except FileNotFoundError:
      return  # another worker expanded it first
    seg_meta = self._read_meta(f"{SEG_PREFIX}{segid}")
    spec = seg_meta.get("spec") if self._spec_active() else None
    for idx, payload in entries:
      if spec and self._spec_resolved(spec["pair"], idx):
        # the pair's other copy completed (and tallied) this index:
        # dropping it is the resolution, not a quarantine
        self._spec_collapse(None, None, 1)
        continue
      name = f"task_{segid}_{idx}.json"
      meta = self._read_meta(name)
      meta["deliveries"] = max(
        int(meta.get("deliveries", 0)), int(seg_meta.get("deliveries", 0))
      )
      meta["failures"] = (
        seg_meta.get("failures", []) + meta.get("failures", [])
      )[-MAX_RECORDED_FAILURES:]
      if spec:
        meta["spec"] = spec
      self._write_meta(name, meta)
      self._record_failure(name, reason)
      self._write_file(self.dlq_dir, name, payload)
      telemetry.incr("dlq.promoted", 1)
    try:
      os.remove(src)
    except FileNotFoundError:
      pass
    self._drop_meta(f"{SEG_PREFIX}{segid}")

  def _pop_pending(self) -> Optional[str]:
    """A pending name from the cached index, random within the first
    ``CONTENTION_WINDOW``; the cache is reverse-sorted so the window sits
    at its tail."""
    cache = self._pending_cache
    if not cache:
      return None
    window = min(len(cache), CONTENTION_WINDOW)
    return cache.pop(len(cache) - 1 - random.randrange(window))

  def _lease_one(self, name: str, seconds: float, cap: int):
    """Acquire one pending file (the rename is the mutex). A classic file
    leases whole; a segment leases as a :class:`RangeLease` split at
    ``cap`` members: the remainder returns to the pool under a new segid
    (attempt meta copied) BEFORE the lease shrinks, so a crash between
    duplicates deliveries but never loses tasks. Returns (task, token)
    pairs, None when the rename race was lost, or [] when the file held
    only indices the pair's other copy already resolved."""
    deadline = time.time() + seconds
    lease_name = f"{deadline:.3f}{LEASE_SEP}{name}"
    src = os.path.join(self.queue_dir, name)
    dst = os.path.join(self.lease_dir, lease_name)
    try:
      os.rename(src, dst)
    except FileNotFoundError:
      return None  # lost the race; the caller tries another
    parsed = seg_parse(name)
    if parsed is None:
      spec = self._spec_of_name(name) if self._spec_active() else None
      if spec is not None:
        carve = _CARVE_RE.match(name)
        if carve and self._spec_resolved(spec["pair"], int(carve.group(2))):
          # the pair's other copy completed (and tallied) this index:
          # drop the duplicate instead of delivering it
          self._spec_collapse(dst, name, 1)
          return []
      meta = self._read_meta(name)
      meta["deliveries"] = int(meta.get("deliveries", 0)) + 1
      self._write_meta(name, meta)
      with open(dst) as f:
        return [(deserialize(f.read()), lease_name)]
    segid = parsed[0]
    entries = self._read_segment(dst)
    if self._spec_active():
      spec = self._spec_of(segid)
      if spec is not None:
        live = [
          (i, p) for i, p in entries
          if not self._spec_resolved(spec["pair"], i)
        ]
        if len(live) != len(entries):
          self._spec_collapse(None, None, len(entries) - len(live))
          if not live:
            try:
              os.remove(dst)
            except FileNotFoundError:
              pass
            self._drop_meta(f"{SEG_PREFIX}{segid}")
            return []
          new_lease = f"{deadline:.3f}{LEASE_SEP}{seg_name(segid, len(live))}"
          self._write_file(self.lease_dir, new_lease, _seg_content(live))
          try:
            os.remove(dst)
          except FileNotFoundError:
            pass
          lease_name, entries = new_lease, live
          dst = os.path.join(self.lease_dir, lease_name)
    cap = max(int(cap), 1)
    if len(entries) > cap:
      keep, rest = entries[:cap], entries[cap:]
      rest_segid = uuid.uuid4().hex
      self._copy_meta(segid, rest_segid)
      rest_name = seg_name(rest_segid, len(rest))
      self._write_file(self.queue_dir, rest_name, _seg_content(rest))
      if self._pending_cache is not None:
        # the next pop likely continues the contiguous run on this worker
        self._pending_cache.append(rest_name)
      lease_name_new = f"{deadline:.3f}{LEASE_SEP}{seg_name(segid, len(keep))}"
      self._write_file(self.lease_dir, lease_name_new, _seg_content(keep))
      try:
        os.remove(dst)
      except FileNotFoundError:
        pass
      lease_name, entries = lease_name_new, keep
    meta = self._read_meta(f"{SEG_PREFIX}{segid}")
    meta["deliveries"] = int(meta.get("deliveries", 0)) + 1
    # holder identity: what speculation targets (a flagged worker's
    # leases) and stealing filters (a thief never claims its own range)
    meta["holder"] = self.worker_id
    meta["leased_at"] = round(time.time(), 3)
    self._write_meta(f"{SEG_PREFIX}{segid}", meta)
    rl = RangeLease(self, lease_name, segid, dict(entries), deadline)
    return [(deserialize(p), RangeSub(rl, i)) for i, p in entries]

  def lease_batch(self, seconds: float = 600, max_tasks: int = 1):
    """Lease up to ``max_tasks`` tasks in one call: segment members come
    back as (task, :class:`RangeSub`) pairs sharing one lease, classic
    files as (task, lease_id) pairs. [] when the queue is drained."""
    self._recycle_expired()
    out: List[Tuple[RegisteredTask, object]] = []
    refreshed = False
    races = 0
    while len(out) < max_tasks and races < 10:
      name = self._pop_pending()
      if name is None:
        if refreshed:
          break
        # cache drained: force a recycle pass (the throttle must not make
        # an emptied-but-expired queue look drained), then re-list once
        self._recycle_expired(force=True)
        self._pending_cache = sorted(os.listdir(self.queue_dir), reverse=True)
        refreshed = True
        continue
      got = self._lease_one(name, seconds, max_tasks - len(out))
      if got is None:
        races += 1
        continue
      out.extend(got)
    return out

  def lease(self, seconds: float = 600) -> Optional[Tuple[RegisteredTask, str]]:
    """(task, lease_id), or None when the queue is drained. On a segment
    the single task splits off, so solo pollers work on batch inserts."""
    got = self.lease_batch(seconds, max_tasks=1)
    return got[0] if got else None

  @staticmethod
  def _lease_deadline(lease_id: str) -> Optional[float]:
    try:
      return float(str(lease_id).split(LEASE_SEP, 1)[0])
    except ValueError:
      return None

  def renew(self, lease_id, seconds: float = 600):
    """Extend a held lease by re-timestamping its name; returns the NEW
    token (the old one is dead). A range member renews its parent's one
    lease and returns the same handle. Refused with StaleLeaseError (and
    ``zombie.renew``) once the lease expired or the task was re-issued."""
    if isinstance(lease_id, RangeSub):
      self._range_renew(lease_id.parent, seconds)
      return lease_id
    deadline = self._lease_deadline(lease_id)
    orig = str(lease_id).split(LEASE_SEP, 1)[-1]
    if deadline is None or deadline < time.time():
      telemetry.incr("zombie.renew", 1)
      raise StaleLeaseError(
        f"lease for {orig!r} already expired; the task is due for re-issue"
      )
    new_id = f"{time.time() + seconds:.3f}{LEASE_SEP}{orig}"
    try:
      os.rename(
        os.path.join(self.lease_dir, lease_id),
        os.path.join(self.lease_dir, new_id),
      )
    except FileNotFoundError:
      telemetry.incr("zombie.renew", 1)
      raise StaleLeaseError(
        f"lease for {orig!r} was re-issued (or completed) by another worker"
      ) from None
    return new_id

  def delete(self, lease_id) -> bool:
    """Complete a task. Fenced: the delete (and its completion tally)
    only lands while the token is current; a stale one returns False and
    counts ``zombie.delete``. A range member acks its index."""
    if isinstance(lease_id, RangeSub):
      return self._range_ack(lease_id.parent, lease_id.index)
    deadline = self._lease_deadline(lease_id)
    if deadline is not None and deadline < time.time():
      telemetry.incr("zombie.delete", 1)
      return False
    orig = str(lease_id).split(LEASE_SEP, 1)[-1]
    try:
      os.remove(os.path.join(self.lease_dir, lease_id))
    except FileNotFoundError:
      telemetry.incr("zombie.delete", 1)
      return False
    spec = self._spec_of_name(orig) if self._spec_active() else None
    self._drop_meta(orig)
    if spec is not None:
      # a speculated index carved out as a classic task: the O_EXCL
      # marker arbitrates the tally exactly as in _range_ack_many
      carve = _CARVE_RE.match(orig)
      idx = int(carve.group(2)) if carve else None
      if idx is not None:
        if not self._spec_mark_first(spec["pair"], idx):
          self._spec_wasted(spec, 1)
          return False  # the pair's other copy completed (and tallied) it
        self._spec_account_first(spec, 1)
    self._tally("completions")
    return True

  def nack(self, lease_id, reason: str = "", requeue: bool = False):
    """Record a failed delivery: the reason persists with the task's
    meta; an exhausted task moves to ``dlq/``; otherwise the lease
    recycles on its timeout unless ``requeue`` returns it now. A range
    member nack carves the failed index out (only it retries). A nack of
    a lease already re-issued is dropped (``zombie.nack``)."""
    if isinstance(lease_id, RangeSub):
      return self._range_nack(
        lease_id.parent, lease_id.index, reason, requeue=requeue
      )
    orig = lease_id.split(LEASE_SEP, 1)[-1]
    src = os.path.join(self.lease_dir, lease_id)
    if not os.path.exists(src):
      telemetry.incr("zombie.nack", 1)
      return
    if self._exhausted(orig):
      self._quarantine_to_dlq(src, orig, reason)
    else:
      self._record_failure(orig, reason)
      if requeue:
        self.release(lease_id)

  def release(self, lease_id):
    """Return a lease to rotation now (undelivered). A range member goes
    back as a fresh one-task segment."""
    if isinstance(lease_id, RangeSub):
      return self._range_release(lease_id.parent, [lease_id.index])
    orig = lease_id.split(LEASE_SEP, 1)[1]
    try:
      os.rename(
        os.path.join(self.lease_dir, lease_id),
        os.path.join(self.queue_dir, orig),
      )
    except FileNotFoundError:
      return
    if self._pending_cache is not None:
      self._pending_cache.append(orig)

  def release_all(self):
    for name in list(os.listdir(self.lease_dir)):
      if LEASE_SEP in name:
        self.release(name)
    self._pending_cache = None

  # -- batched completion ----------------------------------------------------

  def ack_batch(self, tokens) -> List[bool]:
    """Complete many tasks at once: range members of one parent collapse
    into ONE lease-file rewrite. Results align with ``tokens`` (False =
    zombie-fenced)."""
    tokens = list(tokens)
    results = [False] * len(tokens)
    by_parent: Dict[int, Tuple[RangeLease, List[Tuple[int, int]]]] = {}
    for pos, tok in enumerate(tokens):
      if isinstance(tok, RangeSub):
        by_parent.setdefault(id(tok.parent), (tok.parent, []))[1].append(
          (pos, tok.index)
        )
      else:
        results[pos] = self.delete(tok)
    for parent, members in by_parent.values():
      acked = self._range_ack_many(parent, [i for _, i in members])
      for pos, i in members:
        results[pos] = bool(acked.get(int(i)))
    return results

  def nack_batch(self, tokens, reason: str = "", requeue: bool = False):
    """Fail many deliveries (each as a scalar ``nack``)."""
    for tok in tokens:
      self.nack(tok, reason, requeue=requeue)

  # -- range-lease mechanics (handles live in .ranges) -----------------------

  def _range_rewrite(self, rl: RangeLease, new_entries: Dict[int, str],
                     new_deadline: Optional[float] = None) -> bool:
    """Swap the range's lease file for one holding ``new_entries``
    (removed when empty). Write-new-then-remove-old: a crash between
    re-delivers, never loses. False = the old file was gone (expired and
    re-issued, or completed elsewhere); the new file is withdrawn. The
    caller holds ``rl.lock``."""
    deadline = rl.deadline if new_deadline is None else float(new_deadline)
    old = os.path.join(self.lease_dir, rl.token)
    if not new_entries:
      try:
        os.remove(old)
      except FileNotFoundError:
        return False
      rl.entries = {}
      return True
    new_token = f"{deadline:.3f}{LEASE_SEP}{seg_name(rl.segid, len(new_entries))}"
    if new_token == rl.token:
      rl.entries = dict(new_entries)
      return True
    self._write_file(
      self.lease_dir, new_token, _seg_content(sorted(new_entries.items()))
    )
    try:
      os.remove(old)
    except FileNotFoundError:
      try:
        os.remove(os.path.join(self.lease_dir, new_token))
      except FileNotFoundError:
        pass
      return False
    rl.token = new_token
    rl.entries = dict(new_entries)
    rl.deadline = deadline
    return True

  def _range_ack_many(self, rl: RangeLease, indices) -> Dict[int, bool]:
    """Complete several members of one range with a single rewrite."""
    todo = [int(i) for i in indices]
    with rl.lock:
      if rl.deadline < time.time():
        telemetry.incr("zombie.delete", len(todo))
        return {i: False for i in todo}
      hit = sorted({i for i in todo if i in rl.entries})
      miss = [i for i in todo if i not in rl.entries]
      if miss:
        telemetry.incr("zombie.delete", len(miss))
      if not hit:
        return {i: False for i in todo}
      remaining = {i: p for i, p in rl.entries.items() if i not in set(hit)}
      if not self._range_rewrite(rl, remaining):
        telemetry.incr("zombie.delete", len(hit))
        return {i: False for i in todo}
      # first-RESOLUTION-wins: with a live speculation pair, the per-index
      # O_EXCL marker, tried only AFTER the rewrite proved this worker
      # still owns its copy, arbitrates the tally. Exactly one side makes
      # each marker (and tallies); the loser's ack shrank its lease above
      # but tallies nothing.
      spec = self._spec_of(rl.segid) if self._spec_active() else None
      if spec is None:
        first = hit
      else:
        first = [i for i in hit if self._spec_mark_first(spec["pair"], i)]
        if first:
          self._spec_account_first(spec, len(first))
        if len(first) != len(hit):
          self._spec_wasted(spec, len(hit) - len(first))
      if first:
        self._tally("completions", len(first))
      if not remaining:
        self._drop_meta(f"{SEG_PREFIX}{rl.segid}")
      hitset = set(hit)
      return {i: i in hitset for i in todo}

  def _range_ack(self, rl: RangeLease, index: int) -> bool:
    return self._range_ack_many(rl, [index])[int(index)]

  def _range_nack(self, rl: RangeLease, index: int, reason: str = "",
                  requeue: bool = False):
    """Mid-range failure: carve the failed index out as a classic
    single-task lease (``task_<segid>_<idx>.json``) inheriting the
    range's attempt record, shrink the range, then nack the carve, so
    reasons, DLQ promotion and retry budgets apply to that index only."""
    index = int(index)
    with rl.lock:
      if rl.deadline < time.time() or index not in rl.entries:
        telemetry.incr("zombie.nack", 1)
        return
      carve = f"task_{rl.segid}_{index}.json"
      seg_meta = self._read_meta(f"{SEG_PREFIX}{rl.segid}")
      meta = self._read_meta(carve)
      meta["deliveries"] = max(
        int(meta.get("deliveries", 0)), int(seg_meta.get("deliveries", 0))
      )
      meta["failures"] = (
        seg_meta.get("failures", []) + meta.get("failures", [])
      )[-MAX_RECORDED_FAILURES:]
      if seg_meta.get("spec"):
        # pair membership rides along: the carve's ack must still go
        # through the first-resolution markers
        meta["spec"] = seg_meta["spec"]
      self._write_meta(carve, meta)
      carve_lease = f"{rl.deadline:.3f}{LEASE_SEP}{carve}"
      self._write_file(self.lease_dir, carve_lease, rl.entries[index])
      remaining = {i: p for i, p in rl.entries.items() if i != index}
      if not self._range_rewrite(rl, remaining):
        # the whole range is being redelivered; withdraw the carve so the
        # index is not duplicated
        try:
          os.remove(os.path.join(self.lease_dir, carve_lease))
        except FileNotFoundError:
          pass
        telemetry.incr("zombie.nack", 1)
        return
    return self.nack(carve_lease, reason, requeue=requeue)

  def _range_release(self, rl: RangeLease, indices=None) -> int:
    """Return members (all surviving ones when ``indices`` is None) to
    the pool now as a fresh segment under a new segid (attempt meta
    copied, deliveries kept, as a classic release keeps them)."""
    with rl.lock:
      if indices is None:
        chosen = sorted(rl.entries)
      else:
        chosen = sorted({int(i) for i in indices} & set(rl.entries))
      if not chosen or rl.deadline < time.time():
        return 0  # expired: the recycler owns these now
      released = {i: rl.entries[i] for i in chosen}
      new_segid = uuid.uuid4().hex
      self._copy_meta(rl.segid, new_segid)
      new_name = seg_name(new_segid, len(released))
      self._write_file(
        self.queue_dir, new_name, _seg_content(sorted(released.items()))
      )
      remaining = {i: p for i, p in rl.entries.items() if i not in set(chosen)}
      if not self._range_rewrite(rl, remaining):
        try:
          os.remove(os.path.join(self.queue_dir, new_name))
        except FileNotFoundError:
          pass
        return 0
      if self._pending_cache is not None:
        self._pending_cache.append(new_name)
      return len(released)

  def _range_renew(self, rl: RangeLease, seconds: float) -> str:
    """Extend the range's ONE lease (its token rotates inside; RangeSub
    handles stay valid). A no-op while the deadline already covers ~the
    requested extension, so K tracked members cost one rename a beat."""
    with rl.lock:
      now = time.time()
      if not rl.entries:
        # fully completed: a heartbeat racing the final ack
        raise StaleLeaseError(
          f"range {rl.segid!r} fully completed; nothing left to renew"
        )
      if rl.deadline < now:
        telemetry.incr("zombie.renew", 1)
        raise StaleLeaseError(
          f"range lease {rl.segid!r} already expired; due for re-issue"
        )
      # work stealing: the heartbeat is the holder's claim inbox; serve a
      # pending claim before the freshness guard can return, so a thief
      # never waits past one renewal interval
      self._steal_service(rl)
      if rl.deadline >= now + float(seconds) * 0.9:
        return rl.token
      new_deadline = now + float(seconds)
      new_token = (
        f"{new_deadline:.3f}{LEASE_SEP}{seg_name(rl.segid, len(rl.entries))}"
      )
      try:
        os.rename(
          os.path.join(self.lease_dir, rl.token),
          os.path.join(self.lease_dir, new_token),
        )
      except FileNotFoundError:
        telemetry.incr("zombie.renew", 1)
        raise StaleLeaseError(
          f"range lease {rl.segid!r} was re-issued by another worker"
        ) from None
      rl.token = new_token
      rl.deadline = new_deadline
      return rl.token

  # -- campaign survival: straggler speculation and work stealing ----------

  def _spec_active(self) -> bool:
    """One stat call gates every speculation hook: the ``spec/`` sidecar
    exists only once something speculated, so a queue that never did
    reads exactly as a plain one."""
    return os.path.isdir(self.spec_dir)

  def _spec_path(self, name: str) -> str:
    return os.path.join(self.spec_dir, name)

  def _spec_of(self, segid: str) -> Optional[dict]:
    """Pair membership of a segment: ``{"pair": …, "side": "orig"|"twin"}``
    from its attempt meta. The ORIG side gets a pair-file fallback:
    ``speculate_lease`` (the campaign runner's process) stamping ``meta["spec"]`` can
    race the holder's own meta read-modify-write (a lease split's
    delivery bump, a failure record) and lose — but the pair file is
    NAMED after the orig segid, so its existence alone proves
    membership no matter which write landed last."""
    spec = self._read_meta(f"{SEG_PREFIX}{segid}").get("spec")
    if isinstance(spec, dict) and "pair" in spec:
      return spec
    if os.path.exists(self._spec_path(f"pair_{segid}.json")):
      return {"pair": segid, "side": "orig"}
    return None

  def _spec_of_name(self, name: str) -> Optional[dict]:
    """Pair membership of a classic queue/lease/dlq file name (carves
    inherit it into their own meta; plain per-task files never have
    any)."""
    spec = self._read_meta(self._meta_key(name)).get("spec")
    return spec if isinstance(spec, dict) and "pair" in spec else None

  def _spec_resolved(self, pairid: str, index: int) -> bool:
    return os.path.exists(self._spec_path(f"done_{pairid}_{int(index)}"))

  def _spec_mark_first(self, pairid: str, index: int) -> bool:
    """Atomically claim first resolution of (pair, index). The O_EXCL
    create is the ONE commitment point for the completion tally: the
    creator tallies, everyone else is fenced."""
    try:
      fd = os.open(
        self._spec_path(f"done_{pairid}_{int(index)}"),
        os.O_CREAT | os.O_EXCL | os.O_WRONLY,
      )
    except FileExistsError:
      return False
    os.close(fd)
    return True

  def _spec_account_first(self, spec: dict, n: int):
    """Exactly one of won/fenced per issued index, settled at first
    resolution — the twin resolving first means speculation paid off,
    the original resolving first means the twin's copy is now waste.
    Besides the in-process telemetry counter (journal-flushed, LOSSY
    when the acking worker is SIGKILLed before its next flush) the
    resolution appends to a crash-safe queue tally, committed in the
    same breath as the done marker — the campaign runner reconciles
    the journal ledger from these after the pool is down."""
    if spec.get("side") == "twin":
      telemetry.incr("speculation.won", n)
      self._tally("speculation_won", n)
    else:
      telemetry.incr("speculation.fenced", n)
      self._tally("speculation_fenced", n)

  def _spec_wasted(self, spec: dict, n: int):
    """A duplicate ack: the loser executed work the winner already
    tallied. ``speculation.wasted_ms`` accumulates the pair-open window
    per duplicate — the wall-clock bound on the duplicated effort."""
    telemetry.incr("speculation.duplicate_ack", n)
    pair = self._read_pair(spec["pair"])
    if pair and pair.get("ts"):
      window_ms = int(max(0.0, time.time() - float(pair["ts"])) * 1000)
      telemetry.incr("speculation.wasted_ms", window_ms * n)

  def _spec_collapse(self, lease_path: Optional[str],
                     meta_name: Optional[str], n: int):
    """Drop an already-resolved duplicate copy at lease/expiry time. No
    tally — the winner tallied at resolution; this is how a fenced
    twin's leftover copies drain out of rotation."""
    if lease_path is not None:
      try:
        os.remove(lease_path)
      except FileNotFoundError:
        pass
    if meta_name is not None:
      self._drop_meta(meta_name)
    telemetry.incr("speculation.deduped", n)

  def _read_pair(self, pairid: str) -> Optional[dict]:
    try:
      with open(self._spec_path(f"pair_{pairid}.json")) as f:
        return json.load(f)
    except (FileNotFoundError, ValueError):
      return None

  def range_leases(self) -> List[dict]:
    """Live range leases with holder identity — the planner's view for
    speculation targeting and steal candidate selection."""
    now = time.time()
    spec_on = self._spec_active()
    out = []
    for name in os.listdir(self.lease_dir):
      try:
        deadline = float(name.split(LEASE_SEP, 1)[0])
      except ValueError:
        continue
      parsed = seg_parse(name.split(LEASE_SEP, 1)[-1])
      if parsed is None:
        continue
      segid, count = parsed
      meta = self._read_meta(f"{SEG_PREFIX}{segid}")
      paired = bool(meta.get("spec")) or (
        # pair-file fallback: a clobbered orig meta must not make this
        # lease look stealable/re-speculatable (see _spec_of)
        spec_on
        and os.path.exists(self._spec_path(f"pair_{segid}.json"))
      )
      out.append({
        "lease": name, "segid": segid, "count": count,
        "deadline": deadline, "expired": deadline < now,
        "holder": meta.get("holder"),
        "leased_at": meta.get("leased_at"),
        "spec": paired,
      })
    return out

  @staticmethod
  def _held_sec(r: dict, now: float) -> float:
    """How long a listed range lease has been held. ``leased_at`` is
    rounded to the millisecond, so a lease taken in this millisecond can
    read as held for a negative time: clamp at 0, or a threshold of 0
    would skip a lease just taken."""
    return max(now - float(r["leased_at"] or now), 0.0)

  def speculate_lease(self, lease_name: str) -> int:
    """Double-issue the unfinished tail of one held range lease as a
    speculative TWIN segment: fresh segid, fresh delivery budget, the
    SAME global task indices. The twin enters normal rotation; whichever
    copy resolves an index first tallies it (see ``_range_ack_many``)
    and the loser's copy is fenced. One live pair per segment —
    re-speculation waits until the pair resolves and GCs. Returns the
    number of indices twinned (0 when the target is not a range lease,
    is already paired, is below ``IGNEOUS_SPECULATE_MIN_TASKS``, or
    rotated away since it was listed)."""
    orig = str(lease_name).split(LEASE_SEP, 1)[-1]
    parsed = seg_parse(orig)
    if parsed is None:
      return 0
    segid = parsed[0]
    key = f"{SEG_PREFIX}{segid}"
    meta = self._read_meta(key)
    if meta.get("spec"):
      return 0
    v = knobs.get_int("IGNEOUS_SPECULATE_MIN_TASKS")
    min_tasks = DEFAULT_SPECULATE_MIN_TASKS if v is None else int(v)
    try:
      entries = self._read_segment(os.path.join(self.lease_dir, lease_name))
    except FileNotFoundError:
      return 0  # rotated or completed since the listing; next sweep
    if len(entries) < max(min_tasks, 1):
      return 0
    os.makedirs(self.spec_dir, exist_ok=True)
    # the pair file is the mutex: an O_EXCL loss means a racing speculator
    # just speculated this segment
    try:
      fd = os.open(
        self._spec_path(f"pair_{segid}.json"),
        os.O_CREAT | os.O_EXCL | os.O_WRONLY,
      )
    except FileExistsError:
      return 0
    twin = uuid.uuid4().hex
    with os.fdopen(fd, "w") as f:
      json.dump({
        "pair": segid, "orig": segid, "twin": twin,
        "indices": [int(i) for i, _ in entries],
        "ts": round(time.time(), 3), "holder": meta.get("holder"),
      }, f)
    self._write_meta(
      f"{SEG_PREFIX}{twin}",
      {"deliveries": 0, "failures": [],
       "spec": {"pair": segid, "side": "twin"}},
    )
    meta["spec"] = {"pair": segid, "side": "orig"}
    self._write_meta(key, meta)
    # the twin entering rotation is the commit point
    twin_name = seg_name(twin, len(entries))
    self._write_file(self.queue_dir, twin_name, _seg_content(entries))
    if self._pending_cache is not None:
      self._pending_cache.append(twin_name)
    telemetry.incr("speculation.issued", len(entries))
    return len(entries)

  def speculate_flagged(self, workers, max_twins: Optional[int] = None) -> int:
    """Driver entry point: twin the tails of every unexpired, unpaired
    range lease held by a flagged worker — biggest ranges first, capped
    at ``max_twins`` new pairs per sweep (IGNEOUS_SPECULATE_MAX_TWINS).
    Returns the total number of indices twinned."""
    workers = {str(w) for w in workers}
    if not workers:
      return 0
    if max_twins is None:
      v = knobs.get_int("IGNEOUS_SPECULATE_MAX_TWINS")
      max_twins = DEFAULT_SPECULATE_MAX_TWINS if v is None else int(v)
    held = knobs.get_float("IGNEOUS_SPECULATE_MIN_HELD_SEC")
    min_held = DEFAULT_SPECULATE_MIN_HELD_SEC if held is None else float(held)
    now = time.time()
    cands = [
      r for r in self.range_leases()
      if not r["expired"] and not r["spec"] and r["holder"] in workers
      and self._held_sec(r, now) >= min_held
    ]
    cands.sort(key=lambda r: (-r["count"], r["lease"]))
    issued = twins = 0
    for r in cands:
      if twins >= max_twins:
        break
      n = self.speculate_lease(r["lease"])
      if n:
        issued += n
        twins += 1
    return issued

  def steal_claim(self, thief: Optional[str] = None) -> Optional[str]:
    """Thief entry point: claim the biggest long-held foreign range so
    its holder's next heartbeat renewal releases the unstarted tail back
    to the pool, where the thief (or any idle worker) leases it. One
    claim file per segment; O_EXCL creation makes racing thieves
    converge on distinct targets deterministically. Returns the claimed
    segid, or None when nothing qualifies."""
    thief = thief or self.worker_id
    v = knobs.get_int("IGNEOUS_STEAL_MIN_TASKS")
    min_tasks = DEFAULT_STEAL_MIN_TASKS if v is None else int(v)
    held = knobs.get_float("IGNEOUS_STEAL_MIN_HELD_SEC")
    min_held = DEFAULT_STEAL_MIN_HELD_SEC if held is None else float(held)
    now = time.time()
    cands = [
      r for r in self.range_leases()
      if not r["expired"] and r["count"] >= max(min_tasks, 1)
      and r["holder"] not in (None, thief)
      and self._held_sec(r, now) >= min_held
    ]
    cands.sort(key=lambda r: (-r["count"], r["lease"]))
    for r in cands:
      os.makedirs(self.steal_dir, exist_ok=True)
      try:
        fd = os.open(
          os.path.join(self.steal_dir, f"{r['segid']}.claim"),
          os.O_CREAT | os.O_EXCL | os.O_WRONLY,
        )
      except FileExistsError:
        continue  # another thief got this range; try the next
      with os.fdopen(fd, "w") as f:
        json.dump({"thief": thief, "ts": round(now, 3)}, f)
      telemetry.incr("steal.claims")
      return r["segid"]
    return None

  def _steal_service(self, rl: RangeLease) -> int:
    """Holder side, under ``rl.lock`` from ``_range_renew``: a pending
    claim releases ``IGNEOUS_STEAL_FRACTION`` of the UNSTARTED tail
    through the expiry-fenced range-release seam, always keeping at
    least one member so the holder's in-flight work keeps its lease.
    Too-small grants deny the claim (file removed) rather than starve
    the thief silently."""
    if not os.path.isdir(self.steal_dir):
      return 0
    claim = os.path.join(self.steal_dir, f"{rl.segid}.claim")
    if not os.path.exists(claim):
      return 0
    frac = knobs.get_float("IGNEOUS_STEAL_FRACTION")
    frac = DEFAULT_STEAL_FRACTION if frac is None else float(frac)
    v = knobs.get_int("IGNEOUS_STEAL_MIN_TASKS")
    min_tasks = DEFAULT_STEAL_MIN_TASKS if v is None else int(v)
    unstarted = sorted(set(rl.entries) - rl.started)
    grant_n = min(
      int(len(unstarted) * max(min(frac, 1.0), 0.0)),
      len(rl.entries) - 1,
    )
    granted = 0
    if grant_n >= 1 and len(unstarted) >= max(min_tasks, 1):
      granted = self._range_release(rl, unstarted[-grant_n:])
    try:
      os.remove(claim)
    except FileNotFoundError:
      pass
    if granted:
      telemetry.incr("steal.granted")
      telemetry.incr("steal.tasks", granted)
    else:
      telemetry.incr("steal.denied")
    return granted

  def _survival_gc(self, now: float):
    """Recycle-pass housekeeping for the survival sidecars: TTL-expired
    steal claims recycle (so a re-leased range can be claimed again),
    DLQ carves whose index the pair's other copy completed are pruned
    as stale duplicates, and fully-resolved pairs drop their markers +
    pair file — but only once NOTHING on disk references either segid,
    because any lingering copy must keep deduping against the markers."""
    if os.path.isdir(self.steal_dir):
      ttl = knobs.get_float("IGNEOUS_STEAL_CLAIM_TTL_SEC")
      ttl = DEFAULT_STEAL_CLAIM_TTL_SEC if ttl is None else float(ttl)
      for name in os.listdir(self.steal_dir):
        if not name.endswith(".claim"):
          continue
        path = os.path.join(self.steal_dir, name)
        try:
          with open(path) as f:
            ts = float(json.load(f).get("ts") or 0)
        except (FileNotFoundError, ValueError, TypeError):
          ts = 0.0
        if now - ts > max(ttl, 0.0):
          try:
            os.remove(path)
            telemetry.incr("steal.expired_claims")
          except FileNotFoundError:
            pass
    if not self._spec_active():
      return
    names = os.listdir(self.spec_dir)
    pairs = [n for n in names if n.startswith("pair_")]
    if not pairs:
      return
    markers = {n for n in names if n.startswith("done_")}
    qlive = os.listdir(self.queue_dir) + os.listdir(self.lease_dir)

    for pname in pairs:
      try:
        with open(self._spec_path(pname)) as f:
          pair = json.load(f)
      except (FileNotFoundError, ValueError):
        continue
      pid = pair.get("pair")
      # descendants (lease splits, stolen/released tails) carry the
      # pair under fresh segids; their side_ lineage markers make them
      # visible here so the pair outlives every circulating copy
      side_pref = f"side_{pid}_"
      lineage = [n[len(side_pref):] for n in names if n.startswith(side_pref)]
      sides = tuple(
        [pair.get("orig", ""), pair.get("twin", "")] + lineage
      )
      # stale DLQ duplicates: the other copy completed this index AFTER
      # it was quarantined — zero-DLQ-leakage means pruning them
      for n in os.listdir(self.dlq_dir):
        m = _CARVE_RE.match(n)
        if not m or m.group(1) not in sides:
          continue
        if f"done_{pid}_{int(m.group(2))}" in markers:
          try:
            os.remove(os.path.join(self.dlq_dir, n))
          except FileNotFoundError:
            continue
          self._drop_meta(n)
          telemetry.incr("speculation.dlq_pruned")
      idxs = pair.get("indices", [])
      done = [f"done_{pid}_{i}" for i in idxs]
      if not all(d in markers for d in done):
        continue

      def referenced(segid: str, listing) -> bool:
        seg_pref = f"{SEG_PREFIX}{segid}_"
        carve_pref = f"task_{segid}_"
        return any(seg_pref in n or carve_pref in n for n in listing)

      dlq_live = os.listdir(self.dlq_dir)
      if any(
        referenced(s, qlive) or referenced(s, dlq_live) for s in sides
      ):
        continue
      for d in done:
        try:
          os.remove(self._spec_path(d))
        except FileNotFoundError:
          pass
      for n in names:
        if n.startswith(side_pref):
          try:
            os.remove(self._spec_path(n))
          except FileNotFoundError:
            pass
      try:
        os.remove(self._spec_path(pname))
      except FileNotFoundError:
        pass
      for s in sides:
        self._drop_meta(f"{SEG_PREFIX}{s}")

  def purge(self):
    """Drop every pending, leased and dead-lettered task, all metadata and
    the counters, and the survival sidecars."""
    for d in (self.queue_dir, self.lease_dir, self.dlq_dir, self.meta_dir,
              self.spec_dir, self.steal_dir):
      if not os.path.isdir(d):
        continue
      for name in list(os.listdir(d)):
        try:
          os.remove(os.path.join(d, name))
        except FileNotFoundError:
          pass
    self._pending_cache = None
    self.rezero()

  # -- worker loop ----------------------------------------------------------

  def poll(
    self,
    lease_seconds: float = 600,
    verbose: bool = False,
    tally: bool = True,
    stop_fn=None,
    max_backoff_window: float = 30.0,
    before_fn=None,
    after_fn=None,
    task_deadline_seconds: Optional[float] = None,
    heartbeat_seconds: Optional[float] = None,
    drain_flag=None,
  ):
    """Lease → execute → delete until ``stop_fn`` says stop
    (``poll_loop``)."""
    del tally  # completions are always tallied; kept for call parity
    return poll_loop(
      self, lease_seconds, verbose, stop_fn, max_backoff_window,
      before_fn, after_fn, task_deadline_seconds,
      heartbeat_seconds, drain_flag,
    )

  def __len__(self):
    return self.enqueued
