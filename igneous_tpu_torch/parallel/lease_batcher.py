"""Queue-leased batched execution: ``execute --batch K``.

The port's own copy of ``igneous_tpu/parallel/lease_batcher.py``. A worker
leases up to K tasks a round, groups the compatible ones (same type and
same device-stage signature) and runs each group's device stage as ONE
set of launches on the card, while every lease still completes on its own:

  * a member whose host stage fails keeps its lease alone: it is nacked
    with its reason and recycles (or dead-letters) by itself;
  * a failed group dispatch reruns the incomplete members solo within the
    same round (the same kernels on the same card), so one poisoned
    member cannot drag K-1 healthy leases into recycling;
  * outputs are those of solo execution: each group feeds its device
    results back through the solo tasks' own completion code
    (``downsample_and_upload(_mips_out=...)``,
    ``SkeletonTask.execute(_prepared=..., _edt_field=...)``,
    ``store_ccl_faces``, ``MeshTask.finish_group``).

The groups and their kernels:

  * DownsampleTask: full cutouts → ``ChunkExecutor`` → ``pyramid2x2x1``
    in one launch; clamped edge cutouts → ``PagedPyramid`` →
    ``page_pyramid`` → ``pool2x2x1`` a page round;
  * SkeletonTask: ``paged_edt`` → ``edt_pass`` (three launches a group);
  * CCLFacesTask: ``paged_ccl`` (or ``connected_components_batch`` where
    the tile cannot page) → ``tile_resolve``;
  * MeshTask: ``tasks.mesh.execute_mesh_tasks_batched``, the marching
    cubes count pass across every member's labels.

While round i runs, round i+1's members are leased (and renewed by the
heartbeat from lease time) and their downsample cutouts downloaded on
the shared prefetch pool, fenced off every (path, mip) round i writes.

The observability hooks are the JAX package's: each round leases under
a ``lease.acquire`` span and runs under a ``lease.round`` span on the
worker trace, each member's completion (or solo run) under its task span,
and the round's spans flush as one journal segment. A worker that ``fleet
check`` flags in ``<journal>/health/flags.json`` stops pre-leasing round
i+1 and hands back what it pre-leased, so healthy workers take the depth;
between the page rounds of a downsample group it sheds the ragged members
none of whose pages ran (``PagedPyramid.split_unstarted``) back to the
queue (``paged_splits``). Each member is marked started as its work
begins, so work stealing carves only untouched members off a range; with
``IGNEOUS_STEAL`` on, a worker that finds the queue empty claims the
biggest long-held foreign range (``steal_claims``) and re-polls within
1-2 s, when the holder's next renewal has released the unstarted tail.

Not ported: the JAX package's host-backend choices (its native pooling,
EDT and CCL on CPU-only hosts: the port has one route, which runs the
plain versions on the CPU).
"""

from __future__ import annotations

import json
import random
import time
from collections import defaultdict
from typing import Optional

from ..analysis import knobs
from .. import telemetry
from ..lib import Bbox
from ..observability import journal as journal_mod
from ..observability import trace
from ..observability.device import LEDGER
from ..queues.filequeue import failure_reason, run_with_deadline


def _range_sizes(tokens):
  """Member counts per shared range lease of a round, largest first; None
  when the round held no range members."""
  from ..queues.ranges import RangeSub

  sizes = {}
  for tok in tokens:
    if isinstance(tok, RangeSub):
      sizes[id(tok.parent)] = sizes.get(id(tok.parent), 0) + 1
  return sorted(sizes.values(), reverse=True) if sizes else None


def _cutout_key(task):
  """Cache key of a prefetched downsample cutout."""
  return (
    task.src_path, int(task.mip),
    tuple(int(v) for v in task.offset),
    tuple(int(v) for v in task.shape),
  )


def _group_key(task, volmeta_cache):
  """Hashable device-stage signature, or None when the task runs solo.

  Keys embed what the group's launches share; the offset is the batch
  dimension. Clamped downsample cutouts group with their full siblings
  when their factor chain pages; skeleton and CCL cutouts of any shape
  share one paged signature."""
  from ..tasks.ccl import CCLFacesTask
  from ..tasks.image import DownsampleTask
  from ..tasks.mesh import MeshTask
  from ..tasks.skeleton import SkeletonTask

  def bounds_of(path, mip, fill_missing=False):
    key = (path, mip)
    if key not in volmeta_cache:
      from ..volume import Volume

      volmeta_cache[key] = Volume(
        path, mip=mip, fill_missing=fill_missing, bounded=False
      ).meta.bounds(mip)
    return volmeta_cache[key]

  if type(task) is DownsampleTask:
    bounds = bounds_of(task.src_path, task.mip, task.fill_missing)
    box = Bbox.intersection(
      Bbox(task.offset, task.offset + task.shape), bounds
    )
    if box.empty():
      return None
    if box != Bbox(task.offset, task.offset + task.shape):
      # a clamped edge cutout rides the paged pyramid when its factor
      # chain pages; chains that resolve against destination metadata
      # (factor or num_mips unset) stay solo
      from ..ops.pooling import _normalize_factors
      from .paged import pages_compatible

      if task.factor is None or task.num_mips is None:
        return None
      if not pages_compatible(
        _normalize_factors(task.factor, int(task.num_mips))
      ):
        return None
    return (
      "downsample", task.src_path, int(task.mip),
      tuple(int(v) for v in task.shape),
      None if task.factor is None else tuple(int(v) for v in task.factor),
      task.num_mips, bool(task.sparse), bool(task.fill_missing),
      task.downsample_method, task.compress,
      bool(task.delete_black_uploads), int(task.background_color),
    )

  if type(task) is SkeletonTask:
    bounds = bounds_of(task.cloudpath, task.mip, task.fill_missing)
    core = Bbox.intersection(
      Bbox(task.offset, task.offset + task.shape), bounds
    )
    if core.empty():
      return None  # the solo path no-ops it cheaply
    return (
      "skeleton", task.cloudpath, int(task.mip), ("paged",),
      bool(task.fill_missing),
    )

  if type(task) is CCLFacesTask:
    bounds = bounds_of(task.src_path, task.mip, task.fill_missing)
    cutout = Bbox.intersection(
      Bbox(task.offset, task.offset + task.shape + 1), bounds
    )
    if cutout.empty():
      return None
    from .paged import ccl_page_compatible

    shape_part = (
      ("paged",) if ccl_page_compatible()
      else tuple(int(v) for v in cutout.size3())
    )
    return (
      "ccl_faces", task.src_path, int(task.mip), shape_part,
      task.threshold_gte, task.threshold_lte,
      int(task.dust_threshold), bool(task.fill_missing),
    )

  if type(task) is MeshTask:
    # mesh cutouts need not share shapes: the count pass batches per mask
    # bucket across tasks; the kernel and resolution must agree
    return ("mesh", task.layer_path, int(task.mip), task.mesher)

  return None


class LeaseBatcher:
  """Worker loop that leases up to ``batch_size`` tasks a round and runs
  compatible device stages as single dispatches on the card."""

  def __init__(
    self,
    queue,
    batch_size: int = 8,
    lease_seconds: float = 600,
    verbose: bool = False,
    timing: bool = False,
    task_deadline_seconds: Optional[float] = None,
    heartbeat_seconds: Optional[float] = None,
    drain_flag=None,
  ):
    self.queue = queue
    self.batch_size = int(batch_size)
    self.lease_seconds = lease_seconds
    self.verbose = verbose
    # per-member deadline for the solo and completion stages
    self.task_deadline_seconds = task_deadline_seconds
    # renewal while a round executes: K leases are held across one device
    # dispatch, which a short lease would otherwise outlive
    self.heartbeat_seconds = heartbeat_seconds
    # graceful drain: finish the member in flight, release the rest
    self.drain_flag = drain_flag
    # ``execute --batch K --time``: one JSON line per lease round
    self.timing = timing
    self.stats = {
      "executed": 0, "batched": 0, "solo": 0, "failed": 0,
      "group_fallbacks": 0, "released": 0, "rounds": 0,
      "prefetched_rounds": 0, "prefetched_cutouts": 0,
      "straggler_surrenders": 0, "straggler_prefetch_skips": 0,
      # members a flagged worker shed between page rounds, and the steal
      # claims this worker filed while the queue looked empty
      "paged_splits": 0, "steal_claims": 0,
      "dispatches": defaultdict(int),
    }
    self._flag_cache = (0.0, False)  # (checked_at_monotonic, flagged)
    self._completed_in_group = set()
    self._hb = None
    self._next_round = None   # Future -> list[(task, lease_id)]
    self._img_cache = {}      # prefetched cutouts by _cutout_key

  def _draining(self) -> bool:
    return self.drain_flag is not None and self.drain_flag.is_set()

  # how often a worker re-reads <journal>/health/flags.json (one small GET)
  FLAG_POLL_SEC = 15.0

  def _straggler_flagged(self) -> bool:
    """True when the last ``fleet check`` flagged THIS worker (by its
    journal worker id): it then stops pre-leasing round i+1, so queue
    depth goes to healthy workers."""
    j = journal_mod.get_active()
    if j is None:
      return False
    now = time.monotonic()
    checked_at, flagged = self._flag_cache
    if now - checked_at < self.FLAG_POLL_SEC:
      return flagged
    try:
      from ..observability import health

      flagged = j.worker_id in health.flagged_workers(j.cloudpath)
    except Exception:
      flagged = False
    self._flag_cache = (now, flagged)
    return flagged

  def _current_id(self, lease_id):
    """The member's CURRENT lease token (renewals re-timestamp fq://
    tokens), and stop renewing it: every caller is about to delete, nack
    or release the lease."""
    return self._hb.untrack(lease_id) if self._hb is not None else lease_id

  def _release_members(self, members):
    """Drain path: hand still-leased members straight back to the queue
    instead of letting their leases age out."""
    for _task, lease_id in members:
      try:
        self.queue.release(self._current_id(lease_id))
      except Exception:
        continue  # worst case the lease ages out
      self.stats["released"] += 1
      telemetry.incr("drain.released", 1)

  # -- poll loop ------------------------------------------------------------

  def poll(
    self,
    stop_fn=None,
    max_backoff_window: float = 30.0,
    task_budget: Optional[int] = None,
  ) -> int:
    """Lease K → group → dispatch → complete each lease on its own, with
    ``poll_loop``'s stop_fn and backoff contract. ``task_budget`` caps the
    tasks executed: the loop never leases past what remains of it."""
    from ..queues.heartbeat import LeaseHeartbeat

    # ONE heartbeat spans the loop: round i+1's pre-leased members must
    # keep renewing while round i executes
    self._hb = LeaseHeartbeat(
      self.queue, self.lease_seconds, interval=self.heartbeat_seconds
    )
    self._hb.start()
    try:
      return self._poll_inner(stop_fn, max_backoff_window, task_budget)
    finally:
      self._hb.stop()
      self._hb = None

  def _poll_inner(self, stop_fn, max_backoff_window, task_budget) -> int:
    backoff = 1.0
    while True:
      if self._draining():
        self._surrender_prefetch()
        return self.stats["executed"]
      if stop_fn is not None and stop_fn(
        executed=self.stats["executed"], empty=False
      ):
        self._surrender_prefetch()
        return self.stats["executed"]
      cap = self.batch_size
      if task_budget is not None:
        cap = min(cap, task_budget - self.stats["executed"])
        if cap <= 0:
          self._surrender_prefetch()
          return self.stats["executed"]
      if self._next_round is not None and self._straggler_flagged():
        # flagged mid-flight: round i+1's pre-leased members go back to
        # the queue instead of waiting on this slow worker
        self._surrender_prefetch()
        self.stats["straggler_surrenders"] += 1
      members = self._take_prefetched()
      if len(members) > cap:
        # the budget shrank between prefetch and now: the surplus goes back
        self._release_members(members[cap:])
        members = members[:cap]
      lease_t0 = time.time()
      synced = []
      while len(members) < cap and not self._draining():
        got = self._lease_many(cap - len(members))
        if not got:
          break
        for leased in got:
          members.append(leased)
          self._hb.track(leased[1])
          synced.append(leased[1])
      if synced:
        # the round's queue interaction, on the worker trace
        attrs = {"members": len(synced)}
        sizes = _range_sizes(synced)
        if sizes:
          attrs["range_sizes"] = sizes
        trace.record_root("lease.acquire", lease_t0, time.time() - lease_t0, **attrs)
      if self._draining():
        # drained between lease and dispatch: nothing ran, all go back
        self._release_members(members)
        return self.stats["executed"]
      if not members:
        if stop_fn is not None and stop_fn(
          executed=self.stats["executed"], empty=True
        ):
          return self.stats["executed"]
        if self._try_steal():
          # a claim is filed: the holder's next renewal releases the
          # unstarted tail, so re-poll soon instead of backing off
          time.sleep(1.0 + random.random())
          continue
        if self.drain_flag is not None and hasattr(self.drain_flag, "wait"):
          self.drain_flag.wait(backoff + random.random())
        else:
          time.sleep(backoff + random.random())
        backoff = min(backoff * 2, max_backoff_window)
        continue
      backoff = 1.0
      # lease the NEXT round while this one dispatches and completes
      if len(members) == cap and (
        task_budget is None
        or task_budget - self.stats["executed"] - len(members) > 0
      ):
        if self._straggler_flagged():
          # flagged by the health plane: run what is held, pre-lease no
          # more; healthy workers take round i+1
          self.stats["straggler_prefetch_skips"] += 1
        else:
          next_cap = self.batch_size
          if task_budget is not None:
            next_cap = min(
              next_cap, task_budget - self.stats["executed"] - len(members)
            )
          from ..pipeline import shared_prefetch_pool

          self._next_round = shared_prefetch_pool().submit(
            self._prelease_and_prefetch, next_cap,
            self._round_write_set(members),
          )
      if self.timing:
        before = dict(self.stats, dispatches=dict(self.stats["dispatches"]))
        t0 = time.perf_counter()
        self.run_round(members)
        print(json.dumps({
          "round_members": len(members),
          "wall_s": round(time.perf_counter() - t0, 3),
          "executed": self.stats["executed"] - before["executed"],
          "failed": self.stats["failed"] - before["failed"],
          "solo": self.stats["solo"] - before["solo"],
          "group_fallbacks": (
            self.stats["group_fallbacks"] - before["group_fallbacks"]
          ),
          "dispatches": {
            k: v - before["dispatches"].get(k, 0)
            for k, v in self.stats["dispatches"].items()
            if v - before["dispatches"].get(k, 0)
          },
        }), flush=True)
      else:
        self.run_round(members)
      # round boundary: the round's spans (one lease.round and its
      # members' task spans) flush as one journal segment
      journal_mod.maybe_flush_active(event="round")

  def _try_steal(self) -> bool:
    """The idle worker's half of work stealing: the queue looks empty,
    but a long-held range lease may still pin unstarted members; claim
    the biggest so its holder's next renewal releases the unstarted tail
    to the pool. Off unless ``IGNEOUS_STEAL``; queues without
    ``steal_claim`` are skipped."""
    steal_claim = getattr(self.queue, "steal_claim", None)
    if steal_claim is None or not knobs.get_bool("IGNEOUS_STEAL"):
      return False
    try:
      seg = steal_claim()
    except Exception:
      return False
    if seg is None:
      return False
    self.stats["steal_claims"] += 1
    return True

  @staticmethod
  def _mark_started(lease_id):
    """Fence this member off work stealing, which carves only UNSTARTED
    members off a claimed range. Classic tokens have no mark and need
    none: stealing is range-only."""
    mark = getattr(lease_id, "mark_started", None)
    if mark is not None:
      mark()

  def _lease_many(self, n: int):
    """One queue interaction for up to ``n`` leases (``lease_batch`` where
    the backend has it: fq:// segments arrive as range members sharing
    one lease), else the scalar lease loop."""
    lease_batch = getattr(self.queue, "lease_batch", None)
    if lease_batch is not None:
      return lease_batch(self.lease_seconds, max_tasks=n)
    out = []
    while len(out) < n and not self._draining():
      leased = self.queue.lease(self.lease_seconds)
      if leased is None:
        break
      out.append(leased)
    return out

  # -- next-round prefetch --------------------------------------------------

  def _take_prefetched(self):
    fut, self._next_round = self._next_round, None
    if fut is None:
      return []
    return fut.result()

  def _surrender_prefetch(self):
    """Drain or stop: pre-leased members of a round that will never run
    go straight back to the queue."""
    try:
      self._release_members(self._take_prefetched())
    finally:
      self._img_cache.clear()

  def _round_write_set(self, members):
    """The (path, mip) image layers a round's members write, or None when
    a member's writes are unknowable. Fences the next round's cutout
    prefetch off chunks this round is still producing."""
    from ..tasks.ccl import CCLFacesTask
    from ..tasks.image import TransferTask
    from ..tasks.mesh import MeshTask
    from ..tasks.skeleton import SkeletonTask

    writes = set()
    for task, _lease_id in members:
      if isinstance(task, TransferTask):  # DownsampleTask included
        if not task.skip_first:
          writes.add((task.dest_path, int(task.mip)))
        if task.skip_downsamples:
          continue
        if task.num_mips is None:
          return None  # the pyramid depth resolves from dest metadata
        writes.update(
          (task.dest_path, int(task.mip) + m)
          for m in range(1, int(task.num_mips) + 1)
        )
      elif type(task) in (SkeletonTask, CCLFacesTask, MeshTask):
        # these write fragments and scratch files, never image chunks
        continue
      else:
        return None
    return writes

  def _invalidate_cache(self, writes):
    """Drop prefetched cutouts (and decoded chunks) whose (path, mip) a
    round wrote; ``writes=None`` drops everything."""
    from .. import chunk_cache

    if writes is None:
      self._img_cache.clear()
      chunk_cache.clear()
      return
    if not writes:
      return
    for ckey in [k for k in self._img_cache if (k[0], k[1]) in writes]:
      self._img_cache.pop(ckey, None)
    chunk_cache.invalidate_writes(writes)

  def _prelease_and_prefetch(self, cap: int, busy_writes=frozenset()):
    """Background half of the round pipeline: lease round i+1's members
    (renewed from lease time) and download the cutouts its downsample
    groups need, skipping any (path, mip) round i still writes. Download
    failures are dropped: the round's own download surfaces them."""
    members = []
    while len(members) < cap and not self._draining():
      got = self._lease_many(cap - len(members))
      if not got:
        break
      if self._draining():
        # the drain raced these leases: they go straight back, uncounted
        for leased in got:
          try:
            self.queue.release(leased[1])
          except Exception:
            pass
        break
      for leased in got:
        members.append(leased)
        if self._hb is not None:
          self._hb.track(leased[1])
    if not members:
      return members
    self.stats["prefetched_rounds"] += 1
    self._invalidate_cache(busy_writes)
    while len(self._img_cache) > 2 * max(cap, 1):
      self._img_cache.pop(next(iter(self._img_cache)), None)
    volmeta_cache = {}
    vols = {}
    from ..volume import Volume

    for task, _lease_id in members:
      if self._draining():
        break
      try:
        key = _group_key(task, volmeta_cache)
      except Exception:
        continue
      if key is None or key[0] != "downsample":
        continue
      ckey = _cutout_key(task)
      if ckey in self._img_cache:
        continue
      if busy_writes is None or (ckey[0], ckey[1]) in busy_writes:
        continue  # round i is still writing this (path, mip)
      vkey = (task.src_path, int(task.mip), bool(task.fill_missing))
      try:
        if vkey not in vols:
          vols[vkey] = Volume(
            task.src_path, mip=task.mip, fill_missing=task.fill_missing
          )
        vol = vols[vkey]
        box = Bbox.intersection(
          Bbox(task.offset, task.offset + task.shape), vol.meta.bounds(task.mip)
        )
        self._img_cache[ckey] = vol.download(box)
        self.stats["prefetched_cutouts"] += 1
        telemetry.incr("pipeline.lease.prefetched_cutouts", 1)
      except Exception:
        continue
    return members

  def run_round(self, members):
    """Execute one lease round: group, dispatch groups, solo the rest.
    Every member is heartbeat-renewed for the round; a drain releases
    the members not yet started."""
    from ..queues.heartbeat import LeaseHeartbeat

    owns_hb = self._hb is None  # a direct caller outside poll()
    if owns_hb:
      self._hb = LeaseHeartbeat(
        self.queue, self.lease_seconds, interval=self.heartbeat_seconds
      )
      self._hb.start()
    for _task, lease_id in members:
      self._hb.track(lease_id)  # idempotent for pre-leased members
    self.stats["rounds"] += 1
    t0 = time.time()
    before_exec = self.stats["executed"]
    before_fail = self.stats["failed"]
    try:
      self._run_round_inner(members)
    finally:
      # one lease round (group dispatches and member completions) on the
      # worker trace
      trace.record_root(
        "lease.round", t0, time.time() - t0, members=len(members),
        executed=self.stats["executed"] - before_exec,
        failed=self.stats["failed"] - before_fail,
      )
      # a member re-leased after a failure must never read a cutout that
      # this round's writes made stale
      self._invalidate_cache(self._round_write_set(members))
      if owns_hb:
        self._hb.stop()
        self._hb = None

  def _run_round_inner(self, members):
    volmeta_cache = {}
    groups = defaultdict(list)
    solo = []
    for task, lease_id in members:
      try:
        key = _group_key(task, volmeta_cache)
      except Exception:
        key = None  # unreadable metadata: the solo path surfaces it
      if key is None:
        solo.append((task, lease_id))
      else:
        groups[key].append((task, lease_id))

    for key, group in groups.items():
      if self._draining():
        self._release_members(group)
        continue
      if len(group) == 1:
        solo.extend(group)
        continue
      handler = {
        "downsample": self._run_downsample_group,
        "skeleton": self._run_skeleton_group,
        "ccl_faces": self._run_ccl_group,
        "mesh": self._run_mesh_group,
      }[key[0]]
      self._completed_in_group = set()
      for _task, lease_id in group:
        self._mark_started(lease_id)  # the group's work begins now
      try:
        handler(key, group)
      except Exception:
        # a group-stage failure (one member's corrupt chunk poisoning the
        # shared download, say): rerun the incomplete members solo in
        # this round on the same kernels, so only bad leases recycle
        if self.verbose:
          import traceback

          traceback.print_exc()
        self.stats["group_fallbacks"] += 1
        solo.extend(
          m for m in group if m[1] not in self._completed_in_group
        )

    for i, (task, lease_id) in enumerate(solo):
      if self._draining():
        self._release_members(solo[i:])
        return
      if self.verbose:
        print(f"Executing (solo) {task!r}")
      self._mark_started(lease_id)
      try:
        with trace.task_span(task, attempt=self._attempt_of(lease_id),
                             mode="batch-solo"):
          run_with_deadline(task.execute, self.task_deadline_seconds)
      except Exception as e:
        self._record_failure(lease_id, e)
        continue
      self.queue.delete(self._current_id(lease_id))
      self.stats["executed"] += 1
      self.stats["solo"] += 1
      LEDGER.record_fastpath(host=1)

  # -- completion -----------------------------------------------------------

  def _record_failure(self, lease_id, exc):
    """Every failed member's one bookkeeping path: its reason is recorded
    with the task (``queue.nack``), which dead-letters it once its
    deliveries run out."""
    if self.verbose:
      import traceback

      traceback.print_exc()
    telemetry.incr("tasks.failed", 1)
    self.stats["failed"] += 1
    if hasattr(self.queue, "nack"):
      self.queue.nack(self._current_id(lease_id), failure_reason(exc))

  def _complete(self, lease_id):
    self.queue.delete(self._current_id(lease_id))
    self.stats["executed"] += 1
    self.stats["batched"] += 1
    LEDGER.record_fastpath(batched=1)
    # group membership tracks the ORIGINAL token (what handlers hold)
    self._completed_in_group.add(lease_id)

  def _attempt_of(self, lease_id):
    try:
      if hasattr(self.queue, "delivery_count"):
        return int(self.queue.delivery_count(lease_id))
    except Exception:
      pass
    return None

  def _finish_members(self, group, finish_one):
    """Each member's host completion; a failure keeps that member's lease
    only."""
    for idx, (task, lease_id) in enumerate(group):
      try:
        # the member's completion span: its share of the round (the
        # shared dispatch is the round's lease.round span)
        with trace.task_span(task, attempt=self._attempt_of(lease_id),
                             mode="batched"):
          run_with_deadline(
            lambda: finish_one(idx, task), self.task_deadline_seconds
          )
      except Exception as e:
        self._record_failure(lease_id, e)
        continue
      self._complete(lease_id)

  # -- group handlers -------------------------------------------------------

  def _run_downsample_group(self, key, group):
    """K downsample cutouts → one ``ChunkExecutor`` pyramid launch for the
    full-shape members and a ``PagedPyramid`` for the clamped ones; the
    uploads go through ``downsample_and_upload`` so chunk bytes are solo's.
    Between page rounds a straggler-flagged worker sheds the clamped
    members none of whose pages ran back to the queue, so healthy workers
    take them; it finishes only the members it kept."""
    from ..ops import pooling
    from ..pipeline import SerialSink, config as pcfg
    from ..pipeline import shared_encode_pool, shared_prefetch_pool
    from ..tasks.image import _resolve_factors, downsample_and_upload
    from ..volume import Volume
    from .batch_runner import device_pyramid_batch
    from .executor import cached_chunk_executor

    t0 = group[0][0]
    src = Volume(t0.src_path, mip=t0.mip, fill_missing=t0.fill_missing)
    dest = Volume(
      t0.dest_path, mip=t0.mip, fill_missing=t0.fill_missing,
      delete_black_uploads=t0.delete_black_uploads,
      background_color=t0.background_color,
    )
    factors = _resolve_factors(dest, t0.mip, t0.shape, t0.num_mips, t0.factor)
    if not factors:
      # nothing to produce: solo execution is the same clean no-op
      for _task, lease_id in group:
        self._complete(lease_id)
      return
    method = pooling.method_for_layer(dest.layer_type, t0.downsample_method)
    bounds = src.meta.bounds(t0.mip)
    boxes = [
      Bbox.intersection(Bbox(t.offset, t.offset + t.shape), bounds)
      for t, _ in group
    ]
    nominal = tuple(int(v) for v in t0.shape)  # shared by the key
    full_idx = [
      k for k, b in enumerate(boxes)
      if tuple(int(v) for v in b.size3()) == nominal
    ]
    ragged_idx = [k for k in range(len(boxes)) if k not in full_idx]

    def fetch(pair):
      k, task = pair
      img = self._img_cache.pop(_cutout_key(task), None)
      if img is not None and (
        tuple(int(v) for v in img.shape[:3])
        == tuple(int(v) for v in boxes[k].size3())
      ):
        return img
      with telemetry.stage("download"):
        return src.download(boxes[k])

    imgs = list(shared_prefetch_pool().map(
      fetch, list(enumerate(t for t, _ in group))
    ))

    mips_out = None
    full_pos = {k: j for j, k in enumerate(full_idx)}
    if full_idx:
      executor = cached_chunk_executor(
        factors=tuple(factors), method=method, sparse=t0.sparse,
      )
      mips_out = device_pyramid_batch(executor, [imgs[k] for k in full_idx])
      self.stats["dispatches"]["downsample"] += 1

    pyramid = None
    ragged_pos = {k: j for j, k in enumerate(ragged_idx)}
    released = set()
    if ragged_idx:
      from .paged import PagedPyramid

      pyramid = PagedPyramid(
        [imgs[k] for k in ragged_idx], tuple(factors), len(factors),
        method=method, sparse=t0.sparse,
      )
      while pyramid.pending:
        if self._straggler_flagged():
          shed = pyramid.split_unstarted()
          if shed:
            self._release_members([group[ragged_idx[j]] for j in shed])
            self.stats["paged_splits"] += len(shed)
            for j in shed:
              k = ragged_idx[j]
              released.add(k)
              # the lease is back in the queue for a healthy worker: a
              # group fallback must not also rerun it solo here
              self._completed_in_group.add(group[k][1])
        if not pyramid.pending:
          break
        pyramid.run_round()
        self.stats["dispatches"]["downsample_paged"] += 1
    del imgs
    idx_map = [k for k in range(len(group)) if k not in released]

    def finish(j, task):
      k = idx_map[j]
      # the member's chunk encodes and puts on the shared pool, joined
      # inside its own deadline window before its lease is deleted
      sink = (
        shared_encode_pool().ticket() if pcfg.use_threads() else SerialSink()
      )
      mips = (
        pyramid.result(ragged_pos[k]) if k in ragged_pos
        else [m[full_pos[k]].transpose(3, 2, 1, 0) for m in mips_out]
      )
      try:
        downsample_and_upload(
          None, boxes[k], dest,
          task_shape=task.shape, mip=task.mip, num_mips=task.num_mips,
          factor=task.factor, sparse=task.sparse,
          method=task.downsample_method, compress=task.compress,
          _mips_out=mips, sink=sink,
        )
      finally:
        sink.join()

    self._finish_members([group[k] for k in idx_map], finish)

  def _run_skeleton_group(self, key, group):
    """K skeleton cutouts → one ``paged_edt`` (three ``edt_pass``
    launches); tracing and uploads run through
    ``SkeletonTask.execute(_prepared, _edt_field)``."""
    from ..pipeline import shared_prefetch_pool
    from ..volume import Volume
    from .paged import paged_edt

    t0 = group[0][0]
    vol = Volume(
      t0.cloudpath, mip=t0.mip, fill_missing=t0.fill_missing, bounded=False
    )
    anis = tuple(float(v) for v in vol.resolution)

    def prep(task):
      return task.prepare_labels(Volume(
        t0.cloudpath, mip=t0.mip, fill_missing=task.fill_missing,
        bounded=False,
      ))

    preps = list(shared_prefetch_pool().map(prep, [t for t, _ in group]))
    live = [i for i, p in enumerate(preps) if p is not None]
    fields = {}
    if live:
      edts = paged_edt([preps[i][0] for i in live], anis)
      self.stats["dispatches"]["skeleton"] += 1
      fields = dict(zip(live, edts))

    def finish(k, task):
      if preps[k] is None:
        return  # empty core: solo execute() is the same clean no-op
      task.execute(_prepared=preps[k], _edt_field=fields[k])

    self._finish_members(group, finish)

  def _run_ccl_group(self, key, group):
    """K CCL cutouts → one batched CCL (``tile_resolve``); face planes are
    stored by the helpers ``CCLFacesTask.execute`` uses."""
    import numpy as np

    from ..ops.ccl import _batch_executor, connected_components_batch
    from ..pipeline import shared_prefetch_pool
    from ..storage import CloudFiles
    from ..tasks.ccl import (
      _offset_components,
      _prep_ccl_image,
      ccl_scratch_path,
      store_ccl_faces,
    )
    from .paged import ccl_page_compatible, paged_ccl

    t0 = group[0][0]
    files = CloudFiles(t0.src_path)
    scratch = ccl_scratch_path(t0.src_path, t0.mip)

    def prep(task):
      return _prep_ccl_image(
        task.src_path, task.mip, task.shape, task.offset,
        task.fill_missing, task.threshold_gte, task.threshold_lte,
        task.dust_threshold,
      )

    preps = list(shared_prefetch_pool().map(prep, [t for t, _ in group]))
    if ccl_page_compatible():
      comps = paged_ccl([p[0] for p in preps], 6)
    else:
      comps = connected_components_batch(
        np.stack([p[0] for p in preps]), executor=_batch_executor(6)
      )
    self.stats["dispatches"]["ccl_faces"] += 1

    def finish(k, task):
      _img, cutout, core = preps[k]
      cc = _offset_components(comps[k], task.task_num, task.shape)
      store_ccl_faces(cc, cutout, core, task.task_num, files, scratch)

    self._finish_members(group, finish)

  def _run_mesh_group(self, key, group):
    """K mesh cutouts → the count pass batched across every member's
    labels (one dispatch a mask bucket); emission, weld, simplification
    and upload stay per task."""
    from ..tasks.mesh import execute_mesh_tasks_batched

    dispatches = execute_mesh_tasks_batched([t for t, _ in group])
    self.stats["dispatches"]["mesh"] += dispatches

    def finish(k, task):
      err = getattr(task, "_batch_error", None)
      if err is not None:
        task._batch_error = None
        raise err

    self._finish_members(group, finish)


def poll_batched(
  queue,
  batch_size: int = 8,
  lease_seconds: float = 600,
  verbose: bool = False,
  stop_fn=None,
  max_backoff_window: float = 30.0,
  task_budget: Optional[int] = None,
  timing: bool = False,
  task_deadline_seconds: Optional[float] = None,
  heartbeat_seconds: Optional[float] = None,
  drain_flag=None,
):
  """Functional entry point mirroring ``queues.filequeue.poll_loop``;
  returns (executed, stats)."""
  batcher = LeaseBatcher(
    queue, batch_size=batch_size, lease_seconds=lease_seconds,
    verbose=verbose, timing=timing,
    task_deadline_seconds=task_deadline_seconds,
    heartbeat_seconds=heartbeat_seconds, drain_flag=drain_flag,
  )
  executed = batcher.poll(
    stop_fn=stop_fn, max_backoff_window=max_backoff_window,
    task_budget=task_budget,
  )
  return executed, batcher.stats
