"""Deterministic discrete-event fleet simulator over a mined workload.

The port's own copy of ``igneous_tpu/observability/sim.py``: pure Python,
so the same seed, model and config give the JAX package's results dict
and journal bytes exactly.

Takes a :class:`~.replay.WorkloadModel` (empirical per-type duration
samples, failure rates, round overhead, worker-speed spread mined from a
real journal) and replays a campaign through N **virtual** workers on a
virtual clock, modeling the semantics that actually decide campaign
shape:

* lease / redeliver / nack / DLQ-after-max-deliveries, with lease-expiry
  recycling and zombie fencing (a late completion on an expired lease is
  discarded and counted, exactly like the real queue);
* pre-lease rounds (``batch_size`` members per round, ``lease.acquire``
  overhead drawn from the mined distribution, straggler flag dropping a
  flagged worker to single-member rounds);
* chaos fault modes — graceful preemption (finish in-flight member,
  release the rest, clean ``drain`` exit), hard kill (silent death,
  leases recycle at expiry), stragglers (mined speed tail amplified),
  stall (lease a round then go dark: the recycle + fence path);
* an optional **virtual autoscale controller** ticking the same
  :class:`~.autoscale.PolicyLoop` the live controller runs — this is how
  a policy is tuned before it touches a real fleet.

Two contracts matter more than realism:

1. **Determinism** — one seeded ``random.Random``, a (time, seq) heap
   for total event order, counter-derived span/trace ids, and a fixed
   ``base_ts`` anchor (default 0.0, i.e. *no wall-clock anywhere*): the
   same seed + model + config produce bit-identical results AND
   bit-identical journal bytes.
2. **Journal-format output** — :meth:`FleetSimulator.write_journal`
   emits per-worker segments indistinguishable in shape from real ones,
   so ``igneous fleet status|check|watch|top``, the HealthEngine, the
   Perfetto exporter, and even :func:`~.replay.mine_journal` itself run
   unchanged on a simulated campaign.
"""

from __future__ import annotations

import heapq
import random
from collections import deque
from dataclasses import dataclass, field, fields
from typing import Dict, List, Optional

from .autoscale import AutoscalePolicy, PolicyLoop

from .. import secrets as knobs


@dataclass
class ChaosSpec:
  """Fault injection: how many workers misbehave, and when (sim-seconds;
  a time of 0 auto-picks a fraction of the naive makespan estimate so
  the fault lands mid-campaign regardless of scale)."""

  preempt: int = 0          # graceful SIGTERM-style drains
  preempt_at: float = 0.0
  kill: int = 0             # silent deaths — leases recycle at expiry
  kill_at: float = 0.0
  stragglers: int = 0       # speed multiplied by straggler_factor
  straggler_factor: float = 4.0
  stall: int = 0            # lease one round, then go dark
  stall_at: float = 0.0

  def any(self) -> bool:
    return bool(self.preempt or self.kill or self.stragglers or self.stall)


@dataclass
class SimConfig:
  workers: int = 4
  seed: int = 0
  tasks: Optional[int] = None      # total tasks; None = replay mined mix
  batch_size: int = 1
  lease_sec: float = 60.0
  max_deliveries: int = 5
  poll_sec: float = 2.0
  worker_start_sec: float = 5.0    # spawn -> first lease (autoscale adds)
  fail_scale: float = 1.0          # multiply mined failure probabilities
  base_ts: float = 0.0             # journal timestamp anchor (0 = virtual)
  replay_worker_speeds: bool = True
  autoscale: bool = False
  policy: Optional[AutoscalePolicy] = None
  autoscale_interval_sec: float = 15.0
  rate_window_sec: float = 60.0    # completion-rate window for the loop
  cost_per_worker_hour: float = 0.0
  chaos: ChaosSpec = field(default_factory=ChaosSpec)
  max_sim_sec: float = 30 * 24 * 3600.0
  segment_spans: int = 512         # spans per emitted journal segment
  range_lease: int = 0             # 1 = one shared lease per round
  # campaign survival: duplicate-issue the leased members of
  # slow/stalled holders (first resolution wins, the loser fences) and
  # let idle workers carve the unstarted tails of long-held rounds
  speculate: int = 0
  speculate_interval_sec: float = 10.0
  steal: int = 0
  steal_min_held_sec: float = 5.0
  # replay an OBSERVED fleet trajectory: one worker spawned per entry,
  # at that sim-second offset (0 = campaign start). Overrides `workers`
  # for the initial population — replacements an external autoscaler
  # produced are just later entries, so a forecast can hold the fleet
  # history fixed and test only the execution/lease/survival model.
  worker_arrivals: Optional[List[float]] = None

  _ENV = {
    "workers": "IGNEOUS_SIM_WORKERS",
    "seed": "IGNEOUS_SIM_SEED",
    "batch_size": "IGNEOUS_SIM_BATCH",
    "lease_sec": "IGNEOUS_SIM_LEASE_SEC",
    "max_deliveries": "IGNEOUS_SIM_MAX_DELIVERIES",
    "poll_sec": "IGNEOUS_SIM_POLL_SEC",
    "worker_start_sec": "IGNEOUS_SIM_WORKER_START_SEC",
    "fail_scale": "IGNEOUS_SIM_FAIL_SCALE",
    "max_sim_sec": "IGNEOUS_SIM_MAX_SEC",
    "range_lease": "IGNEOUS_SIM_RANGE_LEASE",
    "speculate": "IGNEOUS_SIM_SPECULATE",
    "steal": "IGNEOUS_SIM_STEAL",
  }
  _INT_FIELDS = ("workers", "seed", "tasks", "batch_size",
                 "max_deliveries", "segment_spans", "range_lease",
                 "speculate", "steal")

  @classmethod
  def from_env(cls, **overrides) -> "SimConfig":
    kw = {}
    for f in fields(cls):
      if f.name.startswith("_"):
        continue
      val = overrides.get(f.name)
      if val is None and f.name in cls._ENV:
        val = knobs.opt_float(cls._ENV[f.name])
      if val is not None:
        kw[f.name] = val
    cfg = cls(**kw)
    for name in cls._INT_FIELDS:
      val = getattr(cfg, name)
      if val is not None:
        setattr(cfg, name, int(val))
    return cfg


class _SimWorker:
  __slots__ = (
    "wid", "speed", "mode", "alive", "draining", "exited", "exit_event",
    "start_t", "end_t", "records", "counters", "round_state", "rounds",
    "busy_sec", "completed", "straggler_flagged", "stalled",
  )

  def __init__(self, wid: str, speed: float):
    self.wid = wid
    self.speed = speed
    self.mode = "normal"       # normal | straggler | stall
    self.alive = False
    self.draining = False
    self.exited = False
    self.exit_event = None     # "exit" | "drain" | None (killed/stalled)
    self.start_t = None
    self.end_t = None
    self.records: List[dict] = []
    self.counters: Dict[str, int] = {}
    self.round_state = None
    self.rounds = 0
    self.busy_sec = 0.0
    self.completed = 0
    self.straggler_flagged = False
    self.stalled = False

  def incr(self, key: str, n: int = 1) -> None:
    self.counters[key] = self.counters.get(key, 0) + n


class FleetSimulator:
  """One simulation run. Construct, :meth:`run`, then optionally
  :meth:`write_journal`. Instances are single-use."""

  DRIVER_ID = "sim-driver"

  def __init__(self, model, config: Optional[SimConfig] = None):
    self.model = model
    self.cfg = config or SimConfig()
    self.rng = random.Random(self.cfg.seed)
    self._heap: list = []
    self._evseq = 0
    self._id_counter = 0
    self._lease_seq = 0
    self._wseq = 0
    self.t = 0.0
    self.done = False
    self.timed_out = False
    self.makespan: Optional[float] = None
    self.tasks: List[dict] = []
    self.pending: deque = deque()
    self.workers: Dict[str, _SimWorker] = {}
    self.driver = _SimWorker(self.DRIVER_ID, 1.0)
    self.completion_log: List[float] = []
    self.scale_events: List[dict] = []
    self.peak_workers = 0
    self.terminal = 0          # done + dlq
    self.dlq = 0
    self.failed_deliveries = 0
    self.lease_recycles = 0
    self.zombie_fenced = 0
    self.released = 0
    self.range_rounds = 0
    self.spec_issued = 0       # campaign survival
    self.spec_won = 0
    self.spec_fenced = 0
    self.spec_dup = 0
    self.steals = 0
    self.steal_tasks = 0
    self.policy_loop = PolicyLoop(
      self.cfg.policy or AutoscalePolicy()
    ) if self.cfg.autoscale else None
    self._ran = False

  # -- plumbing -------------------------------------------------------------

  def _push(self, t: float, fn) -> None:
    self._evseq += 1
    heapq.heappush(self._heap, (t, self._evseq, fn))

  def _sid(self) -> str:
    self._id_counter += 1
    return f"{self._id_counter:016x}"

  def _trace_id(self) -> str:
    self._id_counter += 1
    return f"sim{self.cfg.seed & 0xFFFF:04x}{self._id_counter:012x}"

  def _span(self, w: _SimWorker, name: str, ts: float, dur: float,
            trace: Optional[str] = None, parent: Optional[str] = None,
            span: Optional[str] = None, **attrs) -> dict:
    rec = {
      "kind": "span",
      "trace": trace or self._trace_id(),
      "span": span or self._sid(),
      "parent": parent,
      "name": name,
      "ts": round(ts, 6),
      "dur": round(dur, 6),
    }
    rec.update(attrs)
    w.records.append(rec)
    return rec

  # -- setup ----------------------------------------------------------------

  def _build_tasks(self) -> None:
    mix = self.model.task_mix()
    if not mix:
      mix = {"Task": max(self.cfg.tasks or 1, 1)}
    if self.cfg.tasks:
      total = sum(mix.values())
      scaled, rema = {}, []
      for name in sorted(mix):
        exact = mix[name] * self.cfg.tasks / total
        scaled[name] = int(exact)
        rema.append((-(exact - int(exact)), name))
      short = self.cfg.tasks - sum(scaled.values())
      for _, name in sorted(rema)[:short]:
        scaled[name] += 1
      mix = {k: v for k, v in scaled.items() if v > 0}
    names = [name for name in sorted(mix) for _ in range(mix[name])]
    self.rng.shuffle(names)   # deterministic interleave of the type mix
    for i, name in enumerate(names):
      self.tasks.append({
        "i": i, "type": name, "state": "pending", "deliveries": 0,
        "enqueue_t": 0.0, "lease_token": 0, "lease_worker": None,
        "done_t": None,
        # speculation: a leased task can carry a second live
        # lease — the twin. spec: None -> "wait" (twin queued) ->
        # "open" (twin leased) -> "resolved" (first terminal ack won)
        "twin_token": 0, "twin_worker": None, "spec": None,
      })
      self.pending.append(i)

  def _naive_makespan(self) -> float:
    """Serial work / worker count: the chaos auto-time anchor."""
    total = 0.0
    for name, t in self.model.task_types.items():
      durs = t.get("durs") or ()
      mean = (sum(durs) / len(durs)) if durs else 1.0
      count = sum(1 for task in self.tasks if task["type"] == name)
      total += mean * count
    unmodeled = sum(
      1 for task in self.tasks if task["type"] not in self.model.task_types
    )
    total += float(unmodeled)
    return max(total / max(self.cfg.workers, 1), 1.0)

  def _add_worker(self, t: float, delay: float = 0.0) -> _SimWorker:
    wid = f"sim-w{self._wseq:03d}"
    self._wseq += 1
    speed = (
      self.model.sample_worker_speed(self.rng)
      if self.cfg.replay_worker_speeds else 1.0
    )
    w = _SimWorker(wid, max(speed, 0.05))
    self.workers[wid] = w
    self._push(t + delay, lambda: self._worker_start(w))
    return w

  def _pool(self) -> List[_SimWorker]:
    """The autoscaler's view of "current": everything spawned and not
    yet exited or draining (a scheduled-but-unstarted worker counts — it
    was paid for)."""
    return [
      w for w in self.workers.values()
      if not w.exited and not w.draining and not w.stalled
    ]

  def _assign_chaos(self) -> None:
    chaos = self.cfg.chaos
    if not chaos.any():
      return
    est = self._naive_makespan()
    order = [self.workers[k] for k in sorted(self.workers)]
    cursor = 0
    for _ in range(min(chaos.stragglers, len(order))):
      w = order[cursor % len(order)]
      w.mode = "straggler"
      w.speed *= max(chaos.straggler_factor, 1.0)
      cursor += 1
    for _ in range(min(chaos.stall, len(order) - 1)):
      w = order[cursor % len(order)]
      if w.mode == "normal":
        w.mode = "stall"
      cursor += 1
    kill_at = chaos.kill_at or est * 0.4
    for _ in range(min(chaos.kill, max(len(order) - 1, 0))):
      w = order[cursor % len(order)]
      cursor += 1
      self._push(kill_at, lambda w=w: self._kill(w))
    preempt_at = chaos.preempt_at or est * 0.25
    for _ in range(min(chaos.preempt, max(len(order) - 1, 0))):
      w = order[cursor % len(order)]
      cursor += 1
      self._push(preempt_at, lambda w=w: self._preempt(w))

  # -- worker lifecycle -----------------------------------------------------

  def _worker_start(self, w: _SimWorker) -> None:
    if w.exited:
      return
    w.alive = True
    w.start_t = self.t
    self.peak_workers = max(self.peak_workers, len(self._pool()))
    self._poll(w)

  def _clean_exit(self, w: _SimWorker) -> None:
    w.alive = False
    w.exited = True
    w.exit_event = "exit"
    w.end_t = self.t

  def _drain_exit(self, w: _SimWorker, released: List[int]) -> None:
    for i in released:
      task = self.tasks[i]
      if task["state"] != "leased":
        continue
      if task["lease_worker"] == w.wid:
        task["lease_token"] = 0
        task["lease_worker"] = None
      elif task["twin_worker"] == w.wid:
        task["twin_token"] = 0
        task["twin_worker"] = None
      else:
        continue
      # requeue only when no speculative twin survives us — a live
      # twin keeps the index; requeueing would fence its completion
      if not (task["lease_token"] or task["twin_token"]):
        task["state"] = "pending"
        self.pending.append(i)
      w.incr("drain.released")
      self.released += 1
    rs = w.round_state
    if rs is not None:
      self._span(
        w, "lease.round", rs["t0"], self.t - rs["t0"],
        members=len(rs["members"]), executed=rs["executed"],
        failed=rs["failed"], drained=len(released),
      )
      w.round_state = None
    w.alive = False
    w.exited = True
    w.exit_event = "drain"
    w.end_t = self.t

  def _preempt(self, w: _SimWorker) -> None:
    if w.exited or not w.alive:
      return
    w.draining = True
    self._span(w, "sim.preempt", self.t, 0.0)
    if w.round_state is None:
      # idle: drain immediately rather than waiting for the next poll
      self._drain_exit(w, [])

  def _kill(self, w: _SimWorker) -> None:
    if w.exited:
      return
    w.alive = False
    w.exited = True
    w.exit_event = None   # silent death: no clean-exit record
    w.end_t = self.t
    # leased members recycle at their already-scheduled expiry events

  def _poll(self, w: _SimWorker) -> None:
    if not w.alive or w.exited:
      return
    if w.draining:
      return self._drain_exit(w, [])
    members: List[int] = []
    twins: List[int] = []
    cap = 1 if w.straggler_flagged else max(self.cfg.batch_size, 1)
    use_range = bool(self.cfg.range_lease)
    while self.pending and len(members) < cap:
      i = self.pending.popleft()
      task = self.tasks[i]
      if task["state"] == "leased":
        # speculative duplicate-issue: the original holder
        # keeps its lease — this worker runs a twin copy with its own
        # token; first resolution wins, the loser's ack fences
        if task["spec"] != "wait" or task["lease_worker"] == w.wid:
          continue   # resolved / recycled / own lease: stale entry
        task["spec"] = "open"
        task["deliveries"] += 1
        task["twin_worker"] = w.wid
        if not use_range:
          self._lease_seq += 1
          task["twin_token"] = self._lease_seq
          tok = self._lease_seq
          self._push(
            self.t + self.cfg.lease_sec,
            lambda i=i, tok=tok: self._lease_expire(i, tok),
          )
        else:
          twins.append(i)
        members.append(i)
        continue
      if task["state"] != "pending":
        continue   # reached terminal state while a stale entry sat queued
      task["state"] = "leased"
      task["deliveries"] += 1
      task["lease_worker"] = w.wid
      if not use_range:
        self._lease_seq += 1
        task["lease_token"] = self._lease_seq
        tok = self._lease_seq
        self._push(
          self.t + self.cfg.lease_sec,
          lambda i=i, tok=tok: self._lease_expire(i, tok),
        )
      members.append(i)
    if use_range and members:
      # range lease: the round holds ONE shared token and ONE
      # expiry event, mirroring an fq:// segment lease — completed /
      # nacked members change state individually (sub-task accounting),
      # so the shared expiry recycles only still-leased survivors
      self._lease_seq += 1
      tok = self._lease_seq
      twin_set = set(twins)
      for i in members:
        if i in twin_set:
          self.tasks[i]["twin_token"] = tok
        else:
          self.tasks[i]["lease_token"] = tok
      self._push(
        self.t + self.cfg.lease_sec,
        lambda m=tuple(members), tok=tok: self._range_expire(m, tok),
      )
      self.range_rounds += 1
      w.incr("sim.range_rounds")
    if not members:
      if self.done:
        return self._clean_exit(w)
      if self.cfg.steal and self._steal(w):
        # a claim was serviced: the carved tail is back in pending —
        # re-poll now instead of sleeping through the backoff
        self._push(self.t, lambda: self._poll(w))
        return
      self._push(self.t + self.cfg.poll_sec, lambda: self._poll(w))
      return
    w.rounds += 1
    overhead = self.model.sample_round_overhead(self.rng)
    w.round_state = {
      "members": members, "i": 0, "t0": self.t,
      "executed": 0, "failed": 0,
    }
    if overhead > 0:
      attrs = {"members": len(members)}
      if use_range:
        attrs["range_sizes"] = [len(members)]
      self._span(w, "lease.acquire", self.t, overhead, **attrs)
    if w.mode == "stall" and not w.stalled:
      # the zombie scenario: a round is leased, then the worker goes
      # dark holding it — expiry recycles the members, and any fence
      # accounting lands when (never, here) it wakes
      w.stalled = True
      w.incr("sim.stalled_rounds")
      self._span(w, "sim.stall", self.t, 0.0, members=len(members))
      return
    self._push(self.t + overhead, lambda: self._exec_next(w))

  def _exec_next(self, w: _SimWorker) -> None:
    if not w.alive or w.exited:
      return
    rs = w.round_state
    if rs is None:
      return
    if w.draining:
      return self._drain_exit(w, rs["members"][rs["i"]:])
    if rs["i"] >= len(rs["members"]):
      self._span(
        w, "lease.round", rs["t0"], self.t - rs["t0"],
        members=len(rs["members"]), executed=rs["executed"],
        failed=rs["failed"],
      )
      w.round_state = None
      # mined speed tail >2x fleet median mirrors the lease batcher's
      # straggler flag: subsequent rounds lease a single member
      if w.speed > 2.0 and not w.straggler_flagged:
        w.straggler_flagged = True
        w.incr("sim.straggler_flagged")
      self._push(self.t, lambda: self._poll(w))
      return
    i = rs["members"][rs["i"]]
    task = self.tasks[i]
    if task["state"] == "leased" and task["lease_worker"] == w.wid:
      tok = task["lease_token"]
    elif task["state"] == "leased" and task["twin_worker"] == w.wid:
      tok = task["twin_token"]   # we hold the speculative twin side
    else:
      # lease recycled or stolen from under us before the member started
      rs["i"] += 1
      self._push(self.t, lambda: self._exec_next(w))
      return
    dur = self.model.sample_duration(task["type"], self.rng) * w.speed
    dur = max(dur, 1e-6)
    fail_p = min(
      self.model.fail_prob(task["type"]) * self.cfg.fail_scale, 0.95,
    )
    fail = self.rng.random() < fail_p
    start_t = self.t
    self._push(
      self.t + dur,
      lambda: self._member_done(w, i, tok, start_t, dur, fail),
    )

  def _member_done(self, w: _SimWorker, i: int, tok: int,
                   start_t: float, dur: float, fail: bool) -> None:
    if w.exited or not w.alive:
      return   # killed mid-member: work lost, lease recycles at expiry
    rs = w.round_state
    task = self.tasks[i]
    w.busy_sec += dur
    side = (
      "twin" if (task["twin_token"] and tok == task["twin_token"])
      else "orig"
    )
    live = task["state"] == "leased" and (
      tok == task["lease_token"] or
      (task["twin_token"] and tok == task["twin_token"])
    )
    if not live:
      # lease expired / recycled mid-execution, or the speculative twin
      # already resolved this index: the completion is fenced exactly
      # like the real queue's zombie + done-marker paths
      w.incr("zombie.delete")
      self.zombie_fenced += 1
      if task["spec"] == "resolved":
        w.incr("speculation.duplicate_ack")
        self.spec_dup += 1
      self._span(
        w, "task", start_t, dur, task=task["type"],
        attempt=task["deliveries"], fenced=True,
      )
    else:
      attempt = task["deliveries"]
      tid = self._trace_id()
      task_sid = self._sid()
      wait = max(start_t - task["enqueue_t"], 0.0)
      self._span(
        w, "queue.wait", task["enqueue_t"], wait,
        trace=tid, parent=task_sid, attempt=attempt,
      )
      if fail:
        w.incr("tasks.failed")
        self.failed_deliveries += 1
        self._span(
          w, "task", start_t, dur, trace=tid, span=task_sid,
          task=task["type"], attempt=attempt, error="SimFault",
        )
        # retire the acking side; a surviving twin/orig keeps running
        # and owns the remaining retry budget
        if side == "twin":
          task["twin_token"] = 0
          task["twin_worker"] = None
        else:
          task["lease_token"] = 0
          task["lease_worker"] = None
        if task["lease_token"] or task["twin_token"]:
          pass   # the other side is still live: no requeue, no dlq
        elif (
          self.cfg.max_deliveries
          and attempt >= self.cfg.max_deliveries
        ):
          task["state"] = "dlq"
          w.incr("dlq.promoted")
          self.dlq += 1
          if task["spec"] in ("wait", "open"):
            # the pair resolved by exhaustion, not by a win: account it
            # as fenced so won + fenced == issued still reconciles
            task["spec"] = "resolved"
            w.incr("speculation.fenced")
            self.spec_fenced += 1
          self._terminal()
        else:
          w.incr("retries.nack")
          task["state"] = "pending"
          self.pending.append(i)
      else:
        self._span(
          w, "task", start_t, dur, trace=tid, span=task_sid,
          task=task["type"], attempt=attempt,
        )
        task["state"] = "done"
        task["done_t"] = self.t
        if task["spec"] in ("wait", "open"):
          # first terminal ack wins the pair — the done-marker seam
          task["spec"] = "resolved"
          if side == "twin":
            w.incr("speculation.won")
            self.spec_won += 1
          else:
            w.incr("speculation.fenced")
            self.spec_fenced += 1
        w.completed += 1
        self.completion_log.append(self.t)
        self._terminal()
    if rs is not None:
      rs["i"] += 1
      if fail:
        rs["failed"] += 1
      else:
        rs["executed"] += 1
      self._push(self.t, lambda: self._exec_next(w))

  def _expire_side(self, i: int, tok: int) -> bool:
    """Retire whichever side (original lease or speculative twin) of
    task ``i`` holds ``tok``. The task recycles back to pending only
    when no other live side remains — a surviving twin keeps running
    and owns the index. Returns True when the task was recycled."""
    task = self.tasks[i]
    if task["state"] != "leased":
      return False
    if task["lease_token"] == tok:
      task["lease_token"] = 0
      task["lease_worker"] = None
    elif task["twin_token"] and task["twin_token"] == tok:
      task["twin_token"] = 0
      task["twin_worker"] = None
    else:
      return False
    if task["lease_token"] or task["twin_token"]:
      return False
    task["state"] = "pending"
    self.pending.append(i)
    return True

  def _lease_expire(self, i: int, tok: int) -> None:
    if self._expire_side(i, tok):
      self.driver.incr("retries.lease_recycle")
      self.lease_recycles += 1

  def _range_expire(self, members, tok: int) -> None:
    """Shared-token expiry for a range-leased round: recycle every member
    still holding the round's token. Members already done / dlq'd / nacked
    back to pending (sub-task accounting) are untouched."""
    recycled = sum(1 for i in members if self._expire_side(i, tok))
    if recycled:
      self.driver.incr("retries.lease_recycle", recycled)
      self.lease_recycles += recycled

  # -- campaign survival -----------------------------------------------------

  def _speculate_tick(self) -> None:
    """The campaign runner's speculation sweep: duplicate-issue every
    leased task whose holder is stalled, straggler-slow, or dead with
    an unexpired lease (the live runner's silent-holder trigger). First
    terminal ack wins the pair; the loser fences — exactly the live
    ``speculate_flagged`` + done-marker protocol."""
    if self.done:
      return
    issued = 0
    for task in self.tasks:
      if task["state"] != "leased" or task["spec"] is not None:
        continue
      holder = self.workers.get(task["lease_worker"])
      if holder is None:
        continue
      # a dead holder's unexpired lease is journal-silent: the live
      # runner's silent-holder trigger twins it instead of waiting out
      # lease expiry, so the sim must too (exited-with-leases = killed;
      # drains release on the way out and never reach here)
      if not holder.exited and not (
        holder.stalled or holder.mode == "straggler"
        or holder.straggler_flagged
      ):
        continue
      task["spec"] = "wait"
      self.pending.append(task["i"])
      issued += 1
    if issued:
      self.spec_issued += issued
      self.driver.incr("speculation.issued", issued)
      self._span(self.driver, "sim.speculate", self.t, 0.0, twinned=issued)
    self._push(self.t + self.cfg.speculate_interval_sec,
               self._speculate_tick)

  def _steal(self, w: _SimWorker) -> bool:
    """Idle worker carves the unstarted tail off the longest round held
    past ``steal_min_held_sec`` — the claim-file handshake collapsed to
    its effect (the holder's heartbeat releases; here it is immediate
    and deterministic). Returns True when tasks were released."""
    best = None
    for wid in sorted(self.workers):
      v = self.workers[wid]
      rs = v.round_state
      if v is w or rs is None:
        continue
      if self.t - rs["t0"] < self.cfg.steal_min_held_sec:
        continue
      tail = [
        i for i in rs["members"][rs["i"] + 1:]
        if self.tasks[i]["state"] == "leased"
        and self.tasks[i]["lease_worker"] == v.wid
        and self.tasks[i]["spec"] is None
      ]
      if len(tail) >= 2 and (best is None or len(tail) > len(best[1])):
        best = (v, tail)
    if best is None:
      return False
    v, tail = best
    grant = tail[-(len(tail) // 2):]   # holder keeps at least half + current
    for i in grant:
      task = self.tasks[i]
      task["state"] = "pending"
      task["lease_token"] = 0
      task["lease_worker"] = None
      self.pending.append(i)
    grant_set = set(grant)
    rs = v.round_state
    rs["members"] = [i for i in rs["members"] if i not in grant_set]
    w.incr("steal.claims")
    v.incr("steal.granted")
    v.incr("steal.tasks", len(grant))
    self.steals += 1
    self.steal_tasks += len(grant)
    self._span(
      self.driver, "sim.steal", self.t, 0.0,
      thief=w.wid, victim=v.wid, tasks=len(grant),
    )
    return True

  def _terminal(self) -> None:
    self.terminal += 1
    if self.terminal >= len(self.tasks) and not self.done:
      self.done = True
      self.makespan = self.t

  # -- virtual autoscale controller -----------------------------------------

  def _autoscale_tick(self) -> None:
    if self.done:
      return
    window = max(self.cfg.rate_window_sec, 1e-9)
    floor = self.t - window
    while self.completion_log and self.completion_log[0] <= floor:
      self.completion_log.pop(0)
    rate = len(self.completion_log) / window
    backlog = len(self.pending)
    pool = self._pool()
    current = len(pool)
    pwr = rate / max(current, 1)
    decision = self.policy_loop.decide(backlog, pwr, current, self.t)
    target = decision["target"]
    if target > current:
      for _ in range(target - current):
        self._add_worker(self.t, delay=self.cfg.worker_start_sec)
      self.driver.incr("autoscale.scale_up")
      self.driver.incr("autoscale.workers_added", target - current)
    elif target < current:
      # drain the newest workers first, idle ones preferentially
      victims = sorted(
        pool, key=lambda w: (w.round_state is not None, w.wid),
        reverse=True,
      )[:current - target]
      for w in victims:
        self._preempt(w)
      self.driver.incr("autoscale.scale_down")
      self.driver.incr("autoscale.workers_removed", current - target)
    else:
      self.driver.incr("autoscale.steady")
    if target != current:
      self.scale_events.append({
        "t": round(self.t, 3), "current": current, "target": target,
        "reason": decision["reason"],
      })
      self._span(
        self.driver, "autoscale.action", self.t, 0.0,
        **{k: v for k, v in decision.items()},
      )
    self._push(self.t + self.cfg.autoscale_interval_sec,
               self._autoscale_tick)

  # -- run ------------------------------------------------------------------

  def run(self) -> dict:
    if self._ran:
      raise RuntimeError("FleetSimulator instances are single-use")
    self._ran = True
    cfg = self.cfg
    self._build_tasks()
    if cfg.worker_arrivals:
      # observed-trajectory replay: spawn order follows arrival order so
      # chaos assignment (sorted wids) lands on the campaign's earliest
      # workers — the ones a real storm actually hit
      for off in sorted(float(o) for o in cfg.worker_arrivals):
        self._add_worker(max(off, 0.0))
    else:
      initial = cfg.workers
      if cfg.autoscale:
        pol = self.policy_loop.policy
        initial = max(pol.min_workers, min(pol.max_workers, cfg.workers))
      for _ in range(max(initial, 0)):
        self._add_worker(0.0)
    self._assign_chaos()
    if cfg.autoscale:
      self._push(cfg.autoscale_interval_sec, self._autoscale_tick)
    if cfg.speculate:
      self._push(cfg.speculate_interval_sec, self._speculate_tick)
    while self._heap:
      t, _, fn = heapq.heappop(self._heap)
      if t > cfg.max_sim_sec:
        self.timed_out = True
        break
      self.t = t
      fn()
    if self.makespan is None:
      self.makespan = self.t
    # close out survivors (stalled / never-exited workers ran to the end)
    for w in self.workers.values():
      if w.end_t is None:
        w.end_t = self.makespan
    return self._results()

  def _results(self) -> dict:
    cfg = self.cfg
    completed = sum(1 for t in self.tasks if t["state"] == "done")
    worker_seconds = sum(
      max((w.end_t or 0.0) - w.start_t, 0.0)
      for w in self.workers.values() if w.start_t is not None
    )
    busy = sum(w.busy_sec for w in self.workers.values())
    per_type: Dict[str, dict] = {}
    for t in self.tasks:
      st = per_type.setdefault(
        t["type"], {"tasks": 0, "completed": 0, "dlq": 0},
      )
      st["tasks"] += 1
      if t["state"] == "done":
        st["completed"] += 1
      elif t["state"] == "dlq":
        st["dlq"] += 1
    makespan = self.makespan or 0.0
    cost = (
      round(worker_seconds / 3600.0 * cfg.cost_per_worker_hour, 4)
      if cfg.cost_per_worker_hour else None
    )
    return {
      "seed": cfg.seed,
      "workers": cfg.workers,
      "peak_workers": self.peak_workers,
      "tasks": len(self.tasks),
      "completed": completed,
      "completed_all": completed + self.dlq >= len(self.tasks) and (
        completed == len(self.tasks) - self.dlq
      ),
      "dlq": self.dlq,
      "failed_deliveries": self.failed_deliveries,
      "lease_recycles": self.lease_recycles,
      "zombie_fenced": self.zombie_fenced,
      "released": self.released,
      "rounds": sum(w.rounds for w in self.workers.values()),
      "range_rounds": self.range_rounds,
      "speculation": {
        "issued": self.spec_issued,
        "won": self.spec_won,
        "fenced": self.spec_fenced,
        "duplicate_acks": self.spec_dup,
      },
      "steals": {"claims": self.steals, "tasks": self.steal_tasks},
      "makespan_sec": round(makespan, 3),
      "tasks_per_sec": (
        round(completed / makespan, 4) if makespan > 0 else 0.0
      ),
      "worker_seconds": round(worker_seconds, 3),
      "busy_seconds": round(busy, 3),
      "utilization": (
        round(busy / worker_seconds, 4) if worker_seconds > 0 else 0.0
      ),
      "cost_usd": cost,
      "scale_events": self.scale_events,
      "autoscale": {
        "ups": self.driver.counters.get("autoscale.scale_up", 0),
        "downs": self.driver.counters.get("autoscale.scale_down", 0),
      },
      "timed_out": self.timed_out,
    }

  # -- journal emission ------------------------------------------------------

  def write_journal(self, cloudpath: str) -> int:
    """Emit the run as journal segments (one or more per worker plus a
    driver segment) under ``cloudpath``. Timestamps are ``base_ts +
    sim_t``; with the default anchor of 0.0 and a fixed seed the bytes
    are identical across reruns. Returns segments written."""
    if not self._ran:
      raise RuntimeError("run() before write_journal()")
    import json

    from ..storage import CloudFiles
    from . import journal as journal_mod

    base = self.cfg.base_ts
    cf = CloudFiles(cloudpath)
    nseg = 0

    # the driver carries the campaign-level span + queue-side counters
    self._span(
      self.driver, "sim.run", 0.0, self.makespan or 0.0,
      seed=self.cfg.seed, workers=self.cfg.workers,
      tasks=len(self.tasks), autoscale=bool(self.cfg.autoscale),
    )

    def counters_record(w: _SimWorker) -> dict:
      return {
        "kind": "counters",
        "worker": w.wid,
        "ts": round(base + (w.end_t or 0.0), 6),
        "event": w.exit_event or "interval",
        "counters": {k: w.counters[k] for k in sorted(w.counters)},
        "timers": {},
        "gauges": {},
      }

    order = sorted(self.workers) + [self.DRIVER_ID]
    for wid in order:
      w = self.driver if wid == self.DRIVER_ID else self.workers[wid]
      if w.start_t is None and w is not self.driver and not w.records:
        continue   # scheduled after completion; never ran
      spans = []
      for rec in w.records:
        rec = dict(rec)
        rec["worker"] = w.wid
        rec["ts"] = round(base + rec["ts"], 6)
        spans.append(rec)
      if w is self.driver:
        w.end_t = self.makespan
        w.exit_event = "exit"
      chunk = max(self.cfg.segment_spans, 1)
      seq = 0
      pieces = [
        spans[i:i + chunk] for i in range(0, len(spans), chunk)
      ] or [[]]
      for pi, piece in enumerate(pieces):
        lines = [json.dumps(r) for r in piece]
        if pi == len(pieces) - 1:
          lines.append(json.dumps(counters_record(w)))
        data = ("\n".join(lines) + "\n").encode("utf8")
        data = journal_mod.encode_segment(data)
        cf.put(f"{w.wid}-{seq:06d}.jsonl", data, compress=None)
        seq += 1
        nseg += 1
    return nseg


def simulate(model, config: Optional[SimConfig] = None,
             journal_path: Optional[str] = None) -> dict:
  """One-shot convenience: run, optionally emit the journal, return the
  results dict."""
  sim = FleetSimulator(model, config)
  results = sim.run()
  if journal_path:
    results["journal_segments"] = sim.write_journal(journal_path)
    results["journal_path"] = journal_path
  return results


def what_if(model, base: SimConfig, worker_counts: List[int]) -> List[dict]:
  """Same campaign, same seed, different fleet sizes — the forecast
  table `igneous fleet simulate` prints. Each entry is the results dict
  plus the varied worker count."""
  out = []
  for n in worker_counts:
    cfg = SimConfig(**{
      f.name: getattr(base, f.name) for f in fields(base)
      if not f.name.startswith("_")
    })
    cfg.workers = int(n)
    out.append(FleetSimulator(model, cfg).run())
  return out
