"""Closed-loop campaign runner: autoscale + speculation + stealing.

The port's own copy of ``igneous_tpu/observability/campaign.py``.
``python -m igneous_tpu_torch campaign run`` is the one process a hostile-fleet campaign
needs running besides the workers. Each tick it composes the survival
mechanisms the repo already has into one loop:

1. **autoscale** — an :class:`~.autoscale.AutoscaleController` step:
   load the journal, evaluate the HealthEngine, size the fleet to drain
   the backlog within the horizon, actuate (spawn/SIGTERM-drain local
   workers, or publish the target for an external reconciler);
2. **flags** — publish ``health/flags.json`` so flagged stragglers
   surrender their pre-leases (the lease batcher polls them) and shed
   the unstarted members of a paged group;
3. **speculation** — twin the unfinished tails of range leases held by
   flagged workers, by holders whose journal-mined per-task time is
   projected past ``IGNEOUS_SPECULATE_TAIL_RATIO`` × the fleet p95, and
   by holders gone journal-silent past the stall window (the worker
   frozen before its first flush, invisible to the health engine)
   (queues.FileQueue.speculate_flagged: first ack wins, the loser is
   fenced, completions never double-count);
4. **stealing** — nothing to drive here: idle workers pull claims
   themselves (``IGNEOUS_STEAL``); the runner only ships the knob into
   worker environments and surfaces ``steal.*`` counters.

The loop exits when the campaign drains (no backlog, no outstanding
leases, pool at the policy floor) or ``max_wall_sec`` elapses. Its
summary carries the final fleet status so the chaos soak and the
acceptance test can assert that the sim forecast, the live run, and
``fleet status`` agree.
"""

from __future__ import annotations

import time
from typing import List, Optional

from . import fleet, health, metrics
from .autoscale import AutoscaleController, AutoscalePolicy

from .. import secrets as knobs


class CampaignRunner:
  """One runner tick = autoscale step + flags + speculation sweep."""

  def __init__(
    self,
    journal_path: str,
    queue,
    actuator,
    policy: Optional[AutoscalePolicy] = None,
    health_config=None,
    tick_sec: Optional[float] = None,
    speculate: Optional[bool] = None,
    max_wall_sec: Optional[float] = None,
  ):
    self.journal_path = journal_path
    self.queue = queue
    self.controller = AutoscaleController(
      journal_path, queue, actuator,
      policy=policy, health_config=health_config, interval_sec=tick_sec,
    )
    self.tick_sec = (
      float(tick_sec) if tick_sec is not None
      else knobs.get_float("IGNEOUS_CAMPAIGN_TICK_SEC")
    )
    self.speculate = (
      bool(speculate) if speculate is not None
      else knobs.get_bool("IGNEOUS_CAMPAIGN_SPECULATE")
    )
    wall = (
      float(max_wall_sec) if max_wall_sec is not None
      else knobs.get_float("IGNEOUS_CAMPAIGN_MAX_WALL_SEC")
    )
    self.max_wall_sec = wall if wall and wall > 0 else None
    self.history: List[dict] = []

  # -- speculation targeting --------------------------------------------------

  def _slow_holders(self, report: dict, records) -> set:
    """Holders whose journal-mined per-task time projects a range tail
    past ``tail_ratio`` × the fleet p95 — the stragglers that haven't
    tripped a health flag (yet) but will hold the campaign tail hostage
    if left alone. Rates are busy-time (fleet.worker_rates), so an
    idle-but-fast holder never qualifies."""
    ratio = knobs.get_float("IGNEOUS_SPECULATE_TAIL_RATIO")
    p95_ms = (report.get("fleet") or {}).get("p95_task_ms") or 0.0
    if not records or p95_ms <= 0 or ratio <= 0:
      return set()
    rates = fleet.worker_rates(records)
    if not rates:
      return set()
    range_leases = getattr(self.queue, "range_leases", None)
    if range_leases is None:
      return set()
    slow = set()
    for r in range_leases():
      holder = r.get("holder")
      rate = rates.get(holder)
      if not holder or not rate or r.get("expired") or r.get("spec"):
        continue
      # projected per-member time on this holder vs the fleet p95:
      # the member count cancels out of the comparison
      if (1000.0 / rate) > ratio * p95_ms:
        slow.add(holder)
    return slow

  def _silent_holders(self, records, now: Optional[float] = None) -> set:
    """Holders of live, unpaired range leases that have gone journal-
    silent past the health stall window. This catches the worker frozen
    BEFORE its first flush — it has no rate and never trips a health
    flag (the engine only judges workers it has seen), so it is
    invisible to the other two triggers — as well as one whose journal
    simply stopped mid-campaign. The lease's own ``leased_at`` is the
    silence floor: a holder is never condemned for quiet time predating
    its lease."""
    range_leases = getattr(self.queue, "range_leases", None)
    if range_leases is None:
      return set()
    # the stall window the controller's health engine judges with (its
    # config, else the environment's), as the JAX package's runner does
    # only when given a config (it falls back to the dataclass default)
    cfg = self.controller.engine.config
    stall = float(getattr(cfg, "stall_sec", 0.0) or 0.0)
    if stall <= 0:
      return set()
    now = time.time() if now is None else now
    last_seen: dict = {}
    for r in records or ():
      w = r.get("worker")
      ts = r.get("ts")
      if w and isinstance(ts, (int, float)):
        end = float(ts) + float(r.get("dur") or 0.0)
        if end > last_seen.get(w, 0.0):
          last_seen[w] = end
    silent = set()
    for r in range_leases():
      holder = r.get("holder")
      if not holder or r.get("expired") or r.get("spec"):
        continue
      anchor = max(
        float(r.get("leased_at") or 0.0), last_seen.get(holder, 0.0)
      )
      if anchor and now - anchor >= stall:
        silent.add(holder)
    return silent

  def _speculate(self, report: dict, records) -> int:
    speculate_flagged = getattr(self.queue, "speculate_flagged", None)
    if speculate_flagged is None:
      return 0
    targets = set(report.get("flagged_workers") or ())
    targets |= self._slow_holders(report, records)
    targets |= self._silent_holders(records)
    if not targets:
      return 0
    try:
      return int(speculate_flagged(targets))
    except Exception:
      metrics.incr("campaign.speculate_failed")
      return 0

  # -- the loop ----------------------------------------------------------------

  def tick(self, now: Optional[float] = None) -> dict:
    now = time.time() if now is None else now
    decision = self.controller.step(now=now)
    report = self.controller.last_report
    speculated = 0
    if report is not None:
      health.publish_gauges(report)
      try:
        health.write_flags(self.journal_path, report)
      except Exception:
        metrics.incr("campaign.flags_failed")
      if self.speculate:
        speculated = self._speculate(report, self.controller.last_records)
    metrics.incr("campaign.ticks")
    if speculated:
      metrics.incr("campaign.speculated", speculated)
    summary = dict(
      decision,
      speculated=speculated,
      flagged=sorted(report["flagged_workers"]) if report else [],
      anomalies=(
        [a["kind"] for a in report["anomalies"]] if report else []
      ),
    )
    self.history.append(summary)
    return summary

  def _reconcile_ledger(self) -> dict:
    """Worker journals are lossy under SIGKILL: a won/fenced increment
    whose marker (and completion) committed to disk dies with the
    worker if it never flushed. The queue's speculation tallies are
    crash-safe (1-byte appends written in the same breath as the done
    marker), so once the pool is down the runner journals the missing
    difference — ``won + fenced == issued`` then reconciles from the
    journal alone, no matter how the workers died."""
    won = getattr(self.queue, "speculation_won", None)
    fenced = getattr(self.queue, "speculation_fenced", None)
    if not won and not fenced:
      return {}
    try:
      counters = fleet.status(
        fleet.load_effective(self.journal_path)
      ).get("counters", {})
    except Exception:
      return {}
    topped = {}
    missing = int(won or 0) - int(counters.get("speculation.won", 0))
    if missing > 0:
      metrics.incr("speculation.won", missing)
      topped["speculation.won"] = missing
    missing = int(fenced or 0) - int(counters.get("speculation.fenced", 0))
    if missing > 0:
      metrics.incr("speculation.fenced", missing)
      topped["speculation.fenced"] = missing
    if topped:
      metrics.incr("campaign.ledger_topped_up", sum(topped.values()))
      try:
        self.controller.journal.write_records(
          [{
            "kind": "counters", "ts": time.time(), "event": "campaign",
            "counters": metrics.counters_snapshot(), "timers": {},
            "gauges": metrics.gauges_snapshot(),
          }],
          event="campaign",
        )
      except Exception:
        metrics.incr("campaign.reconcile_failed")
    return topped

  def _drained(self, decision: dict) -> bool:
    if decision["backlog"] > 0:
      return False
    # backlog counts PENDING work; outstanding leases must resolve too,
    # or the runner walks away while stragglers still hold the tail
    enqueued = getattr(self.queue, "enqueued", 0)
    if enqueued and enqueued > 0:
      return False
    actuator = self.controller.actuator
    actuator.reap()
    return actuator.current() <= self.controller.loop.policy.min_workers

  def run(self, iterations: Optional[int] = None,
          sleep_fn=time.sleep) -> dict:
    """Tick until the campaign drains, ``max_wall_sec`` elapses, or
    ``iterations`` runs out. The actuator is always shut down (graceful
    SIGTERM drain) on the way out."""
    t0 = time.time()
    n = 0
    timed_out = False
    try:
      while True:
        decision = self.tick()
        n += 1
        if n > 1 and self._drained(decision):
          break
        if iterations is not None and n >= iterations:
          break
        if self.max_wall_sec and time.time() - t0 > self.max_wall_sec:
          timed_out = True
          metrics.incr("campaign.timed_out")
          break
        sleep_fn(self.tick_sec)
    finally:
      self.controller.actuator.shutdown()
      # after shutdown every surviving worker has flushed; what the
      # SIGKILLed ones lost is recovered from the queue's tallies
      self._reconcile_ledger()
    return self.summary(timed_out=timed_out, wall_sec=time.time() - t0)

  def summary(self, timed_out: bool = False,
              wall_sec: Optional[float] = None) -> dict:
    """Final reconciliation: runner history + the queue's own tallies +
    a fresh ``fleet status`` over the journal, in one dict — the three
    views the acceptance criteria require to agree."""
    try:
      status = fleet.status(fleet.load_effective(self.journal_path))
    except Exception:
      status = None
    out = {
      "ticks": len(self.history),
      "actions": sum(1 for d in self.history if d.get("actuated")),
      "speculated": sum(d.get("speculated", 0) for d in self.history),
      "timed_out": timed_out,
      "queue": {},
      "fleet_status": status,
    }
    if wall_sec is not None:
      out["wall_sec"] = round(wall_sec, 2)
    for attr in ("enqueued", "completed", "inserted", "dlq_count", "leased"):
      try:
        out["queue"][attr] = int(getattr(self.queue, attr))
      except Exception:
        continue
    actuator = self.controller.actuator
    if hasattr(actuator, "stats"):
      out["actuator"] = dict(
        actuator.stats, exits=dict(actuator.stats.get("exits", {}))
      )
    return out
