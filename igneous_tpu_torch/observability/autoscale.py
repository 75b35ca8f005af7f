"""Closed-loop autoscaling: one policy, pluggable actuators, a controller.

The port's own copy of ``igneous_tpu/observability/autoscale.py``:

* :func:`compute_desired`: the desired-workers formula, which the health
  report, the fleet simulator and the live controller all run;
* :class:`PolicyLoop`: the stateful half (cooldown between actions,
  per-action step cap) shared by the simulator and the controller;
* actuators: :class:`LocalPoolActuator` spawns and drains real
  ``python -m igneous_tpu_torch execute`` workers (each resolves its device
  through ``device.py``: the card unless ``IGNEOUS_TORCH_DEVICE=cpu``),
  :class:`TextfileActuator` publishes the target where an external
  reconciler reads it, :class:`CommandActuator` runs a ``kubectl
  scale``-style template;
* :class:`AutoscaleController`: the ``fleet autoscale`` loop: poll the
  journal and the queue depth, evaluate, damp, actuate, and journal the
  action as ``autoscale.action`` records and ``autoscale.*`` counters,
  which ``fleet status|watch`` read.

The controller never kills a worker before its grace window: scale-down
is SIGTERM, the graceful drain (finish the task in flight, release the
leases, exit 83). Cooldown and hysteresis are enforced here, not in the
actuator, so every actuator gets the same damping.
"""

from __future__ import annotations

import math
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, fields
from typing import List, Optional

from . import metrics

from ..analysis import knobs

COOLDOWN_ENV = "IGNEOUS_AUTOSCALE_COOLDOWN_SEC"
INTERVAL_ENV = "IGNEOUS_AUTOSCALE_INTERVAL_SEC"
STEP_MAX_ENV = "IGNEOUS_AUTOSCALE_STEP_MAX"

DEFAULT_COOLDOWN_SEC = 60.0
DEFAULT_INTERVAL_SEC = 15.0


@dataclass
class AutoscalePolicy:
  """Sizing + damping knobs. The first four mirror the HealthConfig
  fields (same env vars, same defaults); cooldown/step are controller
  additions — a recommendation can flap per-evaluation, an *action*
  must not."""

  min_workers: int = 1
  max_workers: int = 1000
  horizon_sec: float = 600.0
  hysteresis: float = 0.2
  cooldown_sec: float = DEFAULT_COOLDOWN_SEC
  step_max: int = 0  # max workers added/removed per action; 0 = no cap

  _ENV = {
    "min_workers": "IGNEOUS_AUTOSCALE_MIN",
    "max_workers": "IGNEOUS_AUTOSCALE_MAX",
    "horizon_sec": "IGNEOUS_AUTOSCALE_HORIZON_SEC",
    "hysteresis": "IGNEOUS_AUTOSCALE_HYSTERESIS",
    "cooldown_sec": COOLDOWN_ENV,
    "step_max": STEP_MAX_ENV,
  }

  @classmethod
  def from_env(cls, **overrides) -> "AutoscalePolicy":
    kw = {}
    for f in fields(cls):
      if f.name.startswith("_"):
        continue
      val = overrides.get(f.name)
      if val is None:
        val = knobs.opt_float(cls._ENV[f.name])
      if val is not None:
        kw[f.name] = val
    pol = cls(**kw)
    pol.min_workers = int(pol.min_workers)
    pol.max_workers = int(pol.max_workers)
    pol.step_max = int(pol.step_max)
    return pol


def compute_desired(backlog: int, per_worker_rate: float, current: int,
                    policy: AutoscalePolicy):
  """Workers needed to drain ``backlog`` within ``horizon_sec`` at the
  observed per-worker rate, clamped to [min, max] and hysteresis-damped
  against ``current``. Returns ``(desired, damped)``.

  This IS the HealthEngine formula (extracted, not forked):
  ``health.evaluate`` calls it for the report's ``desired_workers``, the
  simulator calls it for virtual controller ticks, and the live
  controller calls it before actuating — tune once, behave identically
  everywhere."""
  if backlog <= 0:
    desired = policy.min_workers
  elif per_worker_rate <= 0:
    # backlog with no observed throughput: never scale DOWN on missing
    # data; hold current (or bootstrap to min when nothing runs yet)
    desired = max(current, policy.min_workers)
  else:
    desired = int(math.ceil(
      backlog / (per_worker_rate * policy.horizon_sec)
    ))
  desired = max(policy.min_workers, min(policy.max_workers, desired))
  if backlog > 0 and desired < 1:
    # scale-to-zero floors (batch campaigns) still need a bootstrap
    # worker whose journal seeds the rate estimate
    desired = 1
  damped = False
  if (
    backlog > 0 and current > 0
    and abs(desired - current) / current <= policy.hysteresis
  ):
    desired, damped = current, True
  return desired, damped


class PolicyLoop:
  """Stateful damping over :func:`compute_desired`: a cooldown window
  after every action and an optional per-action step cap. Deterministic
  given explicit ``now`` values — the simulator drives it with virtual
  time, the controller with wall-clock."""

  def __init__(self, policy: Optional[AutoscalePolicy] = None):
    self.policy = policy or AutoscalePolicy.from_env()
    self.last_change_ts: Optional[float] = None

  def decide(self, backlog: int, per_worker_rate: float, current: int,
             now: float) -> dict:
    pol = self.policy
    desired, damped = compute_desired(
      backlog, per_worker_rate, current, pol
    )
    target = desired
    reason = "steady"
    if target != current:
      reason = "scale_up" if target > current else "scale_down"
      if (
        self.last_change_ts is not None
        and now - self.last_change_ts < pol.cooldown_sec
      ):
        target, reason = current, "cooldown"
      elif pol.step_max > 0 and abs(target - current) > pol.step_max:
        target = current + (
          pol.step_max if target > current else -pol.step_max
        )
    elif damped:
      reason = "hysteresis"
    if target != current:
      self.last_change_ts = now
    return {
      "backlog": int(backlog),
      "per_worker_rate": round(per_worker_rate, 4),
      "current": int(current),
      "desired": int(desired),
      "target": int(target),
      "reason": reason,
    }


# -- actuators ----------------------------------------------------------------


class Actuator:
  """Minimal surface the controller needs: observed worker count and a
  scale-to-N action. ``reap`` lets process-owning actuators collect
  exits between ticks; ``shutdown`` is the controller's exit path."""

  name = "abstract"

  def current(self) -> int:
    raise NotImplementedError

  def scale_to(self, n: int) -> None:
    raise NotImplementedError

  def reap(self) -> None:
    pass

  def shutdown(self) -> None:
    pass


class LocalPoolActuator(Actuator):
  """A real local worker pool: ``scale_to`` spawns and drains
  ``python -m igneous_tpu_torch execute`` subprocesses: real processes,
  real leases, real graceful drains.

  Scale-down SIGTERMs the newest workers (the drain path: finish the
  task in flight, release pre-leases, flush the journal, exit 83), each
  once: a worker already draining is not signalled again, since a second
  SIGTERM that lands after its handlers are gone (while it flushes and
  exits) would kill it. Only ``shutdown`` kills a worker, and only once
  its grace window has passed."""

  name = "local"

  def __init__(self, queue_spec: str, worker_args: Optional[List[str]] = None,
               env: Optional[dict] = None, grace_sec: float = 60.0):
    self.queue_spec = queue_spec
    self.worker_args = list(worker_args or ())
    self.env = dict(os.environ, **(env or {}))
    self.grace_sec = grace_sec
    self.procs: List[subprocess.Popen] = []
    self._draining: set = set()   # ids of the workers sent SIGTERM
    self.stats = {"spawned": 0, "drained": 0, "exits": {}}

  def _spawn(self) -> subprocess.Popen:
    cmd = [
      sys.executable, "-m", "igneous_tpu_torch", "execute", self.queue_spec,
      *self.worker_args,
    ]
    proc = subprocess.Popen(cmd, env=self.env)
    self.stats["spawned"] += 1
    return proc

  def reap(self) -> None:
    alive = []
    for p in self.procs:
      rc = p.poll()
      if rc is None:
        alive.append(p)
      else:
        self._draining.discard(id(p))
        key = str(rc)
        self.stats["exits"][key] = self.stats["exits"].get(key, 0) + 1
    self.procs = alive

  def current(self) -> int:
    self.reap()
    return len(self.procs)

  def scale_to(self, n: int) -> None:
    self.reap()
    n = max(int(n), 0)
    while len(self.procs) < n:
      self.procs.append(self._spawn())
    surplus = len(self.procs) - n
    for p in self.procs[len(self.procs) - surplus:]:
      if id(p) in self._draining:
        continue
      try:
        p.send_signal(signal.SIGTERM)
      except OSError:
        pass
      self._draining.add(id(p))
      self.stats["drained"] += 1
    # drained workers stay in self.procs until reap() sees them exit:
    # "current" keeps counting a draining worker (it still holds leases)

  def shutdown(self) -> None:
    """Drain everything and wait out the grace window."""
    self.scale_to(0)
    deadline = time.monotonic() + self.grace_sec
    for p in self.procs:
      timeout = max(deadline - time.monotonic(), 0.1)
      try:
        p.wait(timeout=timeout)
      except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
    self.reap()


class TextfileActuator(Actuator):
  """Publish the target where an external reconciler reads it — a k8s
  sidecar watching a shared volume, a node-exporter textfile collector,
  a cron diffing the file against ``kubectl get deploy``. Atomic
  (tmp+rename) so readers never see a torn write."""

  name = "textfile"

  def __init__(self, path: str, initial: int = 0):
    self.path = path
    self._current = int(initial)

  def current(self) -> int:
    return self._current

  def scale_to(self, n: int) -> None:
    import json

    tmp = f"{self.path}.tmp.{os.getpid()}"
    payload = {"desired_workers": int(n), "ts": time.time()}
    dirname = os.path.dirname(self.path)
    if dirname:
      os.makedirs(dirname, exist_ok=True)
    with open(tmp, "w") as f:
      json.dump(payload, f)
    os.replace(tmp, self.path)
    self._current = int(n)


class CommandActuator(Actuator):
  """Shell out to a scale command template with a ``{n}`` placeholder —
  ``kubectl scale --replicas={n} deployment/igneous-worker`` being the
  canonical production wiring. The observed count is the last target we
  set (external truth lives in the orchestrator)."""

  name = "command"

  def __init__(self, template: str, initial: int = 0):
    if "{n}" not in template:
      raise ValueError("command template needs a {n} placeholder")
    self.template = template
    self._current = int(initial)

  def current(self) -> int:
    return self._current

  def scale_to(self, n: int) -> None:
    import shlex

    cmd = shlex.split(self.template.format(n=int(n)))
    res = subprocess.run(cmd, capture_output=True)
    if res.returncode != 0:
      metrics.incr("autoscale.actuate_failed")
      raise RuntimeError(
        f"scale command failed rc={res.returncode}: "
        f"{res.stderr.decode('utf8', errors='replace')[-500:]}"
      )
    self._current = int(n)


# -- controller ---------------------------------------------------------------


class AutoscaleController:
  """The ``fleet autoscale`` loop.

  Each tick: read the journal (rollups + uncovered raw segments), evaluate the HealthEngine for the per-worker rate,
  snapshot live queue depth for backlog (fresher than the journal),
  run the :class:`PolicyLoop`, actuate, and journal the action — so
  ``fleet status|watch`` and the simulator's live-vs-predicted
  comparison see the controller's own history as first-class records."""

  def __init__(
    self,
    journal_path: str,
    queue,
    actuator: Actuator,
    policy: Optional[AutoscalePolicy] = None,
    health_config=None,
    interval_sec: Optional[float] = None,
    journal=None,
  ):
    from . import health as health_mod
    from . import journal as journal_mod

    self.journal_path = journal_path
    self.queue = queue
    self.actuator = actuator
    self.loop = PolicyLoop(policy)
    self.health_config = health_config
    self.engine = health_mod.HealthEngine(health_config)
    self.interval_sec = (
      float(interval_sec) if interval_sec is not None
      else knobs.get_float(INTERVAL_ENV)
    )
    self.journal = journal or journal_mod.Journal(
      journal_path, worker_id=f"autoscale-{os.getpid()}",
    )
    self.history: List[dict] = []

  def _queue_stats(self) -> dict:
    if hasattr(self.queue, "depth_snapshot"):
      try:
        return self.queue.depth_snapshot()
      except Exception:
        pass
    try:
      return {"backlog": int(getattr(self.queue, "backlog"))}
    except Exception:
      return {"backlog": 0}

  def step(self, now: Optional[float] = None) -> dict:
    from . import fleet

    now = time.time() if now is None else now
    queue_stats = self._queue_stats()
    backlog = int(queue_stats.get("backlog") or 0)
    per_worker_rate = 0.0
    report = None
    try:
      records = fleet.load_effective(self.journal_path)
    except Exception:
      records = []
    if records:
      report = self.engine.evaluate(records, queue_stats, now=now)
      per_worker_rate = report["autoscale"]["per_worker_tasks_per_sec"]
    # the last health report + raw records, for composers (the campaign
    # runner writes flags / drives speculation off the SAME evaluation
    # this tick actuated on, without a second journal load)
    self.last_report = report
    self.last_records = records
    current = self.actuator.current()
    decision = self.loop.decide(backlog, per_worker_rate, current, now)
    decision["ts"] = now
    decision["actuator"] = self.actuator.name
    target = decision["target"]
    if target != current:
      self.actuator.scale_to(target)
      delta = target - current
      if delta > 0:
        metrics.incr("autoscale.scale_up")
        metrics.incr("autoscale.workers_added", delta)
      else:
        metrics.incr("autoscale.scale_down")
        metrics.incr("autoscale.workers_removed", -delta)
      decision["actuated"] = True
    else:
      metrics.incr("autoscale.steady")
      decision["actuated"] = False
    metrics.gauge_set("autoscale.target_workers", target)
    self.history.append(decision)
    # journal the action: one autoscale.action span + this process's
    # cumulative autoscale.* counters, so `fleet status` counts actions
    # and the simulator's validation can diff policy traces
    try:
      self.journal.write_records(
        [
          {
            "kind": "span", "name": "autoscale.action",
            "ts": now, "dur": 0.0, **{
              k: v for k, v in decision.items() if k != "ts"
            },
          },
          {
            "kind": "counters", "ts": now, "event": "autoscale",
            "counters": metrics.counters_snapshot(),
            "timers": {}, "gauges": metrics.gauges_snapshot(),
          },
        ],
        event="autoscale",
      )
    except Exception:
      metrics.incr("autoscale.journal_failed")
    return decision

  def run(
    self,
    iterations: Optional[int] = None,
    stop_when_drained: bool = False,
    sleep_fn=time.sleep,
  ) -> List[dict]:
    """Tick until ``iterations`` runs out (None = forever), or — with
    ``stop_when_drained`` — until the queue has no backlog and the pool
    sits at the policy floor (the batch-campaign exit: scale up, drain,
    scale down, leave)."""
    n = 0
    while True:
      decision = self.step()
      n += 1
      if stop_when_drained:
        self.actuator.reap()
        if (
          decision["backlog"] <= 0
          and self.actuator.current() <= self.loop.policy.min_workers
        ):
          return self.history
      if iterations is not None and n >= iterations:
        return self.history
      sleep_fn(self.interval_sec)
