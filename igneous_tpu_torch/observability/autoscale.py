"""The autoscale policy: the desired-workers formula of the health report.

The port's own copy of ``AutoscalePolicy`` and ``compute_desired`` from
``igneous_tpu/observability/autoscale.py``, which ``health.py`` calls for
the report's ``desired_workers``. The stateful loop, the actuators and the
controller of that module are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields

from .. import secrets as knobs
COOLDOWN_ENV = "IGNEOUS_AUTOSCALE_COOLDOWN_SEC"
STEP_MAX_ENV = "IGNEOUS_AUTOSCALE_STEP_MAX"

DEFAULT_COOLDOWN_SEC = 60.0


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
