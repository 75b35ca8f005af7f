"""Worker configuration from the environment.

The port's own copy of ``igneous_tpu/secrets.py``: ``QUEUE_URL`` (or
``SQS_URL``), ``LEASE_SECONDS`` (600), the SQS region and endpoint, the
heartbeat interval (``IGNEOUS_HEARTBEAT_SEC``) and the secrets directory
(``IGNEOUS_TPU_SECRETS``), read straight from the environment with the same
parses and defaults. ``env_number`` and ``env_flag`` parse a numeric or
on/off knob as the JAX package's knob registry does
(``igneous_tpu/analysis/knobs.py``); the queues, the lifecycle, the
pipeline and the storage plane read their knobs through them.

``KNOBS`` is the port's copy of that registry's observability, campaign
and serving knobs (the journal, roll-ups, tracing, ``/metrics``, the
profiler, health and SLOs, the autoscale controller, straggler
speculation, work stealing, the campaign runner, the fleet simulator, and
the serving tier's cache, fleet, QoS, prewarm and fill verification),
with the same types and defaults; ``get_str``,
``get_int``, ``get_float``, ``opt_float`` and ``get_bool`` read them with
the registry's parses (unset or empty: the default; unparseable number:
the default; a flag is off for 0, off, false and no), and refuse a name
the table does not hold.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple, Union


def queue_url() -> Optional[str]:
  return os.environ.get("QUEUE_URL") or os.environ.get("SQS_URL")


def sqs_region_name() -> Optional[str]:
  return os.environ.get("SQS_REGION_NAME")


def sqs_endpoint_url() -> Optional[str]:
  return os.environ.get("SQS_ENDPOINT_URL")


def lease_seconds() -> int:
  return int(os.environ.get("LEASE_SECONDS", 600))


def heartbeat_seconds() -> Optional[float]:
  """Lease-renewal interval for workers. None (unset or unparseable) lets
  the heartbeat default to lease/3; 0 disables renewal."""
  return env_number("IGNEOUS_HEARTBEAT_SEC", None, float)


def secrets_dir() -> str:
  return os.environ.get("IGNEOUS_TPU_SECRETS") or os.path.expanduser(
    "~/.cloudfiles/secrets"
  )


_FALSE_WORDS = ("0", "off", "false", "no")


def env_number(name: str, default, cast):
  """``cast`` of a set, parseable variable, else ``default`` (ints go
  through float first, as the knob registry parses them)."""
  val = os.environ.get(name, "")
  if val != "":
    try:
      return cast(float(val))
    except ValueError:
      pass
  return default


def env_flag(name: str, default: bool) -> bool:
  """Unset or empty: ``default``; else anything but 0, off, false, no."""
  val = os.environ.get(name, "")
  if val == "":
    return default
  return val.strip().lower() not in _FALSE_WORDS


# name -> (type, default): the observability and campaign knobs of the
# JAX package's registry, with its defaults (None: unset, derived where it is read)
KNOBS: Dict[str, Tuple[str, Union[str, int, float, bool, None]]] = {
  # journal and roll-ups
  "IGNEOUS_JOURNAL": ("str", None),
  "IGNEOUS_JOURNAL_FLUSH_SEC": ("float", 30.0),
  "IGNEOUS_JOURNAL_COMPRESS": ("bool", False),
  "IGNEOUS_JOURNAL_RETAIN": ("float", 3600.0),
  "IGNEOUS_ROLLUP_WINDOW_SEC": ("float", 60.0),
  "IGNEOUS_ROLLUP_MAX_SAMPLES": ("int", 512),
  "IGNEOUS_ROLLUP_EVERY": ("int", 16),
  # trace, metrics, profile
  "IGNEOUS_TRACE_SAMPLE": ("float", 1.0),
  "IGNEOUS_METRICS_PORT": ("int", None),
  "IGNEOUS_METRICS_TEXTFILE": ("str", None),
  "IGNEOUS_PROFILE_DIR": ("str", None),
  "IGNEOUS_TPU_PROFILE_DIR": ("str", None),
  "IGNEOUS_PROFILE_EVERY": ("int", 0),
  "IGNEOUS_PROFILE_SEC": ("float", 2.0),
  # health and SLOs
  "IGNEOUS_HEALTH_WINDOW_SEC": ("float", 600.0),
  "IGNEOUS_HEALTH_STRAGGLER_RATIO": ("float", 3.0),
  "IGNEOUS_HEALTH_STRAGGLER_MIN_TASKS": ("int", 3),
  "IGNEOUS_HEALTH_STALL_SEC": ("float", 120.0),
  "IGNEOUS_HEALTH_FORGET_SEC": ("float", 3600.0),
  "IGNEOUS_HEALTH_DLQ_RATE": ("float", 0.05),
  "IGNEOUS_HEALTH_RETRY_RATE": ("float", 1.0),
  "IGNEOUS_HEALTH_ZOMBIE_RATE": ("float", 0.5),
  "IGNEOUS_HEALTH_STALL_RATIO": ("float", 0.9),
  "IGNEOUS_HEALTH_RECOMPILES_PER_MIN": ("float", 10.0),
  "IGNEOUS_HEALTH_HBM_FRAC": ("float", 0.9),
  "IGNEOUS_HEALTH_DEVICE_IDLE_RATIO": ("float", 0.05),
  "IGNEOUS_HEALTH_INTEGRITY_MAX": ("float", 0.0),
  "IGNEOUS_SLO_SUCCESS": ("float", 0.99),
  "IGNEOUS_SLO_P95_MS": ("float", None),
  # the serving tier: the cache, the fleet, QoS and prewarm
  "IGNEOUS_SERVE_RAM_MB": ("float", 256.0),
  "IGNEOUS_SERVE_SSD_DIR": ("str", None),
  "IGNEOUS_SERVE_SSD_MB": ("float", 4096.0),
  "IGNEOUS_SERVE_CACHE_CONTROL": ("str", "public, max-age=300"),
  "IGNEOUS_SERVE_SYNTH_MIPS": ("bool", True),
  "IGNEOUS_SERVE_WRITEBACK": ("bool", False),
  "IGNEOUS_SERVE_MAX_OBJECT_MB": ("float", 64.0),
  "IGNEOUS_SERVE_IO_THREADS": ("int", 16),
  "IGNEOUS_SERVE_DRAIN_SEC": ("float", 30.0),
  "IGNEOUS_SERVE_FLEET_PEERS": ("str", None),
  "IGNEOUS_SERVE_FLEET_MEMBERSHIP": ("str", None),
  "IGNEOUS_SERVE_FLEET_SELF": ("str", None),
  "IGNEOUS_SERVE_FLEET_TTL_SEC": ("float", 15.0),
  "IGNEOUS_SERVE_FLEET_TIMEOUT_MS": ("float", 2000.0),
  "IGNEOUS_SERVE_FLEET_RETRY_SEC": ("float", 10.0),
  "IGNEOUS_SERVE_PREWARM": ("bool", False),
  "IGNEOUS_SERVE_PREWARM_INTERVAL_SEC": ("float", 30.0),
  "IGNEOUS_SERVE_PREWARM_TOP": ("int", 16),
  "IGNEOUS_SERVE_PREWARM_BUDGET": ("int", 64),
  "IGNEOUS_SERVE_QOS_RPS": ("float", 0.0),
  "IGNEOUS_SERVE_QOS_WEIGHTS": ("str", None),
  "IGNEOUS_SERVE_QOS_BURST_SEC": ("float", 2.0),
  "IGNEOUS_INTEGRITY_SERVE_VERIFY": ("bool", True),
  "IGNEOUS_INTEGRITY_SSD_VERIFY": ("bool", True),
  # the serving tier's health detectors
  "IGNEOUS_SERVE_SLO_P99_MS": ("float", None),
  "IGNEOUS_SERVE_PEER_FAIL_RATIO": ("float", 0.5),
  "IGNEOUS_SERVE_PEER_MIN": ("int", 8),
  "IGNEOUS_SERVE_SHED_RATIO": ("float", 0.2),
  "IGNEOUS_SERVE_MISS_RATIO": ("float", 0.9),
  "IGNEOUS_SERVE_MIN_REQUESTS": ("int", 50),
  # the autoscale policy
  "IGNEOUS_AUTOSCALE_MIN": ("int", 1),
  "IGNEOUS_AUTOSCALE_MAX": ("int", 1000),
  "IGNEOUS_AUTOSCALE_HORIZON_SEC": ("float", 600.0),
  "IGNEOUS_AUTOSCALE_HYSTERESIS": ("float", 0.2),
  "IGNEOUS_AUTOSCALE_COOLDOWN_SEC": ("float", 60.0),
  "IGNEOUS_AUTOSCALE_STEP_MAX": ("int", 0),
  "IGNEOUS_AUTOSCALE_INTERVAL_SEC": ("float", 15.0),
  # campaign survival: speculation, stealing, the campaign runner
  "IGNEOUS_SPECULATE_MIN_TASKS": ("int", 1),
  "IGNEOUS_SPECULATE_MAX_TWINS": ("int", 4),
  "IGNEOUS_SPECULATE_MIN_HELD_SEC": ("float", 0.0),
  "IGNEOUS_SPECULATE_TAIL_RATIO": ("float", 1.5),
  "IGNEOUS_SPECULATE_WASTE_MAX": ("float", 0.5),
  "IGNEOUS_SPECULATE_MIN_ISSUED": ("int", 8),
  "IGNEOUS_STEAL": ("bool", False),
  "IGNEOUS_STEAL_MIN_TASKS": ("int", 2),
  "IGNEOUS_STEAL_MIN_HELD_SEC": ("float", 2.0),
  "IGNEOUS_STEAL_FRACTION": ("float", 0.5),
  "IGNEOUS_STEAL_CLAIM_TTL_SEC": ("float", 300.0),
  "IGNEOUS_CAMPAIGN_TICK_SEC": ("float", 5.0),
  "IGNEOUS_CAMPAIGN_MAX_WALL_SEC": ("float", 0.0),
  "IGNEOUS_CAMPAIGN_SPECULATE": ("bool", True),
  # the fleet simulator
  "IGNEOUS_SIM_WORKERS": ("int", 4),
  "IGNEOUS_SIM_SEED": ("int", 0),
  "IGNEOUS_SIM_BATCH": ("int", 1),
  "IGNEOUS_SIM_LEASE_SEC": ("float", 60.0),
  "IGNEOUS_SIM_MAX_DELIVERIES": ("int", 5),
  "IGNEOUS_SIM_POLL_SEC": ("float", 2.0),
  "IGNEOUS_SIM_WORKER_START_SEC": ("float", 5.0),
  "IGNEOUS_SIM_FAIL_SCALE": ("float", 1.0),
  "IGNEOUS_SIM_MAX_SEC": ("float", 30 * 24 * 3600.0),
  "IGNEOUS_SIM_RANGE_LEASE": ("int", 0),
  "IGNEOUS_SIM_SPECULATE": ("int", 0),
  "IGNEOUS_SIM_STEAL": ("int", 0),
}


def _default(name: str):
  try:
    return KNOBS[name][1]
  except KeyError:
    raise KeyError(f"unregistered knob {name!r}: add it to secrets.KNOBS") from None


def raw(name: str) -> Optional[str]:
  """The value exactly as set (None when unset), no default applied."""
  _default(name)
  return os.environ.get(name)


def get_str(name: str) -> Optional[str]:
  default = _default(name)
  val = os.environ.get(name)
  if val is None or val == "":
    return None if default is None else str(default)
  return val


def get_int(name: str) -> Optional[int]:
  default = _default(name)
  val = env_number(name, None, int)
  if val is not None:
    return val
  return None if default is None else int(default)


def get_float(name: str) -> Optional[float]:
  default = _default(name)
  val = env_number(name, None, float)
  if val is not None:
    return val
  return None if default is None else float(default)


def opt_float(name: str) -> Optional[float]:
  """The set, parseable value, else None (a dataclass's ``from_env`` then
  keeps its field default, which equals the table's)."""
  _default(name)
  return env_number(name, None, float)


def get_bool(name: str) -> bool:
  return env_flag(name, bool(_default(name)))


def set_env(name: str, value) -> None:
  """Set a knob for this process and the workers it spawns."""
  _default(name)
  os.environ[name] = str(value)
