"""Worker configuration from the environment.

The port's own copy of ``igneous_tpu/secrets.py``: ``QUEUE_URL`` (or
``SQS_URL``), ``LEASE_SECONDS`` (600), the SQS region and endpoint, the
heartbeat interval (``IGNEOUS_HEARTBEAT_SEC``) and the secrets directory
(``IGNEOUS_TPU_SECRETS``), read straight from the environment with the same
parses and defaults. ``env_number`` and ``env_flag`` parse a numeric or
on/off knob as the JAX package's knob registry does
(``igneous_tpu/analysis/knobs.py``); the queues, the lifecycle, the
pipeline and the storage plane read their knobs through them.
"""

from __future__ import annotations

import os
from typing import Optional


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
