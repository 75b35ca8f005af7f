"""Worker configuration from the environment.

The port's own copy of ``igneous_tpu/secrets.py``: ``QUEUE_URL`` (or
``SQS_URL``), ``LEASE_SECONDS`` (600), the SQS region and endpoint, the
heartbeat interval (``IGNEOUS_HEARTBEAT_SEC``) and the secrets directory
(``IGNEOUS_TPU_SECRETS``), read straight from the environment with the same
parses and defaults.
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
  val = os.environ.get("IGNEOUS_HEARTBEAT_SEC", "")
  if val == "":
    return None
  try:
    return float(val)
  except ValueError:
    return None


def secrets_dir() -> str:
  return os.environ.get("IGNEOUS_TPU_SECRETS") or os.path.expanduser(
    "~/.cloudfiles/secrets"
  )
