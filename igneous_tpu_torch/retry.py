"""The retry policy of every network seam (storage_http, hence gs:// and s3://).

The port's own copy of ``igneous_tpu/retry.py``: ``RetryPolicy`` carries
the base delay, the cap, the jitter mode and an attempt and sleep budget;
callers iterate ``policy.retries(counter)``, which sleeps before each retry
and ticks ``retries.<counter>`` in ``telemetry``. The knobs, read when a
policy is built from the environment, have the JAX package's names, parses
and defaults:

  IGNEOUS_RETRY_ATTEMPTS   total attempts incl. the first (default 6)
  IGNEOUS_RETRY_BASE_S     first backoff delay (default 0.25)
  IGNEOUS_RETRY_CAP_S      max single delay (default 30)
  IGNEOUS_RETRY_BUDGET_S   total sleep budget per operation (default 120)

``sleep_fn`` and ``rng`` let tests run a schedule without sleeping.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from . import telemetry
from .analysis import knobs

RETRYABLE_STATUS = (408, 429, 500, 502, 503, 504)


@dataclass
class RetryPolicy:
  """Exponential backoff with full jitter and a total-sleep budget.

  attempts: total tries including the first (1 = no retries).
  base_s/cap_s: delay = min(cap, base * 2**retry_index), jittered.
  budget_s: once the planned sleep would pass this, stop retrying even
    if attempts remain (the queue's redelivery is the outer retry loop).
  jitter: "full" (uniform in [0, delay]) or "none" (deterministic).
  """

  attempts: int = 6
  base_s: float = 0.25
  cap_s: float = 30.0
  budget_s: float = 120.0
  jitter: str = "full"
  sleep_fn: Callable[[float], None] = field(default=time.sleep, repr=False)
  rng: random.Random = field(default=random, repr=False)

  @classmethod
  def from_env(cls, **overrides) -> "RetryPolicy":
    kw = dict(
      attempts=knobs.get_int("IGNEOUS_RETRY_ATTEMPTS"),
      base_s=knobs.get_float("IGNEOUS_RETRY_BASE_S"),
      cap_s=knobs.get_float("IGNEOUS_RETRY_CAP_S"),
      budget_s=knobs.get_float("IGNEOUS_RETRY_BUDGET_S"),
    )
    kw.update(overrides)
    return cls(**kw)

  def delay(self, retry_index: int) -> float:
    """Planned delay before retry number ``retry_index`` (0-based)."""
    d = min(self.cap_s, self.base_s * (2.0 ** retry_index))
    if self.jitter == "full":
      d = self.rng.random() * d
    return d

  def retries(self, counter: Optional[str] = None):
    """Yield once per retry, sleeping before each, until the attempts or
    the sleep budget run out. The first attempt is the caller's."""
    slept = 0.0
    for i in range(max(self.attempts - 1, 0)):
      d = self.delay(i)
      if slept + d > self.budget_s:
        return
      self.sleep_fn(d)
      slept += d
      if counter:
        telemetry.incr(f"retries.{counter}", 1)
      yield i


_DEFAULT: Optional[RetryPolicy] = None


def default_policy() -> RetryPolicy:
  """The process-wide policy, built from the environment once."""
  global _DEFAULT
  if _DEFAULT is None:
    _DEFAULT = RetryPolicy.from_env()
  return _DEFAULT


def set_default_policy(policy: Optional[RetryPolicy]):
  """Replace the process-wide policy (None: rebuild from the environment
  on next use)."""
  global _DEFAULT
  _DEFAULT = policy
