"""Wall-clock stage timers and counters: a shim over
``observability.metrics``, the one registry of the process.

Like ``igneous_tpu/telemetry.py`` it re-exports the registry's names
(``incr``, ``observe``, ``observe_quiet``, ``gauge_max``, ``gauge_set``,
the snapshots, ``StageTimes``/``task_timing``, ``emit_counters``,
``timed_poll_hooks``, ``queue_eta``, ``device_trace``). The port's own
sites keep their stage names and the calls below:

* ``stage(name)`` times a block on the host clock into the timer
  ``name`` and into every active ``task_timing`` scope, as the JAX
  package's ``stage`` does for its scopes. It records no trace span: the
  JAX package's ``stage`` records none, so both packages' traces hold the
  same spans. The device stages synchronise where they end (ops.pooling,
  ops.ccl, ops.mesh).
* ``snapshot()`` is ``{timer: {"seconds", "count"}}``, the stage view
  that the port's callers and ``chip_smoke.py`` print.

Counters count under the JAX package's names (the queues' and the
worker's ``tasks.failed``, ``dlq.promoted``, ``zombie.*`` and
``drain.released`` among them).

``observe`` adds a duration measured elsewhere (the staged pipeline's
stall seconds) and records a span under a sampled trace, as in the JAX
package; the device ledger (``observability.device``) records its
``device.*`` timers with ``observe_quiet``, beside spans of its own.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict

from .observability.metrics import (  # noqa: F401
  StageTimes,
  _stack,
  counters_snapshot,
  device_trace,
  emit_counters,
  gauge_max,
  gauge_set,
  gauges_snapshot,
  histograms_snapshot,
  incr,
  observe,
  observe_quiet,
  queue_eta,
  reset_all,
  reset_counters,
  task_timing,
  timed_poll_hooks,
  timer_totals,
  timers_snapshot,
)


@contextmanager
def stage(name: str):
  t0 = time.perf_counter()
  try:
    yield
  finally:
    dt = time.perf_counter() - t0
    observe_quiet(name, dt)
    for st in _stack():
      st.add(name, dt)


def snapshot() -> Dict[str, dict]:
  """{stage: {"seconds": total, "count": entries}} since the last reset."""
  return {k: {"seconds": v["sum"], "count": v["count"]}
          for k, v in timer_totals().items()}


__all__ = [
  "StageTimes", "counters_snapshot", "device_trace", "emit_counters",
  "gauge_max", "gauge_set", "gauges_snapshot", "histograms_snapshot", "incr",
  "observe", "observe_quiet", "queue_eta", "reset_all", "reset_counters",
  "snapshot", "stage", "task_timing", "timed_poll_hooks", "timer_totals",
  "timers_snapshot",
]
