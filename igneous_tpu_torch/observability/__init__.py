"""Observability of the port: trace context, spans, journal, exporters.

The port's own copy of ``igneous_tpu/observability``::

    task factory ──mint──> trace_id in the queue payload
         │                        │
      enqueue              lease / redeliver / DLQ (identity survives)
         │                        │
         └──> worker: task_span + stage spans (pipeline observe() sites,
              storage ops, lease rounds, device spans) → per-thread
              span buffers
                                  │
              Journal.flush ──> <queue>/journal/*.jsonl segments
                                  │            │
         fleet status|trace|top|devices        │ rollup.compact
         Prometheus /metrics        Perfetto   ▼
                                    <journal>/rollup/ windowed records
                                               │
              HealthEngine (stragglers, anomalies, SLO burn, autoscale)
                 │               │                    │
         fleet check|watch   health.* events   health/flags.json
                                               (LeaseBatcher backs off)

The device plane (``device``): the ledger of the hand kernels' spans on
CUDA events, its ``{"kind": "device"}`` journal records and
``igneous_device_*`` gauges, ``fleet devices``, and ``profile capture``
on ``torch.profiler``. Every record, line and exposition is the JAX
package's, so a fleet may mix workers of both packages.

The forward plane: ``replay`` mines the journal into a ``WorkloadModel``;
``sim`` replays it through a deterministic discrete-event fleet
simulation that emits journal segments (the JAX package's bytes for the
same seed); ``autoscale`` closes the loop (``PolicyLoop``, the actuators,
``AutoscaleController``: ``fleet autoscale``); ``campaign`` drives a
campaign (autoscale, flags and straggler speculation a tick: ``campaign
run``).

``igneous_tpu_torch.telemetry`` is the shim over :mod:`.metrics` that the
port's stage sites call.
"""

from . import (
  autoscale,
  campaign,
  device,
  fleet,
  health,
  journal,
  perfetto,
  prom,
  replay,
  rollup,
  sim,
  trace,
)
from .metrics import (
  StageTimes,
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
  stage,
  task_timing,
  timed_poll_hooks,
  timers_snapshot,
)

__all__ = [
  "autoscale", "campaign", "device", "fleet", "health", "journal",
  "perfetto", "prom", "replay", "rollup", "sim", "trace",
  "StageTimes", "counters_snapshot", "device_trace", "emit_counters",
  "gauge_max", "gauge_set", "gauges_snapshot", "histograms_snapshot",
  "incr", "observe", "observe_quiet", "queue_eta", "reset_all",
  "reset_counters", "stage",
  "task_timing", "timed_poll_hooks", "timers_snapshot",
]
