"""Process-local metrics: counters, float timers, gauges, histograms.

The port's own copy of ``igneous_tpu/observability/metrics.py``, the one
registry of the process: what reaches a journal record or ``/metrics``
carries the JAX package's names, shapes and buckets.

  * ``observe()`` feeds a log-scale histogram per timer (Prometheus
    histogram export) and records a trace span when a sampled trace
    context is active on the calling thread — the pipeline's
    ``observe()`` sites become span emitters for free.
  * ``reset_counters()`` is counter-only; ``reset_all()`` clears
    timers/gauges/histograms too.
  * ``device_trace(logdir)`` runs ``torch.profiler`` (CPU and, where the
    process has a card, CUDA activity) around a region and writes a
    Chrome trace JSON, where the JAX package runs ``jax.profiler``.

``igneous_tpu_torch.telemetry`` is the shim the port's own stage sites
call (``stage``, ``add``, ``snapshot``, ``counters``, ``gauges``,
``reset``); it records into this registry.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

from . import trace

from ..analysis import knobs

_local = threading.local()

# -- failure-containment counters ---------------------------------------------
# process-wide monotonic counters for retry/fault/DLQ events: cheap enough
# to always collect, surfaced by `igneous queue status` and the chaos soak.

_COUNTERS: Dict[str, int] = defaultdict(int)
_COUNTERS_LOCK = threading.Lock()


def incr(name: str, n: int = 1) -> None:
  """Bump a named counter (e.g. "retries.storage_http", "dlq.promoted")."""
  with _COUNTERS_LOCK:
    _COUNTERS[name] += n


def counters_snapshot() -> Dict[str, int]:
  with _COUNTERS_LOCK:
    return dict(_COUNTERS)


def reset_counters() -> None:
  """Clear the int counters ONLY (timers/gauges/histograms survive)."""
  with _COUNTERS_LOCK:
    _COUNTERS.clear()


def reset_all() -> None:
  """Clear every metric family: counters, timers, gauges, histograms —
  what ``reset_counters()`` used to do implicitly."""
  with _COUNTERS_LOCK:
    _COUNTERS.clear()
    _TIMERS.clear()
    _TIMER_COUNTS.clear()
    _GAUGES.clear()
    _HISTOGRAMS.clear()


# -- staged-pipeline spans -----------------------------------------------------
# float-valued accumulators alongside the int counters: per-stage stall
# time, bytes in flight, queue depth. Same lock — a pipeline flush reads
# both families as one consistent snapshot.

_TIMERS: Dict[str, float] = defaultdict(float)
_TIMER_COUNTS: Dict[str, int] = defaultdict(int)
_GAUGES: Dict[str, float] = defaultdict(float)  # high-water marks

# log-scale histogram per timer name (Prometheus export). Upper bounds in
# seconds; the final implicit bucket is +Inf.
HISTOGRAM_BUCKETS = (
  0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0,
)
_HISTOGRAMS: Dict[str, list] = {}


def observe(name: str, seconds: float) -> None:
  """Accumulate a float span (e.g. "pipeline.download.stall_s")."""
  observe_quiet(name, seconds)
  # observe sites double as span emitters when the calling thread runs
  # inside a sampled trace (pipeline stages, buffer stalls)
  trace.record_span(name, seconds)


def observe_quiet(name: str, seconds: float) -> None:
  """``observe`` without the trace-span side channel — for callers that
  emit their own richer span for the same interval (the device plane
  records ``device.execute`` spans with kernel/device/byte attrs; a
  second bare span from observe() would double every interval in the
  Perfetto view)."""
  seconds = float(seconds)
  with _COUNTERS_LOCK:
    _TIMERS[name] += seconds
    _TIMER_COUNTS[name] += 1
    buckets = _HISTOGRAMS.get(name)
    if buckets is None:
      buckets = _HISTOGRAMS[name] = [0] * (len(HISTOGRAM_BUCKETS) + 1)
    for i, bound in enumerate(HISTOGRAM_BUCKETS):
      if seconds <= bound:
        buckets[i] += 1
        break
    else:
      buckets[-1] += 1


def gauge_max(name: str, value: float) -> None:
  """Record a high-water mark (e.g. "pipeline.buffer.bytes" in flight)."""
  with _COUNTERS_LOCK:
    if value > _GAUGES[name]:
      _GAUGES[name] = float(value)


def gauge_set(name: str, value: float) -> None:
  """Overwrite a gauge (health/autoscale signals: the CURRENT value is
  the point, unlike gauge_max's high-water marks)."""
  with _COUNTERS_LOCK:
    _GAUGES[name] = float(value)


def gauge_set_async_safe(name: str, value: float) -> None:
  """Signal-handler-safe gauge write: skips the metrics lock (a handler
  interrupting this thread while it holds the lock would deadlock). A
  dict setitem is atomic under the GIL — a concurrent snapshot may miss
  the newest value, but state can never corrupt."""
  _GAUGES[name] = float(value)


def timers_snapshot() -> Dict[str, dict]:
  with _COUNTERS_LOCK:
    out = {
      name: {"seconds": round(total, 4), "count": _TIMER_COUNTS[name]}
      for name, total in _TIMERS.items()
    }
    out.update({
      name: {"max": round(v, 1)} for name, v in _GAUGES.items()
    })
    return out


def gauges_snapshot() -> Dict[str, float]:
  with _COUNTERS_LOCK:
    return dict(_GAUGES)


def histograms_snapshot() -> Dict[str, dict]:
  """Per-timer bucket counts: {name: {"buckets": [...], "bounds": [...]}}
  where buckets[i] counts observations <= bounds[i] (last = +Inf)."""
  with _COUNTERS_LOCK:
    return {
      name: {"bounds": list(HISTOGRAM_BUCKETS), "buckets": list(b)}
      for name, b in _HISTOGRAMS.items()
    }


def histogram_quantile(name: str, q: float) -> Optional[float]:
  """Approximate quantile (seconds) of a timer from its log-scale
  histogram — the upper bound of the bucket holding the q-th
  observation, Prometheus ``histogram_quantile`` style. The serve tier's
  p50/p99 gauges and the bench read latency through this; None when the
  timer has no observations. The overflow bucket reports the top bound
  (the histogram cannot resolve beyond it)."""
  with _COUNTERS_LOCK:
    buckets = _HISTOGRAMS.get(name)
    if buckets is None:
      return None
    buckets = list(buckets)
  total = sum(buckets)
  if total == 0:
    return None
  rank = max(1, int(q * total + 0.5))
  cum = 0
  for i, count in enumerate(buckets):
    cum += count
    if cum >= rank:
      return HISTOGRAM_BUCKETS[min(i, len(HISTOGRAM_BUCKETS) - 1)]
  return HISTOGRAM_BUCKETS[-1]


def timer_totals() -> Dict[str, dict]:
  """Raw (sum, count) per timer, no gauges mixed in (Prometheus export)."""
  with _COUNTERS_LOCK:
    return {
      name: {"sum": total, "count": _TIMER_COUNTS[name]}
      for name, total in _TIMERS.items()
    }


def emit_counters(event: str = "counters", **extra) -> dict:
  """Flush the counters as one JSON line (stdout). Workers call this on
  graceful drain so retry/zombie/DLQ tallies survive the pod — the line
  is the worker's last will, greppable from `kubectl logs --previous`."""
  record = {"event": event, **extra, "counters": counters_snapshot()}
  timers = timers_snapshot()
  if timers:
    record["spans"] = timers
  print(json.dumps(record), flush=True)
  return record


def _stack():
  if not hasattr(_local, "stack"):
    _local.stack = []
  return _local.stack


class StageTimes:
  """Accumulates wall-clock per named stage (download/compute/upload/…)."""

  def __init__(self):
    self.totals: Dict[str, float] = defaultdict(float)
    self.counts: Dict[str, int] = defaultdict(int)

  def add(self, stage: str, seconds: float):
    self.totals[stage] += seconds
    self.counts[stage] += 1

  def summary(self) -> dict:
    return {
      stage: {"seconds": round(self.totals[stage], 4), "count": self.counts[stage]}
      for stage in sorted(self.totals)
    }

  def __str__(self):
    return json.dumps(self.summary())


@contextlib.contextmanager
def task_timing() -> Iterator[StageTimes]:
  """Collect stage timings for one task execution."""
  st = StageTimes()
  _stack().append(st)
  try:
    yield st
  finally:
    _stack().pop()


@contextlib.contextmanager
def stage(name: str):
  """Time a stage; attributes to every active task_timing() scope."""
  t0 = time.perf_counter()
  try:
    yield
  finally:
    dt = time.perf_counter() - t0
    for st in _stack():
      st.add(name, dt)


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None):
  """``torch.profiler`` trace around a device-heavy region.

  Gated on ``IGNEOUS_PROFILE_DIR`` (legacy ``IGNEOUS_TPU_PROFILE_DIR``
  still honored) so it is INERT by default — workers without profiling
  infrastructure pay one env read. Each region writes one Chrome trace
  JSON under a per-worker directory (hostname-pid): concurrent workers
  sharing one profile dir never write the same file. The profiler
  records CPU activity, and CUDA activity when the process has a card.
  Stopping is exception-safe twice over: it runs from a ``finally`` so
  the region's exception still stops the profiler, and a stop or export
  failure never masks — or adds to — the region's own outcome."""
  logdir = (
    logdir
    or knobs.get_str("IGNEOUS_PROFILE_DIR")
    or knobs.get_str("IGNEOUS_TPU_PROFILE_DIR")
  )
  if not logdir:
    yield
    return
  import socket

  from .device import profiler_activities

  host = socket.gethostname().split(".")[0] or "worker"
  logdir = os.path.join(logdir, f"{host}-{os.getpid()}")
  try:
    import torch.profiler

    prof = torch.profiler.profile(activities=profiler_activities())
    prof.__enter__()
  except Exception:
    # a second profiler in this process (nested regions, a concurrent
    # triggered capture) raises; profiling is diagnostics, not
    # correctness
    incr("device.profile.start_failed")
    yield
    return
  try:
    yield
  finally:
    try:
      prof.__exit__(None, None, None)
      os.makedirs(logdir, exist_ok=True)
      prof.export_chrome_trace(
        os.path.join(logdir, f"trace-{time.time_ns()}.json")
      )
    except Exception:
      incr("device.profile.stop_failed")


def timed_poll_hooks(verbose: bool = True):
  """(before_fn, after_fn) for FileQueue.poll: logs per-task wall time and
  stage breakdown as one JSON line per completed task."""
  state = {}

  def _close():
    scope = state.pop("scope", None)
    if scope is not None:
      scope.__exit__(None, None, None)

  def before(task):
    # poll() calls after_fn only on success: if the previous task raised,
    # its scope is still open — close it here so the stack never grows
    _close()
    state["t0"] = time.perf_counter()
    scope = task_timing()
    state["st"] = scope.__enter__()
    state["scope"] = scope

  def after(task):
    st: StageTimes = state["st"]
    _close()
    record = {
      "task": type(task).__name__,
      "wall_s": round(time.perf_counter() - state["t0"], 4),
      "stages": st.summary(),
    }
    if verbose:
      print(json.dumps(record), flush=True)

  return before, after


def queue_eta(queue, sample_seconds: float = 10.0,
              journal_path: Optional[str] = None) -> dict:
  """Tasks/sec + ETA. When ``journal_path`` holds journal segments, the
  throughput derives from the fleet's task spans (no sampling sleep);
  otherwise two enqueued-count samples ``sample_seconds`` apart
  (reference `igneous queue status --eta`, cli.py:1998-2048)."""
  if journal_path is not None:
    from . import fleet

    derived = fleet.journal_throughput(journal_path)
    if derived is not None:
      rate = derived["tasks_per_sec"]
      enq = queue.enqueued
      return {
        "enqueued": enq,
        "tasks_per_sec": round(rate, 3),
        "eta_sec": round(enq / rate, 1) if rate > 0 else None,
        "source": "journal",
        "window_sec": derived["window_sec"],
        "tasks_observed": derived["tasks"],
      }
  first = queue.enqueued
  t0 = time.time()
  time.sleep(sample_seconds)
  second = queue.enqueued
  dt = time.time() - t0
  rate = max((first - second) / dt, 0.0)
  return {
    "enqueued": second,
    "tasks_per_sec": round(rate, 3),
    "eta_sec": round(second / rate, 1) if rate > 0 else None,
    "source": "sampled",
  }
