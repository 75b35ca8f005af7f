"""The device ledger: kernel spans, library builds, transfers, padding and
memory of the port's device, for one process.

The port's own copy of ``igneous_tpu/observability/device.py``: the
ledger and its span context managers, the ledger's ``{"kind": "device"}``
journal records (``journal_records``, ``install``), the
``igneous_device_*`` gauges (``publish_gauges``), the profiler capture on
request (``profile capture``: ``write_profile_request``,
``poll_profile_trigger``, ``start_capture``, ``list_profiles``) and every
``IGNEOUS_PROFILE_EVERY``-th dispatch, and the fleet read side
(``device_ledgers``, ``render_devices``, ``fleet_summary``,
``report_json``), with the JAX package's names and record shapes.

What differs on the card:

* **Spans do not synchronise.** The JAX package times a blocking call on
  the host clock. Here an ``execute_span`` or ``transfer_span`` on a CUDA
  device records a start and an end ``torch.cuda.Event(enable_timing=True)``
  on the current stream and queues the pair. A pair is resolved when its
  end event has completed (``Event.query``, polled as later spans close)
  or at ``snapshot()`` / ``busy_seconds()``, which wait on those events
  alone. No span calls ``torch.cuda.synchronize()``: the stages already
  synchronise where they end, and a span that did would change the
  overlap the staged pipeline buys. A span opened while the stream is
  being captured into a CUDA graph records nothing (its replays run
  later, outside the ledger).
* **Busy seconds are a union, not a sum.** Spans nest (a kernel launch
  inside an executor's dispatch) and several host threads launch onto one
  stream, so every resolved pair is placed on one timeline per device,
  as milliseconds from an anchor event recorded at ``reset()`` (or at the
  first span on that device), and busy seconds are the length of the
  union of the execute and transfer intervals. On the CPU the same code
  runs on ``time.perf_counter`` intervals. A span's device interval runs
  from the moment the stream reaches its start event to the moment it
  reaches its end event, so a span around host work between launches
  counts the card's idle gaps inside it: busy seconds are at least the
  card's kernel and copy time inside the spans and at most the wall.
  Per-kernel ``execute_s`` sums each name's own intervals and may overlap
  across names (an executor's span holds its kernels' spans).
* **``dispatches`` counts outermost execute spans** (one host-side
  dispatch, whatever kernels it launches); a kernel's ``executes`` counts
  every span of its name, and its ``devices`` splits them by device. The
  hand kernels' wrappers span each launch, so their executes on the card
  equal their ``LAUNCHES``, and on the CPU count the plain versions' calls
  (a CUDA process runs some on the CPU on purpose: the skeleton task's
  boundary planes). ``busy_s`` is the busiest device's; ``devices`` gives
  each device's.
* **Compiles are library builds.** PyTorch compiles nothing per shape.
  ``record_compile`` is charged by ``ops._build.build`` for each nvcc or
  g++ run, and ``device.recompiles`` counts those builds only.
  ``note_signature`` still counts distinct (kernel, shapes, dtypes), so
  ``distinct_signatures`` shows shape churn as in the JAX package.
* **Memory** comes from ``torch.cuda.memory_stats()`` (allocated bytes,
  current and peak) and ``torch.cuda.mem_get_info()``'s total (the limit
  the health engine's HBM high-water reads), for every CUDA device the
  process has initialised, labelled ``cuda:N``; on the CPU
  ``sample_hbm`` returns ``{}`` and sets no gauge. The ledger record also
  names each card (``kinds``: ``torch.cuda.get_device_name``), which
  ``render_devices`` prints under its table.
* **Trace spans come from the events.** A span opened under a sampled
  task or stage context records a ``device.execute`` (``device.h2d``,
  ``device.d2h``) span parented to that context, as the JAX package's
  ``record_span`` does; outside a task it lands on the worker trace. On the
  card the span is recorded when its event pair resolves, with the host's
  wall time at launch as ``ts`` and the events' interval as ``dur``.
* **A profile is a Chrome trace.** ``profile capture`` runs
  ``torch.profiler`` (CPU and CUDA activity on the card, CPU alone
  elsewhere) on a thread of its own for the requested seconds, and
  uploads ``trace.json`` under ``<journal>/profiles/<worker>-<id>/``,
  where the JAX package uploads an xplane.

Counters and gauges go to ``observability.metrics`` under the JAX
package's names: ``device.recompiles``, ``device.execute.s``,
``device.compile.s``, ``device.h2d.s``, ``device.d2h.s``,
``device.pad_waste_ratio``, ``device.fastpath.*``, ``device.busy_ratio``,
``device.hbm.bytes_in_use|peak_bytes|bytes_limit``,
``device.compile_cache.hit|miss|put|corrupt|error`` and
``device.profile.*``.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from .. import secrets as knobs
from . import metrics, trace

PROFILE_DIR_ENV = "IGNEOUS_PROFILE_DIR"
PROFILE_EVERY_ENV = "IGNEOUS_PROFILE_EVERY"
PROFILE_REQUEST_KEY = "profile/request.json"
PROFILE_ARTIFACT_PREFIX = "profiles/"
# how often a worker re-reads <journal>/profile/request.json (one small
# GET on the journal's maybe_flush cadence)
PROFILE_POLL_SEC = 15.0
# a capture request older than this is history, not a trigger
PROFILE_REQUEST_TTL_SEC = 600.0

# the compile-cache events and their counters
_CACHE_COUNTER = {"hits": "hit", "misses": "miss", "puts": "put",
                  "corrupt": "corrupt", "errors": "error"}
# intervals kept before merging them into their union
_MERGE_AT = 4096


def _union_seconds(intervals: List[Tuple[float, float]]) -> Tuple[float, list]:
  """(length of the union, the union as sorted disjoint intervals)."""
  merged: List[Tuple[float, float]] = []
  for s, e in sorted(intervals):
    if merged and s <= merged[-1][1]:
      if e > merged[-1][1]:
        merged[-1] = (merged[-1][0], e)
    else:
      merged.append((s, e))
  return sum(e - s for s, e in merged), merged


def _label(dev: torch.device) -> str:
  if dev.type == "cuda":
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return f"cuda:{index}"
  return dev.type


class DeviceLedger:
  """Cumulative accounting of device work since ``reset()``."""

  def __init__(self):
    self.lock = threading.Lock()
    self.reset()

  def reset(self) -> None:
    with self.lock:
      self.t_start = time.time()  # guarded-by: self.lock
      self._t0 = time.perf_counter()  # guarded-by: self.lock
      self.kernels: Dict[str, dict] = {}  # guarded-by: self.lock
      self._signatures: set = set()  # guarded-by: self.lock
      # device label -> intervals (seconds on that device's timeline)
      self._intervals: Dict[str, list] = {}  # guarded-by: self.lock
      self._merged: Dict[str, int] = {}  # guarded-by: self.lock
      # (kind, name, label, start event, end event, elements, nbytes, top)
      self._pending: list = []  # guarded-by: self.lock
      # CUDA device index -> the event every interval is measured from
      self._anchors: Dict[int, torch.cuda.Event] = {}  # guarded-by: self.lock
      self.h2d_bytes = 0  # guarded-by: self.lock
      self.d2h_bytes = 0  # guarded-by: self.lock
      self.h2d_seconds = 0.0  # guarded-by: self.lock
      self.d2h_seconds = 0.0  # guarded-by: self.lock
      self.recompiles = 0  # guarded-by: self.lock
      self.dispatches = 0  # guarded-by: self.lock
      self.transfers = 0  # guarded-by: self.lock
      self.fastpath = {"batched": 0, "host": 0}  # guarded-by: self.lock
      # the library store: saved_s sums the producer's build seconds each
      # hit avoided, fetch_s the seconds the fetches took instead
      self.compile_cache = dict(  # guarded-by: self.lock
        hits=0, misses=0, puts=0, corrupt=0, errors=0, saved_s=0.0, fetch_s=0.0,
      )
      self.pad_bytes = 0  # guarded-by: self.lock
      self.real_bytes = 0  # guarded-by: self.lock
      self.hbm: Dict[str, dict] = {}  # guarded-by: self.lock
      # device label -> the card's name
      self.kinds: Dict[str, str] = {}  # guarded-by: self.lock
      # recorded since the last journal record? An idle worker must not
      # write a segment every flush interval
      self._dirty = False  # guarded-by: self.lock
    if torch.cuda.is_initialized():
      self._anchor(torch.cuda.current_device())

  def _kernel_locked(self, name: str) -> dict:
    k = self.kernels.get(name)
    if k is None:
      k = self.kernels[name] = {
        "compiles": 0, "compile_s": 0.0, "executes": 0, "execute_s": 0.0,
        "elements": 0, "bytes": 0, "cache_hits": 0, "devices": {},
      }
    return k

  def _anchor(self, index: int) -> torch.cuda.Event:
    with self.lock:
      anchor = self._anchors.get(index)
      if anchor is None:
        anchor = torch.cuda.Event(enable_timing=True)
        anchor.record(torch.cuda.current_stream(index))
        self._anchors[index] = anchor
      return anchor

  def _add_interval_locked(self, label: str, start: float, end: float) -> None:
    ivs = self._intervals.setdefault(label, [])
    ivs.append((start, end))
    if len(ivs) >= self._merged.get(label, 0) + _MERGE_AT:
      _, ivs[:] = _union_seconds(ivs)
      self._merged[label] = len(ivs)

  # -- write side -----------------------------------------------------------

  def note_signature(self, kernel: str, signature) -> bool:
    """True exactly once per (kernel, signature): a shape or dtype this
    process had not run the kernel on. It does not tick
    ``device.recompiles``: nothing is compiled per shape."""
    key = (kernel, repr(signature))
    with self.lock:
      if key in self._signatures:
        return False
      self._signatures.add(key)
      return True

  def record_cache_event(self, event: str, kernel: str = "", saved_s: float = 0.0,
                         fetch_s: float = 0.0) -> None:
    """The library store's accounting: ``event`` is one of hits, misses,
    puts, corrupt and errors; ``saved_s`` the producer's build seconds a
    hit avoided, ``fetch_s`` the seconds its fetch took."""
    with self.lock:
      cc = self.compile_cache
      cc[event] += 1
      cc["saved_s"] += float(saved_s)
      cc["fetch_s"] += float(fetch_s)
      if kernel and event == "hits":
        self._kernel_locked(kernel)["cache_hits"] += 1
      self._dirty = True
    metrics.incr(f"device.compile_cache.{_CACHE_COUNTER[event]}")

  def record_compile(self, kernel: str, seconds: float) -> None:
    """One library build (an nvcc or g++ run) of ``seconds``."""
    with self.lock:
      k = self._kernel_locked(kernel)
      k["compiles"] += 1
      k["compile_s"] += float(seconds)
      self.recompiles += 1
      self._dirty = True
    metrics.incr("device.recompiles")
    metrics.observe_quiet("device.compile.s", float(seconds))

  def record_execute(self, kernel: str, seconds: float, elements: int = 0,
                     nbytes: int = 0, device: str = "cpu",
                     interval: Optional[Tuple[float, float]] = None,
                     dispatch: bool = True) -> None:
    """One execution of ``kernel``: ``seconds`` of device time, placed at
    ``interval`` on ``device``'s timeline (default: ending now, on the
    host clock); ``dispatch`` counts it as a host-side dispatch."""
    seconds = float(seconds)
    if interval is None:
      end = time.perf_counter() - self._t0
      interval = (end - seconds, end)
    with self.lock:
      k = self._kernel_locked(kernel)
      k["executes"] += 1
      k["devices"][device] = k["devices"].get(device, 0) + 1
      k["execute_s"] += seconds
      k["elements"] += int(elements)
      k["bytes"] += int(nbytes)
      self.dispatches += int(bool(dispatch))
      self._add_interval_locked(device, *interval)
      self._dirty = True
    metrics.observe_quiet("device.execute.s", seconds)

  def record_transfer(self, direction: str, nbytes: int, seconds: float,
                      device: str = "cpu",
                      interval: Optional[Tuple[float, float]] = None) -> None:
    """One host<->device copy (``direction`` "h2d" or "d2h"); its interval
    counts toward the device's busy time, as a copy engine's work."""
    seconds = float(seconds)
    if interval is None:
      end = time.perf_counter() - self._t0
      interval = (end - seconds, end)
    with self.lock:
      self.transfers += 1
      if direction == "h2d":
        self.h2d_bytes += int(nbytes)
        self.h2d_seconds += seconds
      else:
        self.d2h_bytes += int(nbytes)
        self.d2h_seconds += seconds
      self._add_interval_locked(device, *interval)
      self._dirty = True
    metrics.observe_quiet(f"device.{direction}.s", seconds)

  def record_fastpath(self, batched: int = 0, host: int = 0) -> None:
    """``batched`` deliveries rode a batched dispatch, ``host`` took the
    per-task path."""
    with self.lock:
      self.fastpath["batched"] += int(batched)
      self.fastpath["host"] += int(host)
      self._dirty = True
      b, h = self.fastpath["batched"], self.fastpath["host"]
    if batched:
      metrics.incr("device.fastpath.batched", int(batched))
    if host:
      metrics.incr("device.fastpath.host", int(host))
    if b + h:
      metrics.gauge_set("device.fastpath_ratio", b / (b + h))

  def record_pad_waste(self, padded_bytes: int = 0, real_bytes: int = 0) -> None:
    """``padded_bytes`` of filler (a dispatch group's fill, a page's slack)
    beside ``real_bytes`` of data; the gauge is the cumulative ratio."""
    with self.lock:
      self.pad_bytes += int(padded_bytes)
      self.real_bytes += int(real_bytes)
      self._dirty = True
      p, r = self.pad_bytes, self.real_bytes
    if r:
      metrics.gauge_set("device.pad_waste_ratio", p / r)

  def sample_hbm(self) -> Dict[str, dict]:
    """Allocated bytes (current, peak) and the memory's size of every CUDA
    device this process initialised; ``{}`` (and no gauge) without one."""
    if not torch.cuda.is_initialized():
      return {}
    out = {}
    kinds = {}
    for index in range(torch.cuda.device_count()):
      stats = torch.cuda.memory_stats(index)
      if not stats:
        continue
      kinds[f"cuda:{index}"] = torch.cuda.get_device_name(index)
      out[f"cuda:{index}"] = {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.mem_get_info(index)[1]),
      }
    if out:
      with self.lock:
        self.kinds.update(kinds)
        for label, rec in out.items():
          prev = self.hbm.get(label) or {}
          rec["peak_bytes_in_use"] = max(rec["peak_bytes_in_use"],
                                         prev.get("peak_bytes_in_use", 0))
          self.hbm[label] = rec
      worst = max(out.values(), key=lambda r: r["peak_bytes_in_use"])
      metrics.gauge_set("device.hbm.bytes_in_use", worst["bytes_in_use"])
      metrics.gauge_max("device.hbm.peak_bytes", worst["peak_bytes_in_use"])
      metrics.gauge_set("device.hbm.bytes_limit", worst["bytes_limit"])
    return out

  # -- CUDA event pairs -------------------------------------------------------

  def _queue(self, item) -> None:
    with self.lock:
      self._pending.append(item)
      self._dirty = True
    self._resolve(wait=False)

  def _resolve(self, wait: bool) -> None:
    """Turn completed event pairs into records, oldest first; with
    ``wait``, wait on each pending end event (never on the device)."""
    while True:
      with self.lock:
        if not self._pending:
          return
        item = self._pending[0]
      kind, name, label, start, end, elements, nbytes, top, ident, ts, attrs = item
      # wait outside the lock: other threads go on recording spans
      if wait:
        end.synchronize()
      elif not end.query():
        return
      with self.lock:
        if not self._pending or self._pending[0] is not item:
          continue  # another reader took it, or a reset dropped it
        self._pending.pop(0)
        anchor = self._anchors[int(label.split(":")[1])]
      s = anchor.elapsed_time(start) / 1e3
      e = anchor.elapsed_time(end) / 1e3
      if kind == "execute":
        self.record_execute(name, e - s, elements, nbytes, label, (s, e), top)
      else:
        self.record_transfer(kind, nbytes, e - s, label, (s, e))
      _trace_span(ident, kind, name, label, elements, nbytes, ts, e - s, attrs)

  # -- read side --------------------------------------------------------------

  def busy_seconds(self) -> float:
    """The busiest device's union of execute and transfer intervals."""
    self._resolve(wait=True)
    with self.lock:
      return max((_union_seconds(ivs)[0] for ivs in self._intervals.values()),
                 default=0.0)

  def utilization(self) -> Optional[float]:
    """Busy seconds over the wall seconds since ``reset()``; None before
    any device work."""
    busy = self.busy_seconds()
    wall = time.perf_counter() - self._t0
    if wall <= 0 or not self._intervals:
      return None
    return min(busy / wall, 1.0)

  def snapshot(self) -> Optional[dict]:
    """The ledger as a dict; None when no device work was recorded."""
    self._resolve(wait=True)
    with self.lock:
      if not self._intervals and not self.fastpath["host"] and not self.recompiles \
         and not any(self.compile_cache[k] for k in _CACHE_COUNTER):
        return None
      wall = max(time.perf_counter() - self._t0, 1e-9)
      devices = {label: _union_seconds(ivs)[0]
                 for label, ivs in sorted(self._intervals.items())}
      busy = max(devices.values(), default=0.0)
      kernels = {}
      for name, k in self.kernels.items():
        kernels[name] = {
          **k,
          "devices": dict(k["devices"]),
          "vox_per_sec": k["elements"] / k["execute_s"] if k["execute_s"] > 0 else None,
          "bytes_per_sec": (k["bytes"] / k["execute_s"]
                            if k["execute_s"] > 0 and k["bytes"] else None),
        }
      snap = {
        "ts": time.time(),
        "t_start": self.t_start,
        "wall_s": wall,
        "busy_s": busy,
        "busy_ratio": min(busy / wall, 1.0),
        "dispatches": self.dispatches,
        "transfers": self.transfers,
        "recompiles": self.recompiles,
        "distinct_signatures": len(self._signatures),
        "kernels": kernels,
        "devices": devices,
        "fastpath": dict(self.fastpath),
        "compile_cache": dict(self.compile_cache),
        "pad_bytes": self.pad_bytes,
        "real_bytes": self.real_bytes,
        "pad_waste_ratio": self.pad_bytes / self.real_bytes if self.real_bytes else None,
        "h2d_bytes": self.h2d_bytes,
        "d2h_bytes": self.d2h_bytes,
        "h2d_MBps": (self.h2d_bytes / self.h2d_seconds / 1e6
                     if self.h2d_seconds > 0 else None),
        "d2h_MBps": (self.d2h_bytes / self.d2h_seconds / 1e6
                     if self.d2h_seconds > 0 else None),
      }
      if self.hbm:
        snap["hbm"] = {dev: dict(rec) for dev, rec in self.hbm.items()}
      if self.kinds:
        snap["kinds"] = dict(self.kinds)
      return snap


LEDGER = DeviceLedger()

# open execute spans on this thread: the outermost one is a dispatch
_DEPTH = threading.local()


def reset() -> None:
  """A fresh ledger and profiler trigger state."""
  LEDGER.reset()
  _PROFILE_STATE.update(cache=(0.0, None), served=set(), active=False)


def publish_gauges() -> None:
  """Ledger → ``igneous_device_*`` gauges (rendered by prom.render):
  the busy ratio and the memory watermarks sampled fresh; the dispatch
  and recompile counters register as they are recorded."""
  util = LEDGER.utilization()
  if util is not None:
    metrics.gauge_set("device.busy_ratio", util)
  LEDGER.sample_hbm()


# ---------------------------------------------------------------------------
# trace spans of the ledger's spans


def _trace_identity() -> Optional[Tuple[str, Optional[str]]]:
  """(trace id, parent span id) a device span records under, or None:
  the active sampled context's node; outside any task the worker trace,
  as the JAX package's ``record_span`` places lease-round and driver
  dispatches; an unsampled task keeps its verdict."""
  ctx = trace.current()
  if ctx is not None:
    return (ctx.trace_id, ctx.span_id) if ctx.sampled else None
  if trace.tracing_enabled():
    return (trace.worker_trace_id(), None)
  return None


def _trace_span(ident, kind: str, name: str, label: str, elements: int,
                nbytes: int, ts: float, dur: float, extra=None) -> None:
  if ident is None:
    return
  if kind == "execute":
    attrs = dict(kernel=name, elements=int(elements), device=label, devices=1)
  else:
    attrs = dict(kernel=None, bytes=int(nbytes), device=label)
  attrs.update(extra or {})
  trace.record_at(f"device.{kind}", ts, dur, ident[0], parent=ident[1], **attrs)


def _device(device) -> torch.device:
  if device is None:
    from ..device import get_device

    return get_device()
  return torch.device(device)


@contextlib.contextmanager
def _span(kind: str, name: str, device, elements: int, nbytes: int,
          attrs=None) -> Iterator[None]:
  dev = _device(device)
  depth = getattr(_DEPTH, "n", 0)
  top = depth == 0
  if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
    yield
    return
  if kind == "execute":
    _DEPTH.n = depth + 1
  ident = _trace_identity()
  ts = time.time()
  try:
    if dev.type != "cuda":
      t0 = time.perf_counter()
      yield
      t1 = time.perf_counter()
      s, e = t0 - LEDGER._t0, t1 - LEDGER._t0
      if kind == "execute":
        LEDGER.record_execute(name, e - s, elements, nbytes, _label(dev), (s, e), top)
      else:
        LEDGER.record_transfer(kind, nbytes, e - s, _label(dev), (s, e))
      _trace_span(ident, kind, name, _label(dev), elements, nbytes, ts, e - s, attrs)
      return
    label = _label(dev)
    LEDGER._anchor(int(label.split(":")[1]))
    stream = torch.cuda.current_stream(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    yield
    end.record(torch.cuda.current_stream(dev))
    LEDGER._queue((kind, name, label, start, end, elements, nbytes, top, ident, ts, attrs))
  finally:
    if kind == "execute":
      _DEPTH.n = depth
      if top:
        maybe_sample_profile()


def execute_span(kernel: str, elements: int = 0, nbytes: int = 0, device=None,
                 signature=None, **attrs):
  """Account the device work launched inside the context to ``kernel`` on
  ``device`` (default: the port's device). ``signature`` (shapes, dtypes)
  feeds ``note_signature``. On the card it records CUDA events and never
  synchronises; the caller need not wait for the work. Extra keyword
  ``attrs`` ride onto the ``device.execute`` span (the fused pyramid's
  ``mip_from`` and ``mip_to``)."""
  if signature is not None:
    LEDGER.note_signature(kernel, signature)
  return _span("execute", kernel, device, elements, nbytes, attrs)


def transfer_span(direction: str, nbytes: int, device=None):
  """Account one host<->device copy (``direction`` "h2d" or "d2h") of
  ``nbytes`` on ``device``."""
  if direction not in ("h2d", "d2h"):
    raise ValueError(f"direction must be h2d or d2h, not {direction!r}")
  return _span(direction, "", device, 0, nbytes)


@contextlib.contextmanager
def compile_span(kernel: str) -> Iterator[None]:
  """Time one library build on the host clock, charge it to the ledger
  and record a ``device.compile`` span."""
  ident = _trace_identity()
  ts = time.time()
  t0 = time.perf_counter()
  try:
    yield
  finally:
    dt = time.perf_counter() - t0
    LEDGER.record_compile(kernel, dt)
    if ident is not None:
      trace.record_at("device.compile", ts, dt, ident[0], parent=ident[1], kernel=kernel,
                      device=(f"cuda:{torch.cuda.current_device()}"
                              if torch.cuda.is_initialized() else "cpu"))


def nbytes_of(tree) -> int:
  """Bytes of the tensors and arrays of a tuple / list / dict nest."""
  if isinstance(tree, dict):
    return sum(nbytes_of(v) for v in tree.values())
  if isinstance(tree, (tuple, list)):
    return sum(nbytes_of(v) for v in tree)
  if isinstance(tree, torch.Tensor):
    return tree.numel() * tree.element_size()
  return int(getattr(tree, "nbytes", 0))


def elements_of(tree) -> int:
  """Elements of the tensors and arrays of a nest."""
  if isinstance(tree, dict):
    return sum(elements_of(v) for v in tree.values())
  if isinstance(tree, (tuple, list)):
    return sum(elements_of(v) for v in tree)
  if isinstance(tree, torch.Tensor):
    return tree.numel()
  return int(getattr(tree, "size", 0))


# ---------------------------------------------------------------------------
# journal integration


def journal_records() -> List[dict]:
  """The journal flush hook (``journal.register_record_provider``): one
  cumulative ``device`` record per flush, only when the ledger changed
  since the last one. Resolving the record waits on the spans' end
  events (never on the whole device), and turns them into trace spans
  of the same segment."""
  with LEDGER.lock:
    dirty = LEDGER._dirty
    LEDGER._dirty = False
  if not dirty:
    return []
  publish_gauges()  # refreshes the memory watermarks before the snapshot
  snap = LEDGER.snapshot()
  if snap is None:
    return []
  snap["kind"] = "device"
  return [snap]


def install() -> None:
  """Wire the device plane into a journal-bearing worker: ledger records
  ride every journal flush, and the profiler trigger is polled on the
  same cadence. Idempotent."""
  from . import journal as journal_mod

  journal_mod.register_record_provider(journal_records)
  journal_mod.register_poll_hook(poll_profile_trigger)


# ---------------------------------------------------------------------------
# profiler capture on request


_PROFILE_STATE = {
  "cache": (0.0, None),  # (checked_at_monotonic, request-or-None)
  "served": set(),       # request ids this process already captured
  "active": False,       # a capture thread is running
}
_PROFILE_LOCK = threading.Lock()


def profiler_activities() -> list:
  """CPU activity, and CUDA activity when the process has a card."""
  from torch.profiler import ProfilerActivity

  acts = [ProfilerActivity.CPU]
  if torch.cuda.is_available():
    acts.append(ProfilerActivity.CUDA)
  return acts


def write_profile_request(journal_path: str, duration_sec: float = 5.0,
                          workers: Optional[List[str]] = None,
                          request_id: Optional[str] = None) -> dict:
  """Publish a capture request where workers see it (``profile
  capture``). ``workers`` restricts the trigger; None: every worker that
  polls the flag captures once."""
  from ..storage import CloudFiles

  req = {
    "id": request_id or trace.new_id(),
    "ts": time.time(),
    "duration_sec": float(duration_sec),
    "workers": list(workers) if workers else None,
  }
  CloudFiles(journal_path).put_json(PROFILE_REQUEST_KEY, req)
  return req


def read_profile_request(journal_path: str) -> Optional[dict]:
  from ..storage import CloudFiles

  try:
    req = CloudFiles(journal_path).get_json(PROFILE_REQUEST_KEY)
  except Exception:
    return None
  if not req or not req.get("id"):
    return None
  if time.time() - float(req.get("ts") or 0) > PROFILE_REQUEST_TTL_SEC:
    return None
  return req


def poll_profile_trigger(journal=None) -> bool:
  """Worker-side poll (cached for ``PROFILE_POLL_SEC``, on the journal's
  flush cadence): when a fresh request names this worker (or no one in
  particular), start one bounded capture. True when one started."""
  j = journal
  if j is None:
    from . import journal as journal_mod

    j = journal_mod.get_active()
  if j is None:
    return False
  now = time.monotonic()
  checked_at, req = _PROFILE_STATE["cache"]
  if now - checked_at > PROFILE_POLL_SEC:
    req = read_profile_request(j.cloudpath)
    _PROFILE_STATE["cache"] = (now, req)
  if req is None:
    return False
  if req["id"] in _PROFILE_STATE["served"]:
    return False
  targets = req.get("workers")
  if targets and j.worker_id not in targets:
    return False
  _PROFILE_STATE["served"].add(req["id"])
  return start_capture(
    duration_sec=float(req.get("duration_sec") or 5.0),
    journal=j, request_id=req["id"],
  )


def start_capture(duration_sec: float, journal=None,
                  request_id: str = "manual",
                  logdir: Optional[str] = None) -> bool:
  """Run one bounded ``torch.profiler`` capture on a thread of its own
  (the worker keeps executing, so the capture sees its kernels) and
  upload the trace next to the journal. False when a capture is already
  running: a second request is refused, never queued.

  The thread starts and stops the profiler itself, and is not a daemon:
  interpreter shutdown joins it, so a draining worker's capture lands
  instead of dying with the process."""
  with _PROFILE_LOCK:
    if _PROFILE_STATE["active"]:
      return False
    _PROFILE_STATE["active"] = True

  def run():
    try:
      _capture_blocking(duration_sec, journal, request_id, logdir)
    finally:
      _PROFILE_STATE["active"] = False

  threading.Thread(target=run, daemon=False, name="igt-profile").start()
  return True


def _capture_blocking(duration_sec, journal, request_id, logdir):
  import tempfile

  base = logdir or knobs.get_str(PROFILE_DIR_ENV)
  if not base:
    base = tempfile.mkdtemp(prefix="igneous-profile-")
  worker = journal.worker_id if journal is not None else "local"
  capture_dir = os.path.join(base, f"{worker}-{request_id}")
  try:
    import torch.profiler

    prof = torch.profiler.profile(activities=profiler_activities())
    prof.__enter__()
  except Exception:
    metrics.incr("device.profile.start_failed")
    return
  try:
    time.sleep(max(float(duration_sec), 0.0))
  finally:
    try:
      prof.__exit__(None, None, None)
      os.makedirs(capture_dir, exist_ok=True)
      prof.export_chrome_trace(os.path.join(capture_dir, "trace.json"))
    except Exception:
      metrics.incr("device.profile.stop_failed")
      return
  metrics.incr("device.profile.captures")
  trace.event("device.profile", request_id=request_id, dir=capture_dir,
              duration_sec=float(duration_sec))
  if journal is not None:
    uploaded = _upload_artifacts(journal.cloudpath, capture_dir,
                                 f"{PROFILE_ARTIFACT_PREFIX}{worker}-{request_id}/")
    journal.write_records([{
      "kind": "span", "name": "device.profile", "ts": time.time(),
      "dur": float(duration_sec), "trace": trace.worker_trace_id(),
      "span": trace.new_id(), "parent": None,
      "request_id": request_id, "artifacts": uploaded,
    }], event="profile")


def _upload_artifacts(journal_path: str, local_dir: str, prefix: str) -> int:
  """Copy the capture's local files under ``<journal>/profiles/``;
  returns the files uploaded."""
  from ..storage import CloudFiles

  cf = CloudFiles(journal_path)
  n = 0
  for root, _dirs, files in os.walk(local_dir):
    for fname in files:
      full = os.path.join(root, fname)
      rel = os.path.relpath(full, local_dir)
      try:
        with open(full, "rb") as f:
          cf.put(prefix + rel.replace(os.sep, "/"), f.read(), compress=None)
        n += 1
      except Exception:
        metrics.incr("device.profile.upload_failed")
  return n


def list_profiles(journal_path: str) -> List[str]:
  from ..storage import CloudFiles

  try:
    return sorted(CloudFiles(journal_path).list(PROFILE_ARTIFACT_PREFIX))
  except Exception:
    return []


_SAMPLE_COUNT = [0]


def maybe_sample_profile() -> None:
  """Sampled capture: with ``IGNEOUS_PROFILE_DIR`` set and
  ``IGNEOUS_PROFILE_EVERY=N`` (N>0), every Nth dispatch (an outermost
  execute span) starts a short capture. Inert by default: two env reads
  a dispatch."""
  if not knobs.get_str(PROFILE_DIR_ENV):
    return
  every = knobs.get_int(PROFILE_EVERY_ENV)
  if every <= 0:
    return
  _SAMPLE_COUNT[0] += 1
  if _SAMPLE_COUNT[0] % every:
    return
  start_capture(
    duration_sec=knobs.get_float("IGNEOUS_PROFILE_SEC"),
    request_id=f"sample-{_SAMPLE_COUNT[0]}",
  )


# ---------------------------------------------------------------------------
# fleet read side — merged per-device table


def device_ledgers(records) -> Dict[str, dict]:
  """Latest cumulative device record per worker from merged journal
  records (raw segments or rollups — both carry them verbatim)."""
  out: Dict[str, dict] = {}
  for rec in records:
    if rec.get("kind") != "device":
      continue
    worker = rec.get("worker", "local")
    prev = out.get(worker)
    if prev is None or rec.get("ts", 0) >= prev.get("ts", 0):
      out[worker] = rec
  return out


def _fmt_bytes(n) -> str:
  if n is None:
    return "-"
  n = float(n)
  for unit in ("B", "KB", "MB", "GB", "TB"):
    if abs(n) < 1024 or unit == "TB":
      return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
    n /= 1024
  return f"{n:.1f}TB"


def render_devices(ledgers: Dict[str, dict]) -> List[str]:
  """The ``igneous fleet devices`` table: one row per worker x device
  with busy ratio + HBM, then per-kernel vox/s rows."""
  if not ledgers:
    return ["no device records in the journal (no worker dispatched "
            "device work, or the device plane is disabled)"]
  lines = [
    f"{'worker':<28}{'device':<14}{'busy_s':>9}{'busy%':>7}"
    f"{'disp':>6}{'recomp':>7}{'hbm_peak':>10}"
  ]
  for worker in sorted(ledgers):
    rec = ledgers[worker]
    devices = rec.get("devices") or {}
    hbm = rec.get("hbm") or {}
    ratio = rec.get("busy_ratio")
    for i, (dev, busy) in enumerate(sorted(devices.items())):
      peak = (hbm.get(dev) or {}).get("peak_bytes_in_use")
      pct = (
        f"{ratio * 100:.1f}%" if ratio is not None and i == 0 else ""
      )
      lines.append(
        f"{worker if i == 0 else '':<28}{dev:<14}{busy:>9.2f}"
        f"{pct:>7}"
        f"{rec.get('dispatches', 0) if i == 0 else '':>6}"
        f"{rec.get('recompiles', 0) if i == 0 else '':>7}"
        f"{_fmt_bytes(peak):>10}"
      )
    if not devices:
      lines.append(f"{worker:<28}{'-':<14}{0.0:>9.2f}{'':>7}"
                   f"{rec.get('dispatches', 0):>6}"
                   f"{rec.get('recompiles', 0):>7}{'-':>10}")
  # the port's records name each card; the JAX package's carry no kinds
  kinds = {}
  for rec in ledgers.values():
    kinds.update(rec.get("kinds") or {})
  if kinds:
    lines.append("cards: " + ", ".join(
      f"{dev} {name}" for dev, name in sorted(kinds.items())))
  lines.append("")
  lines.append(f"{'worker':<28}{'kernel':<22}{'execs':>6}{'exec_s':>9}"
               f"{'vox/s':>14}{'compiles':>9}")
  for worker in sorted(ledgers):
    for i, (kname, k) in enumerate(
      sorted((ledgers[worker].get("kernels") or {}).items())
    ):
      vox = k.get("vox_per_sec")
      lines.append(
        f"{worker if i == 0 else '':<28}{kname:<22}{k.get('executes', 0):>6}"
        f"{k.get('execute_s', 0.0):>9.3f}"
        f"{(f'{vox:,.0f}' if vox else '-'):>14}{k.get('compiles', 0):>9}"
      )
  fp = {"batched": 0, "host": 0}
  for rec in ledgers.values():
    for key in fp:
      fp[key] += int((rec.get("fastpath") or {}).get(key, 0))
  total = fp["batched"] + fp["host"]
  if total:
    lines.append("")
    lines.append(
      f"fast path: {fp['batched']}/{total} deliveries batched "
      f"({fp['batched'] / total:.1%}), {fp['host']} fell to host"
    )
  pad = sum(int(rec.get("pad_bytes") or 0) for rec in ledgers.values())
  real = sum(int(rec.get("real_bytes") or 0) for rec in ledgers.values())
  if real:
    lines.append(
      f"pad waste: {_fmt_bytes(pad)} padding over {_fmt_bytes(real)} real "
      f"bytes ({pad / real:.1%})"
    )
  cc = _cache_rollup(ledgers)
  if cc["hits"] or cc["misses"] or cc["puts"] or cc["corrupt"]:
    lines.append(
      f"compile cache: {cc['hits']} hits / {cc['misses']} misses, "
      f"{cc['puts']} puts, {cc['corrupt']} corrupt — "
      f"{cc['saved_s']:.1f}s compile time saved fleet-wide "
      f"({cc['fetch_s']:.1f}s spent fetching)"
    )
  return lines


def _cache_rollup(ledgers: Dict[str, dict]) -> dict:
  """Summed persistent compile-cache stats across every worker's latest
  ledger record — the fleet-wide compile-seconds-saved number."""
  cc = {"hits": 0, "misses": 0, "puts": 0, "corrupt": 0,
        "saved_s": 0.0, "fetch_s": 0.0}
  for rec in ledgers.values():
    src = rec.get("compile_cache") or {}
    for key in cc:
      cc[key] += type(cc[key])(src.get(key, 0) or 0)
  cc["saved_s"] = round(cc["saved_s"], 4)
  cc["fetch_s"] = round(cc["fetch_s"], 4)
  return cc


def fleet_summary(ledgers: Dict[str, dict]) -> Optional[dict]:
  """Compact cross-worker rollup for the health report / watch
  dashboard: fleet busy ratio (busiest device per worker, averaged),
  total recompiles/dispatches, worst HBM fraction."""
  if not ledgers:
    return None
  ratios = [
    r["busy_ratio"] for r in ledgers.values()
    if r.get("busy_ratio") is not None
  ]
  hbm_frac = None
  for rec in ledgers.values():
    for dev_stats in (rec.get("hbm") or {}).values():
      limit = dev_stats.get("bytes_limit")
      if limit:
        frac = dev_stats.get("peak_bytes_in_use", 0) / limit
        hbm_frac = frac if hbm_frac is None else max(hbm_frac, frac)
  fp = {"batched": 0, "host": 0}
  for rec in ledgers.values():
    for key in fp:
      fp[key] += int((rec.get("fastpath") or {}).get(key, 0))
  pad = sum(int(rec.get("pad_bytes") or 0) for rec in ledgers.values())
  real = sum(int(rec.get("real_bytes") or 0) for rec in ledgers.values())
  return {
    "workers": len(ledgers),
    "pad_waste_ratio": round(pad / real, 4) if real else None,
    "busy_ratio": (
      round(sum(ratios) / len(ratios), 4) if ratios else None
    ),
    "dispatches": sum(r.get("dispatches", 0) for r in ledgers.values()),
    "recompiles": sum(r.get("recompiles", 0) for r in ledgers.values()),
    "hbm_peak_frac": round(hbm_frac, 4) if hbm_frac is not None else None,
    "fastpath": fp,
    "compile_cache": _cache_rollup(ledgers),
  }


def report_json(ledgers: Dict[str, dict]) -> str:
  return json.dumps(
    {"summary": fleet_summary(ledgers), "workers": ledgers},
    indent=2,
  )
