"""The device ledger: kernel spans, library builds, transfers, padding and
memory of the port's device, for one process.

The port's own copy of ``igneous_tpu/observability/device.py`` (its
``DeviceLedger``, ``LEDGER``, ``reset`` and the span context managers),
trimmed to what the port's paths record. The journal, Prometheus, fleet
roll-ups, health anomalies and the profiler capture on request are not
ported (ROADMAP.md).

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
  current and peak) and ``torch.cuda.mem_get_info()``'s total, for every
  CUDA device the process has initialised, labelled ``cuda:N``; on the CPU
  ``sample_hbm`` returns ``{}`` and sets no gauge.

Counters and gauges go to ``igneous_tpu_torch.telemetry`` under the JAX
package's names: ``device.recompiles``, ``device.execute.s``,
``device.compile.s``, ``device.h2d.s``, ``device.d2h.s``,
``device.pad_waste_ratio``, ``device.fastpath.*``,
``device.hbm.bytes_in_use|peak_bytes|bytes_limit`` and
``device.compile_cache.hit|miss|put|corrupt|error``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from .. import telemetry

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
    telemetry.add(f"device.compile_cache.{_CACHE_COUNTER[event]}", 1)

  def record_compile(self, kernel: str, seconds: float) -> None:
    """One library build (an nvcc or g++ run) of ``seconds``."""
    with self.lock:
      k = self._kernel_locked(kernel)
      k["compiles"] += 1
      k["compile_s"] += float(seconds)
      self.recompiles += 1
    telemetry.add("device.recompiles", 1)
    telemetry.observe("device.compile.s", float(seconds))

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
    telemetry.observe("device.execute.s", seconds)

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
    telemetry.observe(f"device.{direction}.s", seconds)

  def record_fastpath(self, batched: int = 0, host: int = 0) -> None:
    """``batched`` deliveries rode a batched dispatch, ``host`` took the
    per-task path."""
    with self.lock:
      self.fastpath["batched"] += int(batched)
      self.fastpath["host"] += int(host)
      b, h = self.fastpath["batched"], self.fastpath["host"]
    if batched:
      telemetry.add("device.fastpath.batched", int(batched))
    if host:
      telemetry.add("device.fastpath.host", int(host))
    if b + h:
      telemetry.gauge_set("device.fastpath_ratio", b / (b + h))

  def record_pad_waste(self, padded_bytes: int = 0, real_bytes: int = 0) -> None:
    """``padded_bytes`` of filler (a dispatch group's fill, a page's slack)
    beside ``real_bytes`` of data; the gauge is the cumulative ratio."""
    with self.lock:
      self.pad_bytes += int(padded_bytes)
      self.real_bytes += int(real_bytes)
      p, r = self.pad_bytes, self.real_bytes
    if r:
      telemetry.gauge_set("device.pad_waste_ratio", p / r)

  def sample_hbm(self) -> Dict[str, dict]:
    """Allocated bytes (current, peak) and the memory's size of every CUDA
    device this process initialised; ``{}`` (and no gauge) without one."""
    if not torch.cuda.is_initialized():
      return {}
    out = {}
    for index in range(torch.cuda.device_count()):
      stats = torch.cuda.memory_stats(index)
      if not stats:
        continue
      out[f"cuda:{index}"] = {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.mem_get_info(index)[1]),
      }
    if out:
      with self.lock:
        for label, rec in out.items():
          prev = self.hbm.get(label) or {}
          rec["peak_bytes_in_use"] = max(rec["peak_bytes_in_use"],
                                         prev.get("peak_bytes_in_use", 0))
          self.hbm[label] = rec
      worst = max(out.values(), key=lambda r: r["peak_bytes_in_use"])
      telemetry.gauge_set("device.hbm.bytes_in_use", worst["bytes_in_use"])
      telemetry.gauge_max("device.hbm.peak_bytes", worst["peak_bytes_in_use"])
      telemetry.gauge_set("device.hbm.bytes_limit", worst["bytes_limit"])
    return out

  # -- CUDA event pairs -------------------------------------------------------

  def _queue(self, item) -> None:
    with self.lock:
      self._pending.append(item)
    self._resolve(wait=False)

  def _resolve(self, wait: bool) -> None:
    """Turn completed event pairs into records, oldest first; with
    ``wait``, wait on each pending end event (never on the device)."""
    while True:
      with self.lock:
        if not self._pending:
          return
        item = self._pending[0]
      kind, name, label, start, end, elements, nbytes, top = item
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
      return snap


LEDGER = DeviceLedger()

# open execute spans on this thread: the outermost one is a dispatch
_DEPTH = threading.local()


def reset() -> None:
  """A fresh ledger."""
  LEDGER.reset()


def _device(device) -> torch.device:
  if device is None:
    from ..device import get_device

    return get_device()
  return torch.device(device)


@contextlib.contextmanager
def _span(kind: str, name: str, device, elements: int, nbytes: int) -> Iterator[None]:
  dev = _device(device)
  depth = getattr(_DEPTH, "n", 0)
  top = depth == 0
  if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
    yield
    return
  if kind == "execute":
    _DEPTH.n = depth + 1
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
      return
    label = _label(dev)
    LEDGER._anchor(int(label.split(":")[1]))
    stream = torch.cuda.current_stream(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    yield
    end.record(torch.cuda.current_stream(dev))
    LEDGER._queue((kind, name, label, start, end, elements, nbytes, top))
  finally:
    if kind == "execute":
      _DEPTH.n = depth


def execute_span(kernel: str, elements: int = 0, nbytes: int = 0, device=None,
                 signature=None):
  """Account the device work launched inside the context to ``kernel`` on
  ``device`` (default: the port's device). ``signature`` (shapes, dtypes)
  feeds ``note_signature``. On the card it records CUDA events and never
  synchronises; the caller need not wait for the work."""
  if signature is not None:
    LEDGER.note_signature(kernel, signature)
  return _span("execute", kernel, device, elements, nbytes)


def transfer_span(direction: str, nbytes: int, device=None):
  """Account one host<->device copy (``direction`` "h2d" or "d2h") of
  ``nbytes`` on ``device``."""
  if direction not in ("h2d", "d2h"):
    raise ValueError(f"direction must be h2d or d2h, not {direction!r}")
  return _span(direction, "", device, 0, nbytes)


@contextlib.contextmanager
def compile_span(kernel: str) -> Iterator[None]:
  """Time one library build on the host clock and charge it to the
  ledger."""
  t0 = time.perf_counter()
  try:
    yield
  finally:
    LEDGER.record_compile(kernel, time.perf_counter() - t0)


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
