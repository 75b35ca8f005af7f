"""Trace context + span recording — the identity layer of observability.

Every task minted by a factory carries a ``trace_id`` (and optionally a
``parent_span_id``) in its queue payload, so enqueue → lease → execute →
retry → DLQ is ONE trace no matter how many workers touch it. Spans are
wall-clock intervals attributed to that trace: the task execution itself,
each pipeline stage (download/compute/encode/upload — recorded through
the existing ``telemetry.observe`` sites), storage ops, and lease-batcher
rounds.

Cost model: span records are plain dicts appended to per-thread buffers
(one tiny uncontended lock per thread — no global lock on the hot path),
drained in batches by the journal. ``IGNEOUS_TRACE_SAMPLE`` (default 1.0)
gates allocation: at 0 no trace objects exist at all (task payloads carry
no trace, every span call is a thread-local None check), between 0 and 1
trace identity is always minted (lineage stays intact) but only the
sampled fraction records spans.

The port's own copy of ``igneous_tpu/observability/trace.py``: the same
record shapes and payload fields, so one trace runs through workers of
either package.
"""

from __future__ import annotations

import contextlib
import os
import random
import threading
import time
import uuid
from typing import Iterator, Optional

from ..analysis import knobs

SAMPLE_ENV = "IGNEOUS_TRACE_SAMPLE"

# per-thread span buffers are bounded: a worker that never flushes (no
# journal configured) must not grow without limit. Drops are counted.
MAX_SPANS_PER_THREAD = 50_000

_TLS = threading.local()
_BUFFERS: list = []  # _ThreadBuffer registry (drained by the journal)
_BUFFERS_LOCK = threading.Lock()
_DROPPED = [0]

# one trace id per process for worker-scoped spans (lease rounds, poll
# idle) that belong to no single task
_WORKER_TRACE = uuid.uuid4().hex[:16]

# span and trace ids: 64 random bits from a generator of this process,
# seeded from the OS once (again in a forked child). The JAX package draws
# each id from uuid4, one getrandom syscall an id: on the card's host that
# syscall cost 2.6-21 us, more than the rest of a span.
_IDS = random.Random()
if hasattr(os, "register_at_fork"):
  os.register_at_fork(after_in_child=_IDS.seed)


def sample_rate() -> float:
  return knobs.get_float(SAMPLE_ENV)


def tracing_enabled() -> bool:
  return sample_rate() > 0.0


def new_id() -> str:
  return f"{_IDS.getrandbits(64):016x}"


def worker_trace_id() -> str:
  return _WORKER_TRACE


def mint(parent_span_id: Optional[str] = None) -> Optional[dict]:
  """Trace payload for a freshly created task (embedded in the queue
  payload under ``"trace"``). None when tracing is off entirely — that is
  the sampling=0 'no span allocation' contract."""
  rate = sample_rate()
  if rate <= 0.0:
    return None
  t = {"trace_id": new_id(), "ts": time.time()}
  if parent_span_id:
    t["parent_span_id"] = parent_span_id
  if rate < 1.0 and random.random() >= rate:
    t["sampled"] = False
  return t


class SpanContext:
  """The thread-local active node of a trace: new spans parent to
  ``span_id``. Activation installs a per-thread COPY (contexts are
  mutated for nesting, and one task's stages run on many threads)."""

  __slots__ = ("trace_id", "span_id", "sampled")

  def __init__(self, trace_id: str, span_id: Optional[str], sampled: bool):
    self.trace_id = trace_id
    self.span_id = span_id
    self.sampled = sampled

  def copy(self) -> "SpanContext":
    return SpanContext(self.trace_id, self.span_id, self.sampled)


def current() -> Optional[SpanContext]:
  return getattr(_TLS, "ctx", None)


def active() -> bool:
  ctx = getattr(_TLS, "ctx", None)
  return ctx is not None and ctx.sampled


class _ThreadBuffer:
  __slots__ = ("lock", "items")

  def __init__(self):
    self.lock = threading.Lock()
    self.items: list = []


def _buffer() -> _ThreadBuffer:
  buf = getattr(_TLS, "buf", None)
  if buf is None:
    buf = _ThreadBuffer()
    _TLS.buf = buf
    with _BUFFERS_LOCK:
      _BUFFERS.append(buf)
  return buf


def _record(rec: dict) -> None:
  buf = _buffer()
  with buf.lock:  # per-thread, uncontended except during a drain
    if len(buf.items) >= MAX_SPANS_PER_THREAD:
      _DROPPED[0] += 1
      return
    buf.items.append(rec)


def drain_spans() -> list:
  """Collect every thread's pending span records (journal flush path)."""
  out = []
  with _BUFFERS_LOCK:
    bufs = list(_BUFFERS)
  for buf in bufs:
    with buf.lock:
      if buf.items:
        out.extend(buf.items)
        buf.items = []
  return out


def dropped_spans() -> int:
  return _DROPPED[0]


def pending_spans() -> int:
  """Spans buffered but not yet journaled (Prometheus self-health:
  a growing backlog means the flush path is stuck)."""
  with _BUFFERS_LOCK:
    bufs = list(_BUFFERS)
  return sum(len(b.items) for b in bufs)


def reset() -> None:
  """Testing hook: drop all pending spans and the drop tally."""
  drain_spans()
  _DROPPED[0] = 0


@contextlib.contextmanager
def activate(ctx: Optional[SpanContext]) -> Iterator[Optional[SpanContext]]:
  """Install ``ctx`` (a copy) as this thread's active trace context."""
  prev = getattr(_TLS, "ctx", None)
  _TLS.ctx = ctx.copy() if ctx is not None else None
  try:
    yield _TLS.ctx
  finally:
    _TLS.ctx = prev


@contextlib.contextmanager
def span(name: str, **attrs) -> Iterator[Optional[str]]:
  """Record a wall-clock span under the active context (no-op when no
  sampled context is active). Nested spans parent to this one."""
  ctx = getattr(_TLS, "ctx", None)
  if ctx is None or not ctx.sampled:
    yield None
    return
  span_id = new_id()
  parent = ctx.span_id
  ctx.span_id = span_id
  ts = time.time()
  t0 = time.perf_counter()
  error = None
  try:
    yield span_id
  except BaseException as e:
    error = type(e).__name__
    raise
  finally:
    ctx.span_id = parent
    rec = {
      "trace": ctx.trace_id, "span": span_id, "parent": parent,
      "name": name, "ts": ts,
      "dur": time.perf_counter() - t0,
    }
    if error:
      rec["error"] = error
    if attrs:
      rec.update(attrs)
    _record(rec)


def maybe_span(name: str, **attrs):
  """``span`` with a fast inactive path (storage hot loops)."""
  ctx = getattr(_TLS, "ctx", None)
  if ctx is None or not ctx.sampled:
    return contextlib.nullcontext()
  return span(name, **attrs)


def record_span(name: str, seconds: float, **attrs) -> None:
  """Record a pre-measured span ending NOW (the telemetry.observe hook:
  observe sites measure duration themselves)."""
  ctx = getattr(_TLS, "ctx", None)
  if ctx is None or not ctx.sampled:
    return
  rec = {
    "trace": ctx.trace_id, "span": new_id(), "parent": ctx.span_id,
    "name": name, "ts": time.time() - seconds, "dur": float(seconds),
  }
  if attrs:
    rec.update(attrs)
  _record(rec)


def event(name: str, **attrs) -> None:
  """Zero-duration marker under the active context (chaos faults,
  lifecycle edges)."""
  record_span(name, 0.0, **attrs)


def record_at(name: str, ts: float, dur: float, trace_id: str,
              span_id: Optional[str] = None, parent: Optional[str] = None,
              **attrs) -> Optional[str]:
  """Record a span with fully explicit identity (trace, span, parent).

  For callers whose request handlers interleave on ONE event-loop
  thread (the JAX package's serve tier), where the thread-local context
  of :func:`span` cannot carry per-request identity. Returns the span id recorded (minted when
  ``span_id`` is None), or None when tracing is off."""
  if not tracing_enabled():
    return None
  sid = span_id or new_id()
  rec = {
    "trace": trace_id, "span": sid, "parent": parent,
    "name": name, "ts": float(ts), "dur": float(dur),
  }
  if attrs:
    rec.update(attrs)
  _record(rec)
  return sid


def record_root(name: str, ts: float, dur: float,
                trace_id: Optional[str] = None, **attrs) -> None:
  """Record a span with explicit timing under an explicit trace
  (worker-scoped spans like lease rounds; no thread context needed)."""
  if not tracing_enabled():
    return
  rec = {
    "trace": trace_id or _WORKER_TRACE, "span": new_id(), "parent": None,
    "name": name, "ts": float(ts), "dur": float(dur),
  }
  if attrs:
    rec.update(attrs)
  _record(rec)


# -- task-level plumbing ------------------------------------------------------


def trace_of(task) -> Optional[dict]:
  return getattr(task, "_trace", None)


def _exec_root(tinfo: dict) -> str:
  """The root span id of this delivery's execution; stage spans recorded
  through task_context() parent to it. Minted lazily per deserialized
  task instance — a redelivery is a fresh instance, hence a fresh root."""
  sid = tinfo.get("exec_span_id")
  if not sid:
    sid = new_id()
    tinfo["exec_span_id"] = sid
  return sid


def task_context(task) -> Optional[SpanContext]:
  """A SpanContext rooted at the task's execution span, or None when the
  task carries no trace (or tracing is off). Activate it on whatever
  thread runs one of the task's stages."""
  tinfo = trace_of(task)
  if tinfo is None or not tracing_enabled():
    return None
  return SpanContext(
    tinfo["trace_id"], _exec_root(tinfo), bool(tinfo.get("sampled", True))
  )


def record_for_task(task, name: str, ts: float, dur: float, **attrs) -> None:
  """Record a span attributed to ``task``'s trace without needing an
  active thread context (e.g. the pipelined runner's admit→join span)."""
  tinfo = trace_of(task)
  if tinfo is None or not tinfo.get("sampled", True) or not tracing_enabled():
    return
  rec = {
    "trace": tinfo["trace_id"], "span": _exec_root(tinfo),
    "parent": tinfo.get("parent_span_id"),
    "name": name, "ts": float(ts), "dur": float(dur),
    "task": type(task).__name__,
  }
  if attrs:
    rec.update(attrs)
  _record(rec)


@contextlib.contextmanager
def task_span(task, attempt=None, **attrs) -> Iterator[Optional[SpanContext]]:
  """Wrap one delivery's execution: records the enqueue-wait span (mint →
  now; on attempt N this measures the retry latency too) and the task
  span itself, with nested stage spans parenting to it."""
  tinfo = trace_of(task)
  if tinfo is None or not tracing_enabled():
    yield None
    return
  ctx = task_context(task)
  if ctx is not None and ctx.sampled and tinfo.get("ts"):
    wait = max(time.time() - float(tinfo["ts"]), 0.0)
    rec = {
      "trace": ctx.trace_id, "span": new_id(), "parent": ctx.span_id,
      "name": "queue.wait", "ts": float(tinfo["ts"]), "dur": wait,
    }
    if attempt is not None:
      rec["attempt"] = attempt
    _record(rec)
  ts = time.time()
  t0 = time.perf_counter()
  error = None
  try:
    with activate(ctx) as live:
      yield live
  except BaseException as e:
    error = type(e).__name__
    raise
  finally:
    if ctx is not None and ctx.sampled:
      rec = {
        "trace": ctx.trace_id, "span": ctx.span_id,
        "parent": tinfo.get("parent_span_id"),
        "name": "task", "ts": ts, "dur": time.perf_counter() - t0,
        "task": type(task).__name__,
      }
      if attempt is not None:
        rec["attempt"] = attempt
      if error:
        rec["error"] = error
      extra = getattr(task, "trace_attrs", None)
      if extra is not None:
        try:
          rec.update(extra())
        except Exception:
          pass
      if attrs:
        rec.update(attrs)
      _record(rec)
