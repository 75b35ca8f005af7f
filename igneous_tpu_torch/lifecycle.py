"""Worker lifecycle: graceful drain on preemption.

The port's own copy of ``igneous_tpu/lifecycle.py``. A drain request (a
signal, a sentinel file, or the preemption metadata endpoint) sets a
``StopFlag`` that the poll loops, the lease batcher, ``LocalTaskQueue``
and the staged pipeline check between tasks and in every blocking stage
wait: the task in flight finishes, leased batch members not started go
back to the queue, and ``execute`` exits ``EXIT_PREEMPTED`` (83), which a
scheduler tells apart from a failure.

The counterpart fencing, a worker presumed dead that wakes and tries to
complete a task the queue re-issued, lives in the queue backends
(delete/renew/nack refuse stale tokens with ``zombie.*`` counters).

``StopFlag.set`` also marks the active journal dirty, so the poll loop's
next flush writes the last span batch before the worker exits, and sets
the ``worker.draining`` gauge that tells the health plane a draining
worker from a stalled one.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from .secrets import env_number

# distinct from any Python or argparse failure code, so a pod spec can map
# it: preempted workers restart quietly, real failures alarm
EXIT_PREEMPTED = 83


class StopFlag:
  """Thread-safe drain request; records the first reason it was set."""

  def __init__(self):
    self._event = threading.Event()
    self._lock = threading.Lock()
    self.reason: Optional[str] = None  # guarded by self._lock

  def set(self, reason: str = "stop"):
    with self._lock:
      if self.reason is None:
        self.reason = reason
    self._event.set()
    # signal-handler safe: only an event and a lock-free gauge write
    try:
      from .observability import journal, metrics

      journal.request_flush()
      metrics.gauge_set_async_safe("worker.draining", 1.0)
    except Exception:
      pass

  def is_set(self) -> bool:
    return self._event.is_set()

  def wait(self, timeout: Optional[float] = None) -> bool:
    return self._event.wait(timeout)


def install_signal_handlers(flag: StopFlag, signals=None):
  """Route SIGTERM and SIGINT into ``flag`` (a graceful drain instead of
  a death mid-lease). Returns a ``restore()`` that puts the previous
  handlers back. Off the main thread it installs nothing (only the main
  thread may set handlers)."""
  import signal as signal_mod

  if signals is None:
    signals = (signal_mod.SIGTERM, signal_mod.SIGINT)
  previous = {}

  def handler(signum, frame):
    del frame
    try:
      name = signal_mod.Signals(signum).name
    except ValueError:
      name = f"signal-{signum}"
    flag.set(name)

  for sig in signals:
    try:
      previous[sig] = signal_mod.signal(sig, handler)
    except (ValueError, OSError):  # not the main thread, or unsupported
      continue

  def restore():
    for sig, prev in previous.items():
      try:
        signal_mod.signal(sig, prev)
      except (ValueError, OSError):
        pass

  return restore


class PreemptionWatcher:
  """Daemon thread that sets ``flag`` when preemption is announced.

  Two sources, both optional (without either the watcher is inert;
  signals still work):

  * a sentinel file (``sentinel=`` or ``IGNEOUS_PREEMPT_SENTINEL``): drain
    once the path exists;
  * a metadata endpoint (``metadata_url=`` or ``IGNEOUS_PREEMPT_URL``),
    read with the ``Metadata-Flavor: Google`` header: a body of TRUE
    means the VM is being preempted. Never on by default.

  Poll cadence: ``IGNEOUS_PREEMPT_POLL_SEC`` (default 1 s); the first
  check runs at start.
  """

  def __init__(self, flag: StopFlag, sentinel: Optional[str] = None,
               metadata_url: Optional[str] = None,
               interval: Optional[float] = None):
    self.flag = flag
    self.sentinel = (
      sentinel if sentinel is not None
      else os.environ.get("IGNEOUS_PREEMPT_SENTINEL") or None
    )
    self.metadata_url = (
      metadata_url if metadata_url is not None
      else os.environ.get("IGNEOUS_PREEMPT_URL") or None
    )
    if interval is None:
      interval = env_number("IGNEOUS_PREEMPT_POLL_SEC", 1.0, float)
    self.interval = float(interval)
    self._stop = threading.Event()
    self._thread: Optional[threading.Thread] = None

  def check(self) -> Optional[str]:
    """One poll; returns the drain reason or None."""
    if self.sentinel and os.path.exists(self.sentinel):
      return "sentinel"
    if self.metadata_url and self._metadata_preempted():
      return "preempted"
    return None

  def _metadata_preempted(self) -> bool:
    import urllib.request

    try:
      req = urllib.request.Request(
        self.metadata_url, headers={"Metadata-Flavor": "Google"}
      )
      with urllib.request.urlopen(req, timeout=2) as resp:
        return resp.read().strip().upper() == b"TRUE"
    except Exception:
      return False  # a metadata hiccup must never kill a healthy worker

  def _run(self):
    while True:
      reason = self.check()
      if reason is not None:
        self.flag.set(reason)
        return
      if self._stop.wait(self.interval):
        return

  def start(self):
    if self._thread is not None or not (self.sentinel or self.metadata_url):
      return self
    self._thread = threading.Thread(
      target=self._run, daemon=True, name="preemption-watcher"
    )
    self._thread.start()
    return self

  def stop(self):
    self._stop.set()
    if self._thread is not None:
      self._thread.join(timeout=5.0)
      self._thread = None

  __enter__ = start

  def __exit__(self, *exc):
    self.stop()
    return False
