"""The process-wide cache of decoded chunks.

The port's own copy of ``igneous_tpu/chunk_cache.py``. A chunk read again
(overlapping cutouts, a prefetch and a later read of the same layer) costs
a digest of its stored bytes instead of an inflate and a chunk decode.

Keying: entries are keyed by (layer path, mip, chunk bbox, blake2b-128 of
the stored bytes). The digest is taken over the bytes as fetched, so a
chunk that a writer has overwritten never matches a stale entry: a hit is
always equal to decoding what storage holds now. ``invalidate(path,
mip)``, which ``Volume.upload`` and the pipeline runner's write joins
call, only frees doomed entries early; it is not what keeps reads right.

Budget, in bytes of decoded voxels:

  IGNEOUS_CHUNK_CACHE      on|off|auto   master switch (auto = on)
  IGNEOUS_CHUNK_CACHE_MB   float         budget (default: the pipeline's
                                         stage budget / 8)

Entries are read-only; readers copy voxels into their own cutouts. A chunk
that fails to decode is never stored. Counters: ``chunk_cache.hits``,
``misses``, ``bytes_saved``, ``evicted``, ``invalidated``; gauge
``chunk_cache.bytes``.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict
from typing import Iterable, Optional, Tuple

import numpy as np

from . import telemetry


def enabled() -> bool:
  val = os.environ.get("IGNEOUS_CHUNK_CACHE", "").strip().lower()
  return val not in ("0", "off", "false", "no")


def budget_bytes() -> int:
  try:
    mb = float(os.environ.get("IGNEOUS_CHUNK_CACHE_MB", "") or 0)
  except ValueError:
    mb = 0.0
  if mb:
    return max(int(mb * 1e6), 1)
  from .pipeline import config

  return max(config.memory_budget_bytes() // 8, 1)


def digest(data: bytes) -> bytes:
  """Digest of the stored bytes: the part of the key that keeps readers
  right beside concurrent writers without coordination."""
  return hashlib.blake2b(data, digest_size=16).digest()


class ChunkDecodeCache:
  """Byte-budgeted LRU of decoded chunks, keyed on stored-byte digests."""

  def __init__(self, budget: Optional[int] = None):
    self._budget = budget
    self._lock = threading.Lock()
    self._entries: OrderedDict = OrderedDict()  # guarded by self._lock
    self._by_layer: dict = {}  # (path, mip) -> keys; guarded by self._lock
    self._bytes = 0  # guarded by self._lock

  @property
  def budget(self) -> int:
    return self._budget if self._budget is not None else budget_bytes()

  def make_key(self, path: str, mip: int, bbox_key, stored: bytes) -> tuple:
    # the same normalisation as the metadata's cloudpath, so task paths
    # and volume paths address the same entries
    return (path.rstrip("/"), int(mip), bbox_key, digest(stored))

  def get(self, key: tuple) -> Optional[np.ndarray]:
    with self._lock:
      arr = self._entries.get(key)
      if arr is None:
        telemetry.incr("chunk_cache.misses", 1)
        return None
      self._entries.move_to_end(key)
    telemetry.incr("chunk_cache.hits", 1)
    telemetry.incr("chunk_cache.bytes_saved", int(arr.nbytes))
    return arr

  def put(self, key: tuple, arr: np.ndarray) -> np.ndarray:
    """Insert; returns the read-only view that was cached, which callers
    hand out so no writable alias of an entry escapes."""
    nbytes = int(arr.nbytes)
    arr = arr.view()
    arr.flags.writeable = False
    if nbytes > self.budget:
      return arr  # one oversized chunk must not wipe the working set
    with self._lock:
      old = self._entries.pop(key, None)
      if old is not None:
        self._bytes -= int(old.nbytes)
      self._entries[key] = arr
      self._by_layer.setdefault((key[0], key[1]), set()).add(key)
      self._bytes += nbytes
      while self._bytes > self.budget and self._entries:
        self._evict_oldest_locked()
      telemetry.gauge_max("chunk_cache.bytes", self._bytes)
    return arr

  def _evict_oldest_locked(self) -> None:
    old_key, old_arr = self._entries.popitem(last=False)
    self._bytes -= int(old_arr.nbytes)
    layer = self._by_layer.get((old_key[0], old_key[1]))
    if layer is not None:
      layer.discard(old_key)
      if not layer:
        self._by_layer.pop((old_key[0], old_key[1]), None)
    telemetry.incr("chunk_cache.evicted", 1)

  def invalidate(self, path: str, mip: Optional[int] = None) -> int:
    """Drop every entry of (path, mip), or of every mip when ``mip`` is
    None. Returns the number dropped."""
    path = path.rstrip("/")
    with self._lock:
      if mip is None:
        layers = [k for k in self._by_layer if k[0] == path]
      else:
        layers = [(path, int(mip))]
      dropped = 0
      for layer in layers:
        for key in self._by_layer.pop(layer, ()):
          arr = self._entries.pop(key, None)
          if arr is not None:
            self._bytes -= int(arr.nbytes)
            dropped += 1
    if dropped:
      telemetry.incr("chunk_cache.invalidated", dropped)
    return dropped

  def clear(self) -> None:
    with self._lock:
      self._entries.clear()
      self._by_layer.clear()
      self._bytes = 0

  @property
  def nbytes(self) -> int:
    with self._lock:
      return self._bytes

  def __len__(self) -> int:
    with self._lock:
      return len(self._entries)


_SHARED: Optional[ChunkDecodeCache] = None
_SHARED_LOCK = threading.Lock()

# callers besides the decode cache that must hear "this (path, mip) was
# rewritten"; invalidate() and invalidate_writes() call every hook
_INVALIDATION_HOOKS: list = []
_HOOKS_LOCK = threading.Lock()


def register_invalidation_hook(fn) -> None:
  """Call ``fn(path, mip_or_None)`` on every invalidation. Hooks must be
  fast; a hook that raises is counted (``chunk_cache.hook_failed``) and
  never stops the invalidation."""
  with _HOOKS_LOCK:
    if fn not in _INVALIDATION_HOOKS:
      _INVALIDATION_HOOKS.append(fn)


def unregister_invalidation_hook(fn) -> None:
  with _HOOKS_LOCK:
    if fn in _INVALIDATION_HOOKS:
      _INVALIDATION_HOOKS.remove(fn)


def _notify_hooks(path: str, mip: Optional[int]) -> None:
  with _HOOKS_LOCK:
    hooks = list(_INVALIDATION_HOOKS)
  for fn in hooks:
    try:
      fn(path, mip)
    except Exception:  # noqa: BLE001 - counted, by the hook contract
      telemetry.incr("chunk_cache.hook_failed", 1)


def shared_cache() -> ChunkDecodeCache:
  global _SHARED
  with _SHARED_LOCK:
    if _SHARED is None:
      _SHARED = ChunkDecodeCache()
    return _SHARED


def lookup(path: str, mip: int, bbox_key, stored: bytes):
  """(key, decoded chunk or None). The key comes back either way, so a
  miss can ``store`` its decode under the digest already taken."""
  cache = shared_cache()
  key = cache.make_key(path, mip, bbox_key, stored)
  return key, cache.get(key)


def store(key: tuple, arr: np.ndarray) -> np.ndarray:
  return shared_cache().put(key, arr)


def invalidate(path: str, mip: Optional[int] = None) -> int:
  _notify_hooks(path, mip)
  if _SHARED is None:
    return 0
  return _SHARED.invalidate(path, mip)


def invalidate_writes(writes: Iterable[Tuple[str, int]]) -> None:
  """Invalidate a stage plan's set of (layer path, mip) writes."""
  for path, mip in writes:
    invalidate(path, mip)


def clear() -> None:
  if _SHARED is not None:
    _SHARED.clear()
