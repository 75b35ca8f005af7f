"""The serving tier's multi-tier cache of stored bytes.

The port's own copy of ``igneous_tpu/serve/cache.py``. It caches wire
bytes (what storage holds: codec-encoded, maybe gzip-compressed), not
decoded voxels, so the hot path never touches a codec and hands the
stored bytes to the client with the matching ``Content-Encoding``:

  RAM   a byte-budgeted LRU of (layer, key) -> (bytes, method, etag).
  SSD   a spill directory in the ``CloudFiles`` file layout
        (``<root>/<layer-slug>/<key><compression-ext>``): entries survive
        restarts and round-trip byte for byte, and dropping a mip is one
        subtree walk.
  CDN   not code here: every response carries a strong ETag of the stored
        bytes and a ``Cache-Control``, so any HTTP cache can front the
        fleet.

The ETag is ``"<blake2b-128 hex of the stored bytes>"`` and the slug and
spill layout are the JAX package's: an object served by either package
carries the same ETag, and either package's server re-serves the other's
spill directory.

Counters per tier: ``serve.cache.{ram,ssd}.{hits,misses,evicted,
invalidated}``; byte gauges ``serve.cache.{ram,ssd}.bytes``.
"""

from __future__ import annotations

import hashlib
import os
import re
import threading
from collections import OrderedDict
from typing import Optional, Tuple

from .. import secrets
from ..observability import metrics
from ..storage import (
  COMPRESSION_EXTS,
  decompress_bytes,
  method_for_ext,
  stored_exts,
)


def strong_etag(data: bytes) -> str:
  return '"' + hashlib.blake2b(data, digest_size=16).hexdigest() + '"'


def layer_slug(cloudpath: str) -> str:
  """Filesystem-safe, collision-free directory name for a layer path."""
  base = re.sub(r"[^A-Za-z0-9._-]+", "_", cloudpath.rstrip("/"))[-48:]
  h = hashlib.blake2b(
    cloudpath.rstrip("/").encode("utf8"), digest_size=8
  ).hexdigest()
  return f"{base}-{h}"


class Entry:
  __slots__ = ("data", "method", "etag")

  def __init__(self, data: bytes, method: Optional[str], etag: str):
    self.data = data
    self.method = method  # wire compression the bytes carry (None = raw)
    self.etag = etag


class RamTier:
  """Byte-budgeted LRU of stored-bytes entries."""

  def __init__(self, budget_bytes: int):
    self.budget = int(budget_bytes)
    self._lock = threading.Lock()
    self._entries: "OrderedDict[tuple, Entry]" = OrderedDict()  # guarded-by: self._lock
    self._bytes = 0  # guarded-by: self._lock

  def get(self, key: tuple) -> Optional[Entry]:
    with self._lock:
      e = self._entries.get(key)
      if e is None:
        return None
      self._entries.move_to_end(key)
      return e

  def put(self, key: tuple, entry: Entry) -> None:
    n = len(entry.data)
    if self.budget <= 0 or n > self.budget:
      return
    with self._lock:
      old = self._entries.pop(key, None)
      if old is not None:
        self._bytes -= len(old.data)
      self._entries[key] = entry
      self._bytes += n
      while self._bytes > self.budget and self._entries:
        _, ev = self._entries.popitem(last=False)
        self._bytes -= len(ev.data)
        metrics.incr("serve.cache.ram.evicted")
      metrics.gauge_set("serve.cache.ram.bytes", self._bytes)

  def invalidate(self, layer: str, prefix: Optional[str] = None) -> int:
    with self._lock:
      doomed = [
        k for k in self._entries
        if k[0] == layer and (prefix is None or k[1].startswith(prefix))
      ]
      for k in doomed:
        self._bytes -= len(self._entries.pop(k).data)
      metrics.gauge_set("serve.cache.ram.bytes", self._bytes)
    if doomed:
      metrics.incr("serve.cache.ram.invalidated", len(doomed))
    return len(doomed)

  @property
  def nbytes(self) -> int:
    with self._lock:
      return self._bytes

  def __len__(self) -> int:
    with self._lock:
      return len(self._entries)


class SsdTier:
  """Local-disk spill mirroring the CloudFiles layout.

  Files live at ``<root>/<layer-slug>/<key><ext>`` where ``ext`` encodes
  the wire method — exactly how the origin stores them, so a round trip
  through the spill is byte identity by construction and a fresh server
  pointed at the same directory re-serves (and re-derives the same
  ETags for) everything a predecessor spilled."""

  def __init__(self, root: str, budget_bytes: int):
    self.root = root
    self.budget = int(budget_bytes)
    self._lock = threading.Lock()
    # access-ordered index: relpath -> size (seeded from disk by mtime so
    # restart eviction order approximates the predecessor's LRU)
    self._index: "OrderedDict[str, int]" = OrderedDict()  # guarded-by: self._lock
    # relpath -> expected ETag for entries written (or verified once)
    # by THIS process; restart-seeded entries start absent here
    self._etags: dict = {}  # guarded-by: self._lock
    self._bytes = 0  # guarded-by: self._lock
    os.makedirs(root, exist_ok=True)
    self._seed_index()

  def _seed_index(self) -> None:
    found = []
    for dirpath, _dirs, files in os.walk(self.root):
      for fname in files:
        if ".tmp." in fname:
          continue
        full = os.path.join(dirpath, fname)
        try:
          st = os.stat(full)
        except OSError:
          continue
        found.append((st.st_mtime, os.path.relpath(full, self.root), st.st_size))
    found.sort()
    with self._lock:
      for _mt, rel, size in found:
        self._index[rel] = size
        self._bytes += size
      metrics.gauge_set("serve.cache.ssd.bytes", self._bytes)

  def _relpath(self, key: tuple, ext: str) -> str:
    return os.path.join(layer_slug(key[0]), key[1] + ext)

  def get(self, key: tuple) -> Optional[Entry]:
    for ext in stored_exts():
      rel = self._relpath(key, ext)
      with self._lock:
        known = rel in self._index
        expected = self._etags.get(rel)
      if not known:
        continue
      try:
        with open(os.path.join(self.root, rel), "rb") as f:
          data = f.read()
      except OSError:
        with self._lock:
          size = self._index.pop(rel, None)
          self._etags.pop(rel, None)
          if size is not None:
            self._bytes -= size
        continue
      etag = strong_etag(data)
      if not self._promotable(ext, data, etag, expected):
        # never serve (or promote to RAM) bytes that fail verification:
        # evict and fall through to an origin refetch
        self._evict_corrupt(rel)
        continue
      with self._lock:
        self._index.move_to_end(rel)
        self._etags[rel] = etag
      return Entry(data, method_for_ext(ext), etag)
    return None

  def _promotable(self, ext: str, data: bytes, etag: str,
                  expected: Optional[str]) -> bool:
    """The integrity gate on SSD -> RAM promotion. An entry this process
    wrote has a recorded ETag, and any drift on disk is a mismatch. An
    entry seeded by a restart's index scan is older than the process: its
    wire compression is verified once before its first promotion; a raw
    entry carries nothing to check, so its ETag is recorded as it is."""
    if expected is not None:
      return etag == expected
    if not secrets.get_bool("IGNEOUS_INTEGRITY_SSD_VERIFY"):
      return True
    method = method_for_ext(ext)
    if method is None:
      return True
    try:
      decompress_bytes(data, method)
    except Exception:
      return False
    return True

  def _evict_corrupt(self, rel: str) -> None:
    metrics.incr("serve.cache.ssd.verify_failed")
    metrics.incr("integrity.corrupt_reads")
    with self._lock:
      size = self._index.pop(rel, None)
      self._etags.pop(rel, None)
      if size is not None:
        self._bytes -= size
      metrics.gauge_set("serve.cache.ssd.bytes", self._bytes)
    try:
      os.remove(os.path.join(self.root, rel))
    except OSError:
      pass

  def put(self, key: tuple, entry: Entry) -> None:
    n = len(entry.data)
    if self.budget <= 0 or n > self.budget:
      return
    rel = self._relpath(key, COMPRESSION_EXTS[entry.method])
    full = os.path.join(self.root, rel)
    os.makedirs(os.path.dirname(full), exist_ok=True)
    tmp = f"{full}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
      with open(tmp, "wb") as f:
        f.write(entry.data)
      os.replace(tmp, full)
    except OSError:
      try:
        os.remove(tmp)
      except OSError:
        pass
      return
    with self._lock:
      old = self._index.pop(rel, None)
      if old is not None:
        self._bytes -= old
      self._index[rel] = n
      self._etags[rel] = entry.etag
      self._bytes += n
      doomed = []
      while self._bytes > self.budget and self._index:
        old_rel, old_size = self._index.popitem(last=False)
        self._etags.pop(old_rel, None)
        self._bytes -= old_size
        doomed.append(old_rel)
      metrics.gauge_set("serve.cache.ssd.bytes", self._bytes)
    for old_rel in doomed:
      try:
        os.remove(os.path.join(self.root, old_rel))
      except OSError:
        pass
      metrics.incr("serve.cache.ssd.evicted")

  def invalidate(self, layer: str, prefix: Optional[str] = None) -> int:
    slug = layer_slug(layer)
    want = os.path.join(slug, prefix) if prefix else slug + os.sep
    with self._lock:
      doomed = [
        rel for rel in self._index
        if rel.startswith(want) or (prefix is None and rel.startswith(slug))
      ]
      for rel in doomed:
        self._bytes -= self._index.pop(rel)
        self._etags.pop(rel, None)
      metrics.gauge_set("serve.cache.ssd.bytes", self._bytes)
    for rel in doomed:
      try:
        os.remove(os.path.join(self.root, rel))
      except OSError:
        pass
    if doomed:
      metrics.incr("serve.cache.ssd.invalidated", len(doomed))
    return len(doomed)

  @property
  def nbytes(self) -> int:
    with self._lock:
      return self._bytes

  def __len__(self) -> int:
    with self._lock:
      return len(self._index)


class TieredStoredCache:
  """RAM LRU fronting an optional SSD spill; SSD hits promote to RAM."""

  def __init__(self, ram_bytes: int, ssd_dir: Optional[str] = None,
               ssd_bytes: int = 0):
    self.ram = RamTier(ram_bytes)
    self.ssd = SsdTier(ssd_dir, ssd_bytes) if ssd_dir else None

  def get(self, layer: str, key: str) -> Tuple[Optional[Entry], Optional[str]]:
    """(entry, tier-name) — tier is "ram" or "ssd"; (None, None) on miss."""
    k = (layer, key)
    e = self.ram.get(k)
    if e is not None:
      metrics.incr("serve.cache.ram.hits")
      return e, "ram"
    metrics.incr("serve.cache.ram.misses")
    if self.ssd is not None:
      e = self.ssd.get(k)
      if e is not None:
        metrics.incr("serve.cache.ssd.hits")
        self.ram.put(k, e)
        return e, "ssd"
      metrics.incr("serve.cache.ssd.misses")
    return None, None

  def put(self, layer: str, key: str, data: bytes,
          method: Optional[str]) -> Entry:
    entry = Entry(bytes(data), method, strong_etag(data))
    k = (layer, key)
    self.ram.put(k, entry)
    if self.ssd is not None:
      self.ssd.put(k, entry)
    return entry

  def invalidate(self, layer: str, prefix: Optional[str] = None) -> int:
    n = self.ram.invalidate(layer, prefix)
    if self.ssd is not None:
      n += self.ssd.invalidate(layer, prefix)
    return n

  def stats(self) -> dict:
    out = {"ram_entries": len(self.ram), "ram_bytes": self.ram.nbytes}
    if self.ssd is not None:
      out["ssd_entries"] = len(self.ssd)
      out["ssd_bytes"] = self.ssd.nbytes
    return out
