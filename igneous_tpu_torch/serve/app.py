"""The serving application: routing, negotiation, coalescing, synthesis.

The port's own copy of ``igneous_tpu/serve/app.py``. One ``ServeApp``
fronts one or many Precomputed layers on any storage backend:

  RAM hit    the stored wire bytes straight from the LRU, with the
             ``Content-Encoding`` storage holds: no decode and no storage
             round trip.
  SSD hit    one local file read, promoted to RAM.
  cold miss  single-flighted per (layer, key): N concurrent clients cost
             one backend fetch (``CloudFiles.get_stored``, the compressed
             domain; the object is inflated only for a client that does
             not accept its wire encoding).
  no object  a chunk of a mip whose scale exists but whose chunks were
             never written is synthesized from its nearest stored
             ancestor through ``ops.pooling.downsample_auto`` on the
             port's device (the card's ``pyramid2x2x1``, and
             ``pool2x2x1`` on odd extents), with the bytes the offline
             ``DownsampleTask`` writes, and optionally written back.

Synthesis runs on the io pool's threads, as in the JAX package, but the
card's part of it (the pooling walk) is serialized behind one lock: launch
counts, the device ledger's spans and the card memory of the walks in
flight stay those of one walk at a time, and the bytes do not depend on
how many requests arrive together.

Every request mints a trace: a ``serve.request`` root span with
``serve.fetch`` / ``serve.synth`` / ``serve.decode`` / ``serve.peer``
children and the storage layer's spans under them. The ``serve.*``
counters and the ``serve.request`` histogram export through
``observability.prom``; the health engine's serve detectors and
Perfetto's serve track read the journaled spans and counters.

Knobs (``IGNEOUS_SERVE_*`` in ``knobs.KNOBS``): RAM_MB, SSD_DIR, SSD_MB,
CACHE_CONTROL, SYNTH_MIPS, WRITEBACK, MAX_OBJECT_MB, IO_THREADS,
DRAIN_SEC, and the federation's ``IGNEOUS_SERVE_FLEET_*``,
``IGNEOUS_SERVE_QOS_*`` and ``IGNEOUS_SERVE_PREWARM*`` (``federation``).
"""

from __future__ import annotations

import asyncio
import json
import math
import os
import posixpath
import threading
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np

from .. import chunk_cache
from ..analysis import knobs
from ..lib import Bbox, Vec
from ..observability import journal as journal_mod
from ..observability import metrics, trace
from ..storage import CloudFiles, compress_bytes, decompress_bytes, normalize_path
from .cache import Entry, TieredStoredCache, strong_etag
from .federation import PEER_FILL_HEADER, Federation, Prewarmer, QosGate
from .server import Request, Response


_JSON_KEYS = ("info", "provenance")
# the card's part of mip synthesis: one pooling walk at a time
_DEVICE_LOCK = threading.Lock()


@dataclass
class ServeConfig:
  """The serving tier's settings; each field has an ``IGNEOUS_SERVE_*``
  knob (``from_env``), and command-line flags win over the knobs."""

  ram_mb: float = 256.0
  ssd_dir: Optional[str] = None
  ssd_mb: float = 4096.0
  cache_control: str = "public, max-age=300"
  synth_mips: bool = True
  writeback: bool = False
  max_object_mb: float = 64.0
  io_threads: int = 16
  drain_sec: float = 30.0

  @classmethod
  def from_env(cls, **overrides) -> "ServeConfig":
    kw = dict(
      ram_mb=knobs.get_float("IGNEOUS_SERVE_RAM_MB"),
      ssd_dir=knobs.get_str("IGNEOUS_SERVE_SSD_DIR") or None,
      ssd_mb=knobs.get_float("IGNEOUS_SERVE_SSD_MB"),
      cache_control=knobs.get_str("IGNEOUS_SERVE_CACHE_CONTROL"),
      synth_mips=knobs.get_bool("IGNEOUS_SERVE_SYNTH_MIPS"),
      writeback=knobs.get_bool("IGNEOUS_SERVE_WRITEBACK"),
      max_object_mb=knobs.get_float("IGNEOUS_SERVE_MAX_OBJECT_MB"),
      io_threads=knobs.get_int("IGNEOUS_SERVE_IO_THREADS"),
      drain_sec=knobs.get_float("IGNEOUS_SERVE_DRAIN_SEC"),
    )
    for name, val in overrides.items():
      if val is not None:
        kw[name] = val
    return cls(**kw)


class LayerHandle:
  """One served layer: its metadata and Volumes built on first use (a
  server that only moves bytes never loads the codecs)."""

  def __init__(self, name: str, cloudpath: str):
    self.name = name
    self.cloudpath = cloudpath.rstrip("/")
    self.norm = normalize_path(self.cloudpath).rstrip("/")
    self.cf = CloudFiles(self.cloudpath)
    self._meta = None
    self._meta_failed = False
    self._vols: Dict[tuple, object] = {}

  def try_meta(self):
    """PrecomputedMetadata, or None when no readable info exists (the
    server still moves raw bytes for such layers; mip synthesis and
    scale routing just stay off)."""
    if self._meta is None and not self._meta_failed:
      try:
        from ..meta import PrecomputedMetadata

        self._meta = PrecomputedMetadata(self.cloudpath)
      except Exception:
        self._meta_failed = True
    return self._meta

  def volume(self, mip: int):
    vol = self._vols.get(mip)
    if vol is None:
      from ..volume import Volume

      vol = self._vols[mip] = Volume(
        self.cloudpath, mip=mip, fill_missing=False, bounded=True
      )
    return vol


class ServeApp:
  """Request handler + cache tiers + single-flight for a set of layers."""

  def __init__(self, layers: Union[str, Dict[str, str]],
               config: Optional[ServeConfig] = None,
               default_layer: Optional[str] = None,
               federation: Optional[Federation] = None,
               qos: Optional[QosGate] = None,
               prewarm: Optional[bool] = None):
    if isinstance(layers, str):
      name = layers.rstrip("/").split("/")[-1] or "layer"
      layers = {name: layers}
      default_layer = default_layer or name
    self.config = config or ServeConfig.from_env()
    self._layers = {
      name: LayerHandle(name, path) for name, path in layers.items()
    }
    self.default_layer = default_layer
    self._cache = TieredStoredCache(
      ram_bytes=int(self.config.ram_mb * 1e6),
      ssd_dir=self.config.ssd_dir,
      ssd_bytes=int(self.config.ssd_mb * 1e6),
    )
    self._pool = ThreadPoolExecutor(
      max_workers=max(int(self.config.io_threads), 1),
      thread_name_prefix="ig-serve-io",
    )
    self._loop: Optional[asyncio.AbstractEventLoop] = None
    self._inflight: Dict[tuple, asyncio.Future] = {}
    self._closed = False
    # fleet surface: inert objects unless peers/QoS/prewarm configured,
    # so the single-replica path pays nothing
    self.federation = federation if federation is not None else Federation.from_env()
    self._qos = qos if qos is not None else QosGate(layer_names=list(self._layers))
    if prewarm is None:
      prewarm = knobs.get_bool("IGNEOUS_SERVE_PREWARM")
    self._prewarmer = Prewarmer(self) if prewarm else None
    # overwrite/delete anywhere in this process (Volume.upload/delete,
    # pipeline write joins, serve's own write-back) invalidates the
    # serving tiers through the ONE shared entry point
    chunk_cache.register_invalidation_hook(self._on_invalidate)

  # -- lifecycle -------------------------------------------------------------

  def attach_loop(self, loop: asyncio.AbstractEventLoop) -> None:
    self._loop = loop

  async def housekeeping(self) -> None:
    """Periodic gauges + journal flush + federation tick, on the serve
    loop (the blocking membership/prefetch IO runs on the executor)."""
    try:
      while True:
        await asyncio.sleep(1.0)
        self.update_gauges()
        await self._run(journal_mod.maybe_flush_active)
        if self.federation.active:
          await self._run(self.federation.tick)
        if self._prewarmer is not None:
          await self._run(self._prewarmer.maybe_cycle)
    except asyncio.CancelledError:
      pass

  def close(self) -> None:
    if self._closed:
      return
    self._closed = True
    chunk_cache.unregister_invalidation_hook(self._on_invalidate)
    self.federation.close()
    self.update_gauges()
    journal_mod.flush_active("drain")
    self._pool.shutdown(wait=False)

  def layer(self, name: str) -> LayerHandle:
    return self._layers[name]

  @property
  def layer_names(self):
    return list(self._layers)

  # -- invalidation ----------------------------------------------------------

  def _on_invalidate(self, path: str, mip: Optional[int]) -> None:
    norm = normalize_path(path).rstrip("/")
    for layer in self._layers.values():
      if layer.norm != norm:
        continue
      self._cache.invalidate(layer.name, self._mip_prefix(layer, mip))
      # fleet-wide coherence: a write on THIS replica (writeback synth,
      # Volume.upload in-process) must not leave stale bytes on peers.
      # Best-effort fire-and-forget — receivers drop tiers directly
      # (no hook) so the broadcast cannot loop.
      if self.federation.active and not self._closed:
        self._pool.submit(
          self.federation.broadcast_invalidate, layer.name, mip
        )

  def _mip_prefix(self, layer: LayerHandle, mip: Optional[int]) -> Optional[str]:
    if mip is None:
      return None
    meta = layer.try_meta()
    if meta is None:
      return None
    try:
      return f"{meta.key(mip)}/"
    except IndexError:
      return None

  # -- request handling ------------------------------------------------------

  async def _run(self, fn, *args):
    loop = self._loop or asyncio.get_running_loop()
    return await loop.run_in_executor(self._pool, fn, *args)

  def _base_headers(self) -> list:
    return [
      ("Access-Control-Allow-Origin", "*"),
      ("Access-Control-Allow-Headers", "*"),
    ]

  async def handle(self, req: Request) -> Response:
    if req.method == "OPTIONS":
      return Response(204, headers=self._base_headers())
    path = urllib.parse.unquote(req.target.split("?", 1)[0])
    key = posixpath.normpath(path.lstrip("/"))
    # never allow escaping the served layers (the CORS wildcard makes
    # any traversal remotely exploitable) — same guard the view dev
    # server always had, applied before any routing
    if key.startswith("..") or key.startswith("/"):
      metrics.incr("serve.forbidden")
      return Response(403, b"forbidden", self._base_headers())
    if key == ".":
      key = ""
    if key.startswith("-/fed/"):
      return await self._handle_fed(req, key[len("-/fed/"):])
    if req.method not in ("GET", "HEAD"):
      return Response(405, b"method not allowed", self._base_headers())
    if key == "healthz":
      body = {
        "ok": True, "layers": self.layer_names, "cache": self._cache.stats(),
      }
      if self.federation.configured:
        body["federation"] = self.federation.stats()
      return Response(
        200, json.dumps(body).encode("utf8"),
        self._base_headers() + [("Content-Type", "application/json")],
      )
    if key == "metrics":
      from ..observability import prom

      return Response(
        200, prom.render().encode("utf8"),
        self._base_headers() + [("Content-Type", prom.CONTENT_TYPE)],
      )
    if not key:
      body = json.dumps({
        "layers": {n: h.cloudpath for n, h in self._layers.items()},
      }).encode("utf8")
      return Response(
        200, body, self._base_headers() + [("Content-Type", "application/json")]
      )
    routed = self._route(key)
    if routed is None:
      metrics.incr("serve.notfound")
      return Response(404, b"not found", self._base_headers())
    layer, subkey = routed
    # a peer fill was already admitted by the edge replica the client
    # hit; re-gating it here would double-charge the same request
    peer_fill = bool(req.header(PEER_FILL_HEADER))
    if peer_fill:
      metrics.incr("serve.peer.served")
    else:
      retry_after = self._qos.admit(layer.name)
      if retry_after is not None:
        metrics.incr("serve.shed.requests")
        metrics.incr(f"serve.shed.layer.{layer.name}")
        return Response(
          503, b"overloaded",
          self._base_headers() + [
            ("Retry-After", str(int(max(1, math.ceil(retry_after))))),
          ],
        )
    return await self._serve_key(layer, subkey, req, peer_fill=peer_fill)

  def _route(self, key: str) -> Optional[Tuple[LayerHandle, str]]:
    head, _, rest = key.partition("/")
    if head in self._layers and rest:
      return self._layers[head], rest
    if self.default_layer is not None:
      return self._layers[self.default_layer], key
    return None

  async def _handle_fed(self, req: Request, sub: str) -> Response:
    """Internal fleet endpoints under ``/-/fed/`` (never routed as layer
    keys: layer names cannot contain ``-/``). Peer-authenticated by the
    same header the fill protocol uses."""
    if sub == "status" and req.method in ("GET", "HEAD"):
      body = json.dumps(self.federation.stats()).encode("utf8")
      return Response(
        200, body, self._base_headers() + [("Content-Type", "application/json")]
      )
    if not req.header(PEER_FILL_HEADER):
      metrics.incr("serve.forbidden")
      return Response(403, b"forbidden", self._base_headers())
    if sub == "invalidate" and req.method == "POST":
      qs = urllib.parse.parse_qs(urllib.parse.urlsplit(req.target).query)
      layer_name = (qs.get("layer") or [""])[0]
      layer = self._layers.get(layer_name)
      if layer is None:
        return Response(404, b"not found", self._base_headers())
      prefix = None
      if qs.get("mip"):
        try:
          mip = int(qs["mip"][0])
        except ValueError:
          return Response(400, b"bad mip", self._base_headers())
        prefix = self._mip_prefix(layer, mip)
      # drop tiers DIRECTLY (not via chunk_cache.invalidate): the hook
      # path would re-broadcast and loop the fleet
      self._cache.invalidate(layer_name, prefix)
      metrics.incr("serve.peer.invalidate.received")
      return Response(204, headers=self._base_headers())
    return Response(404, b"not found", self._base_headers())

  async def _serve_key(self, layer: LayerHandle, key: str, req: Request,
                       peer_fill: bool = False) -> Response:
    ts = time.time()
    t0 = time.perf_counter()
    tinfo = trace.mint()
    sampled = tinfo is not None and tinfo.get("sampled", True)
    tid = tinfo["trace_id"] if tinfo else ""
    root_id = trace.new_id() if sampled else None
    metrics.incr("serve.requests")

    def finish(resp: Response, status: int, tier: str) -> Response:
      dur = time.perf_counter() - t0
      metrics.observe_quiet("serve.request", dur)
      metrics.incr("serve.bytes_sent", len(resp.body))
      if sampled:
        trace.record_at(
          "serve.request", ts, dur, tid, span_id=root_id,
          layer=layer.name, key=key, status=status, tier=tier,
        )
      return resp

    # explicit Range with a definite end: ranged backend read, no
    # caching (Neuroglancer's sharded reader slices multi-GB shard
    # files; pulling those through the chunk tiers would wipe them)
    rng = req.header("range")
    start = length = None
    if rng.startswith("bytes="):
      try:
        start_s, end_s = rng[len("bytes="):].split("-", 1)
        start = int(start_s)
        length = (int(end_s) - start + 1) if end_s else None
      except ValueError:
        start, length = 0, None
      if length is not None and length >= 0:
        data = await self._run(layer.cf.get_range, key, start, length)
        if data is not None:
          metrics.incr("serve.range")
          return finish(self._range_response(data, start), 206, "range")
      # open-ended range or a gzip-stored key ranged raw reads cannot
      # serve: fall through to a full get + slice below

    entry, tier = await self._run(self._cache.get, layer.name, key)
    if entry is None:
      entry, tier = await self._coalesced_fetch(
        layer, key, tid, root_id, sampled, allow_peer=not peer_fill
      )
    if entry is None:
      metrics.incr("serve.notfound")
      return finish(Response(404, b"not found", self._base_headers()), 404, "miss")

    inm = req.header("if-none-match")
    if inm and entry.etag in (t.strip() for t in inm.split(",")):
      metrics.incr("serve.not_modified")
      return finish(
        Response(304, b"", self._entry_headers(entry, key, tier)), 304, tier
      )

    accepts_gzip = "gzip" in req.header("accept-encoding").lower()
    if start is not None:
      body = await self._logical_body(entry, tid, root_id, sampled)
      body = body[start:] if length is None else body[start:start + length]
      return finish(self._range_response(body, start), 206, tier)

    headers = self._entry_headers(entry, key, tier)
    if entry.method is None:
      body = entry.data
      metrics.incr("serve.passthrough")
    elif entry.method == "gzip" and accepts_gzip:
      # the compressed-domain hot path: stored wire bytes move verbatim
      body = entry.data
      headers.append(("Content-Encoding", "gzip"))
      metrics.incr("serve.passthrough")
    else:
      body = await self._logical_body(entry, tid, root_id, sampled)
    return finish(Response(200, body, headers), 200, tier)

  def _range_response(self, data: bytes, start: int) -> Response:
    headers = self._base_headers() + [
      ("Content-Type", "application/octet-stream"),
      ("Content-Range", f"bytes {start}-{start + len(data) - 1}/*"),
    ]
    return Response(206, data, headers)

  def _entry_headers(self, entry: Entry, key: str, tier: str) -> list:
    base = key.rsplit("/", 1)[-1]
    ctype = (
      "application/json"
      if base in _JSON_KEYS or base.endswith(".json")
      else "application/octet-stream"
    )
    return self._base_headers() + [
      ("Content-Type", ctype),
      ("ETag", entry.etag),
      ("Cache-Control", self.config.cache_control),
      ("Vary", "Accept-Encoding"),
      ("X-Igneous-Cache", tier or "miss"),
    ]

  async def _logical_body(self, entry: Entry, tid, root_id, sampled) -> bytes:
    """The stored bytes with the WIRE compression removed (codec bytes —
    what a plain CloudFiles.get returns). Never a codec decode."""
    if entry.method is None:
      return entry.data
    t0 = time.perf_counter()
    ts = time.time()
    body = await self._run(decompress_bytes, entry.data, entry.method)
    metrics.incr("serve.transcode")
    if sampled:
      trace.record_at(
        "serve.decode", ts, time.perf_counter() - t0, tid, parent=root_id,
        method=entry.method, nbytes=len(body),
      )
    return body

  # -- single-flight origin fetch -------------------------------------------

  def _cache_peek(self, layer_name: str, key: str):
    """Tier probe without hit/miss counters (the leader recheck below:
    double-counting would skew the hit-ratio gauges)."""
    k = (layer_name, key)
    e = self._cache.ram.get(k)
    if e is not None:
      return e, "ram"
    if self._cache.ssd is not None:
      e = self._cache.ssd.get(k)
      if e is not None:
        return e, "ssd"
    return None, None

  async def _coalesced_fetch(self, layer: LayerHandle, key: str, tid, root_id,
                             sampled,
                             allow_peer: bool = True) -> Tuple[Optional[Entry], str]:
    fkey = (layer.name, key)
    fut = self._inflight.get(fkey)
    if fut is not None:
      metrics.incr("serve.coalesce.waiters")
      entry = await asyncio.shield(fut)
      return entry, "coalesced"
    loop = self._loop or asyncio.get_running_loop()
    fut = loop.create_future()
    self._inflight[fkey] = fut
    try:
      # late-arrival recheck: a client whose cache probe missed while
      # the previous flight was landing (the fill happens before the
      # in-flight future is popped) would otherwise become a second
      # leader and refetch — the "exactly 1 backend fetch" guarantee
      # requires the new leader to look again before going to origin
      entry, tier = await self._run(self._cache_peek, layer.name, key)
      if entry is not None:
        metrics.incr("serve.coalesce.waiters")
      else:
        metrics.incr("serve.coalesce.leaders")
        entry, tier = await self._run(
          self._fill_blocking, layer, key, allow_peer, tid, root_id, sampled
        )
    except Exception as e:
      self._inflight.pop(fkey, None)
      if not fut.done():
        fut.set_exception(e)
        fut.exception()  # consumed: no "never retrieved" warnings
      metrics.incr("serve.fetch.errors")
      raise
    self._inflight.pop(fkey, None)
    if not fut.done():
      fut.set_result(entry)
    return entry, tier

  def _fill_blocking(self, layer: LayerHandle, key: str, allow_peer: bool,
                     tid, root_id, sampled) -> Tuple[Optional[Entry], str]:
    """Executor thread: peer-fill from the chunk's ring owner when one
    exists, origin otherwise. The single-flight leader runs this, so a
    local herd costs one peer round and the owner's own single-flight
    makes the fleet-wide cost one origin fetch."""
    fed = self.federation
    if allow_peer and fed.active:
      owner = fed.owner(layer.name, key)
      if owner is not None:
        entry, authoritative = self._peer_fill(
          layer, key, owner, tid, root_id, sampled
        )
        if authoritative:
          # a peer 404 is final: the owner already consulted origin and
          # tried synthesis, so retrying origin here would restore the
          # N-replicas-hit-origin behavior federation exists to remove
          return entry, "peer"
        metrics.incr("serve.peer.fallback")
    return self._fetch_blocking(layer, key, tid, root_id, sampled), "origin"

  def _peer_fill(self, layer: LayerHandle, key: str, owner: str, tid, root_id,
                 sampled) -> Tuple[Optional[Entry], bool]:
    """One peer round. Returns ``(entry, authoritative)``: authoritative
    False means transport/integrity failure — quarantine the peer and
    fall back to origin."""
    ts = time.time()
    t0 = time.perf_counter()
    status, data, method, etag = self.federation.peer_fetch(
      owner, layer.name, key
    )
    if sampled:
      trace.record_at(
        "serve.peer", ts, time.perf_counter() - t0, tid, parent=root_id,
        layer=layer.name, key=key, peer=owner, status=status,
      )
    if status == "hit":
      actual = strong_etag(data)
      if etag is not None and etag != actual:
        # the peer transcoded (or corrupted) the stored bytes: the fill
        # would poison this replica's tiers with a different ETag than
        # the owner serves, breaking CDN dedup — treat as a peer failure
        metrics.incr("serve.peer.etag_mismatch")
        self.federation.mark_dead(owner)
        return None, False
      metrics.incr("serve.peer.hits")
      metrics.incr("serve.peer.bytes", len(data))
      self.federation.mark_alive(owner)
      if len(data) <= int(self.config.max_object_mb * 1e6):
        return self._cache.put(layer.name, key, data, method), True
      return Entry(bytes(data), method, actual), True
    if status == "miss":
      metrics.incr("serve.peer.notfound")
      self.federation.mark_alive(owner)
      return None, True
    metrics.incr("serve.peer.errors")
    self.federation.mark_dead(owner)
    return None, False

  def _fetch_blocking(self, layer: LayerHandle, key: str, tid, root_id,
                      sampled) -> Optional[Entry]:
    """Executor thread: origin read (compressed domain) or mip synth."""
    ts = time.time()
    t0 = time.perf_counter()
    span_id = trace.new_id() if sampled else None
    ctx = trace.SpanContext(tid, span_id, True) if sampled else None
    with trace.activate(ctx):
      data, method = layer.cf.get_stored(key)
      synthesized = False
      if data is None and self.config.synth_mips:
        got = self._maybe_synthesize(layer, key)
        if got is not None:
          data, method = got
          synthesized = True
    metrics.incr("serve.fetch")
    if sampled:
      trace.record_at(
        "serve.fetch", ts, time.perf_counter() - t0, tid, span_id=span_id,
        parent=root_id, layer=layer.name, key=key,
        hit=data is not None, synthesized=synthesized,
      )
    if data is None:
      return None
    if not synthesized and not self._fill_verify(layer, key, data, method):
      # corrupt origin object: never admitted to any cache tier, never
      # served — the client sees a 404 and the object is quarantined
      return None
    if len(data) <= int(self.config.max_object_mb * 1e6):
      return self._cache.put(layer.name, key, data, method)
    return Entry(bytes(data), method, strong_etag(data))

  def _fill_verify(self, layer: LayerHandle, key: str, data: bytes,
                   method: Optional[str]) -> bool:
    """The fill path's corruption guard: validate the wire
    compression of an origin fetch before it can reach a cache tier or
    a client. Raw-stored objects carry no checkable redundancy here;
    they are covered by the manifest-digest audit instead."""
    if method is None or not knobs.get_bool("IGNEOUS_INTEGRITY_SERVE_VERIFY"):
      return True
    try:
      decompress_bytes(data, method)
      return True
    except Exception as e:
      from .. import integrity

      metrics.incr("integrity.corrupt_reads")
      metrics.incr("serve.fetch.corrupt")
      integrity.quarantine(
        layer.cf.cloudpath, key, f"serve fill: {type(e).__name__}: {e}"
      )
      return False

  # -- on-the-fly mip synthesis ----------------------------------------------

  def _chunk_ref(self, layer: LayerHandle, key: str):
    parts = key.split("/")
    if len(parts) != 2:
      return None
    meta = layer.try_meta()
    if meta is None:
      return None
    try:
      mip = meta.mip_from_key(parts[0])
    except KeyError:
      return None
    try:
      bbox = Bbox.from_filename(parts[1])
    except (ValueError, IndexError):
      return None
    return meta, mip, bbox

  def _maybe_synthesize(self, layer: LayerHandle, key: str):
    """(stored bytes, wire method) for a missing chunk whose scale
    exists, downsampled on the fly from the parent mip — byte-identical
    to what the offline DownsampleTask would have written (same pooling
    method resolution, same encode path, deterministic gzip). None when
    the key isn't a canonical chunk of mip>0 or the source is absent."""
    ref = self._chunk_ref(layer, key)
    if ref is None:
      return None
    meta, mip, bbox = ref
    if mip <= 0 or meta.is_sharded(mip):
      return None
    bounds = meta.bounds(mip)
    expanded = bbox.expand_to_chunk_size(
      meta.chunk_size(mip), meta.voxel_offset(mip)
    )
    if Bbox.intersection(expanded, bounds) != bbox:
      return None  # not a canonical (grid-aligned, bounds-clamped) chunk
    from ..ops import pooling
    from ..volume import EmptyVolumeError

    t0 = time.perf_counter()
    # walk down to the nearest ancestor mip with readable data, collecting
    # the per-level factors; the walk then runs as one pyramid on the
    # device (each level the pad and pool of the offline DownsampleTask
    # chain, so the bytes are the same). A chunk whose parent was never
    # written is served as long as some ancestor (mip 0 at last) holds it.
    factors = []
    src_mip, src_bbox, img = mip, bbox, None
    while src_mip > 0:
      f = meta.downsample_ratio(src_mip) // meta.downsample_ratio(src_mip - 1)
      if any(int(v) < 1 for v in f) or all(int(v) == 1 for v in f):
        break
      up = Bbox.intersection(
        Bbox(src_bbox.minpt * f, src_bbox.maxpt * f), meta.bounds(src_mip - 1)
      )
      if up.empty():
        break
      factors.insert(0, tuple(int(v) for v in f))
      src_mip -= 1
      src_bbox = up
      try:
        img = layer.volume(src_mip).download(src_bbox, mip=src_mip)
        break
      except EmptyVolumeError:
        img = None
    if img is None or not factors:
      return None
    method = pooling.method_for_layer(meta.layer_type, "auto")
    # one walk on the card at a time (module docstring)
    with _DEVICE_LOCK:
      mips_out = pooling.downsample_auto(
        img, factors, len(factors), method=method, sparse=False,
        mip_from=src_mip,
      )
    mipped = mips_out[-1]
    total = Vec(*np.prod(np.asarray(factors), axis=0).tolist())
    minpt = src_bbox.minpt // total
    dest = Bbox.intersection(
      Bbox(minpt, minpt + Vec(*mipped.shape[:3])), bounds
    )
    if dest != bbox:
      return None
    sl = tuple(slice(0, int(s)) for s in dest.size3())
    cutout = np.asarray(mipped[sl], dtype=meta.dtype)
    metrics.incr("serve.synth")
    trace.record_span("serve.synth", time.perf_counter() - t0,
                      mip=mip, src_mip=src_mip, key=key)
    if self.config.writeback:
      # the upload path IS the DownsampleTask write path, so the stored
      # object is exactly what offline downsampling would leave; the
      # read-back returns those wire bytes for serving + caching
      layer.volume(mip).upload(dest, cutout, mip=mip, compress="gzip")
      metrics.incr("serve.writeback")
      data, method_ = layer.cf.get_stored(key)
      if data is not None:
        return data, method_
    from .. import codecs

    encoding = meta.encoding(mip)
    scale = meta.scale(mip)
    enc_kw = {}
    if encoding == "jpeg" and "jpeg_quality" in scale:
      enc_kw["jpeg_quality"] = int(scale["jpeg_quality"])
    elif encoding == "png" and "png_level" in scale:
      enc_kw["png_level"] = int(scale["png_level"])
    encoded = codecs.encode(
      cutout, encoding, block_size=meta.cseg_block_size(mip), **enc_kw
    )
    return compress_bytes(encoded, "gzip"), "gzip"

  # -- gauges ----------------------------------------------------------------

  def update_gauges(self) -> None:
    c = metrics.counters_snapshot()

    def ratio(hits, misses):
      total = hits + misses
      return hits / total if total else 0.0

    metrics.gauge_set("serve.hit_ratio_ram", ratio(
      c.get("serve.cache.ram.hits", 0), c.get("serve.cache.ram.misses", 0)
    ))
    metrics.gauge_set("serve.hit_ratio_ssd", ratio(
      c.get("serve.cache.ssd.hits", 0), c.get("serve.cache.ssd.misses", 0)
    ))
    leaders = c.get("serve.coalesce.leaders", 0)
    waiters = c.get("serve.coalesce.waiters", 0)
    if leaders:
      metrics.gauge_set("serve.coalesce_fan_in", (leaders + waiters) / leaders)
    # fleet economics: of all cache FILLS, how many came from a peer
    # instead of origin; of all admissions, how many were shed
    peer_hits = c.get("serve.peer.hits", 0)
    fills = peer_hits + c.get("serve.fetch", 0)
    if fills:
      metrics.gauge_set("serve.fleet.peer_hit_ratio", peer_hits / fills)
    sheds = c.get("serve.shed.requests", 0)
    offered = sheds + c.get("serve.requests", 0)
    if offered:
      metrics.gauge_set("serve.fleet.shed_ratio", sheds / offered)
    for q, name in ((0.5, "serve.p50_ms"), (0.99, "serve.p99_ms")):
      val = metrics.histogram_quantile("serve.request", q)
      if val is not None:
        # lint: allow=IGN503 name comes from the literal tuple above
        metrics.gauge_set(name, val * 1e3)
