"""Serve federation: N replicas that behave as one distributed cache.

The port's own copy of ``igneous_tpu/serve/federation.py``; its ring, its
peer-fill protocol and its membership records are the JAX package's, so a
fleet may mix replicas of both packages.

Ownership is a rendezvous (highest-random-weight) hash over the live
replica set: each replica computes ``owner(layer, chunk)`` from the member
URLs alone (blake2b, no process seed), with no coordinator. When a peer
leaves, only the keys it owned move; when one joins, it takes its ~1/N
share and nothing else moves.

The peer-fill protocol is the serving protocol: a replica that misses
locally sends a plain ``GET /<layer>/<key>`` to the owner with
``X-Igneous-Peer-Fill: <self-url>``. The owner never forwards a peer fill
again, does not charge it to QoS admission and counts it apart
(``serve.peer.served``). With each replica's own single-flight, a
fleet-wide cold herd for one chunk costs one origin fetch. A peer 404 is
final (the owner already tried origin and synthesis).

A peer transport error quarantines the peer for
``IGNEOUS_SERVE_FLEET_RETRY_SEC``, and the requester goes to origin at
once (``serve.peer.fallback``): a dead owner costs one request latency,
never availability.

Membership is a static ``--peers`` list or a shared membership directory
(any cloudpath), where each replica heartbeats a ``<slug>.json`` record
({url, ts, pid}) and polls the others; records older than
``IGNEOUS_SERVE_FLEET_TTL_SEC`` leave the ring, and a draining replica
deletes its own.

Also here, since they share the fleet's settings: ``QosGate`` (per-layer
weighted token buckets over one global rate; a shed is a 503 with a
``Retry-After`` from the bucket's refill deficit) and ``Prewarmer`` (it
mines the journal's ``serve.request`` spans for the hottest chunks,
predicts their neighbours and children, and pulls the ones this replica
owns into its tiers while idle).
"""

from __future__ import annotations

import hashlib
import http.client
import json
import re
import threading
import time
import urllib.parse
from typing import Dict, List, Optional, Tuple

from .. import secrets
from ..observability import metrics

PEER_FILL_HEADER = "X-Igneous-Peer-Fill"


def _hash64(data: str) -> int:
  return int.from_bytes(
    hashlib.blake2b(data.encode("utf8"), digest_size=8).digest(), "big"
  )


def member_slug(url: str) -> str:
  """Filesystem-safe membership file name for a replica URL."""
  safe = re.sub(r"[^A-Za-z0-9._-]+", "-", url.split("://", 1)[-1]).strip("-")
  return f"{safe}-{_hash64(url):016x}"


class HashRing:
  """Rendezvous hash over replica base URLs.

  Deterministic across processes (blake2b, no process seed) and
  independent of peer-list order, so every replica agrees on ownership
  from the member set alone."""

  def __init__(self, peers):
    self.peers: Tuple[str, ...] = tuple(sorted(set(peers)))

  def ranked(self, layer: str, key: str) -> List[str]:
    """Peers ordered best-first for this chunk (owner, runner-up, ...)."""
    ident = f"{layer}/{key}"
    return sorted(
      self.peers, key=lambda p: _hash64(f"{p}\x00{ident}"), reverse=True
    )

  def owner(self, layer: str, key: str) -> Optional[str]:
    best, score = None, -1
    ident = f"{layer}/{key}"
    for p in self.peers:
      s = _hash64(f"{p}\x00{ident}")
      if s > score:
        best, score = p, s
    return best

  def __len__(self):
    return len(self.peers)


class StaticMembership:
  """Fixed peer list (``--peers``); join/leave only via restart."""

  def __init__(self, peers):
    self._peers = tuple(sorted(set(peers)))

  def heartbeat(self, self_url: str) -> None:
    pass

  def poll(self, self_url: str) -> Tuple[str, ...]:
    # the static list may or may not include self; ownership math needs it
    return tuple(sorted(set(self._peers) | {self_url}))

  def leave(self, self_url: str) -> None:
    pass


class FileMembership:
  """Shared membership directory (any cloudpath — file:// for one-host
  fleets, gs:// for pods). One JSON record per live replica."""

  def __init__(self, cloudpath: str, ttl_sec: float):
    from ..storage import CloudFiles

    self.cloudpath = cloudpath
    self.ttl_sec = float(ttl_sec)
    self._cf = CloudFiles(cloudpath)

  def heartbeat(self, self_url: str) -> None:
    import os

    self._cf.put_json(f"{member_slug(self_url)}.json", {
      "url": self_url, "ts": time.time(), "pid": os.getpid(),
    })

  def poll(self, self_url: str) -> Tuple[str, ...]:
    now = time.time()
    live = {self_url}
    for key in self._cf.list():
      if not key.endswith(".json"):
        continue
      try:
        rec = self._cf.get_json(key)
      except Exception:
        continue
      if not isinstance(rec, dict) or "url" not in rec:
        continue
      if now - float(rec.get("ts", 0.0)) <= self.ttl_sec:
        live.add(str(rec["url"]))
    return tuple(sorted(live))

  def leave(self, self_url: str) -> None:
    try:
      self._cf.delete(f"{member_slug(self_url)}.json")
    except Exception:
      pass


class Federation:
  """Ring + membership + peer HTTP client for one replica.

  Inert until :meth:`activate` runs with the replica's advertised URL
  (only known after the listening socket binds). All methods are
  thread-safe; the blocking HTTP work is meant to run on the serve
  app's executor pool."""

  def __init__(self, peers=None, membership_dir: Optional[str] = None,
               ttl_sec: Optional[float] = None,
               timeout_ms: Optional[float] = None,
               retry_sec: Optional[float] = None):
    if ttl_sec is None:
      ttl_sec = secrets.get_float("IGNEOUS_SERVE_FLEET_TTL_SEC")
    if timeout_ms is None:
      timeout_ms = secrets.get_float("IGNEOUS_SERVE_FLEET_TIMEOUT_MS")
    if retry_sec is None:
      retry_sec = secrets.get_float("IGNEOUS_SERVE_FLEET_RETRY_SEC")
    self.ttl_sec = float(ttl_sec)
    self.timeout = float(timeout_ms) / 1e3
    self.retry_sec = float(retry_sec)
    self.self_url: Optional[str] = None
    self._static = tuple(peers or ())
    self._membership = (
      FileMembership(membership_dir, self.ttl_sec) if membership_dir
      else StaticMembership(self._static)
    )
    self._configured = bool(self._static) or bool(membership_dir)
    self._lock = threading.Lock()
    self._ring = HashRing(())  # guarded-by: self._lock
    self._dead: Dict[str, float] = {}  # url -> retry deadline, guarded-by: self._lock
    self._next_tick = 0.0  # guarded-by: self._lock
    self._left = False

  @classmethod
  def from_env(cls, peers: Optional[str] = None,
               membership_dir: Optional[str] = None) -> "Federation":
    if peers is None:
      peers = secrets.get_str("IGNEOUS_SERVE_FLEET_PEERS")
    if membership_dir is None:
      membership_dir = secrets.get_str("IGNEOUS_SERVE_FLEET_MEMBERSHIP") or None
    peer_list = [p.strip().rstrip("/") for p in (peers or "").split(",")
                 if p.strip()]
    return cls(peers=peer_list, membership_dir=membership_dir)

  # -- lifecycle -------------------------------------------------------------

  @property
  def configured(self) -> bool:
    return self._configured

  @property
  def active(self) -> bool:
    return self._configured and self.self_url is not None

  def activate(self, self_url: str) -> None:
    """Advertise this replica and build the initial ring (blocking:
    one heartbeat + one membership poll)."""
    self.self_url = self_url.rstrip("/")
    if self._configured:
      self.tick(force=True)

  def close(self) -> None:
    """Graceful leave: drop the membership record so peers rebuild the
    ring at their next poll instead of waiting out the TTL."""
    if self._left or not self.active:
      return
    self._left = True
    self._membership.leave(self.self_url)

  # -- ring maintenance ------------------------------------------------------

  def tick(self, force: bool = False) -> None:
    """Heartbeat + membership poll + ring rebuild, throttled to a
    fraction of the TTL. Called from the serve housekeeping loop."""
    if not self.active or self._left:
      return
    now = time.monotonic()
    with self._lock:
      if not force and now < self._next_tick:
        return
      self._next_tick = now + max(self.ttl_sec / 3.0, 0.5)
    try:
      self._membership.heartbeat(self.self_url)
      members = self._membership.poll(self.self_url)
    except Exception:
      metrics.incr("serve.peer.membership_errors")
      return
    with self._lock:
      if members != self._ring.peers:
        self._ring = HashRing(members)
        metrics.incr("serve.peer.ring_rebuilt")
      metrics.gauge_set("serve.fleet.peers_live", len(members))

  def live_peers(self) -> List[str]:
    """Ring members other than self, dead peers excluded."""
    now = time.monotonic()
    with self._lock:
      return [
        p for p in self._ring.peers
        if p != self.self_url and self._dead.get(p, 0.0) <= now
      ]

  def ring_size(self) -> int:
    with self._lock:
      return len(self._ring)

  def owner(self, layer: str, key: str) -> Optional[str]:
    """The live peer that owns this chunk, or None when this replica
    should go to origin itself (it is the owner, or the fleet is just
    this replica, or every better-ranked peer is quarantined)."""
    if not self.active:
      return None
    now = time.monotonic()
    with self._lock:
      ring, dead = self._ring, self._dead
      for p in ring.ranked(layer, key):
        if p == self.self_url:
          return None
        if dead.get(p, 0.0) <= now:
          return p
    return None

  def mark_dead(self, url: str) -> None:
    with self._lock:
      self._dead[url] = time.monotonic() + self.retry_sec
    metrics.incr("serve.peer.marked_dead")

  def mark_alive(self, url: str) -> None:
    with self._lock:
      self._dead.pop(url, None)

  # -- peer HTTP client ------------------------------------------------------

  def _connect(self, url: str) -> http.client.HTTPConnection:
    parts = urllib.parse.urlsplit(url)
    return http.client.HTTPConnection(
      parts.hostname, parts.port or 80, timeout=self.timeout
    )

  def peer_fetch(self, owner_url: str, layer: str,
                 key: str) -> Tuple[str, Optional[bytes], Optional[str],
                                    Optional[str]]:
    """Fetch stored wire bytes from the owner replica.

    Returns ``(status, data, wire_method, etag)`` where status is
    ``"hit"`` (data present), ``"miss"`` (authoritative 404 — the owner
    already consulted origin and synthesis), or ``"error"`` (transport
    or server failure; the caller falls back to origin and the peer is
    quarantined)."""
    path = "/" + urllib.parse.quote(f"{layer}/{key}")
    conn = None
    try:
      conn = self._connect(owner_url)
      conn.request("GET", path, headers={
        "Accept-Encoding": "gzip",
        PEER_FILL_HEADER: self.self_url or "?",
      })
      resp = conn.getresponse()
      body = resp.read()
      if resp.status == 200:
        method = resp.getheader("Content-Encoding") or None
        return "hit", body, method, resp.getheader("ETag")
      if resp.status == 404:
        return "miss", None, None, None
      return "error", None, None, None
    except Exception:
      return "error", None, None, None
    finally:
      if conn is not None:
        conn.close()

  def broadcast_invalidate(self, layer: str, mip: Optional[int]) -> int:
    """POST the invalidation to every live peer (best effort, blocking —
    run on the executor pool). Returns the number of peers reached."""
    if not self.active:
      return 0
    reached = 0
    q = urllib.parse.urlencode(
      {"layer": layer} if mip is None else {"layer": layer, "mip": mip}
    )
    for url in self.live_peers():
      conn = None
      try:
        conn = self._connect(url)
        conn.request("POST", f"/-/fed/invalidate?{q}",
                     headers={PEER_FILL_HEADER: self.self_url or "?"})
        resp = conn.getresponse()
        resp.read()
        if resp.status in (200, 204):
          reached += 1
          metrics.incr("serve.peer.invalidate.sent")
        else:
          metrics.incr("serve.peer.invalidate.errors")
      except Exception:
        metrics.incr("serve.peer.invalidate.errors")
        self.mark_dead(url)
      finally:
        if conn is not None:
          conn.close()
    return reached

  def stats(self) -> dict:
    now = time.monotonic()
    with self._lock:
      return {
        "active": self.active,
        "self": self.self_url,
        "ring": list(self._ring.peers),
        "dead": sorted(
          u for u, t in self._dead.items() if t > now
        ),
      }


class QosGate:
  """Admission control: one global token rate split across layers by
  weight. ``admit`` returns None (admitted) or the Retry-After seconds
  for a shed — computed from the bucket's true refill deficit, so a
  well-behaved client that honors it is admitted on return."""

  def __init__(self, rps: Optional[float] = None,
               weights: Optional[Dict[str, float]] = None,
               burst_sec: Optional[float] = None,
               layer_names=(), now_fn=time.monotonic):
    if rps is None:
      rps = secrets.get_float("IGNEOUS_SERVE_QOS_RPS")
    if weights is None:
      weights = self.parse_weights(secrets.get_str("IGNEOUS_SERVE_QOS_WEIGHTS"))
    if burst_sec is None:
      burst_sec = secrets.get_float("IGNEOUS_SERVE_QOS_BURST_SEC")
    self.rps = float(rps)
    self.weights = dict(weights or {})
    self.burst_sec = float(burst_sec)
    self._now = now_fn
    self._lock = threading.Lock()
    self._buckets: Dict[str, list] = {}  # layer -> [tokens, last], guarded-by: self._lock
    self._rates: Dict[str, float] = {}
    for name in layer_names:
      self.rate_for(name)

  @staticmethod
  def parse_weights(spec: Optional[str]) -> Dict[str, float]:
    """Parse ``"layer=weight,layer=weight"``; unlisted layers weigh 1."""
    out: Dict[str, float] = {}
    for part in (spec or "").split(","):
      part = part.strip()
      if not part:
        continue
      name, _, val = part.partition("=")
      try:
        w = float(val)
      except ValueError:
        continue
      if name.strip() and w > 0:
        out[name.strip()] = w
    return out

  @property
  def active(self) -> bool:
    return self.rps > 0

  def rate_for(self, layer: str) -> float:
    """This layer's share of the global rate. Weights normalize over
    the layers actually SEEN (lazily), so a single-layer deployment
    gets the whole rate regardless of its configured weight."""
    rate = self._rates.get(layer)
    if rate is None:
      with self._lock:
        self._rates.setdefault(layer, 0.0)
        known = set(self._rates)
        total = sum(self.weights.get(n, 1.0) for n in known)
        for n in known:
          self._rates[n] = self.rps * self.weights.get(n, 1.0) / total
          b = self._buckets.get(n)
          if b is None:
            cap = max(self._rates[n] * self.burst_sec, 1.0)
            self._buckets[n] = [cap, self._now()]
        rate = self._rates[layer]
    return rate

  def admit(self, layer: str) -> Optional[float]:
    if not self.active:
      return None
    rate = self.rate_for(layer)
    if rate <= 0:
      return 1.0
    now = self._now()
    with self._lock:
      bucket = self._buckets[layer]
      cap = max(rate * self.burst_sec, 1.0)
      tokens = min(cap, bucket[0] + (now - bucket[1]) * rate)
      bucket[1] = now
      if tokens >= 1.0:
        bucket[0] = tokens - 1.0
        return None
      bucket[0] = tokens
      return max((1.0 - tokens) / rate, 0.1)


class Prewarmer:
  """Telemetry-driven prefetch: mine the journal's ``serve.request``
  spans for the hottest chunk keys, predict the chunks a viewer is
  likely to touch next, and pull the ones this replica owns into its
  cache tiers while idle.

  The prediction model is the neuroglancer access pattern itself: a
  viewer panning a slice touches the spatial NEIGHBORS of what it just
  fetched (±1 chunk per axis, same mip), and a viewer zooming in
  touches the CHILD chunks (the up-to-8 chunks of the next-finer mip
  covering the same region). ``mine``/``predict`` are pure so the tests
  can drive them with hand-written journal records."""

  def __init__(self, app, interval_sec: Optional[float] = None,
               top: Optional[int] = None, budget: Optional[int] = None):
    if interval_sec is None:
      interval_sec = secrets.get_float("IGNEOUS_SERVE_PREWARM_INTERVAL_SEC")
    if top is None:
      top = secrets.get_int("IGNEOUS_SERVE_PREWARM_TOP")
    if budget is None:
      budget = secrets.get_int("IGNEOUS_SERVE_PREWARM_BUDGET")
    self.app = app
    self.interval_sec = float(interval_sec)
    self.top = int(top)
    self.budget = int(budget)
    self._next_cycle = 0.0
    self._lock = threading.Lock()

  # -- pure stages -----------------------------------------------------------

  def mine(self, records, window_sec: float = 600.0,
           now: Optional[float] = None) -> Dict[Tuple[str, str], int]:
    """(layer, key) -> request count from recent serve.request spans."""
    recs = list(records)
    if now is None:
      now = max((r.get("ts", 0.0) for r in recs), default=0.0)
    counts: Dict[Tuple[str, str], int] = {}
    for rec in recs:
      if rec.get("kind") != "span" or rec.get("name") != "serve.request":
        continue
      layer, key = rec.get("layer"), rec.get("key")
      if not layer or not key or "/" not in key:
        continue
      ts = float(rec.get("ts", 0.0))
      if now - ts > window_sec:
        continue
      counts[(layer, key)] = counts.get((layer, key), 0) + 1
    return counts

  def predict(self, counts: Dict[Tuple[str, str], int]) -> List[Tuple[str, str]]:
    """Predicted-hot (layer, key) chunks: neighbors + children of the
    top mined keys, canonical within layer bounds, the already-hot keys
    themselves excluded."""
    from ..lib import Bbox

    hot = sorted(counts.items(), key=lambda kv: -kv[1])[:self.top]
    seen = set(counts)
    out: List[Tuple[str, str]] = []
    for (layer_name, key), _ in hot:
      try:
        layer = self.app.layer(layer_name)
      except KeyError:
        continue
      ref = self.app._chunk_ref(layer, key)
      if ref is None:
        continue
      meta, mip, bbox = ref

      def emit(m: int, b: "Bbox") -> None:
        cand = self._canonical(meta, m, b)
        if cand is None:
          return
        item = (layer_name, cand)
        if item not in seen:
          seen.add(item)
          out.append(item)

      size = bbox.size3()
      for axis in range(3):
        for sign in (-1, 1):
          shift = [0, 0, 0]
          shift[axis] = sign * int(size[axis])
          emit(mip, Bbox(bbox.minpt + shift, bbox.maxpt + shift))
      if mip > 0:
        f = meta.downsample_ratio(mip) // meta.downsample_ratio(mip - 1)
        child_origin = bbox.minpt * f
        child_size = meta.chunk_size(mip - 1)
        for dx in range(int(f[0])):
          for dy in range(int(f[1])):
            for dz in range(int(f[2])):
              off = child_size * (dx, dy, dz)
              emit(mip - 1, Bbox(child_origin + off,
                                 child_origin + off + child_size))
    return out

  def _canonical(self, meta, mip: int, bbox) -> Optional[str]:
    """Chunk filename for a bbox if it is a real grid-aligned chunk of
    this mip (bounds-clamped, non-empty), else None."""
    from ..lib import Bbox

    try:
      bounds = meta.bounds(mip)
    except IndexError:
      return None
    clamped = Bbox.intersection(bbox, bounds)
    if clamped.empty():
      return None
    expanded = clamped.expand_to_chunk_size(
      meta.chunk_size(mip), meta.voxel_offset(mip)
    )
    if Bbox.intersection(expanded, bounds) != clamped:
      return None
    grid = (clamped.minpt - meta.voxel_offset(mip)) % meta.chunk_size(mip)
    if any(int(v) != 0 for v in grid):
      return None
    return f"{meta.key(mip)}/{clamped.to_filename()}"

  # -- cycle -----------------------------------------------------------------

  def maybe_cycle(self) -> Optional[dict]:
    now = time.monotonic()
    with self._lock:
      if now < self._next_cycle:
        return None
      self._next_cycle = now + self.interval_sec
    return self.cycle()

  def cycle(self) -> dict:
    """One mine -> predict -> prefetch pass (blocking; executor pool).

    Idle-capacity guard: a replica with requests in flight skips the
    cycle — prewarming must never compete with live traffic."""
    from ..observability import journal as journal_mod

    stats = {"mined": 0, "predicted": 0, "fetched": 0, "skipped": 0}
    if self.app._inflight:
      metrics.incr("serve.prewarm.deferred")
      return stats
    jrnl = journal_mod.get_active()
    if jrnl is None:
      return stats
    try:
      counts = self.mine(journal_mod.read_records(jrnl.cloudpath))
    except Exception:
      metrics.incr("serve.prewarm.errors")
      return stats
    stats["mined"] = len(counts)
    predicted = self.predict(counts)
    stats["predicted"] = len(predicted)
    fed = getattr(self.app, "federation", None)
    budget = self.budget
    for layer_name, key in predicted:
      if budget <= 0:
        break
      if fed is not None and fed.active and fed.owner(layer_name, key):
        stats["skipped"] += 1
        continue  # a peer owns it: warming it here would double-cache
      entry, _tier = self.app._cache_peek(layer_name, key)
      if entry is not None:
        stats["skipped"] += 1
        continue
      layer = self.app.layer(layer_name)
      try:
        entry = self.app._fetch_blocking(layer, key, "", None, False)
      except Exception:
        metrics.incr("serve.prewarm.errors")
        continue
      budget -= 1
      if entry is not None:
        stats["fetched"] += 1
        metrics.incr("serve.prewarm.fetched")
    metrics.incr("serve.prewarm.cycles")
    return stats
