"""The port's serve federation against the JAX package's, over HTTP on
localhost: each case of ``tests/test_serve_federation.py`` on the port.

The rendezvous ring ranks peers exactly as the JAX ring does (a few
thousand seeded (layer, key) pairs, on joins and leaves), so a mixed
fleet agrees on owners; a JAX replica and a port replica peered in one
process fill from each other with the same bytes and ETags. Then peer
fills (byte identity, ETags, tiers), a fleet-wide cold herd costing one
origin fetch, an owner down, no re-forwarding, QoS shares and sheds, peer
fills past admission, the invalidation broadcast, file membership with
heartbeats, prewarm predictions (equal to the JAX ``Prewarmer``'s on the
same records), the health engine's fleet detectors and the ``/-/fed/``
endpoints. The comparisons are exact.
"""

import http.client
import json
import threading
import time

import numpy as np
import pytest

import igneous_tpu.tasks  # noqa: F401  (registers the JAX package's tasks)
from igneous_tpu import Volume as JaxVolume
from igneous_tpu import chunk_cache as jax_chunk_cache
from igneous_tpu import serve as jax_serve
from igneous_tpu.observability import health as jax_health
from igneous_tpu.observability import journal as jax_journal
from igneous_tpu.observability import trace as jax_trace
from igneous_tpu.serve import federation as jax_federation
from igneous_tpu.storage import set_backend_wrapper as jax_set_backend_wrapper
from igneous_tpu_torch import Volume, chunk_cache, device
from igneous_tpu_torch import task_creation as tc
from igneous_tpu_torch.observability import health, journal, metrics, trace
from igneous_tpu_torch.queues import LocalTaskQueue
from igneous_tpu_torch.serve import (
  Federation, HashRing, Prewarmer, QosGate, ServeApp, ServeConfig, ServeServer,
  strong_etag,
)
from igneous_tpu_torch.serve.federation import FileMembership, member_slug
from igneous_tpu_torch.storage import CloudFiles, set_backend_wrapper

from test_torch_integrity import flush_local

CHUNK = "1_1_1/0-64_0-64_0-64"


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  for name in ("IGNEOUS_PIPELINE", "IGNEOUS_INTEGRITY", "IGNEOUS_CHUNK_CACHE",
               "IGNEOUS_JOURNAL"):
    monkeypatch.delenv(name, raising=False)
  device.reset_device()
  flush_local()
  chunk_cache.clear()
  jax_chunk_cache.clear()
  # spans of earlier servers wait in thread buffers for a journal
  trace.reset()
  jax_trace.reset()
  yield
  set_backend_wrapper(None)
  jax_set_backend_wrapper(None)
  journal.set_active(None)
  jax_journal.set_active(None)
  flush_local()
  chunk_cache.clear()
  jax_chunk_cache.clear()
  device.reset_device()


def _get(port, path, headers=None, method="GET"):
  conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
  try:
    conn.request(method, path, headers=headers or {})
    resp = conn.getresponse()
    return resp.status, dict(resp.getheaders()), resp.read()
  finally:
    conn.close()


def _seed(path, rng, chunk=64, size=64):
  data = rng.integers(0, 200, (size, size, size)).astype(np.uint8)
  JaxVolume.from_numpy(data, path, chunk_size=(chunk, chunk, chunk), layer_type="image",
                       encoding="raw", compress="gzip")
  return data


def _fleet(layers, n=2, extra_peers=(), qos=None, pkgs=None, **cfg_kw):
  """n in-process replicas over the same layers on a static ring, the
  federation attached once the ports are known (as the CLI does). ``pkgs``
  names each replica's package (the port's by default)."""
  mods = {"port": (ServeApp, ServeConfig, ServeServer, Federation),
          "jax": (jax_serve.ServeApp, jax_serve.ServeConfig, jax_serve.ServeServer,
                  jax_serve.Federation)}
  pkgs = pkgs or ["port"] * n
  servers = []
  for side in pkgs:
    app_cls, cfg_cls, srv_cls, _ = mods[side]
    config = cfg_cls(**{"ram_mb": 64.0, "synth_mips": False, **cfg_kw})
    default = next(iter(layers)) if len(layers) == 1 else None
    app = app_cls(dict(layers), config=config, default_layer=default, qos=qos)
    servers.append(srv_cls(app, host="127.0.0.1", port=0))
  urls = [f"http://127.0.0.1:{s.server_address[1]}" for s in servers]
  ring_urls = urls + list(extra_peers)
  for srv, url, side in zip(servers, urls, pkgs):
    fed = mods[side][3](peers=ring_urls, timeout_ms=5000.0, retry_sec=30.0)
    fed.activate(url)
    srv.app.federation = fed
  return servers, urls


def _shutdown(servers):
  for srv in servers:
    srv.shutdown()


def _owned_chunks(path, urls):
  ring = HashRing(urls)
  layer_name = path.rstrip("/").split("/")[-1]
  return {k: ring.owner(layer_name, k) for k in CloudFiles(path).list() if k.startswith("1_1_1/")}


# ---------------------------------------------------------------------------
# the ring


def test_ring_ranks_peers_as_the_jax_ring(rng):
  """Owners and full rankings of 3,000 seeded (layer, key) pairs, on a
  fleet of 5, after a leave and after a join."""
  peers = [f"http://replica-{i}.example:{8000 + i}" for i in range(5)]
  fleets = [peers, peers[:2] + peers[3:], peers + ["http://127.0.0.1:9999"]]
  layers = [f"layer{i}" for i in range(6)]
  pairs = []
  for _ in range(3000):
    mip = int(rng.integers(0, 5))
    x, y, z = (int(v) * 64 for v in rng.integers(0, 200, 3))
    pairs.append((layers[int(rng.integers(0, 6))],
                  f"{2 ** mip}_{2 ** mip}_40/{x}-{x + 64}_{y}-{y + 64}_{z}-{z + 64}"))
  for members in fleets:
    mine, theirs = HashRing(members), jax_federation.HashRing(list(reversed(members)))
    assert mine.peers == theirs.peers and len(mine) == len(theirs)
    for layer, key in pairs:
      assert mine.ranked(layer, key) == theirs.ranked(layer, key)
      assert mine.owner(layer, key) == theirs.owner(layer, key)
  assert all(member_slug(u) == jax_federation.member_slug(u) for u in fleets[2])


def test_ring_deterministic_and_balanced():
  peers = [f"http://replica-{i}:8080" for i in range(3)]
  keys = [f"1_1_1/k{i}" for i in range(600)]
  a, b = HashRing(peers), HashRing(list(reversed(peers)))
  owners = {k: a.owner("layer", k) for k in keys}
  assert owners == {k: b.owner("layer", k) for k in keys}
  for p in peers:
    assert sum(1 for o in owners.values() if o == p) >= len(keys) * 0.1
  ranked = a.ranked("layer", keys[0])
  assert sorted(ranked) == sorted(peers) and ranked[0] == owners[keys[0]]


def test_ring_rebalance_bounds_on_leave_and_join():
  peers = [f"http://replica-{i}:8080" for i in range(4)]
  keys = [f"1_1_1/k{i}" for i in range(1000)]
  before = {k: HashRing(peers).owner("L", k) for k in keys}
  after_leave = {k: HashRing(peers[:-1]).owner("L", k) for k in keys}
  assert all(after_leave[k] == before[k] for k in keys if before[k] != peers[-1])
  joined = peers + ["http://replica-new:8080"]
  after_join = {k: HashRing(joined).owner("L", k) for k in keys}
  moved = [k for k in keys if after_join[k] != before[k]]
  assert all(after_join[k] == "http://replica-new:8080" for k in moved)
  assert 0 < len(moved) < len(keys) * 0.4


# ---------------------------------------------------------------------------
# peer fill


def test_peer_fill_byte_identity_and_etag(rng, tmp_path):
  path = f"file://{tmp_path}/fed"
  _seed(path, rng)
  stored, method = CloudFiles(path).get_stored(CHUNK)
  servers, urls = _fleet({"fed": path})
  try:
    owner = HashRing(urls).owner("fed", CHUNK)
    edge = next(s for s, u in zip(servers, urls) if u != owner)
    c0 = metrics.counters_snapshot()
    status, headers, body = _get(edge.server_address[1], f"/fed/{CHUNK}",
                                 {"Accept-Encoding": "gzip"})
    assert (status, headers["X-Igneous-Cache"], body) == (200, "peer", stored)
    assert headers.get("Content-Encoding") == method
    assert headers["ETag"] == strong_etag(stored) == jax_serve.strong_etag(stored)
    c1 = metrics.counters_snapshot()
    assert c1.get("serve.peer.hits", 0) - c0.get("serve.peer.hits", 0) == 1
    assert c1.get("serve.peer.served", 0) - c0.get("serve.peer.served", 0) == 1
    _, headers, body2 = _get(edge.server_address[1], f"/fed/{CHUNK}",
                             {"Accept-Encoding": "gzip"})
    assert headers["X-Igneous-Cache"] == "ram" and body2 == stored
    for srv in servers:
      _, h, b = _get(srv.server_address[1], f"/fed/{CHUNK}", {"Accept-Encoding": "gzip"})
      assert b == stored and h["ETag"] == strong_etag(stored)
  finally:
    _shutdown(servers)


@pytest.mark.parametrize("owner_side", ["jax", "port"])
def test_mixed_fleet_peer_fill_both_ways(rng, tmp_path, owner_side):
  """A JAX replica and a port replica on one ring: the edge replica of one
  package fills from the owner of the other with the owner's bytes and
  ETag, and the owner answered it as a peer fill."""
  path = f"file://{tmp_path}/mixed"
  _seed(path, rng, chunk=32)
  servers, urls = _fleet({"mixed": path}, pkgs=["port", "jax"])
  sides = dict(zip(["port", "jax"], zip(servers, urls)))
  try:
    owner_srv, owner_url = sides[owner_side]
    edge_srv = sides["jax" if owner_side == "port" else "port"][0]
    owned = [k for k, o in _owned_chunks(path, urls).items() if o == owner_url]
    assert owned
    for key in owned[:3]:
      stored, method = CloudFiles(path).get_stored(key)
      s1, h1, b1 = _get(edge_srv.server_address[1], f"/mixed/{key}", {"Accept-Encoding": "gzip"})
      s2, h2, b2 = _get(owner_srv.server_address[1], f"/mixed/{key}", {"Accept-Encoding": "gzip"})
      assert (s1, h1["X-Igneous-Cache"], b1) == (200, "peer", stored)
      assert (s2, h2["X-Igneous-Cache"], b2) == (200, "ram", stored)
      assert h1["ETag"] == h2["ETag"] == strong_etag(stored)
      assert h1.get("Content-Encoding") == h2.get("Content-Encoding") == method
  finally:
    _shutdown(servers)


class _CountingBackend:
  def __init__(self, inner, counts, delay):
    self._inner, self._counts, self._delay = inner, counts, delay

  def get(self, key):
    with self._counts["lock"]:
      self._counts[key] = self._counts.get(key, 0) + 1
    time.sleep(self._delay)
    return self._inner.get(key)

  def __getattr__(self, name):
    return getattr(self._inner, name)


def test_fleet_wide_cold_herd_costs_one_origin_fetch(rng, tmp_path):
  path = f"file://{tmp_path}/fedherd"
  _seed(path, rng)
  counts = {"lock": threading.Lock()}
  set_backend_wrapper(lambda b, pth: _CountingBackend(b, counts, 0.2))
  servers, _urls = _fleet({"fedherd": path})
  try:
    ports = [s.server_address[1] for s in servers]
    n = 8
    barrier = threading.Barrier(n)
    bodies = [None] * n

    def client(i):
      barrier.wait()
      _, _, bodies[i] = _get(ports[i % len(ports)], f"/fedherd/{CHUNK}",
                             {"Accept-Encoding": "gzip"})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
      t.start()
    for t in threads:
      t.join()
    # the stored object is <key>.gz: one get of the bare key, one of .gz
    assert counts.get(CHUNK + ".gz", 0) == 1, counts
    expect, _ = CloudFiles(path).get_stored(CHUNK)
    assert all(b == expect for b in bodies)
  finally:
    _shutdown(servers)


def test_owner_down_falls_back_to_origin(rng, tmp_path):
  path = f"file://{tmp_path}/feddown"
  _seed(path, rng, chunk=32)
  dead = "http://127.0.0.1:1"  # nothing listens on port 1
  servers, urls = _fleet({"feddown": path}, n=1, extra_peers=[dead])
  try:
    port = servers[0].server_address[1]
    dead_keys = [k for k, o in _owned_chunks(path, urls + [dead]).items() if o == dead]
    assert dead_keys
    stored, _ = CloudFiles(path).get_stored(dead_keys[0])
    c0 = metrics.counters_snapshot()
    status, headers, body = _get(port, f"/feddown/{dead_keys[0]}", {"Accept-Encoding": "gzip"})
    assert (status, body, headers["X-Igneous-Cache"]) == (200, stored, "origin")
    c1 = metrics.counters_snapshot()
    assert c1.get("serve.peer.errors", 0) - c0.get("serve.peer.errors", 0) == 1
    assert c1.get("serve.peer.fallback", 0) - c0.get("serve.peer.fallback", 0) == 1
    if len(dead_keys) > 1:
      assert _get(port, f"/feddown/{dead_keys[1]}")[0] == 200
      assert metrics.counters_snapshot().get("serve.peer.errors", 0) == c1.get("serve.peer.errors", 0)
  finally:
    _shutdown(servers)


def test_peer_fill_requests_are_never_reforwarded(rng, tmp_path):
  path = f"file://{tmp_path}/fedloop"
  _seed(path, rng)
  servers, urls = _fleet({"fedloop": path})
  try:
    owner = HashRing(urls).owner("fedloop", CHUNK)
    edge = next(s for s, u in zip(servers, urls) if u != owner)
    c0 = metrics.counters_snapshot()
    status, headers, _ = _get(edge.server_address[1], f"/fedloop/{CHUNK}",
                              {"X-Igneous-Peer-Fill": "http://tester"})
    assert (status, headers["X-Igneous-Cache"]) == (200, "origin")
    assert metrics.counters_snapshot().get("serve.peer.hits", 0) == c0.get("serve.peer.hits", 0)
  finally:
    _shutdown(servers)


# ---------------------------------------------------------------------------
# QoS


def test_qos_weighted_shares_as_the_jax_gate():
  """The same admissions and Retry-After values as the JAX gate, step
  for step, on one clock."""
  clock = [0.0]
  kw = dict(rps=10.0, weights={"hot": 4.0, "cold": 1.0}, burst_sec=1.0,
            layer_names=["hot", "cold"], now_fn=lambda: clock[0])
  gate, ref = QosGate(**kw), jax_federation.QosGate(**kw)
  assert gate.rate_for("hot") == pytest.approx(8.0) and gate.rate_for("cold") == pytest.approx(2.0)
  seq = []
  for step in range(60):
    layer = "hot" if step % 3 else "cold"
    got, want = gate.admit(layer), ref.admit(layer)
    assert got == want
    seq.append(got)
    clock[0] += 0.05
  assert sum(1 for r in seq if r is None) < len(seq)
  assert QosGate.parse_weights("a=2, b=x,c=0,=3,d=1.5") == jax_federation.QosGate.parse_weights(
    "a=2, b=x,c=0,=3,d=1.5") == {"a": 2.0, "d": 1.5}


def test_qos_weighted_shares_unit():
  clock = [0.0]
  gate = QosGate(rps=10.0, weights={"hot": 4.0, "cold": 1.0}, burst_sec=1.0,
                 layer_names=["hot", "cold"], now_fn=lambda: clock[0])
  hot = sum(1 for _ in range(20) if gate.admit("hot") is None)
  cold = sum(1 for _ in range(20) if gate.admit("cold") is None)
  assert (hot, cold) == (8, 2)
  retry = gate.admit("cold")
  assert retry is not None and retry > 0
  clock[0] += retry
  assert gate.admit("cold") is None


def test_shed_returns_503_with_retry_after(rng, tmp_path):
  path = f"file://{tmp_path}/qos"
  _seed(path, rng)
  gate = QosGate(rps=0.5, weights={}, burst_sec=1.0, layer_names=["qos"])
  app = ServeApp({"qos": path}, config=ServeConfig(ram_mb=64.0, synth_mips=False),
                 default_layer="qos", qos=gate)
  srv = ServeServer(app, host="127.0.0.1", port=0)
  try:
    port = srv.server_address[1]
    c0 = metrics.counters_snapshot()
    assert _get(port, f"/{CHUNK}")[0] == 200
    status, headers, _ = _get(port, f"/{CHUNK}")
    assert status == 503 and int(headers["Retry-After"]) >= 1
    c1 = metrics.counters_snapshot()
    assert c1.get("serve.shed.requests", 0) - c0.get("serve.shed.requests", 0) == 1
    assert c1.get("serve.shed.layer.qos", 0) - c0.get("serve.shed.layer.qos", 0) == 1
    assert _get(port, "/healthz")[0] == 200
  finally:
    srv.shutdown()


def test_peer_fills_bypass_admission(rng, tmp_path):
  path = f"file://{tmp_path}/qospeer"
  _seed(path, rng)
  gate = QosGate(rps=0.001, weights={}, burst_sec=1.0, layer_names=["qospeer"])
  app = ServeApp({"qospeer": path}, config=ServeConfig(ram_mb=64.0, synth_mips=False),
                 default_layer="qospeer", qos=gate)
  srv = ServeServer(app, host="127.0.0.1", port=0)
  try:
    port = srv.server_address[1]
    _get(port, f"/{CHUNK}")
    assert _get(port, f"/{CHUNK}")[0] == 503
    assert _get(port, f"/{CHUNK}", {"X-Igneous-Peer-Fill": "http://edge"})[0] == 200
  finally:
    srv.shutdown()


# ---------------------------------------------------------------------------
# invalidation broadcast and membership


def test_invalidation_broadcast_reaches_peers(rng, tmp_path):
  path = f"file://{tmp_path}/fedinv"
  data = _seed(path, rng)
  servers, _urls = _fleet({"fedinv": path})
  try:
    ports = [s.server_address[1] for s in servers]
    etags = [_get(p, f"/{CHUNK}", {"Accept-Encoding": "gzip"})[1]["ETag"] for p in ports]
    assert etags[0] == etags[1]
    # only the broadcast from A (whose hook fires on the upload) reaches B
    chunk_cache.unregister_invalidation_hook(servers[1].app._on_invalidate)
    vol = Volume(path)
    vol.upload(vol.meta.bounds(0), ((data.astype(np.uint16) + 55) % 200).astype(np.uint8), mip=0)
    deadline = time.monotonic() + 10.0
    fresh = None
    while time.monotonic() < deadline:
      _, h, body = _get(ports[1], f"/{CHUNK}", {"Accept-Encoding": "gzip"})
      if h["ETag"] != etags[1]:
        fresh = (h["ETag"], body)
        break
      time.sleep(0.05)
    assert fresh is not None, "the broadcast never reached the peer"
    stored, _ = CloudFiles(path).get_stored(CHUNK)
    assert fresh == (strong_etag(stored), stored)
  finally:
    _shutdown(servers)


def test_file_membership_join_and_graceful_leave(tmp_path):
  mdir = f"file://{tmp_path}/members"
  a = Federation(membership_dir=mdir, ttl_sec=30.0)
  b = jax_serve.Federation(membership_dir=mdir, ttl_sec=30.0)  # a JAX replica joins
  a.activate("http://127.0.0.1:7001")
  b.activate("http://127.0.0.1:7002")
  a.tick(force=True)
  ring = ["http://127.0.0.1:7001", "http://127.0.0.1:7002"]
  assert a.stats()["ring"] == b.stats()["ring"] == ring
  owned_by_b = [k for k in (f"1_1_1/k{i}" for i in range(64))
                if a.owner("L", k) == "http://127.0.0.1:7002"]
  assert owned_by_b and all(b.owner("L", k) is None for k in owned_by_b)
  b.close()
  a.tick(force=True)
  assert a.stats()["ring"] == ["http://127.0.0.1:7001"]
  assert all(a.owner("L", k) is None for k in owned_by_b)
  a.close()
  assert not list(CloudFiles(mdir).list())


def test_stale_heartbeats_age_out(tmp_path):
  mdir = f"file://{tmp_path}/members"
  m = FileMembership(mdir, ttl_sec=0.2)
  m.heartbeat("http://127.0.0.1:7001")
  assert m.poll("http://self") == ("http://127.0.0.1:7001", "http://self")
  time.sleep(0.3)
  assert m.poll("http://self") == ("http://self",)
  assert member_slug("http://a:1") != member_slug("http://a:2")


# ---------------------------------------------------------------------------
# prewarm


def test_prewarm_predicts_and_fills_neighbors(rng, tmp_path):
  path = f"file://{tmp_path}/prewarm"
  _seed(path, rng, chunk=32, size=64)  # 8 chunks of 32^3
  jpath = f"file://{tmp_path}/journal"
  journal.set_active(journal.Journal(jpath, worker_id="serve-t"))
  app = ServeApp({"prewarm": path}, config=ServeConfig(ram_mb=64.0, synth_mips=False),
                 default_layer="prewarm")
  srv = ServeServer(app, host="127.0.0.1", port=0)
  ref_app = jax_serve.ServeApp({"prewarm": path},
                               config=jax_serve.ServeConfig(ram_mb=64.0, synth_mips=False),
                               default_layer="prewarm")
  counts = {"lock": threading.Lock()}
  try:
    port = srv.server_address[1]
    hot = "1_1_1/0-32_0-32_0-32"
    for _ in range(3):
      assert _get(port, f"/{hot}")[0] == 200
    journal.flush_active("test")
    records = list(journal.read_records(jpath))
    pw = Prewarmer(app, interval_sec=0.0, top=4, budget=16)
    ref = jax_federation.Prewarmer(ref_app, interval_sec=0.0, top=4, budget=16)
    mined = pw.mine(records)
    assert mined == ref.mine(records) and mined.get(("prewarm", hot), 0) >= 3
    predicted = pw.predict(mined)
    assert predicted == ref.predict(mined)
    neighbors = {"1_1_1/32-64_0-32_0-32", "1_1_1/0-32_32-64_0-32", "1_1_1/0-32_0-32_32-64"}
    assert neighbors <= {k for _, k in predicted} and ("prewarm", hot) not in predicted
    stats = pw.cycle()
    assert stats["fetched"] >= 3
    set_backend_wrapper(lambda b, pth: _CountingBackend(b, counts, 0.0))
    for key in neighbors:
      status, headers, _ = _get(port, f"/{key}")
      assert (status, headers["X-Igneous-Cache"]) == (200, "ram")
    assert not any(k.startswith("1_1_1/") for k in counts if k != "lock")
  finally:
    srv.shutdown()
    ref_app.close()


def test_prewarm_zoom_children(rng, tmp_path):
  path = f"file://{tmp_path}/pwzoom"
  JaxVolume.from_numpy(rng.integers(0, 200, (64, 64, 64)).astype(np.uint8), path,
                       chunk_size=(32, 32, 32))
  LocalTaskQueue(parallel=1).insert(tc.create_downsampling_tasks(
    path, num_mips=1, memory_target=16 * 1024 * 1024))
  app = ServeApp({"pwzoom": path}, config=ServeConfig(ram_mb=64.0, synth_mips=False),
                 default_layer="pwzoom")
  try:
    meta = app.layer("pwzoom").try_meta()
    mip1_key = f"{meta.key(1)}/0-32_0-32_0-32"
    predicted = Prewarmer(app, interval_sec=0.0, top=4, budget=16).predict(
      {("pwzoom", mip1_key): 5})
    children = sorted(k for _, k in predicted if k.startswith(f"{meta.key(0)}/"))
    assert children == [
      f"{meta.key(0)}/0-32_0-32_0-32", f"{meta.key(0)}/0-32_32-64_0-32",
      f"{meta.key(0)}/32-64_0-32_0-32", f"{meta.key(0)}/32-64_32-64_0-32",
    ]
  finally:
    app.close()


# ---------------------------------------------------------------------------
# health and the fed endpoints


def _fleet_counters(now, counters):
  return [{"kind": "counters", "worker": "serve-0", "ts": now - 10, "event": "interval",
           "counters": counters}]


@pytest.mark.parametrize("counters,flagged", [
  ({"serve.requests": 100, "serve.peer.hits": 2, "serve.peer.fallback": 10,
    "serve.peer.notfound": 0, "serve.shed.requests": 60}, True),
  ({"serve.requests": 100, "serve.peer.hits": 50, "serve.peer.fallback": 1,
    "serve.shed.requests": 2}, False),
])
def test_health_peer_fill_storm_and_shed_rate(counters, flagged):
  now = time.time()
  rep = health.HealthEngine(health.HealthConfig(window_sec=600.0)).evaluate(
    _fleet_counters(now, counters), now=now)
  want = jax_health.HealthEngine(jax_health.HealthConfig(window_sec=600.0)).evaluate(
    _fleet_counters(now, counters), now=now)
  assert json.dumps(rep, sort_keys=True) == json.dumps(want, sort_keys=True)
  kinds = {a["kind"] for a in rep["anomalies"]}
  assert ({"peer_fill_storm", "shed_rate_slo"} <= kinds) == flagged
  assert not flagged or "peer_fill_storm" in "\n".join(health.check_lines(rep))


def test_fed_status_and_invalidate_endpoint_auth(rng, tmp_path):
  path = f"file://{tmp_path}/fedep"
  _seed(path, rng)
  servers, urls = _fleet({"fedep": path}, n=1)
  try:
    port = servers[0].server_address[1]
    status, _, body = _get(port, "/-/fed/status")
    assert status == 200 and json.loads(body)["self"] == urls[0]
    assert _get(port, "/-/fed/invalidate?layer=fedep", method="POST")[0] == 403
    peer = {"X-Igneous-Peer-Fill": "http://peer"}
    assert _get(port, "/-/fed/invalidate?layer=fedep", peer, method="POST")[0] == 204
    assert _get(port, "/-/fed/invalidate?layer=nope", peer, method="POST")[0] == 404
    assert _get(port, "/-/fed/invalidate?layer=fedep&mip=x", peer, method="POST")[0] == 400
  finally:
    _shutdown(servers)
