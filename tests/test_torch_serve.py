"""The port's serving tier against the JAX package's, over HTTP on
localhost: each case of ``tests/test_serve.py`` runs on the port, and
where the JAX package answers the same request its answer is the
reference.

Served bytes and headers for each layer type, encoding and compression
(with and without ``Accept-Encoding: gzip``); the ETag of either package's
server for one object; SSD spill restarts within the port and across the
packages both ways; a corrupt spill and a corrupt origin object never
served nor cached; coalescing (N clients, one backend fetch); the RAM hit
path touching neither storage nor a codec; synthesized mips equal to the
port's offline ``DownsampleTask`` and to the JAX package's synthesized
bytes (image average and uint64 segmentation mode, walks of several
levels with mixed (2,2,1) and (2,2,2) factors, odd extents), with
write-back; 8 concurrent clients on distinct missing chunks equal to a
sequential run; traversal, ``/healthz`` and ``/metrics``; journal traces
equal to the JAX package's without the fields that name a run; the health
engine's serve detectors and Perfetto's serve track on the same records;
the invalidation hooks. The comparisons are exact.
"""

import gzip
import http.client
import json
import os
import threading

import numpy as np
import pytest

import igneous_tpu.tasks  # noqa: F401  (registers the JAX package's tasks)
from igneous_tpu import Volume as JaxVolume
from igneous_tpu import chunk_cache as jax_chunk_cache
from igneous_tpu import serve as jax_serve
from igneous_tpu import task_creation as jax_tc
from igneous_tpu.observability import health as jax_health
from igneous_tpu.observability import journal as jax_journal
from igneous_tpu.observability import perfetto as jax_perfetto
from igneous_tpu.observability import trace as jax_trace
from igneous_tpu.queues import LocalTaskQueue as JaxQueue
from igneous_tpu.storage import set_backend_wrapper as jax_set_backend_wrapper
from igneous_tpu_torch import Volume, chunk_cache, device, serve
from igneous_tpu_torch import task_creation as tc
from igneous_tpu_torch.observability import fleet, health, journal, metrics, perfetto, trace
from igneous_tpu_torch.ops import cuda_pooling
from igneous_tpu_torch.queues import LocalTaskQueue
from igneous_tpu_torch.storage import CloudFiles, set_backend_wrapper

from test_torch_integrity import flush_local

CHUNK = "1_1_1/0-64_0-64_0-64"
# fields of a journal record that name a run, not what it did
RUN_FIELDS = ("ts", "dur", "span", "trace", "parent", "worker", "segment", "exec_span_id")


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
  """(status, headers, body) over a fresh connection."""
  conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
  try:
    conn.request(method, path, headers=headers or {})
    resp = conn.getresponse()
    return resp.status, dict(resp.getheaders()), resp.read()
  finally:
    conn.close()


def _serve(pkg, layers, **cfg_kw):
  """A server of ``pkg`` (the port's ``serve`` or ``jax_serve``) on
  127.0.0.1, synthesis off unless asked for."""
  config = pkg.ServeConfig(**{"ram_mb": 64.0, "synth_mips": False, **cfg_kw})
  default = next(iter(layers)) if len(layers) == 1 else None
  app = pkg.ServeApp(dict(layers), config=config, default_layer=default)
  return pkg.ServeServer(app, host="127.0.0.1", port=0)


class _Both:
  """A port server and a JAX server over the same layers."""

  def __init__(self, layers, **cfg_kw):
    self.port = _serve(serve, layers, **cfg_kw)
    self.jax = _serve(jax_serve, layers, **cfg_kw)

  def get(self, path, headers=None):
    """The port's answer, after holding it equal to the JAX server's."""
    got = _get(self.port.server_address[1], path, headers)
    want = _get(self.jax.server_address[1], path, headers)
    assert got == want, (path, got[:2], want[:2])
    return got

  def shutdown(self):
    self.port.shutdown()
    self.jax.shutdown()


def _seed(path, rng, layer_type="image", encoding="raw", compress="gzip"):
  dtype = np.uint8 if layer_type == "image" else np.uint32
  data = rng.integers(0, 200, (64, 64, 64)).astype(dtype)
  JaxVolume.from_numpy(data, path, chunk_size=(64, 64, 64), layer_type=layer_type,
                       encoding=encoding, compress=compress)
  return data


# ---------------------------------------------------------------------------
# bytes and headers


@pytest.mark.parametrize("layer_type,encoding,compress", [
  ("image", "raw", None),
  ("image", "raw", "gzip"),
  ("segmentation", "compressed_segmentation", "gzip"),
])
def test_served_bytes_identity(rng, tmp_path, layer_type, encoding, compress):
  path = f"file://{tmp_path}/ident"
  _seed(path, rng, layer_type, encoding, compress)
  cf = CloudFiles(path)
  stored, method = cf.get_stored(CHUNK)
  logical = cf.get(CHUNK)
  both = _Both({"ident": path})
  try:
    status, headers, body = both.get(f"/{CHUNK}", {"Accept-Encoding": "gzip"})
    assert status == 200
    if method == "gzip":
      assert headers.get("Content-Encoding") == "gzip"
      assert body == stored and gzip.decompress(body) == logical
    else:
      assert "Content-Encoding" not in headers
      assert body == stored == logical
    status, headers, body = both.get(f"/{CHUNK}")
    assert status == 200 and "Content-Encoding" not in headers and body == logical
    # the second request of each kind is a RAM hit on both servers
    assert both.get(f"/{CHUNK}")[1]["X-Igneous-Cache"] == "ram"
  finally:
    both.shutdown()


def test_info_content_type_and_index(rng, tmp_path):
  path = f"file://{tmp_path}/ct"
  _seed(path, rng)
  both = _Both({"ct": path})
  try:
    status, headers, body = both.get("/info")
    assert status == 200 and headers["Content-Type"] == "application/json"
    assert json.loads(body)["type"] == "image"
    _, headers, body = both.get(f"/{CHUNK}")
    assert headers["Content-Type"] == "application/octet-stream"
    status, _, body2 = both.get(f"/ct/{CHUNK}")
    assert status == 200 and body2 == body
    status, _, index = both.get("/")
    assert json.loads(index) == {"layers": {"ct": path}}
  finally:
    both.shutdown()


# ---------------------------------------------------------------------------
# ETags and the SSD spill


def test_etag_restart_stability_and_overwrite(rng, tmp_path):
  path = f"file://{tmp_path}/etag"
  _seed(path, rng)
  ssd = str(tmp_path / "spill")
  srv = _serve(serve, {"etag": path}, ssd_dir=ssd, ssd_mb=64.0)
  try:
    port = srv.server_address[1]
    _, h1, b1 = _get(port, f"/{CHUNK}", {"Accept-Encoding": "gzip"})
    etag1 = h1["ETag"]
    assert etag1 == serve.strong_etag(b1) == jax_serve.strong_etag(b1)
    status, h304, body = _get(port, f"/{CHUNK}", {
      "Accept-Encoding": "gzip", "If-None-Match": etag1})
    assert status == 304 and body == b"" and h304["ETag"] == etag1
    assert "max-age" in h1["Cache-Control"]
  finally:
    srv.shutdown()

  srv = _serve(serve, {"etag": path}, ssd_dir=ssd, ssd_mb=64.0)
  try:
    port = srv.server_address[1]
    _, h2, b2 = _get(port, f"/{CHUNK}", {"Accept-Encoding": "gzip"})
    assert h2["ETag"] == etag1 and b2 == b1 and h2["X-Igneous-Cache"] == "ssd"
    # an overwrite through the port's Volume drops the served entry
    vol = Volume(path)
    newdata = (rng.integers(0, 200, (64, 64, 64)) + 55).astype(np.uint8)
    vol.upload(vol.meta.bounds(0), newdata, mip=0)
    _, h3, b3 = _get(port, f"/{CHUNK}", {"Accept-Encoding": "gzip"})
    stored, _ = CloudFiles(path).get_stored(CHUNK)
    assert h3["ETag"] != etag1 and b3 == stored
    assert h3["ETag"] == jax_serve.strong_etag(stored)
  finally:
    srv.shutdown()


def test_ssd_spill_roundtrip_identity(rng, tmp_path):
  path = f"file://{tmp_path}/spill"
  _seed(path, rng)
  stored, _ = CloudFiles(path).get_stored(CHUNK)
  srv = _serve(serve, {"spill": path}, ram_mb=0.0, ssd_dir=str(tmp_path / "spill_dir"),
               ssd_mb=64.0)
  try:
    port = srv.server_address[1]
    _, h1, b1 = _get(port, f"/{CHUNK}", {"Accept-Encoding": "gzip"})
    _, h2, b2 = _get(port, f"/{CHUNK}", {"Accept-Encoding": "gzip"})
    assert (h1["X-Igneous-Cache"], h2["X-Igneous-Cache"]) == ("origin", "ssd")
    assert b1 == b2 == stored
  finally:
    srv.shutdown()


def _spill_tree(root):
  out = {}
  for dirpath, _dirs, files in os.walk(root):
    for name in files:
      full = os.path.join(dirpath, name)
      out[os.path.relpath(full, root)] = open(full, "rb").read()
  return out


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_ssd_spill_restarts_across_packages(rng, tmp_path, writer, reader):
  """Either package's server re-serves the other's spill directory: the
  same layout, the same bytes, the same ETags, from the SSD tier."""
  pkgs = {"port": serve, "jax": jax_serve}
  path = f"file://{tmp_path}/cross"
  data = rng.integers(0, 200, (128, 64, 64)).astype(np.uint8)
  JaxVolume.from_numpy(data, path, chunk_size=(64, 64, 64), compress="gzip")
  keys = ["1_1_1/0-64_0-64_0-64", "1_1_1/64-128_0-64_0-64"]
  ssd = {side: str(tmp_path / f"spill_{side}") for side in pkgs}
  first = {}
  for side, pkg in pkgs.items():
    srv = _serve(pkg, {"cross": path}, ram_mb=0.0, ssd_dir=ssd[side], ssd_mb=64.0)
    try:
      first[side] = [_get(srv.server_address[1], f"/{k}", {"Accept-Encoding": "gzip"})
                     for k in keys]
    finally:
      srv.shutdown()
  assert [(s, h["ETag"], b) for s, h, b in first["port"]] == [
    (s, h["ETag"], b) for s, h, b in first["jax"]]
  assert _spill_tree(ssd["port"]) == _spill_tree(ssd["jax"])  # one layout

  # every read must come off the writer's spill: the origin goes away
  for k in keys:
    os.remove(os.path.join(str(tmp_path), "cross", k + ".gz"))
  srv = _serve(pkgs[reader], {"cross": path}, ram_mb=0.0, ssd_dir=ssd[writer], ssd_mb=64.0)
  try:
    for k, (status, headers, body) in zip(keys, first[writer]):
      s2, h2, b2 = _get(srv.server_address[1], f"/{k}", {"Accept-Encoding": "gzip"})
      assert (s2, h2["X-Igneous-Cache"], h2["ETag"], b2) == (
        status, "ssd", headers["ETag"], body)
  finally:
    srv.shutdown()


def test_ssd_restart_spot_verify_evicts_corrupt_spill(rng, tmp_path):
  path = f"file://{tmp_path}/ssdverify"
  _seed(path, rng)
  stored, _ = CloudFiles(path).get_stored(CHUNK)
  ssd = str(tmp_path / "spill")
  srv = _serve(serve, {"sv": path}, ram_mb=0.0, ssd_dir=ssd, ssd_mb=64.0)
  try:
    port = srv.server_address[1]
    _get(port, f"/{CHUNK}", {"Accept-Encoding": "gzip"})
    assert _get(port, f"/{CHUNK}", {"Accept-Encoding": "gzip"})[1]["X-Igneous-Cache"] == "ssd"
  finally:
    srv.shutdown()
  spilled = list(_spill_tree(ssd))
  assert spilled
  for rel in spilled:
    full = os.path.join(ssd, rel)
    raw = open(full, "rb").read()
    with open(full, "wb") as f:
      f.write(raw[: max(1, len(raw) // 2)])
  before = metrics.counters_snapshot().get("serve.cache.ssd.verify_failed", 0)
  srv = _serve(serve, {"sv": path}, ram_mb=0.0, ssd_dir=ssd, ssd_mb=64.0)
  try:
    port = srv.server_address[1]
    status, h1, b1 = _get(port, f"/{CHUNK}", {"Accept-Encoding": "gzip"})
    assert status == 200 and b1 == stored and h1["X-Igneous-Cache"] == "origin"
    assert metrics.counters_snapshot()["serve.cache.ssd.verify_failed"] > before
    _, h2, b2 = _get(port, f"/{CHUNK}", {"Accept-Encoding": "gzip"})
    assert h2["X-Igneous-Cache"] == "ssd" and b2 == stored
  finally:
    srv.shutdown()


def test_corrupt_origin_chunk_is_404_not_cached(rng, tmp_path):
  path = f"file://{tmp_path}/fillguard"
  _seed(path, rng)
  cf = CloudFiles(path)
  stored, method = cf.get_stored(CHUNK)
  assert method == "gzip"
  cf.put_stored(CHUNK, stored[: len(stored) // 2], "gzip")  # a torn origin
  both = _Both({"fg": path})
  try:
    before = metrics.counters_snapshot().get("serve.fetch.corrupt", 0)
    status, _, _ = both.get(f"/{CHUNK}", {"Accept-Encoding": "gzip"})
    assert status == 404
    assert metrics.counters_snapshot()["serve.fetch.corrupt"] == before + 1
    assert cf.exists(f"integrity/quarantine/{CHUNK}.gz") or any(
      "quarantine" in k for k in cf.list("integrity/"))
    cf.put_stored(CHUNK, stored, "gzip")  # the origin healed
    status, _, body = both.get(f"/{CHUNK}", {"Accept-Encoding": "gzip"})
    assert status == 200 and body == stored
  finally:
    both.shutdown()


# ---------------------------------------------------------------------------
# coalescing and the hot path


class _CountingBackend:
  def __init__(self, inner, counts, delay):
    self._inner, self._counts, self._delay = inner, counts, delay

  def get(self, key):
    import time

    with self._counts["lock"]:
      self._counts[key] = self._counts.get(key, 0) + 1
    time.sleep(self._delay)
    return self._inner.get(key)

  def __getattr__(self, name):
    return getattr(self._inner, name)


def _herd(port, paths, headers=None):
  """Each of ``paths`` requested by its own client thread, all released
  together; the answers in order."""
  barrier = threading.Barrier(len(paths))
  out = [None] * len(paths)

  def client(i):
    barrier.wait()
    out[i] = _get(port, paths[i], headers)

  threads = [threading.Thread(target=client, args=(i,)) for i in range(len(paths))]
  for t in threads:
    t.start()
  for t in threads:
    t.join()
  return out


def test_single_flight_coalescing(rng, tmp_path):
  path = f"file://{tmp_path}/herd"
  _seed(path, rng, compress=None)  # one fetch is one get
  counts = {"lock": threading.Lock()}
  set_backend_wrapper(lambda b, pth: _CountingBackend(b, counts, 0.25))
  srv = _serve(serve, {"herd": path})
  try:
    answers = _herd(srv.server_address[1], [f"/{CHUNK}"] * 8)
    assert counts.get(CHUNK, 0) == 1, counts
    expect = CloudFiles(path).get(CHUNK)
    assert all(status == 200 and body == expect for status, _, body in answers)
    tiers = sorted(h["X-Igneous-Cache"] for _, h, _ in answers)
    assert tiers.count("origin") == 1
  finally:
    srv.shutdown()


def test_hot_hit_zero_decode_zero_storage(rng, tmp_path, monkeypatch):
  path = f"file://{tmp_path}/hot"
  _seed(path, rng)
  srv = _serve(serve, {"hot": path})
  try:
    port = srv.server_address[1]
    _, _, warm = _get(port, f"/{CHUNK}", {"Accept-Encoding": "gzip"})
    from igneous_tpu_torch.serve import app as app_mod

    def boom(*a, **kw):
      raise AssertionError("hot path touched storage or a codec")

    monkeypatch.setattr(app_mod.ServeApp, "_fetch_blocking", boom)
    monkeypatch.setattr(app_mod, "decompress_bytes", boom)
    status, headers, body = _get(port, f"/{CHUNK}", {"Accept-Encoding": "gzip"})
    assert (status, headers["X-Igneous-Cache"], body) == (200, "ram", warm)
  finally:
    srv.shutdown()


# ---------------------------------------------------------------------------
# mip synthesis


def _offline_and_served(tmp_path, data, layer_type, chunk, num_mips, factor=None,
                        encoding="raw"):
  """Three layers of ``data`` written by the JAX package: ``offline`` and
  ``jax_offline`` downsampled by each package's ``DownsampleTask``s, and
  ``served`` with the same scales and its mips above 0 deleted. Returns
  (paths, mip > 0 chunk keys)."""
  paths = {n: f"file://{tmp_path}/{n}" for n in ("offline", "jax_offline", "served")}
  for name, path in paths.items():
    JaxVolume.from_numpy(data, path, chunk_size=chunk, layer_type=layer_type,
                         encoding=encoding, resolution=(8, 8, 40) if factor is None else (8, 8, 8))
  kw = dict(num_mips=num_mips, memory_target=16 * 1024 * 1024)
  if factor is not None:
    kw["factor"] = factor
  LocalTaskQueue(parallel=1).insert(tc.create_downsampling_tasks(paths["offline"], **kw))
  JaxQueue(parallel=1, progress=False).insert(
    jax_tc.create_downsampling_tasks(paths["jax_offline"], **kw))
  LocalTaskQueue(parallel=1).insert(tc.create_downsampling_tasks(paths["served"], **kw))
  vol = Volume(paths["served"])
  keys = []
  for mip in range(1, vol.meta.num_mips):
    mine = sorted(vol.cf.list(f"{vol.meta.key(mip)}/"))
    assert mine
    keys += mine
  for k in keys:
    vol.cf.delete(k)
  return paths, keys


SYNTH_CASES = {
  # the JAX test's layer: one level of 2x2x1 (resolution 8x8x40)
  "image_one_level": dict(shape=(64, 64, 64), dtype=np.uint8, layer_type="image",
                          chunk=(32, 32, 32), num_mips=1),
  # odd extents, a walk of three levels
  "image_odd_three_levels": dict(shape=(201, 141, 20), dtype=np.uint8, layer_type="image",
                                 chunk=(32, 32, 16), num_mips=3),
  # mixed factors: (2,2,1) twice then (2,2,2), resolution 8x8x40 -> 32x32x80
  "image_mixed_factors": dict(shape=(150, 130, 40), dtype=np.uint8, layer_type="image",
                              chunk=(16, 16, 8), num_mips=3,
                              factor=[(2, 2, 1), (2, 2, 1), (2, 2, 2)]),
  # uint64 labels at or above 2^63 by mode, compressed_segmentation
  "segmentation_mode_cseg": dict(shape=(97, 83, 12), dtype=np.uint64,
                                 layer_type="segmentation", chunk=(16, 16, 12),
                                 num_mips=2, encoding="compressed_segmentation"),
}


def _synth_data(case, rng):
  c = SYNTH_CASES[case]
  if c["dtype"] == np.uint64:
    blocks = rng.integers(0, 5, [(s + 2) // 3 for s in c["shape"]]).astype(np.uint64)
    blocks = blocks * np.uint64(2**62 + 11) + np.uint64(2**40)
    data = blocks.repeat(3, 0).repeat(3, 1).repeat(3, 2)
    data = data[:c["shape"][0], :c["shape"][1], :c["shape"][2]]
  else:
    data = rng.integers(0, 255, c["shape"]).astype(c["dtype"])
  return np.asfortranarray(data)


@pytest.mark.parametrize("case", list(SYNTH_CASES))
def test_synth_mip_matches_offline_downsample(rng, tmp_path, case):
  """Each synthesized chunk: the port's offline DownsampleTask's stored
  bytes, the JAX package's offline bytes, and the JAX server's synthesis
  of the same layer; the port's pooling kernels' plain versions ran."""
  c = SYNTH_CASES[case]
  factor = c.get("factor")
  paths, keys = _offline_and_served(tmp_path, _synth_data(case, rng), c["layer_type"],
                                    c["chunk"], c["num_mips"], factor=factor,
                                    encoding=c.get("encoding", "raw"))
  offline, jax_offline = CloudFiles(paths["offline"]), CloudFiles(paths["jax_offline"])
  both = _Both({"synth": paths["served"]}, synth_mips=True)
  try:
    for key in keys:
      want, method = offline.get_stored(key)
      assert jax_offline.get_stored(key) == (want, method)
      status, headers, body = both.get(f"/{key}", {"Accept-Encoding": "gzip"})
      assert status == 200, key
      assert headers.get("Content-Encoding") == method
      assert body == want, f"synthesized {key} != the offline DownsampleTask's"
    assert not any(CloudFiles(paths["served"]).list(f"{Volume(paths['served']).meta.key(1)}/"))
  finally:
    both.shutdown()


def test_synth_walk_labels_mips_in_the_ledger(rng, tmp_path):
  """A synthesized chunk of mip 3 walks from mip 0 as one pyramid whose
  execute span names the levels."""
  c = SYNTH_CASES["image_odd_three_levels"]
  paths, keys = _offline_and_served(tmp_path, _synth_data("image_odd_three_levels", rng),
                                    c["layer_type"], c["chunk"], c["num_mips"])
  key = next(k for k in keys if k.startswith(Volume(paths["served"]).meta.key(3)))
  trace.reset()
  srv = _serve(serve, {"s": paths["served"]}, synth_mips=True)
  try:
    assert _get(srv.server_address[1], f"/{key}")[0] == 200
  finally:
    srv.shutdown()
  walks = [s for s in trace.drain_spans() if s.get("kernel") == "pooling.fused_pyramid[average]"]
  assert [(s["mip_from"], s["mip_to"]) for s in walks] == [(0, 3)]


def test_synth_writeback_persists(rng, tmp_path):
  c = SYNTH_CASES["image_odd_three_levels"]
  paths, keys = _offline_and_served(tmp_path, _synth_data("image_odd_three_levels", rng),
                                    c["layer_type"], c["chunk"], c["num_mips"])
  srv = _serve(serve, {"wb": paths["served"]}, synth_mips=True, writeback=True)
  try:
    for key in keys[:3] + keys[-2:]:
      status, _, body = _get(srv.server_address[1], f"/{key}", {"Accept-Encoding": "gzip"})
      assert status == 200
      stored, method = CloudFiles(paths["served"]).get_stored(key)
      assert method == "gzip" and body == stored
      assert stored == CloudFiles(paths["offline"]).get_stored(key)[0]
  finally:
    srv.shutdown()


def test_synth_off_gives_404(rng, tmp_path):
  c = SYNTH_CASES["image_one_level"]
  paths, keys = _offline_and_served(tmp_path, _synth_data("image_one_level", rng),
                                    c["layer_type"], c["chunk"], c["num_mips"])
  both = _Both({"off": paths["served"]}, synth_mips=False)
  try:
    assert both.get(f"/{keys[0]}")[0] == 404
  finally:
    both.shutdown()


def test_concurrent_synthesis_equals_sequential(rng, tmp_path):
  """12 clients at once on distinct missing chunks of three mips: the
  bytes and ETags of one client at a time, and the offline task's."""
  c = SYNTH_CASES["image_odd_three_levels"]
  paths, keys = _offline_and_served(tmp_path, _synth_data("image_odd_three_levels", rng),
                                    c["layer_type"], c["chunk"], c["num_mips"])
  meta = Volume(paths["served"]).meta
  picked = [k for m, n in ((1, 5), (2, 5), (3, 2))
            for k in [x for x in keys if x.startswith(meta.key(m) + "/")][:n]]
  assert len(picked) == 12 and len(set(picked)) == 12
  hdr = {"Accept-Encoding": "gzip"}
  srv = _serve(serve, {"c": paths["served"]}, synth_mips=True)
  try:
    concurrent = _herd(srv.server_address[1], [f"/{k}" for k in picked], hdr)
  finally:
    srv.shutdown()
  srv = _serve(serve, {"c": paths["served"]}, synth_mips=True)
  try:
    sequential = [_get(srv.server_address[1], f"/{k}", hdr) for k in picked]
  finally:
    srv.shutdown()
  offline = CloudFiles(paths["offline"])
  for k, (s1, h1, b1), (s2, h2, b2) in zip(picked, concurrent, sequential):
    assert s1 == s2 == 200 and b1 == b2 == offline.get_stored(k)[0], k
    assert h1["ETag"] == h2["ETag"] and h1["X-Igneous-Cache"] == "origin"


# ---------------------------------------------------------------------------
# HTTP semantics, endpoints


def test_traversal_forbidden_and_missing_404(rng, tmp_path):
  (tmp_path / "secret.txt").write_text("nope")
  layer = f"file://{tmp_path / 'layer'}"
  JaxVolume.from_numpy(rng.integers(0, 200, (64, 64, 64)).astype(np.uint8), layer,
                       chunk_size=(64, 64, 64))
  both = _Both({"layer": layer})
  try:
    for srv in (both.port, both.jax):
      conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=30)
      conn.putrequest("GET", "/../secret.txt", skip_host=True)
      conn.putheader("Host", "localhost")
      conn.endheaders()
      resp = conn.getresponse()
      body = resp.read()
      conn.close()
      assert resp.status == 403 and b"nope" not in body
    assert both.get("/1_1_1/64-128_0-64_0-64")[0] == 404
    assert both.get("/info", {"Range": "bytes=2-9"})[0] == 206
  finally:
    both.shutdown()


def test_healthz_and_metrics_endpoints(rng, tmp_path):
  path = f"file://{tmp_path}/hz"
  _seed(path, rng)
  both = _Both({"hz": path})
  try:
    both.get(f"/{CHUNK}")
    status, _, body = both.get("/healthz")
    hz = json.loads(body)
    assert status == 200 and hz["ok"] and hz["layers"] == ["hz"]
    status, headers, body = _get(both.port.server_address[1], "/metrics")
    text = body.decode("utf8")
    assert status == 200 and headers["Content-Type"].startswith("text/plain")
    assert "igneous_serve_requests_total" in text
    assert "igneous_serve_request_seconds" in text
    both.port.app.update_gauges()
    gauges = metrics.gauges_snapshot()
    assert "serve.p99_ms" in gauges and gauges["serve.hit_ratio_ram"] > 0
  finally:
    both.shutdown()


# ---------------------------------------------------------------------------
# traces, health, Perfetto


def _spans(records):
  out = []
  for r in records:
    if r.get("kind") != "span" or not str(r.get("name", "")).startswith(("serve.", "storage.")):
      continue
    out.append({k: v for k, v in r.items() if k not in RUN_FIELDS})
  return sorted(out, key=lambda r: json.dumps(r, sort_keys=True))


def test_requests_mint_traces_into_journal(rng, tmp_path):
  path = f"file://{tmp_path}/traced"
  _seed(path, rng)
  recs = {}
  for side, pkg, jmod, tmod in (("port", serve, journal, trace),
                                ("jax", jax_serve, jax_journal, jax_trace)):
    tmod.reset()
    jpath = f"file://{tmp_path}/journal_{side}"
    jmod.set_active(jmod.Journal(jpath, worker_id="serve-t"))
    srv = _serve(pkg, {"traced": path})
    try:
      port = srv.server_address[1]
      _get(port, f"/{CHUNK}", {"Accept-Encoding": "gzip"})  # origin
      _get(port, f"/{CHUNK}", {"Accept-Encoding": "gzip"})  # ram
    finally:
      srv.shutdown()  # the drain flushes the journal
    jmod.set_active(None)
    recs[side] = list(jmod.read_records(jpath))
  assert _spans(recs["port"]) == _spans(recs["jax"])
  reqs = [s for s in recs["port"] if s.get("name") == "serve.request"]
  assert {s.get("tier") for s in reqs} == {"origin", "ram"}
  origin = next(s for s in reqs if s["tier"] == "origin")
  tree = fleet.trace_records(recs["port"], origin["trace"])
  assert {"serve.request", "serve.fetch"} <= {s["name"] for s in tree}
  assert fleet.render_trace(tree)
  merged = {}
  for rec in recs["port"]:
    if rec.get("kind") == "counters":
      merged.update(rec.get("counters") or {})
  assert merged.get("serve.requests", 0) >= 2 and merged.get("serve.cache.ram.hits", 0) >= 1


def _serve_records(now):
  records = []
  for i in range(60):
    for name, dur in (("serve.request", 0.9), ("serve.fetch", 0.8)):
      records.append({"kind": "span", "name": name, "worker": "s1",
                      "ts": now - 10 - i * 0.01, "dur": dur, "trace": f"t{i}",
                      "layer": "l"})
  return records


def test_health_engine_serve_detectors():
  now = 1000.0
  kw = dict(serve_p99_ms=100.0, serve_miss_ratio_max=0.5, serve_min_requests=10)
  report = health.HealthEngine(health.HealthConfig(**kw)).evaluate(_serve_records(now), now=now)
  want = jax_health.HealthEngine(jax_health.HealthConfig(**kw)).evaluate(
    _serve_records(now), now=now)
  assert json.dumps(report, sort_keys=True) == json.dumps(want, sort_keys=True)
  assert report["serve"]["requests"] == 60 and report["serve"]["miss_ratio"] == 1.0
  assert {"cold_miss_storm", "serve_latency_slo"} <= {a["kind"] for a in report["anomalies"]}
  assert health.check_lines(report) == jax_health.check_lines(want)


def test_perfetto_serve_track_of_the_port_server(rng, tmp_path):
  """The port server's journaled spans render on Perfetto's serve track,
  as the JAX package renders the same records."""
  path = f"file://{tmp_path}/pf"
  _seed(path, rng)
  trace.reset()
  jpath = f"file://{tmp_path}/journal"
  journal.set_active(journal.Journal(jpath, worker_id="serve-p"))
  srv = _serve(serve, {"pf": path})
  try:
    _get(srv.server_address[1], f"/{CHUNK}")
  finally:
    srv.shutdown()
  journal.set_active(None)
  recs = list(journal.read_records(jpath))
  doc = perfetto.chrome_trace(recs)
  assert json.dumps(doc, sort_keys=True) == json.dumps(jax_perfetto.chrome_trace(recs),
                                                       sort_keys=True)
  names = [e["args"]["name"] for e in doc["traceEvents"]
           if e.get("ph") == "M" and e["name"] == "thread_name"]
  assert "serve pf" in names


# ---------------------------------------------------------------------------
# the shared invalidation entry point


def test_invalidation_hook_fires_without_shared_cache():
  calls = []
  hook = lambda path, mip: calls.append((path, mip))  # noqa: E731
  chunk_cache.register_invalidation_hook(hook)
  try:
    chunk_cache.invalidate("mem://x/layer", 2)
    assert calls == [("mem://x/layer", 2)]
  finally:
    chunk_cache.unregister_invalidation_hook(hook)
  chunk_cache.invalidate("mem://x/layer", 3)
  assert len(calls) == 1


def test_invalidation_hook_exception_contained():
  def bad(path, mip):
    raise RuntimeError("hook bug")

  chunk_cache.register_invalidation_hook(bad)
  try:
    before = metrics.counters_snapshot().get("chunk_cache.hook_failed", 0)
    chunk_cache.invalidate("mem://x/layer", 0)
    assert metrics.counters_snapshot().get("chunk_cache.hook_failed", 0) == before + 1
  finally:
    chunk_cache.unregister_invalidation_hook(bad)


def test_closed_app_unregisters_its_hook(rng, tmp_path):
  path = f"file://{tmp_path}/hook"
  _seed(path, rng)
  srv = _serve(serve, {"hook": path})
  app = srv.app
  assert app._on_invalidate in chunk_cache._INVALIDATION_HOOKS
  srv.shutdown()
  assert app._on_invalidate not in chunk_cache._INVALIDATION_HOOKS


def test_synthesis_launches_pooling_on_the_port_device(rng, tmp_path, monkeypatch):
  """On the CPU the walk runs the kernels' plain versions through the
  wrappers, which count no launch; a CUDA tensor would launch."""
  calls = []
  real = cuda_pooling.pyramid2x2x1

  def spy(x, *a, **kw):
    calls.append(x.device.type)
    return real(x, *a, **kw)

  c = SYNTH_CASES["image_one_level"]
  paths, keys = _offline_and_served(tmp_path, _synth_data("image_one_level", rng),
                                    c["layer_type"], c["chunk"], c["num_mips"])
  monkeypatch.setattr(cuda_pooling, "pyramid2x2x1", spy)
  before = dict(cuda_pooling.LAUNCHES)
  srv = _serve(serve, {"d": paths["served"]}, synth_mips=True)
  try:
    assert _get(srv.server_address[1], f"/{keys[0]}")[0] == 200
  finally:
    srv.shutdown()
  assert calls == ["cpu"] and cuda_pooling.LAUNCHES == before
