"""The port's chunk decode cache against the JAX package's.

Each scenario runs on both packages' ``chunk_cache`` and ``Volume`` where
their interfaces agree: a hit returns an equal, read-only array; a chunk
overwritten behind the cache misses (the key holds a digest of the stored
bytes); ``upload`` invalidates its (path, mip); the LRU evicts at its byte
budget; ``IGNEOUS_CHUNK_CACHE=off`` bypasses it with equal reads; and a
corrupt chunk raises and is never stored.
"""

import gzip

import numpy as np
import pytest

import igneous_tpu.chunk_cache as jax_chunk_cache
import igneous_tpu.telemetry as jax_telemetry
from igneous_tpu import Volume as JaxVolume
from igneous_tpu.lib import Bbox as JaxBbox
from igneous_tpu.storage import CloudFiles as JaxCloudFiles
from igneous_tpu_torch import Bbox, CloudFiles, Volume, chunk_cache, device, telemetry

PACKAGES = {
  "port": dict(cache=chunk_cache, Volume=Volume, Bbox=Bbox, CloudFiles=CloudFiles,
               counters=telemetry.counters),
  "jax": dict(cache=jax_chunk_cache, Volume=JaxVolume, Bbox=JaxBbox,
              CloudFiles=JaxCloudFiles, counters=jax_telemetry.counters_snapshot),
}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  for name in ("IGNEOUS_CHUNK_CACHE", "IGNEOUS_CHUNK_CACHE_MB", "IGNEOUS_PIPELINE_MEM_MB"):
    monkeypatch.delenv(name, raising=False)
  device.reset_device()
  for pkg in PACKAGES.values():
    pkg["cache"].clear()
  telemetry.reset()
  jax_telemetry.reset_counters()
  yield
  for pkg in PACKAGES.values():
    pkg["cache"].clear()
  device.reset_device()


def _layer(pkg, tmp_path, seed=0, shape=(64, 64, 32)):
  """A gzip-compressed raw uint8 layer of 32^3 chunks (cacheable)."""
  data = np.random.default_rng(seed).integers(0, 255, shape, dtype=np.uint8)
  path = f"file://{tmp_path / 'layer'}"
  pkg["Volume"].from_numpy(data, path, chunk_size=(32, 32, 32), compress="gzip")
  return path, data


def _hits_misses(pkg):
  c = pkg["counters"]()
  return c.get("chunk_cache.hits", 0), c.get("chunk_cache.misses", 0)


@pytest.mark.parametrize("who", sorted(PACKAGES))
def test_hit_returns_equal_read_only_chunk(tmp_path, who):
  pkg = PACKAGES[who]
  path, data = _layer(pkg, tmp_path)
  vol = pkg["Volume"](path)
  box = pkg["Bbox"]((0, 0, 0), (64, 64, 32))
  first = vol.download(box)
  assert _hits_misses(pkg) == (0, 4)
  second = vol.download(box)
  assert _hits_misses(pkg) == (4, 4)
  assert np.array_equal(first[..., 0], data) and np.array_equal(second[..., 0], data)
  cache = pkg["cache"].shared_cache()
  assert len(cache) == 4 and cache.nbytes == data.nbytes
  # entries are read-only; the cutout handed out is the reader's own copy
  entries = list(cache._entries.values())
  assert all(not e.flags.writeable for e in entries)
  assert second.flags.writeable
  second[...] = 0
  assert np.array_equal(vol.download(box)[..., 0], data)


@pytest.mark.parametrize("who", sorted(PACKAGES))
def test_overwritten_chunk_misses_on_its_digest(tmp_path, who):
  """A writer behind the cache's back (no invalidation) changes the stored
  bytes, so the next read misses and returns the new voxels."""
  pkg = PACKAGES[who]
  path, data = _layer(pkg, tmp_path)
  vol = pkg["Volume"](path)
  box = pkg["Bbox"]((0, 0, 0), (32, 32, 32))
  assert np.array_equal(vol.download(box)[..., 0], data[:32, :32, :32])
  new = np.full((32, 32, 32), 7, np.uint8)
  raw = np.asfortranarray(new).tobytes(order="F")
  pkg["CloudFiles"](path).put("1_1_1/0-32_0-32_0-32", raw, compress="gzip")
  got = vol.download(box)[..., 0]
  assert np.array_equal(got, new)
  assert _hits_misses(pkg) == (0, 2)


@pytest.mark.parametrize("who", sorted(PACKAGES))
def test_upload_invalidates_its_mip(tmp_path, who):
  pkg = PACKAGES[who]
  path, data = _layer(pkg, tmp_path)
  vol = pkg["Volume"](path)
  vol.download(vol.bounds)
  cache = pkg["cache"].shared_cache()
  assert len(cache) == 4
  new = np.zeros((32, 32, 32, 1), np.uint8)
  vol.upload(pkg["Bbox"]((32, 32, 0), (64, 64, 32)), new)
  assert len(cache) == 0 and cache.nbytes == 0
  got = vol.download(vol.bounds)[..., 0]
  want = data.copy()
  want[32:, 32:, :] = 0
  assert np.array_equal(got, want)


@pytest.mark.parametrize("who", sorted(PACKAGES))
def test_lru_evicts_at_its_budget(who):
  cache = PACKAGES[who]["cache"].ChunkDecodeCache(budget=3000)
  arrs = [np.full(1000, i, np.uint8) for i in range(5)]
  keys = [cache.make_key("mem://x/", 0, (i,), arrs[i].tobytes()) for i in range(5)]
  for k, a in zip(keys[:3], arrs[:3]):
    cache.put(k, a)
  assert len(cache) == 3 and cache.nbytes == 3000
  assert cache.get(keys[0]) is not None  # now the most recent
  cache.put(keys[3], arrs[3])  # evicts keys[1], the least recent
  assert cache.get(keys[1]) is None
  assert [cache.get(k) is not None for k in (keys[0], keys[2], keys[3])] == [True] * 3
  assert cache.nbytes == 3000
  # one chunk over the whole budget is handed back, read-only, not stored
  big = cache.put(cache.make_key("mem://x", 0, (9,), b"big"), np.zeros(4000, np.uint8))
  assert not big.flags.writeable and len(cache) == 3
  # the path's trailing slash is normalised on both sides
  assert cache.invalidate("mem://x", 0) == 3 and cache.nbytes == 0


@pytest.mark.parametrize("who", sorted(PACKAGES))
def test_cache_off_bypasses_with_equal_reads(tmp_path, monkeypatch, who):
  pkg = PACKAGES[who]
  path, data = _layer(pkg, tmp_path)
  monkeypatch.setenv("IGNEOUS_CHUNK_CACHE", "off")
  vol = pkg["Volume"](path)
  for _ in range(2):
    assert np.array_equal(vol.download(vol.bounds)[..., 0], data)
  assert _hits_misses(pkg) == (0, 0)
  assert pkg["cache"]._SHARED is None or len(pkg["cache"].shared_cache()) == 0


@pytest.mark.parametrize("who", sorted(PACKAGES))
def test_uncompressed_raw_chunks_are_not_cached(tmp_path, who):
  pkg = PACKAGES[who]
  data = np.arange(32 * 32 * 32, dtype=np.uint32).reshape((32, 32, 32))
  path = f"file://{tmp_path / 'raw'}"
  pkg["Volume"].from_numpy(data, path, chunk_size=(32, 32, 32), compress=None)
  vol = pkg["Volume"](path)
  assert np.array_equal(vol.download(vol.bounds)[..., 0], data)
  assert _hits_misses(pkg) == (0, 0)


def test_corrupt_chunk_raises_and_is_not_stored(tmp_path):
  pkg = PACKAGES["port"]
  path, data = _layer(pkg, tmp_path)
  chunk = tmp_path / "layer" / "1_1_1" / "0-32_0-32_0-32.gz"
  good = chunk.read_bytes()
  chunk.write_bytes(good[: len(good) // 2])
  vol = Volume(path)
  box = Bbox((0, 0, 0), (32, 32, 32))
  with pytest.raises((OSError, EOFError, ValueError)):
    vol.download(box)
  assert len(chunk_cache.shared_cache()) == 0
  # a body that inflates but has the wrong size is refused too
  chunk.write_bytes(gzip.compress(b"\0" * 100, mtime=0))
  with pytest.raises(ValueError):
    vol.download(box)
  assert len(chunk_cache.shared_cache()) == 0
  chunk.write_bytes(good)
  assert np.array_equal(vol.download(box)[..., 0], data[:32, :32, :32])
  assert len(chunk_cache.shared_cache()) == 1


def test_corrupt_chunk_is_refused_by_both_packages(tmp_path):
  """The same torn chunk: both packages raise and cache nothing."""
  for who, pkg in PACKAGES.items():
    root = tmp_path / who
    path, _ = _layer(pkg, root)
    chunk = root / "layer" / "1_1_1" / "32-64_0-32_0-32.gz"
    chunk.write_bytes(chunk.read_bytes()[:40])
    with pytest.raises(Exception):
      pkg["Volume"](path).download(pkg["Bbox"]((32, 0, 0), (64, 32, 32)))
    assert len(pkg["cache"].shared_cache()) == 0, who


@pytest.mark.parametrize("who", sorted(PACKAGES))
def test_invalidation_hooks_hear_uploads(tmp_path, who):
  """A registered hook hears every (path, mip) an upload rewrites; a hook
  that raises is counted and stops nothing."""
  pkg = PACKAGES[who]
  heard = []

  def hook(path, mip):
    heard.append((path, mip))

  def broken(path, mip):
    raise RuntimeError("hook")

  pkg["cache"].register_invalidation_hook(hook)
  pkg["cache"].register_invalidation_hook(broken)
  try:
    path, _ = _layer(pkg, tmp_path)
    vol = pkg["Volume"](path)
    vol.upload(pkg["Bbox"]((0, 0, 0), (32, 32, 32)), np.ones((32, 32, 32, 1), np.uint8))
    pkg["cache"].invalidate_writes([(path, 0)])
  finally:
    pkg["cache"].unregister_invalidation_hook(hook)
    pkg["cache"].unregister_invalidation_hook(broken)
  cloudpath = vol.cloudpath
  assert heard.count((cloudpath, 0)) >= 2 and (path, 0) in heard
  assert pkg["counters"]().get("chunk_cache.hook_failed", 0) == len(heard)
