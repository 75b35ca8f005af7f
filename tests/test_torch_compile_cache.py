"""The port's kernel library store (``igneous_tpu_torch.compile_cache``) on
the CPU, with the g++ library ``cseg`` (the CUDA libraries build only on
the card, where ``chip_smoke.py`` holds the store's round trip).

The key changes with the compiler's version, the compiler, the target,
the flags, the source and the torch version; a library built with the
store set is put there, and a second build directory then loads it with
the compiler made to raise, encoding the same bytes as the JAX package; a
truncated or bit-flipped entry is quarantined and the library rebuilt
and put back; concurrent writers converge on one entry; an unset store
changes nothing; an unreadable store (a file in its place, or an s3://
store whose requests are refused) counts an error and builds; a store on
s3:// (the repo's fake server) round trips; a build that fails still
raises.
"""

import threading

import numpy as np
import pytest

from igneous_tpu import cseg as jax_cseg
from igneous_tpu_torch import compile_cache as cc
from igneous_tpu_torch import cseg, telemetry
from igneous_tpu_torch.observability import device as ledger_mod
from igneous_tpu_torch.observability.device import LEDGER
from igneous_tpu_torch.ops import _build


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
  monkeypatch.delenv(cc.CACHE_ENV, raising=False)
  monkeypatch.setattr(_build, "_LIBS", {})
  monkeypatch.setattr(_build, "BUILD_LOG", {})
  monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build1")
  ledger_mod.reset()
  telemetry.reset_all()
  yield


def _store(monkeypatch, tmp_path):
  root = f"file://{tmp_path}/store"
  monkeypatch.setenv(cc.CACHE_ENV, root)
  return tmp_path / "store"


def _entries(root):
  return sorted(p for p in (root / "libraries").rglob("*.bin"))


def _segmentation():
  rng = np.random.default_rng(3)
  return rng.integers(0, 9, (16, 16, 16)).astype(np.uint64) * np.uint64(2**40 + 1)


def _no_compiler(monkeypatch):
  """Every compiler run raises: the build and the version probe alike."""
  real = _build._source

  def boom():
    raise RuntimeError("no compiler here")

  monkeypatch.setattr(_build, "_source", lambda name: (*real(name)[:2], boom))


def _meta(**kw):
  src, flags, _ = _build._source("cseg")
  meta = cc.library_meta("cseg", src, flags, "g++", "g++ (GCC) 13.2.0")
  meta.update(kw)
  return meta


@pytest.mark.parametrize("field,value", [
  ("compiler_version", "g++ (GCC) 14.1.0"),
  ("compiler", "nvcc"),
  ("target", "sm_90"),
  ("flags", "-O2 -shared -fPIC"),
  ("source", "0" * 64),
  ("torch", "0.0.0"),
  ("cuda", "12.8"),
])
def test_key_changes_with_each_field(field, value):
  base = _meta()
  other = _meta(**{field: value})
  assert cc.entry_key(other) != cc.entry_key(base)
  same_but_version = field == "compiler_version"
  assert (cc._prefix(other) == cc._prefix(base)) == same_but_version


def test_key_follows_the_source_and_flags_build_uses(tmp_path, monkeypatch):
  src, flags, _ = _build._source("cseg")
  edited = tmp_path / "cseg.cpp"
  edited.write_bytes(src.read_bytes() + b"\n// edited\n")
  a = cc.library_meta("cseg", src, flags, "g++", "v")
  assert cc.library_meta("cseg", edited, flags, "g++", "v")["source"] != a["source"]
  assert cc.library_meta("cseg", src, flags + ["-g"], "g++", "v")["flags"] != a["flags"]
  assert a["target"] == "cpu" and cc.target("g++") == "cpu"


def test_store_round_trip_without_a_compiler(tmp_path, monkeypatch):
  root = _store(monkeypatch, tmp_path)
  arr = _segmentation()
  want = jax_cseg.compress(arr)
  assert cseg.compress(arr) == want
  built = _build.library_path("cseg")
  assert _build.BUILD_LOG["cseg"]["seconds"] > 0 and "store" not in _build.BUILD_LOG["cseg"]
  assert len(_entries(root)) == 1
  snap = LEDGER.snapshot()
  assert snap["compile_cache"]["misses"] == 1 and snap["compile_cache"]["puts"] == 1
  assert snap["recompiles"] == 1 and snap["kernels"]["cseg"]["compiles"] == 1

  # a second worker: an empty build directory and no compiler
  monkeypatch.setattr(_build, "_LIBS", {})
  monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build2")
  _no_compiler(monkeypatch)
  assert cseg.compress(arr) == want
  log = _build.BUILD_LOG["cseg"]
  assert log["store"] == "hit" and log["saved_s"] > 0 and log["fetch_s"] >= 0
  assert _build.library_path("cseg").read_bytes() == built.read_bytes()
  snap = LEDGER.snapshot()
  assert snap["compile_cache"]["hits"] == 1 and snap["recompiles"] == 1
  assert snap["kernels"]["cseg"]["cache_hits"] == 1
  assert telemetry.counters_snapshot()["device.compile_cache.hit"] == 1


@pytest.mark.parametrize("damage", ["truncate", "bitflip", "magic"])
def test_corrupt_entry_is_quarantined_and_rebuilt(tmp_path, monkeypatch, damage):
  root = _store(monkeypatch, tmp_path)
  _build.build("cseg")
  (entry,) = _entries(root)
  good = entry.read_bytes()
  data = bytearray(good)
  if damage == "truncate":
    data = data[: len(data) - 100]
  elif damage == "bitflip":
    data[-50] ^= 0x10
  else:
    data[:4] = b"XXXX"
  entry.write_bytes(bytes(data))
  monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build2")
  path = _build.build("cseg")
  assert path.exists() and "store" not in _build.BUILD_LOG["cseg"]  # rebuilt
  quarantined = list((root / "quarantine").rglob("*.bin"))
  assert len(quarantined) == 1 and quarantined[0].read_bytes() == bytes(data)
  (entry2,) = _entries(root)
  body, header = cc.decode_entry(entry2.read_bytes(), header_meta(entry2))
  assert body == path.read_bytes()
  snap = LEDGER.snapshot()["compile_cache"]
  assert snap["corrupt"] == 1 and snap["puts"] == 2 and snap["misses"] == 2
  assert telemetry.counters_snapshot()["device.compile_cache.corrupt"] == 1


def header_meta(entry):
  """The key meta an entry's header carries."""
  import json

  data = entry.read_bytes()
  hlen = int.from_bytes(data[8:12], "big")
  return json.loads(data[12 : 12 + hlen])["meta"]


def test_decode_refuses_a_key_mismatch(tmp_path):
  meta = _meta()
  blob = cc.encode_entry(meta, b"library bytes", 1.0)
  assert cc.decode_entry(blob, meta)[0] == b"library bytes"
  assert cc.decode_entry(blob, _meta(compiler_version=None))[0] == b"library bytes"
  with pytest.raises(cc.CompileCacheError, match="key meta"):
    cc.decode_entry(blob, _meta(target="sm_90"))
  with pytest.raises(cc.CompileCacheError, match="truncated"):
    cc.decode_entry(blob[:20], meta)


def test_concurrent_writers_converge(tmp_path):
  store = cc.CompileCache(f"file://{tmp_path}/store")
  meta = _meta()
  body = bytes(range(256)) * 64
  wins = []
  barrier = threading.Barrier(8)

  def writer(i):
    barrier.wait()
    wins.append(store.put(meta, body, float(i)))

  threads = [threading.Thread(target=writer, args=(i,)) for i in range(8)]
  for t in threads:
    t.start()
  for t in threads:
    t.join(timeout=60)
  assert not any(t.is_alive() for t in threads)
  assert len(wins) == 8 and any(wins)
  (entry,) = _entries(tmp_path / "store")
  got, header = cc.decode_entry(entry.read_bytes(), meta)
  assert got == body and 0 <= header["build_s"] < 8
  assert not store.put(meta, body, 9.0)


def test_unset_store_is_a_no_op(tmp_path):
  assert cc.get_active() is None
  _build.build("cseg")
  assert "store" not in _build.BUILD_LOG["cseg"]
  snap = LEDGER.snapshot()
  assert all(snap["compile_cache"][k] == 0 for k in ("hits", "misses", "puts", "errors"))
  assert not (tmp_path / "store").exists()


def test_unreadable_store_counts_an_error_and_builds(tmp_path, monkeypatch):
  blocker = tmp_path / "store"
  blocker.write_text("a file where the store's directory would be")
  monkeypatch.setenv(cc.CACHE_ENV, f"file://{blocker}")
  path = _build.build("cseg")
  assert path.exists() and _build.BUILD_LOG["cseg"]["seconds"] > 0
  assert LEDGER.snapshot()["compile_cache"]["errors"] >= 1
  assert telemetry.counters_snapshot()["device.compile_cache.error"] >= 1


def test_unported_store_scheme_counts_an_error(monkeypatch):
  # https:// has no storage backend in either package (gs:// and s3:// do)
  monkeypatch.setenv(cc.CACHE_ENV, "https://host/cache")
  assert cc.get_active() is None
  assert telemetry.counters_snapshot()["device.compile_cache.error"] == 1


@pytest.fixture
def s3_store(monkeypatch):
  """A store on the fake S3 server (the envelope off: its buffered records
  would outlive the server)."""
  from fake_cloud_servers import FakeCloudServer

  with FakeCloudServer("s3", s3_creds=("AKIAFAKE", "fakesecret")) as srv:
    for k, v in {"S3_ENDPOINT_URL": srv.endpoint, "AWS_ACCESS_KEY_ID": "AKIAFAKE",
                 "AWS_SECRET_ACCESS_KEY": "fakesecret", "IGNEOUS_INTEGRITY": "off",
                 cc.CACHE_ENV: "s3://store-bucket/cc"}.items():
      monkeypatch.setenv(k, v)
    yield srv


def test_store_on_s3_round_trips(s3_store, tmp_path, monkeypatch):
  first = _build.build("cseg")
  keys = [k for k in s3_store.state.objects if k.startswith("cc/libraries/cseg/")]
  assert len(keys) == 1 and keys[0].endswith(".bin")
  monkeypatch.setattr(_build, "_LIBS", {})
  monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build2")
  _no_compiler(monkeypatch)
  assert _build.build("cseg").read_bytes() == first.read_bytes()
  assert LEDGER.snapshot()["compile_cache"]["hits"] == 1


def test_refused_cloud_store_counts_an_error_and_builds(s3_store, monkeypatch):
  monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "wrong-secret")  # every request 403s
  path = _build.build("cseg")
  assert path.exists() and _build.BUILD_LOG["cseg"]["seconds"] > 0
  assert LEDGER.snapshot()["compile_cache"]["errors"] >= 1


def test_a_miss_without_a_compiler_still_raises(tmp_path, monkeypatch):
  _store(monkeypatch, tmp_path)
  _no_compiler(monkeypatch)
  with pytest.raises(RuntimeError, match="no compiler here"):
    _build.build("cseg")
  assert LEDGER.snapshot()["compile_cache"]["misses"] == 1
  assert not _build.library_path("cseg").exists()
