"""The port's storage plane against the JAX package's.

The storage contract (``tests/test_storage_contract.py``) runs on the
port's ``CloudFiles`` over file://, mem:// and its own gs:// and s3://
clients speaking to the in-process fakes (``fake_cloud_servers.py``):
round trips, listing and pagination, compression, ranges, resumable and
multipart uploads, SigV4 (checked by the fake with the JAX package's
verifier), the secret-file token and 503 retries with their
``retries.storage_http`` ticks. Each object the port puts on a fake reads
back the same through the JAX package's ``CloudFiles``, and the reverse;
the ``.zstd`` listing and its read match the JAX package's with and
without ``zstandard``; the retry schedule, the knobs' parses, path
normalisation and the guarded ``cryptography`` import match too.
"""

import json
import random
import sys

import numpy as np
import pytest

from igneous_tpu import retry as jax_retry
from igneous_tpu import storage as jax_storage
from igneous_tpu import storage_gcs as jax_storage_gcs
from igneous_tpu_torch import device, retry, storage, storage_gcs, telemetry
from igneous_tpu_torch.storage import CloudFiles, clear_memory_storage

from fake_cloud_servers import FakeCloudServer
from test_torch_integrity import flush_local

PACKAGES = {"jax": jax_storage, "port": storage}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  # the envelope's records of a fake server's layer would be flushed after
  # the server stopped, to the real endpoint; one test turns it on
  monkeypatch.setenv("IGNEOUS_INTEGRITY", "off")
  for mod in PACKAGES.values():
    for proto in ("gs", "s3"):  # the real clients, not a memory double
      mod._PROTOCOL_HOOKS.pop(proto, None)
  telemetry.reset_all()
  yield
  flush_local()
  clear_memory_storage()
  jax_storage.clear_memory_storage()


@pytest.fixture
def gcs_server(monkeypatch):
  with FakeCloudServer("gcs") as srv:
    monkeypatch.setenv("GCS_ENDPOINT_URL", srv.endpoint)
    monkeypatch.setenv("IGNEOUS_GCS_RESUMABLE_THRESHOLD", "4096")
    monkeypatch.setenv("IGNEOUS_GCS_UPLOAD_CHUNK", "1024")
    yield srv


@pytest.fixture
def s3_server(monkeypatch):
  with FakeCloudServer("s3", s3_creds=("AKIAFAKE", "fakesecret")) as srv:
    monkeypatch.setenv("S3_ENDPOINT_URL", srv.endpoint)
    monkeypatch.setenv("IGNEOUS_S3_MULTIPART_THRESHOLD", "4096")
    monkeypatch.setenv("IGNEOUS_S3_MULTIPART_CHUNK", "1024")
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "AKIAFAKE")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "fakesecret")
    yield srv


def _root(request, proto, tmp_path, name="bucket"):
  """A storage root of ``proto``, with its fake server started."""
  if proto == "file":
    return f"file://{tmp_path}/{name}"
  if proto == "mem":
    return f"mem://contract-{name}/prefix"
  request.getfixturevalue("gcs_server" if proto == "gs" else "s3_server")
  return f"{proto}://contract-{name}/prefix"


@pytest.fixture(params=["file", "mem", "gs", "s3"])
def cf(request, tmp_path):
  return CloudFiles(_root(request, request.param, tmp_path))


# -- the contract on the port ------------------------------------------------


def test_put_get_roundtrip(cf):
  cf.put("a/b/key.bin", b"hello world")
  assert cf.get("a/b/key.bin") == b"hello world"
  assert cf.get("missing") is None


def test_exists_delete(cf):
  cf.put("k", b"x")
  assert cf.exists("k")
  cf.delete("k")
  assert not cf.exists("k")
  cf.delete("k")  # idempotent


def test_list_prefix(cf):
  for k in ("dir/a", "dir/b", "dir2/c", "top"):
    cf.put(k, b"1")
  assert sorted(cf.list("dir/")) == ["dir/a", "dir/b"]
  assert {"dir/a", "dir/b", "dir2/c", "top"} <= set(cf.list(""))


def test_list_paginates(cf):
  """More keys than one page of the fakes (3), one with a literal '%'."""
  keys = sorted([f"pg/{i:03d}" for i in range(7)] + ["pg/x%20y"])
  for k in keys:
    cf.put(k, b"1")
  assert sorted(cf.list("pg/")) == keys


@pytest.mark.parametrize("compress", [None, "gzip", "gzip-1", "zstd"])
def test_compression_roundtrip(cf, compress):
  if compress == "zstd" and storage.zstandard is None:
    pytest.skip("zstandard is not installed")
  data = bytes(range(256)) * 64
  cf.put(f"c/{compress}", data, compress=compress)
  assert cf.get(f"c/{compress}") == data
  assert list(cf.list("c/")) == [f"c/{compress}"]


def test_json_roundtrip(cf):
  doc = {"a": 1, "nested": {"b": [1, 2, 3]}}
  cf.put_json("doc", doc)
  assert cf.get_json("doc") == doc


def test_puts_bulk(cf):
  assert cf.puts([(f"bulk/{i}", bytes([i])) for i in range(10)]) == 10
  assert cf.puts([{"path": "bulk/z", "content": b"zz", "compress": "gzip"}]) == 1
  assert len(list(cf.list("bulk/"))) == 11
  assert cf.get("bulk/7") == b"\x07"
  assert cf.get("bulk/z") == b"zz"


def test_range_read(cf):
  cf.put("r", b"0123456789", compress=None)
  assert cf.get_range("r", 2, 4) == b"2345"
  assert cf.get_range("r", 20, 4) == b""
  assert cf.get_range("nope", 0, 4) is None


def test_large_object_chunked_upload(cf):
  """Past the test-sized resumable and multipart thresholds."""
  data = bytes(np.random.default_rng(1).integers(0, 256, 10_000, np.uint8))
  cf.put("big/object.bin", data, compress=None)
  assert cf.get("big/object.bin") == data
  assert cf.size("big/object.bin") == len(data)
  assert cf.size("missing") is None


def test_list_forms_flat_delete_prefix_isdir(cf):
  cf.puts([("a/1", b"1"), ("a/sub/2", b"2"), ("b/3", b"3")], compress="gzip")
  got = cf.get(["a/1", "nope"])
  assert got == [{"path": "a/1", "content": b"1", "error": None},
                 {"path": "nope", "content": None, "error": None}]
  assert cf.exists(["a/1", "a/sub/2", "nope"]) == {"a/1": True, "a/sub/2": True,
                                                   "nope": False}
  assert list(cf.list("a/", flat=True)) == ["a/1"]
  assert cf.isdir()
  cf.delete_prefix("a/")
  assert list(cf.list("")) == ["b/3"]


@pytest.mark.parametrize("dest_proto", ["file", "mem", "gs", "s3"])
def test_transfer_to_keeps_stored_bytes(request, cf, tmp_path, dest_proto):
  cf.put("t/raw", b"raw bytes", compress=None)
  cf.put("t/gz", b"gzipped" * 50, compress="gzip")
  dest = _root(request, dest_proto, tmp_path, name="dest")
  cf.transfer_to(dest)
  out = CloudFiles(dest)
  for key in ("t/raw", "t/gz"):
    assert out.get_stored(key) == cf.get_stored(key)


# -- the clients on the fakes ------------------------------------------------


def test_gcs_resumable_session_used(gcs_server):
  cf = CloudFiles("gs://bkt/pre")
  data = bytes(5000)
  cf.put("obj", data, compress=None)
  assert cf.get("obj") == data
  posts = [p for m, p, _a in gcs_server.state.requests if m == "POST"]
  puts = [p for m, p, _a in gcs_server.state.requests if m == "PUT"]
  assert any("uploadType=resumable" in p for p in posts)
  assert sum(p.startswith("/resumable/") for p in puts) == 5  # 5 x 1 KiB


def test_s3_multipart_used(s3_server):
  cf = CloudFiles("s3://bkt/pre")
  data = bytes(range(256)) * 30  # 7680 bytes, past the 4096 threshold
  cf.put("obj", data, compress=None)
  assert cf.get("obj") == data
  reqs = s3_server.state.requests
  assert any("uploads" in p for m, p, _a in reqs if m == "POST")
  assert len([p for m, p, _a in reqs if m == "PUT" and "partNumber" in p]) == 8


def test_s3_requests_are_sigv4_signed(s3_server):
  """The fake recomputes every signature with the JAX package's SigV4 and
  answers 403 to a mismatch."""
  cf = CloudFiles("s3://bkt/pre")
  cf.put("signed/k e+y", b"x", compress=None)
  assert cf.get("signed/k e+y") == b"x"
  assert list(cf.list("signed/")) == ["signed/k e+y"]
  assert s3_server.state.requests and all(a for _m, _p, a in s3_server.state.requests)


def test_s3_bad_signature_is_refused(s3_server, monkeypatch):
  monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "wrong-secret")
  with pytest.raises(Exception, match="403"):
    CloudFiles("s3://bkt/pre").put("k", b"x", compress=None)


def test_gcs_secret_file_token_attached(gcs_server, monkeypatch, tmp_path):
  secret_dir = tmp_path / "secrets"
  secret_dir.mkdir()
  (secret_dir / "google-secret.json").write_text(json.dumps({"token": "static-test-token"}))
  monkeypatch.setenv("IGNEOUS_TPU_SECRETS", str(secret_dir))
  cf = CloudFiles("gs://bkt/pre")
  cf.put("authed", b"x", compress=None)
  assert cf.get("authed") == b"x"
  assert all(a for _m, _p, a in gcs_server.state.requests)


def test_gcs_service_account_needs_cryptography(monkeypatch, tmp_path):
  """Without ``cryptography`` both packages raise the same ImportError."""
  secret = tmp_path / "google-secret.json"
  secret.write_text(json.dumps({
    "type": "service_account", "client_email": "svc@example.invalid",
    "token_uri": "http://127.0.0.1:9/token", "private_key": "unused",
  }))
  monkeypatch.setenv("GOOGLE_APPLICATION_CREDENTIALS", str(secret))
  for name in ("cryptography", "cryptography.hazmat", "cryptography.hazmat.primitives",
               "cryptography.hazmat.primitives.asymmetric"):
    monkeypatch.setitem(sys.modules, name, None)
  errors = []
  for mod in (jax_storage_gcs, storage_gcs):
    mod._TOKEN_CACHE.clear()
    with pytest.raises(ImportError) as ei:
      mod._GoogleAuth().header()
    errors.append(str(ei.value))
  assert errors[0] == errors[1] and "cryptography" in errors[1]


@pytest.mark.parametrize("proto", ["gs", "s3"])
def test_retry_on_503(proto, gcs_server, s3_server):
  srv = gcs_server if proto == "gs" else s3_server
  cf = CloudFiles(f"{proto}://bkt/pre")
  cf.put("k", b"payload", compress=None)
  srv.state.fail_next = 2  # two 503s, then success
  assert cf.get("k") == b"payload"
  assert telemetry.counters_snapshot().get("retries.storage_http") == 2
  srv.state.fail_next = 2
  assert sorted(cf.list("")) == ["k"]
  assert telemetry.counters_snapshot().get("retries.storage_http") == 4


@pytest.mark.parametrize("proto", ["gs", "s3"])
def test_retries_exhausted_raise(proto, gcs_server, s3_server):
  srv = gcs_server if proto == "gs" else s3_server
  fast = retry.RetryPolicy(attempts=3, base_s=0.0, jitter="none")
  retry.set_default_policy(fast)
  try:
    cf = CloudFiles(f"{proto}://bkt/pre")
    srv.state.fail_next = 3
    with pytest.raises(Exception, match="503"):
      cf.get("k")
  finally:
    retry.set_default_policy(None)
  assert telemetry.counters_snapshot().get("retries.storage_http") == 2


@pytest.mark.parametrize("proto", ["gs", "s3"])
def test_volume_roundtrip_on_cloud_protocol(proto, gcs_server, s3_server):
  from igneous_tpu_torch.volume import Volume

  data = np.random.default_rng(0).integers(0, 255, (64, 48, 24)).astype(np.uint8)
  path = f"{proto}://fake-bucket/layer"
  vol = Volume.from_numpy(data, path, resolution=(8, 8, 40))
  assert np.array_equal(Volume(path).download(vol.bounds)[..., 0], data)


@pytest.mark.parametrize("proto", ["gs", "s3"])
def test_envelope_on_cloud_protocol(proto, gcs_server, s3_server, monkeypatch):
  """With the envelope on, a volume on gs:// or s3:// has every chunk in
  its manifest on the server, with the stored bytes' digest, and the JAX
  package reads the same records."""
  from igneous_tpu import integrity as jax_integrity
  from igneous_tpu_torch import integrity
  from igneous_tpu_torch.volume import Volume

  srv = gcs_server if proto == "gs" else s3_server
  monkeypatch.delenv("IGNEOUS_INTEGRITY")
  path = f"{proto}://env-bucket/layer"
  data = np.random.default_rng(3).integers(0, 255, (64, 48, 24)).astype(np.uint8)
  Volume.from_numpy(data, path, resolution=(8, 8, 40), chunk_size=(32, 32, 24))
  integrity.flush_all()  # while the fake server answers
  man = integrity.load_manifest(path)
  assert man == jax_integrity.load_manifest(path)
  chunks = {k[len("layer/"):]: v for k, v in srv.state.objects.items()
            if k.startswith("layer/1_1_1/") or k.startswith("layer/8_8_40/")}
  assert len(chunks) == 4 and set(man) == set(chunks)
  for key, stored in chunks.items():
    assert man[key]["digest"] == integrity.digest_hex(stored) and man[key]["n"] == len(stored)


# -- both packages on the same server ----------------------------------------


@pytest.mark.parametrize("proto", ["gs", "s3"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_objects_cross_packages(proto, writer, gcs_server, s3_server):
  """An object either package puts is stored with the same bytes under the
  same name and reads back the same through the other."""
  srv = gcs_server if proto == "gs" else s3_server
  reader = "port" if writer == "jax" else "jax"
  w = PACKAGES[writer].CloudFiles(f"{proto}://xbkt/layer")
  r = PACKAGES[reader].CloudFiles(f"{proto}://xbkt/layer")
  big = bytes(np.random.default_rng(2).integers(0, 256, 9000, np.uint8))
  w.put("a/raw", b"raw", compress=None)
  w.put("a/gz", b"gz" * 100, compress="gzip")
  w.put("a/big", big, compress=None)  # resumable or multipart
  w.put_json("doc.json", {"x": [1, 2]})
  assert r.get("a/raw") == b"raw"
  assert r.get("a/gz") == b"gz" * 100
  assert r.get("a/big") == big
  assert r.get_json("doc.json") == {"x": [1, 2]}
  assert r.get_stored("a/gz") == w.get_stored("a/gz")
  assert sorted(r.list("a/")) == sorted(w.list("a/")) == ["a/big", "a/gz", "a/raw"]
  assert r.size("a/big") == len(big)
  names = sorted(srv.state.objects)
  assert names == ["layer/a/big", "layer/a/gz.gz", "layer/a/raw", "layer/doc.json"]
  r.delete("a/gz")
  assert not w.exists("a/gz")


@pytest.mark.parametrize("proto", ["file", "mem", "gs", "s3"])
def test_same_observations_as_reference(request, tmp_path, proto):
  """One script on each package's CloudFiles over its own root: every
  observation is equal."""
  def script(mod, name):
    cf = mod.CloudFiles(_root(request, proto, tmp_path, name=name))
    cf.puts([("d/a", b"1"), ("d/s/b", b"22"), ("e", b"333")], compress="gzip")
    cf.put("d/raw", b"0123456789", compress=None)
    return [
      sorted(cf.list("d/")), sorted(cf.list("d/", flat=True)), cf.get(["d/a", "x"]),
      cf.exists(["d/s/b", "x"]), cf.size("e"), cf.get_range("d/raw", 3, 4), cf.isdir(),
      cf.get_stored("d/s/b"),
      (cf.delete_prefix("d/s"), sorted(cf.list("")))[1],
    ]
  assert script(storage, "port") == script(jax_storage, "jax")


# -- .zstd objects -----------------------------------------------------------


@pytest.mark.parametrize("codec", ["installed", "absent"])
def test_zstd_object_lists_and_reads_as_reference(tmp_path, monkeypatch, codec):
  """A ``.zstd`` object lists under its key in both packages, and reading
  it gives the same result: its content with ``zstandard``, the same
  ImportError without it."""
  if codec == "installed" and jax_storage.zstandard is None:
    pytest.skip("zstandard is not installed")
  if codec == "absent":
    for mod in PACKAGES.values():
      monkeypatch.setattr(mod, "zstandard", None)
  payload = b"zstd framed" if jax_storage.zstandard is None else (
    jax_storage.zstandard.ZstdCompressor().compress(b"hello zstd" * 10))
  seen = {}
  for who, mod in PACKAGES.items():
    path = tmp_path / who
    path.mkdir()
    (path / "x.zstd").write_bytes(payload)
    cf = mod.CloudFiles(f"file://{path}")
    listed = list(cf.list(""))
    try:
      got = ("ok", cf.get("x"))
    except ImportError as e:
      got = ("ImportError", str(e))
    seen[who] = (listed, got, cf.exists("x"), cf.get_stored("x")[1])
  assert seen["port"] == seen["jax"]
  assert seen["port"][0] == ["x"]
  assert seen["port"][1][0] == ("ok" if codec == "installed" else "ImportError")
  if codec == "absent":
    with pytest.raises(ImportError):
      storage.compress_bytes(b"x", "zstd")


@pytest.mark.parametrize("value", ["", "none", "gzip", "gzip-3", "zstd"])
def test_scratch_compression_as_reference(monkeypatch, value):
  monkeypatch.setenv("IGNEOUS_SCRATCH_COMPRESS", value)
  assert storage.scratch_compression() == jax_storage.scratch_compression()
  assert storage.scratch_gzip_level(4) == jax_storage.scratch_gzip_level(4)


# -- the retry schedule, the knobs, paths ------------------------------------


def test_retry_schedule_as_reference():
  for kw in (dict(attempts=6, base_s=0.25, cap_s=30.0, budget_s=120.0),
             dict(attempts=10, base_s=1.0, cap_s=4.0, budget_s=9.0),
             dict(attempts=1)):
    schedules = []
    for mod in (jax_retry, retry):
      slept = []
      pol = mod.RetryPolicy(jitter="full", sleep_fn=slept.append,
                            rng=random.Random(7), **kw)
      schedules.append((list(pol.retries()), slept))
    assert schedules[0] == schedules[1]
  assert retry.RETRYABLE_STATUS == jax_retry.RETRYABLE_STATUS


@pytest.mark.parametrize("env", [
  {},
  {"IGNEOUS_RETRY_ATTEMPTS": "3.7", "IGNEOUS_RETRY_BASE_S": "0.5",
   "IGNEOUS_RETRY_CAP_S": "2", "IGNEOUS_RETRY_BUDGET_S": "9.5"},
  {"IGNEOUS_RETRY_ATTEMPTS": "bad", "IGNEOUS_RETRY_BASE_S": ""},
])
def test_retry_knobs_parse_as_reference(monkeypatch, env):
  for name in ("ATTEMPTS", "BASE_S", "CAP_S", "BUDGET_S"):
    monkeypatch.delenv(f"IGNEOUS_RETRY_{name}", raising=False)
  for k, v in env.items():
    monkeypatch.setenv(k, v)
  mine, ref = retry.RetryPolicy.from_env(), jax_retry.RetryPolicy.from_env()
  assert (mine.attempts, mine.base_s, mine.cap_s, mine.budget_s) == (
    ref.attempts, ref.base_s, ref.cap_s, ref.budget_s)


@pytest.mark.parametrize("proto", ["gs", "s3"])
@pytest.mark.parametrize("value", ["", "2048", "1e3", "junk"])
def test_upload_knobs_parse_as_reference(monkeypatch, proto, value):
  from igneous_tpu import storage_s3 as jax_storage_s3
  from igneous_tpu_torch import storage_s3

  names = (("IGNEOUS_GCS_RESUMABLE_THRESHOLD", "IGNEOUS_GCS_UPLOAD_CHUNK") if proto == "gs"
           else ("IGNEOUS_S3_MULTIPART_THRESHOLD", "IGNEOUS_S3_MULTIPART_CHUNK"))
  for name in names:
    monkeypatch.setenv(name, value)
  mods = (jax_storage_gcs, storage_gcs) if proto == "gs" else (jax_storage_s3, storage_s3)
  fns = (("_resumable_threshold", "_upload_chunk") if proto == "gs"
         else ("_multipart_threshold", "_multipart_chunk"))
  for fn in fns:
    assert getattr(mods[1], fn)() == getattr(mods[0], fn)()


@pytest.mark.parametrize("path", [
  "gs://bucket/layer/", "s3://b/p", "mem://x/y", "file:///tmp/a/../b/",
  "precomputed://gs://b/l", "relative/dir",
])
def test_paths_normalise_as_reference(path):
  mine, ref = storage.extract_path(path), jax_storage.extract_path(path)
  assert (mine.protocol, mine.path) == (ref.protocol, ref.path)
  assert storage.to_https_path(path) == jax_storage.to_https_path(path)
  assert storage.normalize_path(path) == jax_storage.normalize_path(path)


def test_unknown_protocol_raises():
  with pytest.raises(ValueError, match="not available"):
    CloudFiles("nope://x")


def test_registered_protocol_and_wrapper_take_effect(tmp_path):
  """``attach_memory_protocol`` takes precedence over the gs:// client,
  and ``set_backend_wrapper`` wraps every backend built."""
  storage.attach_memory_protocol("gs")
  seen = []

  def wrapper(backend, pth):
    seen.append((type(backend).__name__, pth.protocol, pth.path))
    return backend

  storage.set_backend_wrapper(wrapper)
  try:
    cfm = CloudFiles("gs://double-bucket/p")
    cfm.put("k", b"v")
    assert cfm.get("k") == b"v"
    assert type(cfm.backend).__name__ == "_MemBackend"
    CloudFiles(f"file://{tmp_path}/w")
  finally:
    storage.set_backend_wrapper(None)
    storage._PROTOCOL_HOOKS.pop("gs", None)
  assert seen[0] == ("_MemBackend", "gs", "double-bucket/p")
  assert seen[-1] == ("_FileBackend", "file", f"{tmp_path}/w")
