"""The port's chaos layer against the JAX package's.

The same seed fires the same faults: the draws and decisions of
``ChaosConfig`` for every fault kind, the storage wrapper's put, get and
storm answers and its corruption at rest, and the queue wrapper's
dropped, skewed and stalled acks, with the same ``chaos.*`` tallies and
``chaos.*`` trace events. End to end (the cases of
``tests/test_containment.py``'s chaos section): determinism and healing,
permanent keys, corrupt gets, a crash between compute and upload that
converges to the clean run's bytes (and to the JAX package's layer), the
poison task's dead-letter record equal to the JAX package's; a passthrough
transfer and an inference campaign under faults (the cases of
``tests/test_fastpaths.py`` and ``tests/test_inference.py``) against the
port's clean run and the JAX package's output; and the port's soak, its
``faults`` scenario at a small size. The comparisons are exact but for
convnet outputs across the packages (rtol = atol = 1e-5, as in
``tests/test_torch_inference.py``).
"""

import glob
import json
import os
import random
import time
import types
import uuid

import numpy as np
import pytest

import igneous_tpu.tasks  # noqa: F401  (registers the JAX package's tasks)
from igneous_tpu import Volume as JaxVolume
from igneous_tpu import chaos as jax_chaos
from igneous_tpu import task_creation as jax_tc
from igneous_tpu import telemetry as jax_telemetry
from igneous_tpu.infer import ModelSpec as JaxModelSpec
from igneous_tpu.infer import init_params as jax_init_params
from igneous_tpu.infer import registry as jax_registry
from igneous_tpu.infer import save_model as jax_save_model
from igneous_tpu.observability import trace as jax_trace
from igneous_tpu.queues import FileQueue as JaxFileQueue
from igneous_tpu.queues import LocalTaskQueue as JaxQueue
from igneous_tpu.queues import filequeue as jax_filequeue
from igneous_tpu.storage import set_backend_wrapper as jax_set_backend_wrapper
from igneous_tpu.storage_http import HttpError as JaxHttpError
from igneous_tpu.tasks import FailTask as JaxFailTask
from igneous_tpu_torch import chaos, device, telemetry
from igneous_tpu_torch import task_creation as tc
from igneous_tpu_torch.infer import registry
from igneous_tpu_torch.observability import trace
from igneous_tpu_torch.queues import FileQueue, LocalTaskQueue
from igneous_tpu_torch.queues import filequeue as port_filequeue
from igneous_tpu_torch.storage import CloudFiles, set_backend_wrapper
from igneous_tpu_torch.storage_http import HttpError
from igneous_tpu_torch.tasks import FailTask
from igneous_tpu_torch.tools import chaos_soak

from test_torch_integrity import flush_local

PKGS = {
  "port": (chaos, HttpError, telemetry),
  "jax": (jax_chaos, JaxHttpError, jax_telemetry),
}
KINDS = ("put_fail", "get_corrupt", "storm", "crash_put", "drop_delete", "clock_skew",
         "stalled_worker", "torn_write", "bit_flip")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  for name in ("IGNEOUS_PIPELINE", "IGNEOUS_INTEGRITY", "IGNEOUS_CHUNK_CACHE",
               "IGNEOUS_JOURNAL"):
    monkeypatch.delenv(name, raising=False)
  device.reset_device()
  flush_local()
  telemetry.reset_all()
  jax_telemetry.reset_all()
  yield
  set_backend_wrapper(None)
  jax_set_backend_wrapper(None)
  flush_local()
  device.reset_device()


@pytest.fixture
def deterministic(monkeypatch):
  """``uuid4`` from a counter and the lease pick the window's first name
  (as ``tests/test_torch_queues.py``): both packages name every queue
  file alike and lease the same task at every step."""
  state = {"n": 0}

  def uuid4():
    state["n"] += 1
    return uuid.UUID(int=state["n"])

  for module in (jax_filequeue, port_filequeue):
    monkeypatch.setattr(module, "uuid", types.SimpleNamespace(uuid4=uuid4))
  monkeypatch.setattr(random, "randrange", lambda n: 0)
  return lambda: state.update(n=0)


def _chaos_counters(tel) -> dict:
  return {k: v for k, v in tel.counters_snapshot().items() if k.startswith("chaos.")}


class _DictBackend:
  """A minimal in-memory backend with the storage backends' surface."""

  def __init__(self):
    self.objs = {}

  def put(self, key, data):
    self.objs[key] = bytes(data)

  def get(self, key):
    return self.objs.get(key)

  def get_range(self, key, start, length):
    data = self.objs.get(key)
    return None if data is None else data[start:start + length]

  def exists(self, key):
    return key in self.objs

  def delete(self, key):
    self.objs.pop(key, None)

  def size(self, key):
    data = self.objs.get(key)
    return None if data is None else len(data)

  def list(self, prefix=""):
    return iter(sorted(k for k in self.objs if k.startswith(prefix)))


# ---------------------------------------------------------------------------
# the schedule


@pytest.mark.parametrize("seed", [0, 7, 2**40 + 3])
def test_same_draws_and_decisions_as_jax(seed):
  """Every draw and every decision of a long mixed sequence, permanent
  keys and the per-key budget included, and the tallies they leave."""
  rng = np.random.default_rng(seed)
  rates = {k: float(v) for k, v in zip(KINDS, rng.random(len(KINDS)))}
  cfgs = {side: mod.ChaosConfig(seed=seed, max_faults_per_key=3, permanent="poison",
                                **rates)
          for side, (mod, _, _) in PKGS.items()}
  keys = [f"1_1_1/{i * 32}-{i * 32 + 32}_0-32_0-32" for i in range(12)] + ["poison/a"]
  ops = ["put", "corrupt", "storm.get", "crash_put", "drop_delete", "clock_skew"]
  for _ in range(2000):
    op = ops[int(rng.integers(len(ops)))]
    key = keys[int(rng.integers(len(keys)))]
    rate = float(rng.random())
    got = {side: (cfg.roll("draw", key), cfg.should_fault(op, key, rate))
           for side, cfg in cfgs.items()}
    assert got["port"] == got["jax"], (op, key)
  assert cfgs["port"]._counts == cfgs["jax"]._counts
  assert cfgs["port"]._faults == cfgs["jax"]._faults
  assert _chaos_counters(telemetry) == _chaos_counters(jax_telemetry)


def _storage_script(side, seed):
  """One sequence of wrapped storage calls: each call's answer."""
  mod, http_error, _ = PKGS[side]
  cfg = mod.ChaosConfig(seed=seed, put_fail=0.3, get_corrupt=0.3, storm=0.2,
                        crash_put=0.1, torn_write=0.2, bit_flip=0.2,
                        corrupt_key_re=r"^chunk/", max_faults_per_key=2)
  backend = _DictBackend()
  cs = mod.ChaosStorage(backend, cfg, "file://bucket/layer")
  out = []
  for i in range(300):
    key = f"chunk/{i % 9}" if i % 4 else f"info{i % 3}"
    call = ("put", "get", "get_range", "exists", "size", "list", "delete")[i % 7]
    try:
      if call == "put":
        got = cs.put(key, bytes(range(i % 50, i % 50 + 40)))
      elif call == "get":
        got = cs.get(key)
      elif call == "get_range":
        got = cs.get_range(key, 3, 7)
      elif call == "list":
        got = list(cs.list("chunk/"))
      else:
        got = getattr(cs, call)(key)
      out.append((call, key, "ok", got))
    except http_error as e:
      out.append((call, key, "http", e.status, str(e)))
    except mod.ChaosWorkerCrash as e:
      out.append((call, key, "crash", str(e)))
  return out, dict(backend.objs), list(cfg.injected)


@pytest.mark.parametrize("seed", [3, 11])
def test_storage_wrapper_answers_as_jax(seed):
  """Puts, gets, storms, crashes and the corruption at rest of one call
  sequence: the same answers, the same objects at rest, the same list of
  injected corruptions, the same tallies and trace events."""
  trace.reset()
  jax_trace.reset()
  ctx = {"port": trace.SpanContext("a" * 16, "root", True),
         "jax": jax_trace.SpanContext("a" * 16, "root", True)}
  runs = {}
  for side, tmod in (("port", trace), ("jax", jax_trace)):
    with tmod.activate(ctx[side]):
      runs[side] = _storage_script(side, seed)
  assert runs["port"] == runs["jax"]
  assert runs["port"][2], "nothing was corrupted at rest"
  assert _chaos_counters(telemetry) == _chaos_counters(jax_telemetry)
  events = {side: [(s["name"], s["key"]) for s in tmod.drain_spans()
                   if s["name"].startswith("chaos.")]
            for side, tmod in (("port", trace), ("jax", jax_trace))}
  assert events["port"] == events["jax"] and events["port"]


def test_queue_wrapper_faults_as_jax(tmp_path, deterministic):
  """Dropped deletes, skewed lease clocks and stalled workers on one
  script of leases and acks: the same answers, the same tallies and the
  same fenced acks."""
  results = {}
  for side, qcls, fail in (("port", FileQueue, FailTask), ("jax", JaxFileQueue, JaxFailTask)):
    deterministic()
    mod = PKGS[side][0]
    q = qcls(f"fq://{tmp_path}/{side}", max_deliveries=50)
    q.insert([fail(f"t{i}") for i in range(6)])
    cfg = mod.ChaosConfig(seed=5, drop_delete=0.4, clock_skew=0.3, stalled_worker=0.3,
                          max_faults_per_key=2)
    cq = mod.ChaosQueue(q, cfg)
    log = []
    for step in range(40):
      got = cq.lease(30)
      if got is None:
        log.append("empty")
        break
      _task, lease_id = got
      name = str(lease_id).split("--", 1)[-1]
      # a dropped ack leaves its lease held; a fenced one, its task leasable
      log.append((name, bool(cq.delete(lease_id)), q.enqueued, q.completed))
    results[side] = (log, dict(cfg._faults), q.completed)
  assert results["port"] == results["jax"]
  assert _chaos_counters(telemetry) == _chaos_counters(jax_telemetry)
  assert _chaos_counters(telemetry), "no queue fault fired"


# ---------------------------------------------------------------------------
# the cases of the JAX package's containment tests


def test_chaos_deterministic_and_healing():
  def storm_pattern(mod, http_error, seed):
    cs = mod.ChaosStorage(_DictBackend(), mod.ChaosConfig(seed=seed, put_fail=0.5,
                                                         max_faults_per_key=2))
    pattern = []
    for _ in range(10):
      try:
        cs.put("k", b"v")
        pattern.append("ok")
      except http_error:
        pattern.append("fail")
    return pattern

  for seed in range(8):
    a = storm_pattern(chaos, HttpError, seed)
    assert a == storm_pattern(chaos, HttpError, seed)
    assert a == storm_pattern(jax_chaos, JaxHttpError, seed)
    assert a.count("fail") <= 2 and a[-1] == "ok"


def test_chaos_permanent_key_always_faults():
  cs = chaos.ChaosStorage(_DictBackend(), chaos.ChaosConfig(seed=0, permanent="poison"))
  for _ in range(5):
    with pytest.raises(chaos.ChaosWorkerCrash):
      cs.put("has-poison-inside", b"v")
  cs.put("healthy", b"v")
  assert telemetry.counters_snapshot()["chaos.crash_put.permanent"] == 5


def test_chaos_corrupt_get_flips_bytes():
  out = {}
  for side, (mod, _, _) in PKGS.items():
    backend = _DictBackend()
    backend.put("k", b"hello world")
    cs = mod.ChaosStorage(backend, mod.ChaosConfig(seed=1, get_corrupt=1.0,
                                                   max_faults_per_key=1))
    out[side] = (cs.get("k"), cs.get("k"))
  assert out["port"] == out["jax"]
  assert out["port"][0] != b"hello world" and out["port"][1] == b"hello world"


def _layer_bytes(root):
  out = {}
  for dirpath, _dirs, files in os.walk(root):
    for fname in files:
      full = os.path.join(dirpath, fname)
      rel = os.path.relpath(full, root)
      if rel.startswith(("provenance", "integrity")) or ".tmp." in fname:
        continue
      with open(full, "rb") as f:
        out[rel] = f.read()
  return out


def _drain(q, lease_seconds=0.5, rounds=60):
  for _ in range(rounds):
    q.poll(lease_seconds=lease_seconds, stop_fn=lambda executed, empty: empty,
           max_backoff_window=0.05)
    if q.is_empty():
      return
    time.sleep(lease_seconds + 0.02)


def test_crash_between_compute_and_upload_converges(tmp_path):
  """A worker that crashes mid-upload, acks that are lost: the
  redeliveries converge to the clean run's bytes, which are the JAX
  package's clean run's."""
  img = np.random.default_rng(11).integers(0, 255, (64, 64, 32)).astype(np.uint8)

  def run(side, workdir, cfg=None):
    layer = f"file://{workdir}/layer"
    JaxVolume.from_numpy(img, layer, chunk_size=(32, 32, 32), compress="gzip")
    lib, qcls = (tc, FileQueue) if side == "port" else (jax_tc, JaxFileQueue)
    tasks = lib.create_downsampling_tasks(layer, mip=0, num_mips=1, memory_target=int(3e5),
                                          compress="gzip")
    q = qcls(f"fq://{workdir}/q", max_deliveries=20)
    q.insert(tasks)
    if cfg is None:
      _drain(q)
    else:
      with chaos.chaos_storage(cfg):
        _drain(chaos.ChaosQueue(q, cfg))
    assert q.is_empty() and q.dlq_count == 0
    return _layer_bytes(os.path.join(workdir, "layer"))

  clean = run("port", tmp_path / "clean")
  assert clean == run("jax", tmp_path / "jax")
  cfg = chaos.ChaosConfig(seed=5, crash_put=0.4, drop_delete=0.3, max_faults_per_key=1)
  assert run("port", tmp_path / "chaos", cfg) == clean
  fired = _chaos_counters(telemetry)
  assert fired.get("chaos.crash_put", 0) + fired.get("chaos.drop_delete", 0) > 0


def test_poison_dead_letter_record_as_jax(tmp_path, deterministic):
  """A task that always raises, on a ChaosQueue whose acks are dropped:
  the same dead-letter record in both packages."""
  recs = {}
  for side, qcls, fail in (("port", FileQueue, FailTask), ("jax", JaxFileQueue, JaxFailTask)):
    deterministic()
    mod = PKGS[side][0]
    q = qcls(f"fq://{tmp_path}/{side}", max_deliveries=3)
    q.insert([fail("boom-42")])
    cq = mod.ChaosQueue(q, mod.ChaosConfig(seed=2, drop_delete=1.0))
    for _ in range(4):
      cq.poll(lease_seconds=0.01, stop_fn=lambda executed, empty: empty)
      time.sleep(0.03)
    q.lease(0.01)
    assert q.dlq_count == 1
    rec = q.dlq_ls()[0]
    for f in rec.get("failures", []):
      f.pop("time", None)
    rec.pop("time", None)
    # the payload names its package and carries a trace of its own
    payload = json.loads(rec.pop("payload"))
    rec["task"] = (payload["class"], payload["params"])
    recs[side] = rec
  assert recs["port"] == recs["jax"]
  assert recs["port"]["deliveries"] == 3
  assert all("boom-42" in f["error"] for f in recs["port"]["failures"])


# ---------------------------------------------------------------------------
# faults mid-passthrough and mid-inference


def _seg_volume(path):
  rng = np.random.default_rng(7)
  cells = rng.integers(1, 2**40, size=(8, 8, 4)).astype(np.uint64)
  seg = np.kron(cells, np.ones((8, 8, 8), np.uint64))
  seg[rng.random(seg.shape) < 0.03] = 0
  JaxVolume.from_numpy(seg, path, chunk_size=(32, 32, 32), layer_type="segmentation",
                       encoding="compressed_segmentation", compress="gzip")


def test_chaos_fault_mid_passthrough_no_partials(tmp_path):
  """Failed puts and crashes mid-passthrough: the retried transfer leaves
  no partial object and writes the source's bytes, as the JAX package's
  transfer does."""
  src = f"file://{tmp_path}/src"
  _seg_volume(src)
  cfg = chaos.ChaosConfig(seed=11, put_fail=0.4, crash_put=0.25, max_faults_per_key=2)
  dest = f"file://{tmp_path}/chaos"
  attempts = 0
  with chaos.chaos_storage(cfg):
    while True:
      attempts += 1
      assert attempts < 80, "the chaos passthrough never converged"
      try:
        LocalTaskQueue(parallel=1).insert(tc.create_transfer_tasks(
          src, dest, skip_downsamples=True))
        break
      except Exception:  # noqa: BLE001 - a fault; retry as a lease would
        continue
  JaxQueue(parallel=1, progress=False).insert(jax_tc.create_transfer_tasks(
    src, f"file://{tmp_path}/jax", skip_downsamples=True))
  assert attempts > 1, "no fault fired"
  assert not glob.glob(str(tmp_path / "chaos" / "**" / "*.tmp.*"), recursive=True)
  chunks = {k: v for k, v in _layer_bytes(str(tmp_path / "chaos")).items() if k != "info"}
  assert chunks == {k: v for k, v in _layer_bytes(str(tmp_path / "src")).items() if k != "info"}
  assert _layer_bytes(str(tmp_path / "chaos")) == _layer_bytes(str(tmp_path / "jax"))


def test_chaos_mid_inference_converges(tmp_path, monkeypatch):
  """Failed puts, crashes and corrupt gets mid-inference: the dead-letter
  free retries write the port's clean bytes, and those equal the JAX
  package's output within the convnet tolerance."""
  monkeypatch.setenv("IGNEOUS_PIPELINE_THREADS", "1")
  monkeypatch.setenv("IGNEOUS_PIPELINE_PREFETCH", "3")
  registry.clear_model_cache()
  jax_registry.clear_model_cache()
  model = f"file://{tmp_path}/model"
  spec = JaxModelSpec("convnet3d", in_channels=1, out_channels=2, patch_shape=(32, 32, 16),
                      overlap=(8, 8, 4), hidden=(3,))
  jax_save_model(model, spec, jax_init_params(spec, seed=7))
  data = np.random.default_rng(5).random((64, 64, 32, 1)).astype(np.float32)
  roots = {n: tmp_path / n for n in ("clean", "chaos", "jax")}
  for root in roots.values():
    JaxVolume.from_numpy(data, f"file://{root}/src", chunk_size=(32, 32, 16),
                         layer_type="image")

  def make(lib, root):
    return list(lib.create_inference_tasks(f"file://{root}/src", f"file://{root}/out", model,
                                           shape=(32, 32, 16), batch_size=4))

  LocalTaskQueue(parallel=1).insert(make(tc, roots["clean"]))
  JaxQueue(parallel=1, progress=False).insert(make(jax_tc, roots["jax"]))
  cfg = chaos.ChaosConfig(seed=13, put_fail=0.2, crash_put=0.15, get_corrupt=0.1,
                          max_faults_per_key=1)
  q = LocalTaskQueue(parallel=1, max_deliveries=60)
  tasks = make(tc, roots["chaos"])  # planned outside the storm
  with chaos.chaos_storage(cfg):
    q.insert(tasks)
  assert not q.dead_letters, q.dead_letters
  assert _chaos_counters(telemetry), "no fault fired"
  assert not glob.glob(str(roots["chaos"] / "**" / "*.tmp.*"), recursive=True)
  clean, faulted = _layer_bytes(roots["clean"] / "out"), _layer_bytes(roots["chaos"] / "out")
  assert clean == faulted
  from igneous_tpu_torch import Volume

  got = Volume(f"file://{roots['chaos']}/out")
  want = JaxVolume(f"file://{roots['jax']}/out")
  np.testing.assert_allclose(got.download(got.meta.bounds(0)),
                             want.download(want.meta.bounds(0)), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the soak


def test_soak_faults_scenario_small(tmp_path):
  """The port's soak at a small size: the chaos layer equals the clean
  one, faults fired, and the poison task is in the DLQ after 3
  deliveries."""
  import igneous_tpu_torch.tasks  # noqa: F401

  img = np.random.default_rng(7).integers(0, 255, (48, 48, 24)).astype(np.uint8)
  report = chaos_soak.run_faults_scenario(str(tmp_path), img, seed=7)
  assert report["byte_identical"] and report["objects_compared"] > 2
  assert report["faults_injected"] > 0 and report["dlq_poison_deliveries"] == 3


def test_soak_main_prints_its_report(tmp_path, capsys):
  out = tmp_path / "report.json"
  assert chaos_soak.main(["--seed", "3", "--size", "32", "--report-out", str(out)]) == 0
  printed = json.loads(capsys.readouterr().out)
  assert printed == json.loads(out.read_text())
  assert printed["faults"]["byte_identical"] is True


def test_soak_refuses_a_failed_check():
  with pytest.raises(chaos_soak.SoakFailure, match="differ"):
    chaos_soak._check(False, "objects differ")
