"""The port's staged pipeline and passthrough transfer against the JAX
package.

(a) Byte identity: multi-task downsample streams (uint8 average and uint64
mode with ids at and above 2^63, ragged edges included) through the
port's LocalTaskQueue pipelined with threads, with ``IGNEOUS_PIPELINE=off``
and with ``IGNEOUS_PIPELINE_THREADS=0`` (in order), every file equal to
the JAX package's default LocalTaskQueue run. (b) The runner's semantics,
each scenario run on both packages' runners: the byte budget and its
interrupt, write barriers for unaligned and aligned writers of one key,
fail-fast after the uploads in flight join, dead letters, the drain, and
solo tasks behind a barrier; plans prove alignment exactly where the
reference's do. (c) The passthrough: eligible raw and
compressed_segmentation copies decode nothing and write the source's
bytes, and every ineligible case takes the decode route with the
reference's bytes.
"""

import itertools
import pathlib
import threading

import numpy as np
import pytest

import igneous_tpu.pipeline as jax_pipeline
import igneous_tpu.telemetry as jax_telemetry
from igneous_tpu import Volume as JaxVolume
from igneous_tpu import task_creation as jax_tc
from igneous_tpu.lib import Bbox as JaxBbox
from igneous_tpu.queues import LocalTaskQueue as JaxQueue
from igneous_tpu.tasks import FailTask as JaxFailTask
from igneous_tpu.tasks.image import TransferTask as JaxTransferTask
from igneous_tpu_torch import Bbox, Volume, chunk_cache, codecs, device, pipeline, telemetry
from igneous_tpu_torch import task_creation as tc
from igneous_tpu_torch.lifecycle import StopFlag
from igneous_tpu_torch.queues import LocalTaskQueue
from igneous_tpu_torch.queues.registry import RegisteredTask
from igneous_tpu_torch.tasks import TransferTask

KNOBS = ("IGNEOUS_PIPELINE", "IGNEOUS_PIPELINE_THREADS", "IGNEOUS_PIPELINE_PREFETCH",
         "IGNEOUS_PIPELINE_MEM_MB", "IGNEOUS_TRANSFER_PASSTHROUGH", "IGNEOUS_CHUNK_CACHE")
RUNNERS = {"port": pipeline, "jax": jax_pipeline}


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  for name in KNOBS:
    monkeypatch.delenv(name, raising=False)
  device.reset_device()
  telemetry.reset()
  yield
  device.reset_device()


@pytest.fixture
def forced_threads(monkeypatch):
  """The threaded scheduler even on a one-core host, with small pools."""
  monkeypatch.setenv("IGNEOUS_PIPELINE_THREADS", "1")
  monkeypatch.setenv("IGNEOUS_PIPELINE_PREFETCH", "3")
  monkeypatch.setenv("IGNEOUS_PIPELINE_IO_THREADS", "2")
  monkeypatch.setenv("IGNEOUS_PIPELINE_ENCODE_THREADS", "2")


def _files(root: pathlib.Path):
  """Every file under ``root`` but provenance (which holds dates)."""
  return {
    str(p.relative_to(root)): p.read_bytes()
    for p in sorted(root.rglob("*")) if p.is_file() and p.name != "provenance"
  }


def assert_same_files(got: dict, want: dict, min_files: int):
  assert len(want) >= min_files
  assert sorted(got) == sorted(want)
  assert [k for k in want if got[k] != want[k]] == []


# ---------------------------------------------------------------------------
# (a) byte identity of task streams

STREAM_SHAPE = (200, 168, 16)  # 4 x 3 tasks of 64x64x16, ragged in x and y


def _stream_data(kind):
  rng = np.random.default_rng(5)
  if kind == "uint8_average":
    return rng.integers(0, 256, STREAM_SHAPE, dtype=np.uint8)
  ids = np.array([0, 2**63, 2**63 + 2**40 + 3, 2**64 - 1, 2**40, 17], np.uint64)
  return ids[rng.integers(0, 6, STREAM_SHAPE)]


def _stream(root: pathlib.Path, kind: str, who: str):
  path = f"file://{root / 'layer'}"
  make_volume = JaxVolume.from_numpy if who == "jax" else Volume.from_numpy
  data = _stream_data(kind)
  make_volume(data, path, resolution=(8, 8, 40), chunk_size=(16, 16, 16))
  make = jax_tc.create_downsampling_tasks if who == "jax" else tc.create_downsampling_tasks
  tasks = list(make(path, mip=0, num_mips=2, memory_target=int(1e5) * data.itemsize))
  assert len(tasks) == 12 and list(tasks[0].shape) == [64, 64, 16]
  if who == "jax":
    JaxQueue(parallel=1, progress=False).insert(tasks)
    return None
  q = LocalTaskQueue()
  q.insert(tasks)
  assert q.completed == 12
  return q.pipeline_stats


@pytest.fixture(scope="module")
def reference_streams(tmp_path_factory):
  """The JAX package's default LocalTaskQueue on each stream's layer."""
  out = {}
  for kind in ("uint8_average", "uint64_mode"):
    root = tmp_path_factory.mktemp(f"jax_{kind}")
    _stream(root, kind, "jax")
    out[kind] = _files(root / "layer")
  return out


MODES = {
  "pipelined": {"IGNEOUS_PIPELINE_THREADS": "1", "IGNEOUS_PIPELINE_IO_THREADS": "2",
                "IGNEOUS_PIPELINE_ENCODE_THREADS": "3"},
  "serial": {"IGNEOUS_PIPELINE": "off"},
  "in_order": {"IGNEOUS_PIPELINE_THREADS": "0"},
}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("kind", ["uint8_average", "uint64_mode"])
def test_stream_matches_reference_in_every_mode(tmp_path, monkeypatch, reference_streams,
                                                kind, mode):
  for name, value in MODES[mode].items():
    monkeypatch.setenv(name, value)
  stats = _stream(tmp_path, kind, "port")
  if mode == "serial":
    assert stats is None
  else:
    assert stats == {"executed": 12, "staged": 12, "solo": 0, "failed": 0, "drained": False}
  assert_same_files(_files(tmp_path / "layer"), reference_streams[kind], min_files=100)


# ---------------------------------------------------------------------------
# (b) runner semantics, each scenario on both packages' runners


class _PlanTask:
  """A task that publishes a hand-built plan (or none: it runs solo)."""

  def __init__(self, plan=None, execute=None):
    self._plan, self._execute = plan, execute

  def stage_plan(self):
    return self._plan

  def execute(self):
    if self._execute is None:
      raise AssertionError("a staged task ran solo")
    self._execute()


@pytest.mark.parametrize("who", sorted(RUNNERS))
def test_bounded_buffer_budget_and_interrupt(who):
  runner = RUNNERS[who]
  buf = runner.BoundedBuffer(100, name=f"t_{who}")
  buf.acquire(60)
  buf.acquire(40)  # exactly at the budget
  waiting, passed = threading.Event(), threading.Event()

  def producer():
    waiting.set()
    buf.acquire(10)  # over the budget: waits for a release
    passed.set()

  t = threading.Thread(target=producer, daemon=True)
  t.start()
  assert waiting.wait(5)
  assert buf.bytes_held == 100 and not passed.is_set()
  buf.release(60)
  assert passed.wait(5), "a release did not wake the waiting producer"
  t.join(5)
  assert buf.bytes_held == 50

  # one oversized item passes an empty buffer
  big = runner.BoundedBuffer(10, name=f"t2_{who}")
  big.acquire(1000)
  big.release(1000)

  # put/get hand items over in order; a closed, empty buffer returns None
  fifo = runner.BoundedBuffer(10, name=f"t3_{who}")
  fifo.put("a")
  fifo.put("b")
  fifo.close()
  assert [fifo.get(), fifo.get(), fifo.get()] == ["a", "b", None]

  # a drain flag wakes a blocked producer with PipelineInterrupted
  flag = StopFlag()
  blocked = runner.BoundedBuffer(10, name=f"t4_{who}")
  blocked.interrupt(flag)
  blocked.acquire(10)
  errors, started = [], threading.Event()

  def blocked_producer():
    started.set()
    try:
      blocked.acquire(10)
    except runner.PipelineInterrupted:
      errors.append("interrupted")

  t = threading.Thread(target=blocked_producer, daemon=True)
  t.start()
  assert started.wait(5)
  flag.set("test")
  t.join(5)
  assert errors == ["interrupted"]


@pytest.mark.parametrize("a_aligned", [False, True])
@pytest.mark.parametrize("who", sorted(RUNNERS))
def test_unaligned_same_key_writers_serialize(forced_threads, who, a_aligned):
  """A writer that cannot prove alignment waits for every upload in flight
  to the same (layer, mip), aligned or not, before its download starts."""
  runner = RUNNERS[who]
  log, b_downloaded, a_put_started = [], threading.Event(), threading.Event()

  def a_upload(outputs, sink):
    def put():
      a_put_started.set()
      # an overlapping download of B would set the event while A writes
      log.append("A.put overlapped" if b_downloaded.wait(0.5) else "A.put")
    sink.submit(put)

  def b_download():
    log.append("B.download")
    b_downloaded.set()

  tasks = [
    _PlanTask(runner.StagePlan(lambda: None, lambda p: None, a_upload,
                               writes={("mem://ww", 0)}, aligned_writes=a_aligned)),
    _PlanTask(runner.StagePlan(b_download, lambda p: None, lambda o, s: None,
                               writes={("mem://ww", 0)})),
  ]
  stats = runner.run_tasks_pipelined(tasks)
  assert a_put_started.is_set()
  assert log == ["A.put", "B.download"]
  assert stats["staged"] == 2 and stats["failed"] == 0


@pytest.mark.parametrize("who", sorted(RUNNERS))
def test_aligned_same_key_writers_keep_pipelining(forced_threads, who):
  """Writers that prove alignment touch disjoint chunk objects: B's
  download runs while A's upload is still in flight."""
  runner = RUNNERS[who]
  b_downloaded = threading.Event()
  seen = []

  def a_upload(outputs, sink):
    sink.submit(lambda: seen.append(b_downloaded.wait(10)))

  tasks = [
    _PlanTask(runner.StagePlan(lambda: None, lambda p: None, a_upload,
                               writes={("mem://wwa", 0)}, aligned_writes=True)),
    _PlanTask(runner.StagePlan(b_downloaded.set, lambda p: None, lambda o, s: None,
                               writes={("mem://wwa", 0)}, aligned_writes=True)),
  ]
  stats = runner.run_tasks_pipelined(tasks)
  assert seen == [True], "aligned writers of one key were serialized"
  assert stats["staged"] == 2


@pytest.mark.parametrize("who", sorted(RUNNERS))
def test_fail_fast_reraises_after_uploads_in_flight_join(forced_threads, who):
  """Without on_error, B's compute failure re-raises only once A's upload,
  still in flight when B failed, has landed."""
  runner = RUNNERS[who]
  log, b_failed = [], threading.Event()

  def a_upload(outputs, sink):
    def put():
      assert b_failed.wait(10)
      log.append("A.put")
    sink.submit(put)

  def b_compute(payload):
    log.append("B.compute")
    b_failed.set()
    raise RuntimeError("B failed")

  tasks = [
    _PlanTask(runner.StagePlan(lambda: None, lambda p: None, a_upload,
                               writes={("mem://ff", 1)}, aligned_writes=True)),
    _PlanTask(runner.StagePlan(lambda: None, b_compute, lambda o, s: None,
                               writes={("mem://ff", 1)}, aligned_writes=True)),
    _PlanTask(runner.StagePlan(lambda: log.append("C.download"), lambda p: None,
                               lambda o, s: None, reads={("mem://ff", 1)})),
  ]
  with pytest.raises(RuntimeError, match="B failed"):
    runner.run_tasks_pipelined(tasks)
  assert log[:2] == ["B.compute", "A.put"]
  assert "C.compute" not in log


@pytest.mark.parametrize("who", sorted(RUNNERS))
def test_task_without_plan_runs_solo_behind_a_barrier(forced_threads, who):
  runner = RUNNERS[who]
  log, solo_ran = [], threading.Event()

  def a_upload(outputs, sink):
    # a solo task running while A still writes would set the event
    sink.submit(lambda: log.append("A.put overlapped" if solo_ran.wait(0.5) else "A.put"))

  def solo():
    log.append("S.execute")
    solo_ran.set()

  tasks = [
    _PlanTask(runner.StagePlan(lambda: None, lambda p: None, a_upload,
                               writes={("mem://solo", 1)}, aligned_writes=True)),
    _PlanTask(None, execute=solo),
    _PlanTask(runner.StagePlan(lambda: log.append("B.download"), lambda p: None,
                               lambda o, s: None)),
  ]
  stats = runner.run_tasks_pipelined(tasks)
  assert log == ["A.put", "S.execute", "B.download"]
  assert stats == {"executed": 3, "staged": 2, "solo": 1, "failed": 0, "drained": False}


@pytest.mark.parametrize("who", sorted(RUNNERS))
def test_on_error_contains_a_failure_and_the_stream_completes(forced_threads, who):
  runner = RUNNERS[who]
  failed, completed = [], []

  def boom(payload):
    raise ValueError("poison")

  tasks = [_PlanTask(runner.StagePlan(lambda: None, lambda p: None, lambda o, s: None))
           for _ in range(4)]
  tasks.insert(2, _PlanTask(runner.StagePlan(lambda: None, boom, lambda o, s: None)))
  stats = runner.run_tasks_pipelined(
    tasks, on_error=lambda t, e: failed.append((tasks.index(t), str(e))),
    on_complete=lambda t: completed.append(tasks.index(t)),
  )
  assert failed == [(2, "poison")]
  assert sorted(completed) == [0, 1, 3, 4]
  assert stats == {"executed": 4, "staged": 4, "solo": 0, "failed": 1, "drained": False}


class PoisonTask(RegisteredTask):
  """Fails every delivery; ``staged`` fails in its plan's compute stage,
  else in a solo execute()."""

  def __init__(self, staged: bool = False):
    self.staged = staged

  def stage_plan(self):
    if not self.staged:
      return None

    def compute(payload):
      raise RuntimeError("intentional failure")

    return pipeline.StagePlan(lambda: None, compute, lambda o, s: None)

  def execute(self):
    raise RuntimeError("intentional failure")


class FlakyTask(RegisteredTask):
  """Fails its first delivery only (a marker file remembers it)."""

  def __init__(self, marker: str):
    self.marker = marker

  def execute(self):
    marker = pathlib.Path(self.marker)
    if not marker.exists():
      marker.write_text("failed once")
      raise RuntimeError("first delivery")


def _poison_layer(root, who):
  path = f"file://{root / 'layer'}"
  data = np.random.default_rng(3).integers(0, 255, (96, 64, 16), dtype=np.uint8)
  (JaxVolume if who == "jax" else Volume).from_numpy(data, path, chunk_size=(16, 16, 16))
  make = jax_tc.create_downsampling_tasks if who == "jax" else tc.create_downsampling_tasks
  tasks = list(make(path, mip=0, num_mips=1, memory_target=int(3e4)))
  assert len(tasks) >= 4
  return tasks


@pytest.mark.parametrize("who,staged", [("port", False), ("port", True), ("jax", False)])
def test_poison_task_dead_letters_and_the_stream_completes(tmp_path, forced_threads,
                                                           who, staged):
  tasks = _poison_layer(tmp_path, who)
  n = len(tasks)
  if who == "jax":
    tasks.insert(1, JaxFailTask())
    q = JaxQueue(parallel=1, progress=False, max_deliveries=3)
  else:
    tasks.insert(1, PoisonTask(staged=staged))
    q = LocalTaskQueue(max_deliveries=3)
  q.insert(tasks)
  assert len(q.dead_letters) == 1
  assert q.dead_letters[0]["error"] == "RuntimeError: intentional failure"
  assert q.completed == n and q.inserted == n + 1
  if who == "port":
    assert q.pipeline_stats["failed"] == 1 and q.pipeline_stats["staged"] == n
  mip1 = (JaxVolume if who == "jax" else Volume)(f"file://{tmp_path / 'layer'}", mip=1)
  assert mip1.download(mip1.bounds).shape[:3] == (48, 32, 16)


@pytest.mark.parametrize("pipelined", [True, False])
def test_a_failed_delivery_is_retried_before_it_dead_letters(tmp_path, monkeypatch,
                                                             forced_threads, pipelined):
  """The pipelined attempt spends one delivery; the retry runs solo and
  completes the task, so nothing is dead-lettered."""
  if not pipelined:
    monkeypatch.setenv("IGNEOUS_PIPELINE", "off")
  tasks = _poison_layer(tmp_path, "port")
  tasks.insert(1, FlakyTask(str(tmp_path / "marker")))
  q = LocalTaskQueue(max_deliveries=2)
  q.insert(tasks)
  assert q.dead_letters == [] and q.completed == len(tasks)
  assert (tmp_path / "marker").exists()


def test_poison_dead_letters_match_between_packages(tmp_path, forced_threads):
  """The same stream with one poison task: both packages' layers are equal
  file for file and both dead-letter the poison alone."""
  trees = {}
  for who in ("jax", "port"):
    root = tmp_path / who
    tasks = _poison_layer(root, who)
    tasks.insert(2, JaxFailTask() if who == "jax" else PoisonTask(staged=True))
    q = (JaxQueue(parallel=1, progress=False, max_deliveries=2) if who == "jax"
         else LocalTaskQueue(max_deliveries=2))
    q.insert(tasks)
    assert len(q.dead_letters) == 1
    trees[who] = _files(root / "layer")
  assert_same_files(trees["port"], trees["jax"], min_files=20)


@pytest.mark.parametrize("who", sorted(RUNNERS))
def test_drain_mid_stream_joins_uploads_and_leaves_no_partial_object(tmp_path, forced_threads,
                                                                     who):
  tasks = _poison_layer(tmp_path, who)
  flag = StopFlag()
  completed = []

  def on_complete(task):
    completed.append(task)
    flag.set("test drain")

  stats = RUNNERS[who].run_tasks_pipelined(tasks, drain_flag=flag, on_complete=on_complete)
  assert stats["drained"] is True
  assert 0 < stats["executed"] == len(completed) < len(tasks)
  layer = tmp_path / "layer"
  assert not list(layer.rglob("*.tmp.*"))
  vol1 = (JaxVolume if who == "jax" else Volume)(f"file://{layer}", mip=1)
  # every completed task's mip-1 cutout is whole; every chunk object decodes
  for task in completed:
    lo = np.asarray(task.offset) // (2, 2, 1)
    hi = np.minimum(np.asarray(task.offset + task.shape) // (2, 2, 1),
                    np.asarray(vol1.bounds.maxpt))
    vol1.download((JaxBbox if who == "jax" else Bbox)(lo, hi))
  written = list((layer / vol1.meta.key(1)).iterdir())
  assert 0 < len(written) < 24


@pytest.mark.parametrize("pipelined", [True, False])
def test_local_queue_drain_flag_stops_admission(tmp_path, monkeypatch, forced_threads,
                                                pipelined):
  if not pipelined:
    monkeypatch.setenv("IGNEOUS_PIPELINE", "off")
  tasks = _poison_layer(tmp_path, "port")
  flag = StopFlag()
  flag.set("before the insert")
  q = LocalTaskQueue(drain_flag=flag)
  q.insert(tasks)
  assert q.drained and q.completed == 0
  if pipelined:
    assert q.pipeline_stats["drained"] and q.pipeline_stats["executed"] == 0
  assert not (tmp_path / "layer" / Volume(f"file://{tmp_path / 'layer'}").meta.key(1)).exists()


def test_spawn_pool_refuses_the_options_it_lacks():
  with pytest.raises(NotImplementedError):
    LocalTaskQueue(parallel=2, max_deliveries=3)
  with pytest.raises(NotImplementedError):
    LocalTaskQueue(parallel=2, drain_flag=StopFlag())


def test_execute_with_sink_writes_what_execute_writes(tmp_path, monkeypatch, forced_threads):
  """A solo task's encodes and puts on the shared pool (IGNEOUS_PIPELINE=on),
  joined before it returns: the bytes of execute() and of the JAX package."""
  monkeypatch.setenv("IGNEOUS_PIPELINE", "on")
  trees = {}
  for who in ("jax", "port", "port_execute"):
    root = tmp_path / who
    tasks = _poison_layer(root, "jax" if who == "jax" else "port")
    for task in tasks:
      if who == "jax":
        jax_pipeline.execute_with_sink(task)
      elif who == "port":
        pipeline.execute_with_sink(task)
      else:
        task.execute()
    trees[who] = _files(root / "layer")
  assert_same_files(trees["port"], trees["jax"], min_files=20)
  assert_same_files(trees["port_execute"], trees["jax"], min_files=20)


@pytest.mark.parametrize("compress,ext", [("gzip", ".gz"), (None, ""), (False, ""),
                                          ("br", None)])
def test_wire_ext_matches_reference(compress, ext):
  from igneous_tpu import storage as jax_storage
  from igneous_tpu_torch import storage

  assert storage.wire_ext(compress) == jax_storage.wire_ext(compress) == ext
  if ext is not None:
    method = storage.method_for_ext(ext)
    assert method == jax_storage.method_for_ext(ext)
    assert storage.wire_ext(method) == ext


# ---------------------------------------------------------------------------
# alignment proofs against the reference

GRID_SHAPES = [(256, 256, 16), (128, 128, 16), (512, 512, 16), (192, 128, 16), (64, 64, 16)]
GRID_OFFSETS = [(0, 0, 0), (128, 0, 0), (256, 256, 0), (64, 0, 0), (384, 128, 0),
                (512, 384, 0)]
GRID_TRANSLATES = [(0, 0, 0), (128, 0, 0), (1, 0, 0), (0, 0, 16)]


def _alignment_layers(root, who):
  """A 601x421x32 uint8 source in 128x128x16 chunks with 2 mips (ragged,
  and of odd extent, at every level), and a destination with the same
  scales."""
  V = JaxVolume if who == "jax" else Volume
  src = f"file://{root / 'src'}"
  V.from_numpy(np.zeros((601, 421, 32), np.uint8), src, chunk_size=(128, 128, 16))
  make = jax_tc.create_downsampling_tasks if who == "jax" else tc.create_downsampling_tasks
  list(make(src, mip=0, num_mips=2, memory_target=int(8e6)))  # adds the scales
  dest = f"file://{root / 'dest'}"
  V.from_numpy(np.zeros((601, 421, 32), np.uint8), dest, chunk_size=(128, 128, 16))
  list(make(dest, mip=0, num_mips=2, memory_target=int(8e6)))
  return src, dest


def test_plans_prove_alignment_where_the_reference_does(tmp_path):
  proofs = {}
  for who in ("jax", "port"):
    src, dest = _alignment_layers(tmp_path / who, who)
    Task = JaxTransferTask if who == "jax" else TransferTask
    out = []
    for shape, offset, translate, skip_first, num_mips in itertools.product(
        GRID_SHAPES, GRID_OFFSETS, GRID_TRANSLATES, (False, True), (1, 2)):
      task = Task(src_path=src, dest_path=dest, mip=0, shape=shape, offset=offset,
                  translate=translate, skip_first=skip_first, num_mips=num_mips,
                  factor=(2, 2, 1))
      out.append(task.stage_plan().aligned_writes)
    proofs[who] = out
  assert proofs["port"] == proofs["jax"]
  assert any(proofs["port"]) and not all(proofs["port"])


def test_downsample_grid_proves_alignment(tmp_path):
  src, _ = _alignment_layers(tmp_path, "port")
  plans = [t.stage_plan() for t in tc.create_downsampling_tasks(
    src, mip=0, num_mips=1, memory_target=int(2e6))]
  assert len(plans) == 12 and all(p.aligned_writes for p in plans)


# ---------------------------------------------------------------------------
# (c) the passthrough transfer


def _seg(shape, seed=0):
  rng = np.random.default_rng(seed)
  ids = np.array([0, 2**40, 2**63 + 5, 77, 2**33], np.uint64)
  return ids[rng.integers(0, 5, shape)]


PASS_SOURCES = {
  "raw": dict(make=lambda: np.random.default_rng(1).integers(0, 255, (96, 80, 32), np.uint8),
              kw=dict(chunk_size=(32, 32, 16))),
  "cseg": dict(make=lambda: _seg((96, 80, 32)),
               kw=dict(chunk_size=(32, 32, 16), encoding="compressed_segmentation")),
}


def _count_decodes(monkeypatch):
  calls = []
  real = codecs.decode

  def counted(*a, **k):
    calls.append(1)
    return real(*a, **k)

  monkeypatch.setattr(codecs, "decode", counted)
  return calls


def _pass_roots(tmp_path, source):
  spec = PASS_SOURCES[source]
  data = spec["make"]()
  roots = {}
  for who in ("jax", "port"):
    roots[who] = tmp_path / who
    JaxVolume.from_numpy(data, f"file://{roots[who] / 'src'}", resolution=(8, 8, 40),
                         **spec["kw"])
  return roots


def _transfer(roots, who, **kw):
  make = jax_tc.create_transfer_tasks if who == "jax" else tc.create_transfer_tasks
  kw.setdefault("shape", (64, 64, 16))
  bounds = kw.pop("bounds", None)
  if bounds is not None:
    kw["bounds"] = (JaxBbox if who == "jax" else Bbox)(*bounds)
  tasks = list(make(f"file://{roots[who] / 'src'}", f"file://{roots[who] / 'dest'}", **kw))
  if who == "jax":
    JaxQueue(parallel=1, progress=False).insert(tasks)
  else:
    LocalTaskQueue().insert(tasks)
  return tasks


@pytest.mark.parametrize("compress", ["gzip", None])
@pytest.mark.parametrize("source", sorted(PASS_SOURCES))
def test_passthrough_decodes_nothing_and_writes_the_source_bytes(tmp_path, monkeypatch,
                                                                 forced_threads, source,
                                                                 compress):
  roots = _pass_roots(tmp_path, source)
  jax_telemetry.reset_counters()
  _transfer(roots, "jax", skip_downsamples=True, compress=compress)
  decodes = _count_decodes(monkeypatch)
  tasks = _transfer(roots, "port", skip_downsamples=True, compress=compress)
  assert decodes == []
  plans = [t.stage_plan() for t in tasks]
  assert all(p.aligned_writes for p in plans)
  assert {(p.reads, p.writes) for p in plans} == {(
    frozenset({(f"file://{roots['port'] / 'src'}", 0)}),
    frozenset({(f"file://{roots['port'] / 'dest'}", 0)}),
  )}
  port, jax = _files(roots["port"] / "dest"), _files(roots["jax"] / "dest")
  assert_same_files(port, jax, min_files=19)
  chunks = {k: v for k, v in port.items() if k.startswith("8_8_40/")}
  assert len(chunks) == 3 * 3 * 2
  counts = telemetry.counters()
  jax_counts = jax_telemetry.counters_snapshot()
  for name in ("chunks", "bytes", "verbatim", "recompressed"):
    key = f"transfer.passthrough.{name}"
    assert counts.get(key, 0) == jax_counts.get(key, 0), key
  assert counts["transfer.passthrough.chunks"] == len(chunks)
  if compress == "gzip":
    # moved verbatim: each chunk file is the source's file
    assert counts["transfer.passthrough.verbatim"] == len(chunks)
    src = _files(roots["port"] / "src")
    assert all(src[k] == v for k, v in chunks.items())
  else:
    assert counts["transfer.passthrough.recompressed"] == len(chunks)
    assert all(not k.endswith(".gz") for k in chunks)
  got = Volume(f"file://{roots['port'] / 'dest'}")
  want = Volume(f"file://{roots['port'] / 'src'}")
  assert np.array_equal(got.download(got.bounds), want.download(want.bounds))


def _existing_dest(roots, who, **info_changes):
  """A destination made beforehand: the source's info with changes."""
  import json

  info = json.loads((roots[who] / "src" / "info").read_text())
  info["scales"] = info["scales"][:1]
  for key, value in info_changes.items():
    if key == "data_type":
      info[key] = value
    else:
      info["scales"][0][key] = value
  (JaxVolume if who == "jax" else Volume).create(f"file://{roots[who] / 'dest'}", info)


INELIGIBLE = {
  # name: (source, transfer keywords, destination info changes, env)
  "knob_off": ("raw", dict(skip_downsamples=True), None, {"IGNEOUS_TRANSFER_PASSTHROUGH": "off"}),
  "downsample": ("raw", dict(num_mips=1), None, {}),
  "skip_first": ("raw", dict(num_mips=1, skip_first=True), None, {}),
  "translate": ("raw", dict(skip_downsamples=True, translate=(32, 0, 0)), None, {}),
  "fill_missing": ("raw", dict(skip_downsamples=True, fill_missing=True), None, {}),
  "delete_black_uploads": ("raw", dict(skip_downsamples=True, delete_black_uploads=True),
                           None, {}),
  "chunk_size": ("raw", dict(skip_downsamples=True, chunk_size=(16, 16, 16)), None, {}),
  "encoding": ("cseg", dict(skip_downsamples=True, encoding="raw"), None, {}),
  "cseg_block_size": ("cseg", dict(skip_downsamples=True),
                      {"compressed_segmentation_block_size": [4, 4, 4]}, {}),
  "voxel_offset": ("raw", dict(skip_downsamples=True),
                   {"voxel_offset": [-32, 0, 0], "size": [128, 80, 32]}, {}),
  "bounds": ("raw", dict(skip_downsamples=True), {"size": [128, 80, 32]}, {}),
  "dtype": ("raw", dict(skip_downsamples=True), {"data_type": "uint16"}, {}),
}


@pytest.mark.parametrize("case", sorted(INELIGIBLE))
def test_ineligible_transfer_takes_the_decode_route_with_the_reference_bytes(
    tmp_path, monkeypatch, forced_threads, case):
  source, kw, dest_info, env = INELIGIBLE[case]
  for name, value in env.items():
    monkeypatch.setenv(name, value)
  roots = _pass_roots(tmp_path, source)
  if source == "raw" and case in ("delete_black_uploads", "fill_missing"):
    for who in roots:
      if case == "delete_black_uploads":  # whole chunks of background
        v = Volume(f"file://{roots[who] / 'src'}")
        v.upload(Bbox((0, 0, 0), (32, 32, 16)), np.zeros((32, 32, 16, 1), np.uint8))
      else:  # a missing chunk, read back as background
        (roots[who] / "src" / "8_8_40" / "32-64_0-32_0-16.gz").unlink()
  if dest_info is not None:
    for who in roots:
      _existing_dest(roots, who, **dest_info)
  for who in ("jax", "port"):
    _transfer(roots, who, **kw)
  counts = telemetry.counters()
  assert counts.get("transfer.passthrough.chunks", 0) == 0
  assert_same_files(_files(roots["port"] / "dest"), _files(roots["jax"] / "dest"),
                    min_files=5)


def test_passthrough_runs_beside_a_downsample_stream(tmp_path, forced_threads):
  """Staged passthrough plans and downsample plans in one stream, the
  cache on, equal to the JAX package's run of the same stream."""
  trees = {}
  for who in ("jax", "port"):
    root = tmp_path / who
    V = JaxVolume if who == "jax" else Volume
    data = np.random.default_rng(9).integers(0, 255, (96, 80, 32), np.uint8)
    V.from_numpy(data, f"file://{root / 'src'}", chunk_size=(32, 32, 16))
    xfer = jax_tc.create_transfer_tasks if who == "jax" else tc.create_transfer_tasks
    ds = jax_tc.create_downsampling_tasks if who == "jax" else tc.create_downsampling_tasks
    tasks = list(xfer(f"file://{root / 'src'}", f"file://{root / 'dest'}",
                      skip_downsamples=True, shape=(64, 64, 16)))
    tasks += list(ds(f"file://{root / 'dest'}", mip=0, num_mips=1, memory_target=int(1e5)))
    if who == "jax":
      JaxQueue(parallel=1, progress=False).insert(tasks)
    else:
      q = LocalTaskQueue()
      q.insert(tasks)
      assert q.pipeline_stats["staged"] == len(tasks)
      assert telemetry.counters()["transfer.passthrough.verbatim"] == 18
    trees[who] = _files(root / "dest")
  assert_same_files(trees["port"], trees["jax"], min_files=25)
  chunk_cache.clear()
