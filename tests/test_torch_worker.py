"""Whole layers through the port's queue worker, against the JAX package.

``image downsample --queue fq://...`` then ``execute -x`` and ``execute
--batch 4 -x`` write the layers the JAX package's CLI writes with its own
worker (a 601x421 ragged layer, uint8 average and uint64 mode, so the
batched rounds run full members through ``ChunkExecutor`` and clamped ones
through ``PagedPyramid``), and the JAX worker drains a queue the port
filled; the lease batcher's stats equal the JAX package's on the same
queue; ``ccl auto --queue`` and the CCL passes with ``faces`` batched,
``mesh forge`` and ``skeleton forge`` with ``--batch 2`` plus their
merges write the JAX package's files; a poisoned member falls back to
solo and dead-letters after ``--max-deliveries``; ``-n 3`` and
``--min-sec 0`` stop exactly. Layer comparisons leave out ``provenance``
(a date) and compare the integrity sidecars normalised (records without
their ``ts``, segment names without ``w<pid>_<seq>``).
"""

import pathlib
import random
import types
import uuid

import numpy as np
import pytest
from click.testing import CliRunner

import igneous_tpu.tasks  # noqa: F401  (registers the JAX package's tasks)
from igneous_tpu import Volume as JaxVolume
from igneous_tpu import task_creation as jax_tc
from igneous_tpu.cli import main as jax_cli
from igneous_tpu.parallel.lease_batcher import poll_batched as jax_poll_batched
from igneous_tpu.queues import filequeue as jax_filequeue
from igneous_tpu_torch import Volume, device
from igneous_tpu_torch import task_creation as tc
from igneous_tpu_torch.cli import main as cli_main
from igneous_tpu_torch.parallel.lease_batcher import poll_batched
from igneous_tpu_torch.queues import FileQueue, filequeue as port_filequeue
from igneous_tpu_torch.tasks import TouchFileTask

from test_torch_integrity import flush_local, layer_tree
from test_torch_mesh_tasks import IDS, voronoi
from test_torch_skeleton_tasks import tubes

SHAPE = (601, 421, 8)
KINDS = {"uint8_average": (np.uint8, "image"), "uint64_mode": (np.uint64, "segmentation")}


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  # the JAX package batches on its XLA pyramid, as its device hosts do
  monkeypatch.setenv("IGNEOUS_POOL_HOST", "0")
  monkeypatch.setenv("IGNEOUS_EDT_BACKEND", "native")
  monkeypatch.setenv("IGNEOUS_QUEUE_RECYCLE_SEC", "0")
  flush_local()  # the JAX package's `execute` flushes every buffered layer
  for name in ("IGNEOUS_PAGE_SHAPE", "IGNEOUS_PAGE_BATCH", "IGNEOUS_PIPELINE",
               "IGNEOUS_MESH_EMIT", "IGNEOUS_CCL_TILE"):
    monkeypatch.delenv(name, raising=False)
  device.reset_device()
  yield
  device.reset_device()


def _files(root: pathlib.Path) -> dict:
  """Every file of a layer but its provenance, with the integrity sidecars
  normalised (``test_torch_integrity.layer_tree``)."""
  return layer_tree(root)


def _data(kind):
  dtype = KINDS[kind][0]
  rng = np.random.default_rng(11)
  if dtype == np.uint64:
    ids = np.array([0, 2**63 + 5, 2**40, 7, 2**64 - 1], np.uint64)
    return ids[rng.integers(0, 5, SHAPE)]
  return rng.integers(0, 256, SHAPE, dtype=np.uint8)


def _layer(root: pathlib.Path, kind: str, who: str) -> str:
  path = f"file://{root / 'layer'}"
  (JaxVolume if who == "jax" else Volume).from_numpy(
    _data(kind), path, resolution=(8, 8, 40), chunk_size=(32, 32, 8),
    layer_type=KINDS[kind][1],
  )
  return path


def _downsample_args(kind):
  """Two mips of 128x128x8 tasks for either dtype."""
  return ["--num-mips", "2", "--memory", str(200000 * np.dtype(KINDS[kind][0]).itemsize)]


def _jax(args):
  res = CliRunner().invoke(jax_cli, args, catch_exceptions=False)
  assert res.exit_code == 0, res.output
  return res.output


@pytest.fixture(scope="module")
def reference_layers(tmp_path_factory):
  """The JAX package's CLI: downsample into a queue, drain it with its
  worker."""
  out = {}
  for kind in KINDS:
    root = tmp_path_factory.mktemp(f"jax_{kind}")
    path = _layer(root, kind, "jax")
    _jax(["image", "downsample", path, *_downsample_args(kind), "-q", f"fq://{root / 'q'}"])
    _jax(["execute", f"fq://{root / 'q'}", "-x", "-q"])
    out[kind] = _files(root / "layer")
  return out


@pytest.mark.parametrize("mode", ["solo", "batch4", "jax_worker"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_downsample_through_the_queue_matches_jax(tmp_path, reference_layers, kind, mode,
                                                  capsys):
  path = _layer(tmp_path, kind, "port")
  spec = f"fq://{tmp_path / 'q'}"
  assert cli_main(["image", "downsample", path, *_downsample_args(kind), "--queue", spec]) == 0
  n = FileQueue(spec).enqueued
  assert n > 8
  if mode == "jax_worker":
    out = _jax(["execute", spec, "-x", "--batch", "4"])
  else:
    capsys.readouterr()
    assert cli_main(["execute", spec, "-x"] + (["--batch", "4"] if mode == "batch4" else [])) == 0
    out = capsys.readouterr().out
  if mode != "solo":
    assert f"executed {n} tasks ({n} batched in" in out
  got, want = _files(tmp_path / "layer"), reference_layers[kind]
  assert len(want) > 100 and sorted(got) == sorted(want)
  assert [k for k in want if got[k] != want[k]] == []
  assert FileQueue(spec).depth_snapshot()["completed"] == n


@pytest.fixture
def deterministic(monkeypatch):
  """Queue file names from a counter and the first pick of the lease
  window: both packages lease the same rounds."""
  state = {"n": 0}

  def uuid4():
    state["n"] += 1
    return uuid.UUID(int=state["n"])

  for module in (jax_filequeue, port_filequeue):
    monkeypatch.setattr(module, "uuid", types.SimpleNamespace(uuid4=uuid4))
  monkeypatch.setattr(random, "randrange", lambda n: 0)
  return lambda: state.update(n=0)


STATS = ("executed", "batched", "solo", "failed", "released", "group_fallbacks")


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_batcher_stats_match_jax(tmp_path, deterministic, kind):
  stats = {}
  for who in ("jax", "port"):
    root = tmp_path / who
    path = _layer(root, kind, who)
    make = jax_tc.create_downsampling_tasks if who == "jax" else tc.create_downsampling_tasks
    memory = 200000 * np.dtype(KINDS[kind][0]).itemsize
    tasks = list(make(path, mip=0, num_mips=2, memory_target=memory))
    assert len(tasks) == 20
    deterministic()
    q = (jax_filequeue.FileQueue if who == "jax" else FileQueue)(f"fq://{root / 'q'}")
    q.insert_batch(tasks, total=len(tasks))
    run = jax_poll_batched if who == "jax" else poll_batched
    executed, st = run(q, batch_size=4, lease_seconds=60,
                       stop_fn=lambda executed, empty: empty)
    stats[who] = {k: st[k] for k in STATS}
    stats[who]["dispatches"] = dict(st["dispatches"])
    assert executed == len(tasks)
  assert stats["port"] == stats["jax"]
  assert stats["port"]["dispatches"]["downsample"] > 0
  assert stats["port"]["dispatches"]["downsample_paged"] > 0


# ---------------------------------------------------------------------------
# CCL, meshes and skeletons through the queue


def _checkerboard(shape, cell):
  grid = (np.indices(shape) // cell).sum(axis=0)
  return (grid % 2 == 0).astype(np.uint8)


def test_ccl_through_the_queue_matches_jax(tmp_path, monkeypatch, capsys):
  """``ccl auto --queue`` (each pass drained by the solo loop) and the
  passes one by one with ``faces`` through ``execute --batch 4`` write
  the JAX package's destination."""
  monkeypatch.setenv("IGNEOUS_CCL_BACKEND", "native")
  data = _checkerboard((70, 52, 30), 9)
  opts = ["--shape", "32,32,16", "--threshold-gte", "1"]
  srcs = {}
  for who in ("jax", "auto", "passes"):
    srcs[who] = f"file://{tmp_path / who / 'src'}"
    JaxVolume.from_numpy(data, srcs[who], layer_type="image", chunk_size=(16, 16, 16))
  dest = {who: f"file://{tmp_path / who / 'dest'}" for who in srcs}
  _jax(["image", "ccl", "auto", srcs["jax"], dest["jax"], *opts, "--encoding", "raw"])
  assert cli_main(["image", "ccl", "auto", srcs["auto"], dest["auto"], *opts,
                   "--encoding", "raw", "--queue", f"fq://{tmp_path / 'qa'}"]) == 0
  spec = f"fq://{tmp_path / 'qp'}"
  src = srcs["passes"]
  assert cli_main(["image", "ccl", "faces", src, *opts, "-q", spec]) == 0
  capsys.readouterr()
  assert cli_main(["execute", spec, "-x", "--batch", "4"]) == 0
  assert "(12 batched in 3 dispatches" in capsys.readouterr().out
  for step in (["image", "ccl", "links", src, *opts, "-q", spec], ["execute", spec, "-x"],
               ["image", "ccl", "calc-labels", src],
               ["image", "ccl", "relabel", src, dest["passes"], *opts, "--encoding", "raw",
                "-q", spec],
               ["execute", spec, "-x", "--batch", "4"], ["image", "ccl", "clean", src]):
    assert cli_main(step) == 0
  want = _files(tmp_path / "jax" / "dest")
  assert len(want) > 10
  assert _files(tmp_path / "auto" / "dest") == want
  assert _files(tmp_path / "passes" / "dest") == want
  assert FileQueue(f"fq://{tmp_path / 'qa'}").completed == 3 * 12


def test_mesh_forge_batched_through_the_queue_matches_jax(tmp_path, capsys):
  data = voronoi(np.uint32, seed=1)
  args = ["--shape", "32,32,32", "--dust", "40", "--labels",
          ",".join(str(int(v) % 2**32) for v in IDS[:9]), "--simplify-factor", "20"]
  paths = {}
  for who in ("jax", "port"):
    paths[who] = tmp_path / who
    JaxVolume.from_numpy(data, f"file://{paths[who]}", resolution=(8, 8, 40),
                         chunk_size=(16, 16, 16), layer_type="segmentation")
  _jax(["mesh", "forge", f"file://{paths['jax']}", *args])
  _jax(["mesh", "merge", f"file://{paths['jax']}", "--magnitude", "3"])
  spec = f"fq://{tmp_path / 'q'}"
  assert cli_main(["mesh", "forge", f"file://{paths['port']}", *args, "-q", spec]) == 0
  capsys.readouterr()
  assert cli_main(["execute", spec, "-x", "--batch", "2"]) == 0
  assert "executed 4 tasks (4 batched in" in capsys.readouterr().out
  assert cli_main(["mesh", "merge", f"file://{paths['port']}", "--magnitude", "3",
                   "-q", spec]) == 0
  assert cli_main(["execute", spec, "-x"]) == 0
  got, want = _files(paths["port"]), _files(paths["jax"])
  assert len(want) > 10 and got == want


def test_skeleton_forge_batched_through_the_queue_matches_jax(tmp_path, capsys):
  data = tubes(seed=3)
  labels = [str(v) for v in np.unique(data) if v][:8]
  args = ["--shape", "32,24,24", "--dust-threshold", "40", "--const", "80",
          "--labels", ",".join(labels), "--no-fix-branching"]
  merge = ["--dust-threshold", "50", "--tick-threshold", "100", "--magnitude", "2"]
  paths = {}
  for who in ("jax", "port"):
    paths[who] = tmp_path / who
    JaxVolume.from_numpy(data, f"file://{paths[who]}", resolution=(8, 8, 40),
                         chunk_size=(16, 16, 8), layer_type="segmentation")
  _jax(["skeleton", "forge", f"file://{paths['jax']}", *args])
  _jax(["skeleton", "merge", f"file://{paths['jax']}", *merge])
  spec = f"fq://{tmp_path / 'q'}"
  assert cli_main(["skeleton", "forge", f"file://{paths['port']}", *args, "-q", spec]) == 0
  capsys.readouterr()
  assert cli_main(["execute", spec, "-x", "--batch", "2"]) == 0
  assert "executed 4 tasks (4 batched in 2 dispatches" in capsys.readouterr().out
  assert cli_main(["skeleton", "merge", f"file://{paths['port']}", *merge, "-q", spec]) == 0
  assert cli_main(["execute", spec, "-x"]) == 0
  got, want = _files(paths["port"]), _files(paths["jax"])
  assert len(want) > 10 and got == want


# ---------------------------------------------------------------------------
# containment and budgets


def test_a_poisoned_member_falls_back_and_dead_letters(tmp_path):
  """One member's chunk is corrupt: its group falls back to solo, the
  healthy members complete, the poisoned one dead-letters after two
  deliveries with its reason."""
  path = _layer(tmp_path, "uint8_average", "port")
  tasks = list(tc.create_downsampling_tasks(path, mip=0, num_mips=2, memory_target=200000))
  chunk = next((tmp_path / "layer" / "8_8_40").glob("0-32_0-32_0-8*"))
  chunk.write_bytes(b"not a chunk")
  q = FileQueue(f"fq://{tmp_path / 'q'}", max_deliveries=2)
  q.insert_batch(tasks, total=len(tasks))
  # the heartbeat holds the healthy members; the failed one, no longer
  # renewed, recycles when its 2 s lease runs out
  executed, stats = poll_batched(
    q, batch_size=4, lease_seconds=2,
    stop_fn=lambda executed, empty: empty and q.enqueued == 0,
  )
  assert stats["group_fallbacks"] >= 1 and stats["failed"] == 2
  assert executed == len(tasks) - 1 == q.completed
  [rec] = q.dlq_ls()
  assert rec["deliveries"] == 2 and len(rec["failures"]) == 2
  assert list(rec["failures"][-1]) == ["time", "error"]
  assert '"offset": [0, 0, 0]' in rec["payload"]


@pytest.mark.parametrize("args,expected", [
  (["-n", "3"], 3), (["-n", "3", "--batch", "4"], 3),
  (["--min-sec", "0"], 1), (["--min-sec", "0", "--batch", "4"], 1),
])
def test_num_tasks_and_min_sec_zero_stop_exactly(tmp_path, args, expected):
  q = FileQueue(f"fq://{tmp_path / 'q'}")
  q.insert_batch([TouchFileTask(str(tmp_path / "out" / f"t{i}")) for i in range(10)])
  assert cli_main(["execute", f"fq://{tmp_path / 'q'}", "-q", *args]) == 0
  assert len(list((tmp_path / "out").iterdir())) == expected
  snap = q.depth_snapshot()
  assert (snap["completed"], snap["leased"], snap["enqueued"]) == (expected, 0, 10 - expected)


def test_execute_time_prints_a_record_a_task(tmp_path, capsys):
  import json

  path = _layer(tmp_path, "uint8_average", "port")
  spec = f"fq://{tmp_path / 'q'}"
  tasks = list(tc.create_downsampling_tasks(path, mip=0, num_mips=2, memory_target=200000))[:3]
  FileQueue(spec).insert(tasks)
  capsys.readouterr()
  assert cli_main(["execute", spec, "-x", "-q", "--time"]) == 0
  records = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
  assert [r["task"] for r in records] == ["DownsampleTask"] * 3
  for r in records:
    assert r["wall_s"] > 0 and {"download", "upload"} <= set(r["stages"])
    assert all(set(v) == {"seconds", "count"} for v in r["stages"].values())


def test_execute_batch_time_prints_a_record_a_round(tmp_path, capsys):
  import json

  path = _layer(tmp_path, "uint8_average", "port")
  spec = f"fq://{tmp_path / 'q'}"
  tasks = list(tc.create_downsampling_tasks(path, mip=0, num_mips=2, memory_target=200000))[:5]
  FileQueue(spec).insert(tasks)
  capsys.readouterr()
  assert cli_main(["execute", spec, "-x", "-q", "--time", "--batch", "4"]) == 0
  records = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
  # four members ride one group; the round that leased the last one runs it solo
  assert [r["round_members"] for r in records] == [4, 1]
  assert [(r["executed"], r["solo"], r["group_fallbacks"], r["failed"]) for r in records] \
    == [(4, 0, 0, 0), (1, 1, 0, 0)]
  assert records[0]["dispatches"] and records[1]["dispatches"] == {}
  assert FileQueue(spec).completed == 5
