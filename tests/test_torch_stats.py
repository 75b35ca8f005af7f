"""The port's voxel-count census against the JAX package's.

create_voxel_counting_tasks -> LocalTaskQueue -> CountVoxelsTask, then
accumulate_voxel_counts, on the same layer in both packages: every census
JSON (gzip) and ``voxel_counts.im`` byte for byte equal, the key order of
the JSON numpy's ascending order (uint64 ids at or above 2^63 last). A
census written by either package is read by the other's
``load_voxel_counts``; ``globally_small_labels`` agrees, and both raise
without a census; the command lines ``image voxels count|sum`` agree.
"""

import gzip
import json
import pathlib
import struct

import numpy as np
import pytest
from click.testing import CliRunner

from igneous_tpu import Volume as JaxVolume
from igneous_tpu import task_creation as jax_tc
from igneous_tpu.cli import main as jax_cli
from igneous_tpu.queues import LocalTaskQueue as JaxQueue
from igneous_tpu.queues.registry import serialize as jax_serialize
from igneous_tpu.tasks import stats as jax_stats
from igneous_tpu_torch import device
from igneous_tpu_torch import task_creation as tc
from igneous_tpu_torch.cli import main as cli_main
from igneous_tpu_torch.mesh_io import FragMap
from igneous_tpu_torch.queues import LocalTaskQueue, deserialize
from igneous_tpu_torch.tasks import CountVoxelsTask
from igneous_tpu_torch.tasks import stats

SHAPE = (40, 36, 20)
TASK = (16, 16, 16)  # 3 x 3 x 2 tasks, ragged at the far faces


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  device.reset_device()
  yield
  device.reset_device()


IDS = {
  np.uint64: [0, 2**63 + 1, 2**64 - 1, 2**63, 5, 2**40 + 7, 2**63 - 1, 77],
  np.uint32: [0, 2**32 - 1, 2**31, 5, 77, 123456],
  np.uint16: [0, 65535, 300, 5],
  np.uint8: [0, 255, 3, 128],
}


def labels(dtype=np.uint64, seed=0) -> np.ndarray:
  rng = np.random.default_rng(seed)
  ids = np.asarray(IDS[dtype], dtype=dtype)
  # blocks of labels, so that counts differ widely between tasks
  coarse = rng.choice(ids, size=(10, 9, 5))
  return np.asfortranarray(coarse.repeat(4, 0).repeat(4, 1).repeat(4, 2))


def _files(root: pathlib.Path):
  return {
    str(p.relative_to(root)): p.read_bytes()
    for p in sorted(root.rglob("*")) if p.is_file() and p.name != "provenance"
  }


def _census_files(root: pathlib.Path):
  return {k: v for k, v in _files(root).items() if k.startswith("stats/")}


def _layers(tmp_path, data):
  paths = {}
  for who in ("jax", "port"):
    paths[who] = tmp_path / who
    JaxVolume.from_numpy(data, f"file://{paths[who]}", resolution=(8, 8, 40),
                         chunk_size=(16, 16, 8), layer_type="segmentation")
  return paths


def _census_both(paths, shape=TASK):
  JaxQueue(parallel=1, progress=False).insert(
    jax_tc.create_voxel_counting_tasks(f"file://{paths['jax']}", shape=shape))
  ref = jax_tc.accumulate_voxel_counts(f"file://{paths['jax']}")
  LocalTaskQueue().insert(tc.create_voxel_counting_tasks(f"file://{paths['port']}", shape=shape))
  got = tc.accumulate_voxel_counts(f"file://{paths['port']}")
  return ref, got


@pytest.mark.parametrize("dtype", [np.uint64, np.uint32, np.uint16, np.uint8],
                         ids=lambda d: np.dtype(d).name)
def test_census_files_match_reference(dtype, tmp_path):
  data = labels(dtype)
  paths = _layers(tmp_path, data)
  ref, got = _census_both(paths)
  assert got == ref
  uniq, counts = np.unique(data, return_counts=True)
  assert got == {int(l): int(c) for l, c in zip(uniq, counts)}
  files = _census_files(paths["port"])
  assert len(files) == 3 * 3 * 2 + 1
  assert files == _census_files(paths["jax"])


def test_census_json_keys_in_numpy_order(tmp_path):
  """Labels at or above 2^63 come after the smaller ones, as numpy sorts
  uint64: the JSON's key order is its bytes."""
  data = labels(np.uint64)
  paths = _layers(tmp_path, data)
  LocalTaskQueue().insert(tc.create_voxel_counting_tasks(
    f"file://{paths['port']}", shape=SHAPE))
  name = next(k for k in _census_files(paths["port"]) if k.endswith(".gz"))
  doc = json.loads(gzip.decompress(_census_files(paths["port"])[name]))
  keys = [int(k) for k in doc]
  assert keys == sorted(keys) and keys[-1] == 2**64 - 1
  assert keys == [int(v) for v in np.unique(data)]


def test_census_of_a_bounded_grid_and_offset_layer(tmp_path):
  data = labels(np.uint64, seed=3)
  paths = {}
  for who in ("jax", "port"):
    paths[who] = tmp_path / who
    JaxVolume.from_numpy(data, f"file://{paths[who]}", resolution=(4, 4, 40),
                         voxel_offset=(3, 5, 2), chunk_size=(16, 16, 8),
                         layer_type="segmentation")
  ref, got = _census_both(paths, shape=(24, 20, 12))
  assert got == ref
  assert _census_files(paths["port"]) == _census_files(paths["jax"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_census(writer, tmp_path):
  data = labels(np.uint64, seed=1)
  paths = _layers(tmp_path, data)
  path = f"file://{paths[writer]}"
  if writer == "jax":
    JaxQueue(parallel=1, progress=False).insert(jax_tc.create_voxel_counting_tasks(path, shape=TASK))
    jax_tc.accumulate_voxel_counts(path)
  else:
    LocalTaskQueue().insert(tc.create_voxel_counting_tasks(path, shape=TASK))
    tc.accumulate_voxel_counts(path)
  ref = jax_stats.load_voxel_counts(path)
  got = stats.load_voxel_counts(path)
  assert len(got) == len(ref)
  for label in IDS[np.uint64] + [12345]:
    assert got.get(label) == ref.get(label)
  uniq, counts = np.unique(data, return_counts=True)
  for label, count in zip(uniq, counts):
    assert struct.unpack("<Q", got.get(int(label)))[0] == count


def test_globally_small_labels_match_reference(tmp_path):
  data = labels(np.uint64, seed=2)
  paths = _layers(tmp_path, data)
  _census_both(paths)
  query = [int(v) for v in np.unique(data)] + [999, 2**63 + 77]
  for threshold in (1, 64, 400, 1000, 10**6):
    ref = jax_stats.globally_small_labels(f"file://{paths['jax']}", 0, query, threshold)
    got = stats.globally_small_labels(f"file://{paths['port']}", 0, query, threshold)
    assert got == ref


def test_globally_small_labels_without_a_census_raises(tmp_path):
  paths = _layers(tmp_path, labels())
  with pytest.raises(ValueError, match="voxel-count census"):
    jax_stats.globally_small_labels(f"file://{paths['jax']}", 0, [5], 10)
  with pytest.raises(ValueError, match="voxel-count census"):
    stats.globally_small_labels(f"file://{paths['port']}", 0, [5], 10)
  assert stats.load_voxel_counts(f"file://{paths['port']}") is None


def test_fragmap_bytes_match_reference():
  from igneous_tpu.mesh_io import FragMap as JaxFragMap

  mapping = {2**64 - 1: b"a", 5: b"", 2**63: b"xyz" * 9, 0: struct.pack("<Q", 7)}
  blob = FragMap.tobytes(mapping)
  assert blob == JaxFragMap.tobytes(mapping)
  fm = FragMap.frombytes(blob)
  assert len(fm) == 4
  for key, value in mapping.items():
    assert fm.get(key) == value
  assert fm.get(6) is None and fm.get(2**64 - 2) is None
  with pytest.raises(ValueError):
    FragMap.frombytes(b"nope" + blob[4:])


def test_cli_voxels_count_and_sum_match_reference(tmp_path):
  paths = _layers(tmp_path, labels(np.uint32))
  runner = CliRunner()
  for args in (["count", f"file://{paths['jax']}", "--shape", "16,16,16"],
               ["sum", f"file://{paths['jax']}", "-o", str(tmp_path / "jax.im")]):
    res = runner.invoke(jax_cli, ["image", "voxels", *args])
    assert res.exit_code == 0, res.output
  assert cli_main(["image", "voxels", "count", f"file://{paths['port']}",
                   "--shape", "16,16,16"]) == 0
  assert cli_main(["image", "voxels", "sum", f"file://{paths['port']}",
                   "-o", str(tmp_path / "port.im")]) == 0
  assert _census_files(paths["port"]) == _census_files(paths["jax"])
  assert (tmp_path / "port.im").read_bytes() == (tmp_path / "jax.im").read_bytes()


def test_cli_voxels_sum_without_compression(tmp_path):
  paths = _layers(tmp_path, labels(np.uint8))
  runner = CliRunner()
  res = runner.invoke(jax_cli, ["image", "voxels", "count", f"file://{paths['jax']}"])
  assert res.exit_code == 0, res.output
  res = runner.invoke(jax_cli, ["image", "voxels", "sum", f"file://{paths['jax']}",
                                "--compress", "none"])
  assert res.exit_code == 0, res.output
  assert cli_main(["image", "voxels", "count", f"file://{paths['port']}"]) == 0
  assert cli_main(["image", "voxels", "sum", f"file://{paths['port']}", "--compress", "none"]) == 0
  assert _census_files(paths["port"]) == _census_files(paths["jax"])
  assert "stats/voxel_counts/0/voxel_counts.im" in _census_files(paths["port"])


def test_reference_payload_runs_in_the_port(tmp_path):
  paths = _layers(tmp_path, labels(np.uint64, seed=4))
  tasks = list(jax_tc.create_voxel_counting_tasks(f"file://{paths['jax']}", shape=TASK))
  JaxQueue(parallel=1, progress=False).insert(tasks)
  for task in tasks:
    payload = jax_serialize(task).replace(str(paths["jax"]), str(paths["port"]))
    ported = deserialize(payload)
    assert type(ported) is CountVoxelsTask
    ported.execute()
  assert _census_files(paths["port"]) == _census_files(paths["jax"])


def test_graphene_census_options_are_refused(tmp_path):
  paths = _layers(tmp_path, labels())
  with pytest.raises(NotImplementedError, match="agglomerate"):
    tc.create_voxel_counting_tasks(f"file://{paths['port']}", agglomerate=True)
  with pytest.raises(NotImplementedError, match="timestamp"):
    CountVoxelsTask(f"file://{paths['port']}", TASK, (0, 0, 0), timestamp=5.0)
