"""The port's skeleton forge and merge against the JAX package's.

The same layer goes through both packages' create_skeletonizing_tasks ->
LocalTaskQueue -> SkeletonTask, then
create_unsharded_skeleton_merge_tasks -> UnshardedSkeletonMergeTask:
every file under the skeleton directory (the skeleton info, the gzip
``.sk`` fragments, the ``.spatial`` files, the merged skeletons) and the
layer's info must be byte-identical. Also: payloads the JAX package
serialized run in the port, the border pins follow the JAX package's
plane numbering, the command lines agree, and the options the port does
not run yet raise before anything is read or written.
"""

import pathlib

import numpy as np
import pytest
from click.testing import CliRunner

from igneous_tpu import Volume as JaxVolume
from igneous_tpu import task_creation as jax_tc
from igneous_tpu.cli import main as jax_cli
from igneous_tpu.ops.ccl import _ccl_native
from igneous_tpu.queues import LocalTaskQueue as JaxQueue
from igneous_tpu.queues.registry import serialize as jax_serialize
from igneous_tpu.tasks.skeleton import border_targets as jax_border_targets
from igneous_tpu_torch import CloudFiles, Volume, device
from igneous_tpu_torch import task_creation as tc
from igneous_tpu_torch.cli import main as cli_main
from igneous_tpu_torch.ops.ccl import connected_components
from igneous_tpu_torch.queues import LocalTaskQueue, deserialize
from igneous_tpu_torch.skeleton_io import Skeleton
from igneous_tpu_torch.tasks import SkeletonTask, UnshardedSkeletonMergeTask
from igneous_tpu_torch.tasks.skeleton import border_targets

SHAPE = (64, 48, 24)  # (x, y, z)
# small layers: dust and the TEASAR ball scaled down with them
FORGE = dict(dust_threshold=40, teasar_params={"scale": 4, "const": 80})
MERGE = dict(dust_threshold=50.0, tick_threshold=100.0)


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  monkeypatch.setenv("IGNEOUS_EDT_BACKEND", "native")
  device.reset_device()
  yield
  device.reset_device()


def tubes(n=14, seed=0, dtype=np.uint64) -> np.ndarray:
  """(x, y, z) labels: ``n`` straight tubes (radius 1.5-4 voxels) between
  random points, so that many cross the task boundaries; a third of the
  ids at or above 2^63 (uint64), two labels used twice."""
  rng = np.random.default_rng(seed)
  out = np.zeros(SHAPE, dtype)
  grid = np.stack(np.meshgrid(*[np.arange(s) for s in SHAPE], indexing="ij"), -1)
  grid = grid.astype(np.float64)
  for i in range(n):
    a, b = rng.random(3) * SHAPE, rng.random(3) * SHAPE
    d = b - a
    t = np.clip(((grid - a) @ d) / (d @ d), 0, 1)
    dist = np.linalg.norm(grid - (a + t[..., None] * d), axis=-1)
    j = i % (n - 2)
    label = 2**63 + 17 * j if dtype == np.uint64 and j % 3 == 0 else 1000 + 7 * j
    out[dist <= rng.uniform(1.5, 4.0)] = label
  return np.asfortranarray(out)


def _files(root: pathlib.Path):
  """Every file of a layer but its provenance (which records a date)."""
  return {
    str(p.relative_to(root)): p.read_bytes()
    for p in sorted(root.rglob("*")) if p.is_file() and p.name != "provenance"
  }


def _skel_files(root: pathlib.Path):
  """The files under the skeleton directories."""
  return {k: v for k, v in _files(root).items() if k.startswith("skel")}


def _layers(tmp_path, data, chunk=(16, 16, 8)):
  paths = {}
  for who in ("jax", "port"):
    paths[who] = tmp_path / who
    JaxVolume.from_numpy(data, f"file://{paths[who]}", resolution=(8, 8, 40),
                         chunk_size=chunk, layer_type="segmentation")
  return paths


def _forge_both(tmp_path, data, task, merge=True, **kw):
  paths = _layers(tmp_path, data)
  kw = {**FORGE, **kw}
  JaxQueue(parallel=1, progress=False).insert(
    jax_tc.create_skeletonizing_tasks(f"file://{paths['jax']}", shape=task, **kw))
  LocalTaskQueue().insert(tc.create_skeletonizing_tasks(f"file://{paths['port']}", shape=task, **kw))
  if merge:
    JaxQueue(parallel=1, progress=False).insert(
      jax_tc.create_unsharded_skeleton_merge_tasks(f"file://{paths['jax']}", **MERGE))
    LocalTaskQueue().insert(tc.create_unsharded_skeleton_merge_tasks(
      f"file://{paths['port']}", **MERGE))
  return paths


CASES = {
  # task grids: 1, 2 and 4 tasks (border pins on the shared planes)
  "grid_1": ((64, 48, 24), {}),
  "grid_2": ((32, 48, 24), {}),
  "grid_4": ((32, 24, 24), {}),
  "grid_4_uint32": ((32, 24, 24), {"dtype": np.uint32}),
  "no_fix_borders": ((32, 24, 24), {"fix_borders": False}),
  "no_fix_branching_parallel_3": ((32, 24, 24), {"fix_branching": False, "parallel": 3}),
  "object_ids": ((32, 24, 24), {"object_ids": [1000 + 7, 2**63 + 51, 1000 + 7 * 4, 5]}),
  "mask_ids": ((32, 24, 24), {"mask_ids": [1000 + 7, 2**63]}),
  "fix_avocados_skel_dir": ((32, 48, 24), {"fix_avocados": True, "skel_dir": "skels"}),
  "no_spatial_index": ((32, 48, 24), {"spatial_index": False}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forge_and_merge_match_reference(case, tmp_path):
  task, kw = CASES[case]
  kw = dict(kw)
  data = tubes(dtype=kw.pop("dtype", np.uint64))
  paths = _forge_both(tmp_path, data, task, **kw)
  ref, got = _skel_files(paths["jax"]), _skel_files(paths["port"])
  assert sum(k.endswith(".gz") and ":" in k for k in got) > 5
  assert sorted(got) == sorted(ref)
  assert [k for k in ref if got[k] != ref[k]] == []
  assert _files(paths["port"])["info"] == _files(paths["jax"])["info"]


def test_synapse_targets_match_reference(tmp_path):
  """Synapses become per-task extra targets, typed vertices included."""
  data = tubes()
  labels = [int(v) for v in np.unique(data[32]) if v][:3]  # on task 2's first plane
  rng = np.random.default_rng(9)
  synapses = []
  for i, label in enumerate(labels):
    for vox in np.argwhere(data == label)[rng.choice(20, 3, replace=False)]:
      synapses.append((tuple(float(v) for v in vox * (8, 8, 40)), label, i + 2))
  on_plane = np.argwhere(data[32] == labels[0])[0]
  synapses.append(((32 * 8.0, on_plane[0] * 8.0, on_plane[1] * 40.0), labels[0], 0))
  paths = _forge_both(tmp_path, data, (32, 24, 24), merge=False, synapses=synapses)
  assert _skel_files(paths["port"]) == _skel_files(paths["jax"])


def test_reference_payload_runs_in_the_port(tmp_path):
  paths = _layers(tmp_path, tubes(seed=1))
  for who in ("jax", "port"):  # writes the infos
    jax_tc.create_skeletonizing_tasks(f"file://{paths[who]}", shape=(32, 24, 24), **FORGE)
  tasks = list(jax_tc.create_skeletonizing_tasks(
    f"file://{paths['jax']}", shape=(32, 24, 24), **FORGE))
  merges = list(jax_tc.create_unsharded_skeleton_merge_tasks(f"file://{paths['jax']}", **MERGE))
  JaxQueue(parallel=1, progress=False).insert(tasks + merges)
  for task, cls in [(t, SkeletonTask) for t in tasks] + [(t, UnshardedSkeletonMergeTask) for t in merges]:
    payload = jax_serialize(task).replace(str(paths["jax"]), str(paths["port"]))
    ported = deserialize(payload)
    assert type(ported) is cls
    ported.execute()
  assert _skel_files(paths["port"]) == _skel_files(paths["jax"])


def test_each_package_reads_the_others_fragments(tmp_path):
  """Fragments forged by one package merge in the other to the same
  skeletons."""
  paths = _layers(tmp_path, tubes(seed=2))
  LocalTaskQueue().insert(tc.create_skeletonizing_tasks(
    f"file://{paths['port']}", shape=(32, 24, 24), **FORGE))
  JaxQueue(parallel=1, progress=False).insert(jax_tc.create_skeletonizing_tasks(
    f"file://{paths['jax']}", shape=(32, 24, 24), **FORGE))
  JaxQueue(parallel=1, progress=False).insert(
    jax_tc.create_unsharded_skeleton_merge_tasks(f"file://{paths['port']}", **MERGE))
  LocalTaskQueue().insert(tc.create_unsharded_skeleton_merge_tasks(
    f"file://{paths['jax']}", **MERGE))
  merged = {k: v for k, v in _skel_files(paths["port"]).items() if ":" not in k}
  assert len(merged) > 3
  assert merged == {k: v for k, v in _skel_files(paths["jax"]).items() if ":" not in k}


def test_merged_skeletons_cross_the_task_boundaries(tmp_path):
  """A tube through every task merges into one connected skeleton."""
  data = np.zeros(SHAPE, np.uint64)
  data[2:62, 20:26, 8:14] = 2**63 + 1
  data[30:34, 2:46, 16:22] = 77
  paths = _layers(tmp_path, np.asfortranarray(data))
  path = f"file://{paths['port']}"
  LocalTaskQueue().insert(tc.create_skeletonizing_tasks(path, shape=(16, 16, 24), **FORGE))
  LocalTaskQueue().insert(tc.create_unsharded_skeleton_merge_tasks(path, **MERGE))
  cf = CloudFiles(path)
  # (label, axis, the first and the last task boundary it crosses)
  for label, axis, first, last in ((2**63 + 1, 0, 16, 48), (77, 1, 16, 32)):
    skel = Skeleton.from_precomputed(cf.get(f"skeletons_mip_0/{label}"))
    assert len(np.unique(skel.components_by_vertex())) == 1
    coord = skel.vertices[:, axis] / 8
    assert coord.min() < first and coord.max() > last


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_border_targets_number_planes_as_the_reference(seed):
  """The pins of each label follow the JAX package's plane numbering
  (``_ccl_native``), so the port's CPU labelling must number alike."""
  data = tubes(seed=seed, n=20)
  for axis in range(3):
    plane = np.take(data, data.shape[axis] // 2, axis=axis)
    ref = _ccl_native(np.ascontiguousarray(plane[:, :, None]), 6)[0]
    got = connected_components(plane[:, :, None], 6)
    assert np.array_equal(got, ref)
  core = (32, 24, 12)
  for low in [(False, False, False), (True, True, True)]:
    got = border_targets(data, core, low)
    ref = jax_border_targets(data, core, low)
    assert sorted(got) == sorted(ref)
    for label in ref:
      assert np.array_equal(got[label], ref[label])


def test_cli_forge_and_merge_match_reference(tmp_path):
  paths = _layers(tmp_path, tubes(seed=3))
  labels = [str(v) for v in np.unique(tubes(seed=3)) if v][:8]
  args = ["--shape", "32,24,24", "--dust-threshold", "40", "--const", "80",
          "--labels", ",".join(labels), "--no-fix-branching"]
  merge = ["--dust-threshold", "50", "--tick-threshold", "100", "--magnitude", "2"]
  runner = CliRunner()
  res = runner.invoke(jax_cli, ["skeleton", "forge", f"file://{paths['jax']}", *args])
  assert res.exit_code == 0, res.output
  res = runner.invoke(jax_cli, ["skeleton", "merge", f"file://{paths['jax']}", *merge])
  assert res.exit_code == 0, res.output
  assert cli_main(["skeleton", "forge", f"file://{paths['port']}", *args]) == 0
  assert cli_main(["skeleton", "merge", f"file://{paths['port']}", *merge]) == 0
  assert _skel_files(paths["port"]) == _skel_files(paths["jax"])


REFUSED = {
  "sharded": (dict(sharded=True), ["--sharded"]),
  "dust_global": (dict(dust_global=True), ["--dust-global"]),
  "fill_holes": (dict(fill_holes=1), ["--fill-holes", "1"]),
  "fix_autapses": (dict(fix_autapses=True), ["--fix-autapses"]),
  "cross_sectional_area": (dict(cross_sectional_area=True), ["--cross-section", "2"]),
  "root_ids": (dict(root_ids_cloudpath="file:///nowhere"), ["--root-ids", "file:///nowhere"]),
  "graphene": ({}, []),
}


@pytest.mark.parametrize("option", sorted(REFUSED))
def test_unported_options_raise_before_reading_or_writing(option, tmp_path, monkeypatch):
  path = tmp_path / "layer"
  Volume.from_numpy(tubes(), f"file://{path}", resolution=(8, 8, 40), chunk_size=(16, 16, 8))
  before = _files(path)
  kw, cli = REFUSED[option]
  layer = f"graphene://file://{path}" if option == "graphene" else f"file://{path}"
  downloads = []
  monkeypatch.setattr(Volume, "download", lambda *a, **k: downloads.append(a))
  with pytest.raises(NotImplementedError):
    tc.create_skeletonizing_tasks(layer, **kw)
  with pytest.raises(NotImplementedError):
    SkeletonTask(layer, shape=(32, 24, 24), offset=(0, 0, 0), **kw)
  with pytest.raises(NotImplementedError):
    deserialize({"class": "SkeletonTask", "params": {
      "cloudpath": layer, "shape": [32, 24, 24], "offset": [0, 0, 0], **kw}})
  with pytest.raises(NotImplementedError):
    cli_main(["skeleton", "forge", layer, *cli])
  assert downloads == []
  assert _files(path) == before


def test_cli_refuses_options_it_does_not_have(tmp_path, capsys):
  with pytest.raises(SystemExit):
    cli_main(["skeleton", "forge", str(tmp_path), "--queue", "fq://q"])
  assert "unrecognized arguments: --queue" in capsys.readouterr().err


def test_skeleton_task_without_cuda_raises_unless_the_cpu_is_asked_for(tmp_path, monkeypatch):
  import torch

  path = tmp_path / "layer"
  Volume.from_numpy(tubes(), f"file://{path}", resolution=(8, 8, 40), chunk_size=(16, 16, 8))
  tasks = list(tc.create_skeletonizing_tasks(f"file://{path}", shape=(32, 24, 24)))
  before = _files(path)
  monkeypatch.delenv(device.ENV)
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  device.reset_device()
  with pytest.raises(RuntimeError, match="no CUDA device"):
    tasks[0].execute()
  assert _files(path) == before
