"""The port as a package: it imports with jax and igneous_tpu blocked, its
device policy, its task registry and its command line."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import igneous_tpu_torch
import igneous_tpu_torch.task_creation
from igneous_tpu.ops import pooling as jax_pooling
from igneous_tpu_torch import Volume, device
from igneous_tpu_torch.cli import main as cli_main
from igneous_tpu_torch.queues import deserialize, serialize
from igneous_tpu_torch.tasks import DownsampleTask

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "igneous_tpu_torch"


@pytest.fixture
def cpu(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  device.reset_device()
  yield
  device.reset_device()


# ---------------------------------------------------------------------------
# (d) the port imports nothing of JAX or of the JAX package

_BLOCKER = """
import sys
class Block:
  def find_spec(self, name, path=None, target=None):
    if name.split('.')[0] in ('jax', 'jaxlib', 'igneous_tpu'):
      raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import igneous_tpu_torch, igneous_tpu_torch.cli, igneous_tpu_torch.tasks
import igneous_tpu_torch.task_creation, igneous_tpu_torch.ops.pooling
import igneous_tpu_torch.ops.ccl, igneous_tpu_torch.ops.cuda_ccl
import igneous_tpu_torch.ops.remap, igneous_tpu_torch.tasks.ccl
import igneous_tpu_torch.task_creation.ccl, igneous_tpu_torch.tools.ccl_stage_costs
import igneous_tpu_torch.tools.clahe_variants
import igneous_tpu_torch.ops.mesh, igneous_tpu_torch.mesh_io, igneous_tpu_torch.spatial_index
import igneous_tpu_torch.tasks.mesh, igneous_tpu_torch.task_creation.mesh
import igneous_tpu_torch.ops.edt, igneous_tpu_torch.ops.cuda_edt
import igneous_tpu_torch.ops.skeletonize, igneous_tpu_torch.skeleton_io
import igneous_tpu_torch.tasks.skeleton, igneous_tpu_torch.task_creation.skeleton
import igneous_tpu_torch.cseg, igneous_tpu_torch.compresso, igneous_tpu_torch.codecs
import igneous_tpu_torch.parallel, igneous_tpu_torch.parallel.executor
import igneous_tpu_torch.parallel.paged, igneous_tpu_torch.parallel.batch_runner
import igneous_tpu_torch.pipeline, igneous_tpu_torch.pipeline.encoder, igneous_tpu_torch.entry
import igneous_tpu_torch.ops.morphology, igneous_tpu_torch.tasks.stats
import igneous_tpu_torch.infer, igneous_tpu_torch.infer.registry, igneous_tpu_torch.infer.engine
import igneous_tpu_torch.tasks.inference, igneous_tpu_torch.task_creation.inference
import igneous_tpu_torch.observability.device, igneous_tpu_torch.compile_cache
import igneous_tpu_torch.tune
import igneous_tpu_torch.secrets, igneous_tpu_torch.lifecycle, igneous_tpu_torch.queues
import igneous_tpu_torch.queues.filequeue, igneous_tpu_torch.queues.ranges
import igneous_tpu_torch.queues.heartbeat, igneous_tpu_torch.queues.sqs
import igneous_tpu_torch.queues.queue, igneous_tpu_torch.parallel.lease_batcher
import igneous_tpu_torch.retry, igneous_tpu_torch.storage_http, igneous_tpu_torch.storage_gcs
import igneous_tpu_torch.storage_s3, igneous_tpu_torch.integrity
import igneous_tpu_torch.tasks.audit, igneous_tpu_torch.task_creation.audit
import igneous_tpu_torch.sharding, igneous_tpu_torch.sharded_image
import igneous_tpu_torch.tasks.image_sharded
import igneous_tpu_torch.observability.trace, igneous_tpu_torch.observability.metrics
import igneous_tpu_torch.observability.journal, igneous_tpu_torch.observability.rollup
import igneous_tpu_torch.observability.fleet, igneous_tpu_torch.observability.prom
import igneous_tpu_torch.observability.perfetto, igneous_tpu_torch.observability.health
import igneous_tpu_torch.observability.autoscale, igneous_tpu_torch.cli
import igneous_tpu_torch.observability.campaign, igneous_tpu_torch.observability.replay
import igneous_tpu_torch.observability.sim
import igneous_tpu_torch.chaos, igneous_tpu_torch.view, igneous_tpu_torch.serve
import igneous_tpu_torch.serve.app, igneous_tpu_torch.serve.cache, igneous_tpu_torch.serve.server
import igneous_tpu_torch.serve.federation, igneous_tpu_torch.tools.chaos_soak
import igneous_tpu_torch.scripts.remap2npy, igneous_tpu_torch.scripts.validate_provenance
import igneous_tpu_torch.parallel.multihost
import igneous_tpu_torch.analysis, igneous_tpu_torch.analysis.knobs
import igneous_tpu_torch.analysis.findings, igneous_tpu_torch.analysis.discovery
import igneous_tpu_torch.analysis.env_knobs, igneous_tpu_torch.analysis.locks
import igneous_tpu_torch.analysis.determinism, igneous_tpu_torch.analysis.telemetry_names
import igneous_tpu_torch.analysis.racecheck, igneous_tpu_torch.analysis.recompile
import igneous_tpu_torch.analysis.runner, igneous_tpu_torch.analysis.__main__
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'igneous_tpu')]
assert not bad, bad
from igneous_tpu_torch.ops import _build
assert _build._LIBS == {} and _build.BUILD_LOG == {}, 'a library was built at import'
print('IMPORTED')
"""


def test_port_imports_with_jax_and_reference_blocked():
  env = dict(os.environ, PYTHONPATH=str(REPO))
  proc = subprocess.run(
    [sys.executable, "-c", _BLOCKER], cwd=REPO, env=env,
    capture_output=True, text=True, timeout=120,
  )
  assert proc.returncode == 0, proc.stderr
  assert "IMPORTED" in proc.stdout


@pytest.mark.parametrize(
  "path",
  sorted(p for p in PORT.rglob("*.py") if "build" not in p.parts)
  + [REPO / "chip_smoke.py"],
  ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_source_imports_jax_or_reference(path):
  """Every import statement, lazy ones inside functions included."""
  for node in ast.walk(ast.parse(path.read_text())):
    if isinstance(node, ast.Import):
      names = [a.name for a in node.names]
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      names = [node.module or ""]
    else:
      continue
    for name in names:
      assert name.split(".")[0] not in ("jax", "jaxlib", "igneous_tpu"), (path, name)


_BLOCK_CV2 = """
import sys
class Block:
  def find_spec(self, name, path=None, target=None):
    if name.split('.')[0] in ('cv2', 'h5py', 'jax', 'jaxlib', 'igneous_tpu'):
      raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import igneous_tpu_torch, igneous_tpu_torch.cli, igneous_tpu_torch.tasks
import igneous_tpu_torch.task_creation, igneous_tpu_torch.formats
import igneous_tpu_torch.ops.clahe, igneous_tpu_torch.ops.cuda_clahe
import igneous_tpu_torch.tasks.contrast, igneous_tpu_torch.tasks.stats
from igneous_tpu_torch.ops.ccl import statistics
from igneous_tpu_torch.task_creation import compute_rois, create_clahe_tasks
bad = [m for m in sys.modules if m.split('.')[0] in ('cv2', 'h5py', 'jax', 'jaxlib', 'igneous_tpu')]
assert not bad, bad
from igneous_tpu_torch.ops import _build
assert _build._LIBS == {} and _build.BUILD_LOG == {}, 'a library was built at import'
print('IMPORTED')
"""


def test_port_imports_with_opencv_and_h5py_blocked():
  """CLAHE is the port's own kernel: the port imports without OpenCV (the
  card's machine has none), and h5py only when an HDF5 file is read."""
  env = dict(os.environ, PYTHONPATH=str(REPO))
  proc = subprocess.run(
    [sys.executable, "-c", _BLOCK_CV2], cwd=REPO, env=env,
    capture_output=True, text=True, timeout=120,
  )
  assert proc.returncode == 0, proc.stderr
  assert "IMPORTED" in proc.stdout


def _imported_names(nodes):
  for node in nodes:
    if isinstance(node, ast.Import):
      yield from (a.name for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      yield node.module or ""


def _module_level(tree):
  """The statements that run when the module is imported: its body and
  the bodies of its top-level if / try / with blocks."""
  todo = list(tree.body)
  while todo:
    node = todo.pop()
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
      if isinstance(node, ast.ClassDef):
        todo.extend(node.body)
      continue
    yield node
    for field in ("body", "orelse", "finalbody", "handlers"):
      todo.extend(getattr(node, field, []) or [])


@pytest.mark.parametrize(
  "path",
  sorted(p for p in PORT.rglob("*.py") if "build" not in p.parts)
  + [REPO / "chip_smoke.py"],
  ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_source_imports_opencv_or_h5py_at_module_level(path):
  """No import of cv2 anywhere (lazy ones included), and none of h5py
  at module level."""
  tree = ast.parse(path.read_text())
  for name in _imported_names(ast.walk(tree)):
    assert name.split(".")[0] != "cv2", (path, name)
  for name in _imported_names(_module_level(tree)):
    assert name.split(".")[0] != "h5py", (path, name)


# ---------------------------------------------------------------------------
# (e) the device policy


def test_default_device_without_cuda_raises(monkeypatch):
  monkeypatch.delenv(device.ENV, raising=False)
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  device.reset_device()
  try:
    with pytest.raises(RuntimeError, match="no CUDA device"):
      device.get_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
      device.set_device("cuda")
    img = np.zeros((8, 8, 2), np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
      igneous_tpu_torch.ops.pooling.downsample(img, (2, 2, 1), 1)
  finally:
    device.reset_device()


def test_cpu_is_taken_only_when_asked(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  monkeypatch.setenv(device.ENV, "cpu")
  device.reset_device()
  try:
    assert device.get_device() == torch.device("cpu")
    device.reset_device()
    monkeypatch.delenv(device.ENV)
    assert igneous_tpu_torch.set_device("cpu") == torch.device("cpu")
    assert device.get_device() == torch.device("cpu")
    with pytest.raises(ValueError):
      device.set_device("mps")
  finally:
    device.reset_device()


# ---------------------------------------------------------------------------
# the task registry


def test_reference_payload_maps_into_the_port_registry(monkeypatch):
  payload = {
    "class": "DownsampleTask",
    "module": "igneous_tpu.tasks.image",
    "params": {
      "layer_path": "file:///nonexistent", "mip": 0, "shape": [64, 64, 16],
      "offset": [0, 0, 0], "fill_missing": False, "sparse": False,
      "delete_black_uploads": False, "background_color": 0,
      "compress": "gzip", "downsample_method": "auto", "num_mips": 2,
      "factor": [2, 2, 1],
    },
    "trace": {"trace_id": "abc", "ts": 0},
  }
  imported = []
  real_import = __import__

  def spy(name, *a, **kw):
    imported.append(name)
    return real_import(name, *a, **kw)

  monkeypatch.setattr("builtins.__import__", spy)
  task = deserialize(json.dumps(payload))
  monkeypatch.undo()
  assert "igneous_tpu.tasks.image" not in imported
  assert type(task) is DownsampleTask
  assert task._params == payload["params"]
  assert json.loads(serialize(task))["params"] == payload["params"]


def test_unported_payloads_raise():
  """A payload of a class the port does not register raises KeyError (the
  port registers every task class of the JAX package, GrapheneMeshTask
  last); a function payload of an unregistered name raises the JAX
  package's KeyError when it runs."""
  with pytest.raises(KeyError, match="not ported"):
    deserialize({"class": "NoSuchTask", "module": "igneous_tpu.tasks.mesh",
                 "params": {}})
  task = deserialize({"class": "GrapheneMeshTask", "module": "igneous_tpu.tasks.mesh",
                      "params": {"shape": [8, 8, 8], "offset": [0, 0, 0],
                                 "layer_path": "graphene://file:///nowhere"}})
  assert type(task).__name__ == "GrapheneMeshTask" and task.sharded
  with pytest.raises(KeyError, match="is not @queueable-registered"):
    deserialize({"fn": "delete_mesh_files", "args": [], "kwargs": {}}).execute()


def _code(path):
  """A C++ source's lines without comments and blank lines."""
  lines = (line.split("//")[0].rstrip() for line in path.read_text().splitlines())
  return [line for line in lines if line]


@pytest.mark.parametrize("name", ["edt", "dijkstra", "fggraph"])
def test_skeleton_libraries_build_at_first_use_into_the_build_dir(name, tmp_path, monkeypatch, cpu):
  """The skeleton path's sources build only when first called, into
  ``igneous_tpu_torch/build/`` (which .gitignore lists): the CUDA kernel
  with nvcc for sm_90a, the two host libraries with g++ from copies of the
  JAX package's sources."""
  from igneous_tpu_torch.ops import _build, skeletonize

  path = _build.library_path(name)
  assert path.parent == _build.BUILD_DIR == PORT / "build"
  assert "igneous_tpu_torch/build/" in (REPO / ".gitignore").read_text().split()
  src, flags, _ = _build._source(name)
  if name == "edt":
    assert src.name == "edt.cu" and "arch=compute_90a,code=sm_90a" in flags
    return
  assert _code(src) == _code(REPO / "igneous_tpu" / "native" / "csrc" / f"{name}.cpp")
  monkeypatch.setattr(_build, "_LIBS", {})
  monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
  assert list(tmp_path.iterdir()) == []
  mask = np.zeros((12, 6, 6), bool)
  mask[1:11, 2:4, 2:4] = True
  assert len(skeletonize.skeletonize_mask(mask)) > 2
  assert any(p.name.startswith(f"lib{name}-") for p in tmp_path.iterdir())


# ---------------------------------------------------------------------------
# the command line


def test_cli_downsample_matches_reference(tmp_path, cpu):
  img = np.random.default_rng(2).integers(0, 256, (64, 64, 8)).astype(np.uint8)
  path = f"file://{tmp_path / 'layer'}"
  Volume.from_numpy(img, path, resolution=(4, 4, 40), chunk_size=(16, 16, 8))
  assert cli_main(["image", "downsample", path, "--num-mips", "2",
                   "--factor", "2,2,1"]) == 0
  refs = jax_pooling.downsample(img, (2, 2, 1), 2)
  for mip, ref in enumerate(refs, start=1):
    vol = Volume(path, mip=mip)
    assert np.array_equal(vol.download(vol.mip_bounds(mip))[..., 0], ref)


def test_spawned_workers_write_what_one_process_writes(tmp_path, cpu):
  """parallel=2 runs the tasks in spawned workers on the parent's device."""
  img = np.random.default_rng(4).integers(0, 256, (64, 64, 8)).astype(np.uint8)
  outs = {}
  for parallel in (1, 2):
    path = f"file://{tmp_path / str(parallel)}"
    Volume.from_numpy(img, path, resolution=(4, 4, 40), chunk_size=(16, 16, 8))
    tasks = igneous_tpu_torch.task_creation.create_downsampling_tasks(
      path, num_mips=1, memory_target=16 * 16 * 8 * 4 * 2,
    )
    assert len(tasks) == 4
    from igneous_tpu_torch.queues import LocalTaskQueue

    queue = LocalTaskQueue(parallel=parallel)
    queue.insert(tasks)
    assert queue.completed == 4
    vol = Volume(path, mip=1)
    outs[parallel] = vol.download(vol.mip_bounds(1))
  assert np.array_equal(outs[1], outs[2])
  assert np.array_equal(outs[1][..., 0], jax_pooling.downsample(img, (2, 2, 1), 1)[0])
