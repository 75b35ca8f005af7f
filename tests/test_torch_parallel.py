"""The port's batched execution (``igneous_tpu_torch.parallel``) against the
JAX package, bit for bit.

``ChunkExecutor`` and ``pyramid_batched`` against the JAX package's on a
one-device mesh; ``BatchKernelExecutor`` (with and without consts)
against solo calls; ``batched_downsample`` on file:// layers against the
JAX package's ``batched_downsample`` (its XLA pyramid,
``IGNEOUS_POOL_HOST=0``) and against its solo tasks, every chunk file and
the info byte for byte; ``batched_ccl_faces``'s scratch files and
``batched_skeleton_forge``'s fragments against the JAX package's task
path; the ``--batched`` command line; and ``entry()`` against the
repository's ``__graft_entry__.entry()``.
"""

import json
import pathlib

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import __graft_entry__
from igneous_tpu import Volume as JaxVolume
from igneous_tpu import task_creation as jax_tc
from igneous_tpu.cli import main as jax_cli
from igneous_tpu.downsample_scales import compute_factors as jax_compute_factors
from igneous_tpu.downsample_scales import create_downsample_scales as jax_create_scales
from igneous_tpu.ops import pooling as jax_pooling
from igneous_tpu.parallel import batch_runner as jax_runner
from igneous_tpu.parallel.executor import ChunkExecutor as JaxChunkExecutor
from igneous_tpu.parallel.executor import make_mesh
from igneous_tpu.queues import LocalTaskQueue as JaxQueue
from igneous_tpu.tasks.image import DownsampleTask as JaxDownsampleTask
from igneous_tpu_torch import device
from igneous_tpu_torch.cli import main as cli_main
from igneous_tpu_torch.entry import entry
from igneous_tpu_torch.ops import ccl, pooling
from igneous_tpu_torch.parallel import (
  BatchKernelExecutor, ChunkExecutor, batch_runner, cached_chunk_executor,
)
from igneous_tpu_torch.pipeline import SerialSink, shared_encode_pool
from igneous_tpu_torch.volume import Volume


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  # the reference runs its device (XLA) pyramid and its native host EDT
  monkeypatch.setenv("IGNEOUS_POOL_HOST", "0")
  monkeypatch.setenv("IGNEOUS_EDT_BACKEND", "native")
  monkeypatch.delenv("IGNEOUS_PAGE_SHAPE", raising=False)
  monkeypatch.delenv("IGNEOUS_PAGE_BATCH", raising=False)
  device.reset_device()
  yield
  device.reset_device()


def _labels(rng, shape, dtype):
  img = rng.integers(0, 3, shape).astype(dtype)
  if np.dtype(dtype).itemsize == 8:
    img = img + (img > 0).astype(dtype) * dtype(2**40)
  return img


# ---------------------------------------------------------------------------
# ChunkExecutor, pyramid_batched, BatchKernelExecutor


@pytest.mark.parametrize("dtype,method,factors,shape", [
  (np.uint8, "average", ((2, 2, 1), (2, 2, 1)), (3, 1, 4, 16, 16)),  # fused
  (np.uint8, "average", ((2, 2, 1), (2, 2, 2)), (2, 2, 4, 18, 14)),  # iterated + plain
  (np.uint32, "mode", ((2, 2, 1), (2, 2, 1)), (3, 1, 2, 16, 12)),
  (np.uint16, "mode", ((2, 2, 2),), (2, 1, 4, 6, 10)),  # plain only
])
def test_chunk_executor_equals_jax(dtype, method, factors, shape):
  rng = np.random.default_rng(0)
  if method == "mode":
    batch = _labels(rng, shape, dtype) * dtype(70000 if dtype == np.uint32 else 3)
  else:
    batch = rng.integers(0, 256, shape).astype(dtype)
  batch[0, :, 0] = 0  # some zeros for the nonzero count
  got, nz = ChunkExecutor(factors, method=method)(batch)
  want, wnz = JaxChunkExecutor(make_mesh(1), factors=factors, method=method)(batch)
  assert nz == wnz == int(np.count_nonzero(batch))
  assert len(got) == len(want) == len(factors)
  for g, w in zip(got, want):
    assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)


def test_chunk_executor_planes_equal_jax():
  rng = np.random.default_rng(1)
  u = _labels(rng, (2, 1, 2, 12, 20), np.uint64)
  u[1, 0, 1] = 0
  lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
  hi = (u >> np.uint64(32)).astype(np.uint32)
  factors = ((2, 2, 1), (2, 2, 2))
  got, nz = ChunkExecutor(factors, method="mode", planes=2)((lo, hi))
  want, wnz = JaxChunkExecutor(make_mesh(1), factors=factors, method="mode", planes=2)((lo, hi))
  assert nz == wnz == int(np.count_nonzero(u))
  for (gl, gh), (wl, wh) in zip(got, want):
    assert gl.dtype == np.uint32 and np.array_equal(gl, wl) and np.array_equal(gh, wh)
  with pytest.raises(ValueError, match="expected 2 plane"):
    ChunkExecutor(factors, method="mode", planes=2)(lo)
  with pytest.raises(ValueError, match="only meaningful for mode"):
    ChunkExecutor(factors, method="average", planes=2)
  with pytest.raises(ValueError, match="planes must be 1 or 2"):
    ChunkExecutor(factors, planes=3)


def test_cached_chunk_executor_is_shared():
  a = cached_chunk_executor(((2, 2, 1),), "average")
  assert cached_chunk_executor([[2, 2, 1]], "average") is a
  assert cached_chunk_executor(((2, 2, 1),), "mode") is not a


@pytest.mark.parametrize("method", ["average", "mode"])
def test_pyramid_batched_equals_jax(method):
  rng = np.random.default_rng(2)
  x = rng.integers(0, 4 if method == "mode" else 256, (3, 1, 4, 24, 20)).astype(np.uint8)
  factors = ((2, 2, 1), (2, 2, 1), (2, 2, 2))
  got = pooling.pyramid_batched(factors, method, False)(x)
  want = jax_pooling.pyramid_batched(factors, method, False)(x)
  assert len(got) == len(want) == 3
  for g, w in zip(got, want):
    assert np.array_equal(g.numpy(), np.asarray(w))


def test_batch_kernel_executor_equals_solo_calls():
  rng = np.random.default_rng(3)
  labels = (rng.random((3, 9, 10, 11)) < 0.5).astype(np.int32) * rng.integers(1, 4, (3, 9, 10, 11)).astype(np.int32)
  tile = (2, 4, 8)

  def kernel(x):
    return {"roots": ccl._ccl_tiled_roots(x, 26, tile), "sum": x.sum(dim=(1, 2, 3))}

  out = BatchKernelExecutor(kernel)(labels)
  for k in range(3):
    solo = ccl._ccl_tiled_roots(torch.from_numpy(labels[k]), 26, tile).numpy()
    assert np.array_equal(out["roots"][k], solo)
    assert out["sum"][k] == labels[k].sum()

  consts = {"scale": np.float32(3.0), "shift": np.arange(11, dtype=np.float32)}

  def affine(c, x):
    return (x.to(torch.float32) * c["scale"] + c["shift"],)

  ex = BatchKernelExecutor(affine)
  staged = ex.put_consts("model-a", consts)
  assert ex.put_consts("model-a", {"other": np.zeros(1)}) is staged
  for c in (staged, consts):
    (got,) = ex(labels, consts=c)
    for k in range(3):
      assert np.array_equal(got[k], labels[k].astype(np.float32) * 3.0 + consts["shift"])


def test_entry_equals_graft_entry():
  fn, (x,) = entry()
  ref_fn, (ref_x,) = __graft_entry__.entry()
  assert np.array_equal(x, ref_x)
  got, want = fn(x), ref_fn(ref_x)
  assert len(got) == len(want) == 4
  for g, w in zip(got, want):
    assert g.shape == tuple(np.shape(w)) and np.array_equal(g.numpy(), np.asarray(w))


def test_upload_sink_gives_the_same_bytes(tmp_path):
  rng = np.random.default_rng(4)
  data = np.asfortranarray(rng.integers(0, 255, (40, 33, 10)).astype(np.uint8))
  roots = {}
  for who, sink in (("inline", None), ("serial", SerialSink()), ("pool", shared_encode_pool().ticket())):
    vol = Volume.from_numpy(data, f"file://{tmp_path / who}", chunk_size=(16, 16, 8))
    vol.upload(vol.bounds, data[::-1].copy(order="F"), sink=sink)
    if sink is not None:
      sink.join()
    roots[who] = _layer_files(tmp_path / who)
  assert roots["inline"] == roots["serial"] == roots["pool"]


# ---------------------------------------------------------------------------
# batched_downsample on file:// layers


def _layer_files(root):
  """{relative path: bytes} of the info file and every chunk under a scale
  key."""
  root = pathlib.Path(root)
  info = json.loads((root / "info").read_text())
  out = {"info": (root / "info").read_bytes()}
  for scale in info["scales"]:
    for p in sorted((root / scale["key"]).iterdir()):
      out[f"{scale['key']}/{p.name}"] = p.read_bytes()
  return out


def _solo_reference(path, shape, num_mips, factor, chunk_size):
  """The JAX package's solo route over the same grid: the scales
  ``batched_downsample`` creates, then one DownsampleTask per cell."""
  vol = JaxVolume(path)
  factors = jax_compute_factors(shape, factor, num_mips, chunk_size=chunk_size)
  jax_create_scales(vol.meta, 0, shape, factor, num_mips=len(factors))
  vol.commit_info()
  bounds = vol.meta.bounds(0)
  for z in range(0, int(bounds.maxpt[2]), shape[2]):
    for y in range(0, int(bounds.maxpt[1]), shape[1]):
      for x in range(0, int(bounds.maxpt[0]), shape[0]):
        JaxDownsampleTask(
          layer_path=path, mip=0, shape=list(shape), offset=[x, y, z],
          num_mips=len(factors), factor=tuple(factor),
        ).execute()


@pytest.mark.parametrize("name,dtype,layer_type,size,chunk,shape,kw", [
  # odd edges on every axis: 4 full cutouts, 14 paged edge cutouts
  ("u8_average", np.uint8, "image", (151, 133, 21), (16, 16, 16), (64, 64, 16), {}),
  ("u64_mode", np.uint64, "segmentation", (151, 133, 21), (16, 16, 16), (64, 64, 16), {}),
  # pages of 8 in rounds of 4: edge cutouts cut across rounds
  ("u16_small_pages", np.uint16, "image", (90, 70, 12), (8, 8, 4), (32, 32, 8),
   {"IGNEOUS_PAGE_SHAPE": "4,8,8", "IGNEOUS_PAGE_BATCH": "4"}),
])
def test_batched_downsample_equals_jax(tmp_path, monkeypatch, name, dtype, layer_type,
                                       size, chunk, shape, kw):
  for k, v in kw.items():
    monkeypatch.setenv(k, v)
  rng = np.random.default_rng(5)
  if layer_type == "segmentation":
    data = _labels(rng, size, dtype)
  else:
    data = rng.integers(0, np.iinfo(dtype).max, size, endpoint=True).astype(dtype)
  data = np.asfortranarray(data)
  paths = {}
  for who in ("port", "jax", "solo"):
    paths[who] = f"file://{tmp_path / who}"
    JaxVolume.from_numpy(data, paths[who], resolution=(8, 8, 40), chunk_size=chunk,
                         layer_type=layer_type)
  stats = batch_runner.batched_downsample(paths["port"], num_mips=4, shape=shape, batch_size=3)
  want = jax_runner.batched_downsample(paths["jax"], num_mips=4, shape=shape, batch_size=3)
  assert stats["batched_cutouts"] == want["batched_cutouts"] > 0
  assert stats["paged_cutouts"] == want["paged_cutouts"] > 0
  assert stats["edge_cutouts"] == want["edge_cutouts"] == 0
  assert stats["drained"] is False
  _solo_reference(paths["solo"], shape, 4, (2, 2, 1), chunk)
  got = _layer_files(tmp_path / "port")
  assert len(json.loads(got["info"])["scales"]) > 1
  assert got == _layer_files(tmp_path / "jax")
  assert got == _layer_files(tmp_path / "solo")


def test_batched_downsample_solo_edges_and_drain(tmp_path):
  """A factor chain no page tiles sends edges down the task path; a set
  drain flag stops before any batch."""
  rng = np.random.default_rng(6)
  data = np.asfortranarray(rng.integers(0, 255, (100, 70, 9)).astype(np.uint8))
  for who in ("port", "jax"):
    JaxVolume.from_numpy(data, f"file://{tmp_path / who}", chunk_size=(9, 9, 9))
  kw = dict(num_mips=1, shape=(27, 27, 9), factor=(3, 3, 1), batch_size=4)
  stats = batch_runner.batched_downsample(f"file://{tmp_path / 'port'}", **kw)
  want = jax_runner.batched_downsample(f"file://{tmp_path / 'jax'}", **kw)
  assert stats == {"batched_cutouts": 6, "edge_cutouts": 6, "paged_cutouts": 0,
                   "dispatches": 2, "drained": False}
  assert {k: want[k] for k in stats} == stats
  assert _layer_files(tmp_path / "port") == _layer_files(tmp_path / "jax")

  class Drain:
    def is_set(self):
      return True

  drained = batch_runner.batched_downsample(f"file://{tmp_path / 'port'}", drain_flag=Drain(), **kw)
  assert drained == {"batched_cutouts": 0, "edge_cutouts": 0, "paged_cutouts": 0,
                     "dispatches": 0, "drained": True}
  with pytest.raises(ValueError, match="admits no chunk-aligned downsamples"):
    batch_runner.batched_downsample(f"file://{tmp_path / 'port'}", shape=(9, 9, 9))


# ---------------------------------------------------------------------------
# batched CCL faces and skeleton forge


def _ccl_layers(tmp_path, data):
  for who in ("jax", "port"):
    JaxVolume.from_numpy(data, f"file://{tmp_path / who}", resolution=(8, 8, 40),
                         chunk_size=(16, 16, 16), layer_type="segmentation")
  return {who: f"file://{tmp_path / who}" for who in ("jax", "port")}


def _face_files(root):
  d = pathlib.Path(root) / "ccl" / "0" / "faces"
  return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize("tile", [None, "3,4,5"])
def test_batched_ccl_faces_equal_jax_task_path(tmp_path, monkeypatch, tile):
  """The paged route, and (a CCL tile that does not divide the page) the
  per-shape batches with single-shape cutouts on the task path."""
  if tile:
    monkeypatch.setenv("IGNEOUS_CCL_TILE", tile)
  rng = np.random.default_rng(7)
  data = np.asfortranarray(rng.integers(0, 255, (70, 60, 40)).astype(np.uint8))
  paths = _ccl_layers(tmp_path, data)
  kw = dict(shape=(32, 32, 32), threshold_gte=120)
  stats = batch_runner.batched_ccl_faces(paths["port"], batch_size=5, **kw)
  JaxQueue(parallel=1, progress=False).insert(jax_tc.create_ccl_face_tasks(paths["jax"], **kw))
  assert stats["batched_cutouts"] + stats["edge_cutouts"] == 12
  if tile:
    assert stats == {"batched_cutouts": 8, "edge_cutouts": 4, "dispatches": 4}
  else:
    assert stats == {"batched_cutouts": 12, "edge_cutouts": 0, "dispatches": 3}
  got = _face_files(tmp_path / "port")
  assert len(got) > 12 and got == _face_files(tmp_path / "jax")


def test_batched_skeleton_forge_equals_jax_task_path(tmp_path):
  from tests.test_torch_skeleton_tasks import FORGE, _skel_files, tubes

  data = tubes()
  paths = {}
  for who in ("jax", "port"):
    paths[who] = f"file://{tmp_path / who}"
    JaxVolume.from_numpy(data, paths[who], resolution=(8, 8, 40), chunk_size=(16, 16, 8),
                         layer_type="segmentation")
  task = (32, 24, 24)
  stats = batch_runner.batched_skeleton_forge(paths["port"], shape=task, batch_size=3, **FORGE)
  JaxQueue(parallel=1, progress=False).insert(
    jax_tc.create_skeletonizing_tasks(paths["jax"], shape=task, **FORGE))
  assert stats == {"batched_cutouts": 4, "solo_cutouts": 0, "dispatches": 2}
  got = _skel_files(tmp_path / "port")
  assert len(got) > 10 and got == _skel_files(tmp_path / "jax")


# ---------------------------------------------------------------------------
# the --batched command line


def test_batched_cli_equals_jax_cli(tmp_path, capsys):
  rng = np.random.default_rng(8)
  data = np.asfortranarray(rng.integers(0, 255, (100, 80, 16)).astype(np.uint8))
  for who in ("jax", "port"):
    JaxVolume.from_numpy(data, f"file://{tmp_path / who}", chunk_size=(16, 16, 16))
  args = ["image", "downsample", "--batched", "--shape", "32,32,16", "--batch-size", "4",
          "--num-mips", "2", "--xrange", "0,96"]
  assert cli_main(args[:2] + [f"file://{tmp_path / 'port'}"] + args[2:]) == 0
  out = capsys.readouterr().out.strip()
  res = CliRunner().invoke(jax_cli, args[:2] + [f"file://{tmp_path / 'jax'}"] + args[2:])
  assert res.exit_code == 0, res.output
  assert out == res.output.strip() == (
    "batched: 6 cutouts in 3 dispatches, 0 edge cutouts via the task path"
  )
  assert _layer_files(tmp_path / "port") == _layer_files(tmp_path / "jax")


@pytest.mark.parametrize("extra,message", [
  (["--encoding", "raw"], "--batched downsamples in place; --encoding/--chunk-size apply only to the task factories"),
  (["--chunk-size", "8,8,8"], "--batched downsamples in place; --encoding/--chunk-size apply only to the task factories"),
])
def test_batched_cli_usage_errors(tmp_path, capsys, extra, message):
  data = np.zeros((32, 32, 16), np.uint8)
  JaxVolume.from_numpy(data, f"file://{tmp_path / 'l'}", chunk_size=(16, 16, 16))
  path = f"file://{tmp_path / 'l'}"
  with pytest.raises(SystemExit) as e:
    cli_main(["image", "downsample", path, "--batched"] + extra)
  assert e.value.code == 2
  assert message in capsys.readouterr().err
  res = CliRunner().invoke(jax_cli, ["image", "downsample", path, "--batched"] + extra)
  assert res.exit_code == 2 and message in res.output
