"""The port's downsample path against the JAX package, bit for bit.

(b) ops.pooling.downsample on the routes that reach no kernel; (f) the
route each configuration takes; (c) the whole slice on small file://
layers: create_downsampling_tasks -> LocalTaskQueue -> DownsampleTask,
compared by info scales and chunk bytes at every mip, including payloads
that the JAX package serialized and the port executed.
"""

import json
import os

import numpy as np
import pytest

from igneous_tpu import Volume as JaxVolume
from igneous_tpu import task_creation as jax_tc
from igneous_tpu.ops import pooling as jax_pooling
from igneous_tpu.queues import LocalTaskQueue as JaxLocalTaskQueue
from igneous_tpu.queues.registry import serialize as jax_serialize
from igneous_tpu_torch import Volume, device
from igneous_tpu_torch.ops import cuda_pooling, pooling
from igneous_tpu_torch.queues import LocalTaskQueue
from igneous_tpu_torch.task_creation import create_downsampling_tasks

from test_torch_integrity import flush_local, sidecars


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
  monkeypatch.setenv("IGNEOUS_TORCH_DEVICE", "cpu")
  # the reference runs its device (XLA) pyramid, not its native host kernels
  monkeypatch.setenv("IGNEOUS_POOL_HOST", "0")
  device.reset_device()
  yield
  device.reset_device()


def _image(rng, method, dtype, shape):
  dtype = np.dtype(dtype)
  if dtype.kind == "f":
    return rng.normal(size=shape).astype(dtype)
  if dtype == bool:
    return rng.integers(0, 2, shape).astype(bool)
  if method == "mode":
    img = rng.integers(0, 3, shape).astype(dtype)
    if dtype.itemsize == 8:  # labels above 2^32
      img = img + (img > 0).astype(dtype) * dtype.type(2**40)
    return img
  if dtype.itemsize == 8:
    return rng.integers(0, 2**40, shape).astype(dtype)
  info = np.iinfo(dtype)
  return rng.integers(info.min, info.max, shape, endpoint=True, dtype=np.int64).astype(dtype)


def _route(factors, method, sparse, work):
  """(kernel, run): the run of factors ``pooling.route`` gives the kernels,
  and the kernel ``cuda_pooling.pyramid2x2x1`` takes for it on the (c, z,
  y, x) tensor of the (x, y, z, c) array ``work``."""
  run = pooling.route(factors, method, sparse, work.dtype)
  if run == 0:
    return None, 0
  yx = (work.shape[1], work.shape[0])
  return ("pyramid2x2x1" if cuda_pooling.fused_aligned(yx, run) else "pool2x2x1"), run


# (method, dtype, factor, num_mips, shape, sparse, expected route)
CONFIGS = [
  ("average", np.uint8, (2, 2, 2), 2, (33, 17, 5), False, (None, 0)),
  ("average", np.uint16, (2, 2, 2), 2, (16, 16, 6), False, (None, 0)),
  ("average", np.uint32, (2, 2, 2), 2, (16, 18, 6), False, (None, 0)),
  ("average", np.int32, (2, 2, 1), 2, (16, 18, 6), False, (None, 0)),
  ("average", np.uint32, (3, 3, 1), 1, (16, 18, 6), False, (None, 0)),
  ("average", np.int32, (3, 3, 3), 2, (26, 18, 9), False, (None, 0)),
  ("average", np.float32, (3, 3, 1), 1, (16, 18, 6), False, (None, 0)),
  ("average", np.uint64, (2, 2, 1), 2, (20, 18, 6), False, (None, 0)),
  ("average", np.int64, (2, 2, 2), 2, (20, 18, 6), False, (None, 0)),
  ("mode", np.uint64, (2, 2, 1), 3, (40, 24, 4), True, (None, 0)),
  ("mode", np.uint64, (2, 2, 2), 2, (17, 24, 5), False, (None, 0)),
  ("mode", np.uint32, (2, 2, 2), 2, (17, 24, 5), True, (None, 0)),
  ("mode", np.uint16, (3, 3, 3), 1, (17, 24, 5), False, (None, 0)),
  ("min", np.uint16, (2, 2, 2), 2, (17, 24, 5), False, (None, 0)),
  ("max", np.uint8, (2, 2, 1), 2, (17, 24, 5), False, (None, 0)),
  ("min", np.int16, (2, 2, 1), 2, (17, 24, 5), False, (None, 0)),
  ("max", np.uint32, (2, 2, 2), 2, (17, 24, 5), False, (None, 0)),
  ("striding", np.uint8, (2, 2, 1), 2, (17, 24, 5), False, (None, 0)),
  ("striding", np.uint32, (2, 2, 2), 2, (17, 24, 5), False, (None, 0)),
  # the kernel routes, for comparison
  ("mode", np.uint64, (2, 2, 1), 3, (40, 24, 4), False, ("pyramid2x2x1", 3)),
  ("mode", np.int64, (2, 2, 1), 2, (17, 24, 5), False, ("pool2x2x1", 2)),
  ("average", np.int16, (2, 2, 1), 2, (30, 21, 4), False, ("pool2x2x1", 2)),
  ("average", bool, (2, 2, 1), 2, (32, 24, 4), False, ("pyramid2x2x1", 2)),
]


@pytest.mark.parametrize(
  "method,dtype,factor,num_mips,shape,sparse,expected", CONFIGS,
  ids=lambda v: str(v) if not isinstance(v, type) else v.__name__,
)
def test_downsample_matches_reference(method, dtype, factor, num_mips, shape,
                                      sparse, expected):
  rng = np.random.default_rng(3)
  img = _image(rng, method, dtype, shape)
  refs = jax_pooling.downsample(img, factor, num_mips, method=method, sparse=sparse)
  outs = pooling.downsample(img, factor, num_mips, method=method, sparse=sparse)
  assert len(outs) == len(refs)
  for r, o in zip(refs, outs):
    assert o.dtype == r.dtype and o.shape == r.shape
    assert np.array_equal(o, r)

  factors = pooling._normalize_factors(factor, num_mips)
  work = pooling._work_array(img, method)
  assert _route(factors, method, sparse, work) == expected


def test_route_splits_a_leading_2x2x1_run():
  f = ((2, 2, 1), (2, 2, 1), (2, 2, 2))
  u8, u64 = np.zeros((64, 64, 8, 1), np.uint8), np.zeros((64, 64, 8, 1), np.uint64)
  assert _route(f, "average", False, u8) == ("pyramid2x2x1", 2)
  assert _route(f, "average", False, np.zeros((66, 64, 8, 1), np.uint8)) == ("pool2x2x1", 2)
  assert _route(f[::-1], "average", False, u8) == (None, 0)
  assert _route(f, "mode", True, u64) == (None, 0)
  img = np.random.default_rng(5).integers(0, 255, (64, 64, 8)).astype(np.uint8)
  for r, o in zip(jax_pooling.downsample(img, f, 3), pooling.downsample(img, f, 3)):
    assert np.array_equal(o, r)


# ---------------------------------------------------------------------------
# (c) the whole slice on file:// layers


def _layer_files(root):
  """{relative path: bytes} of the info file and every chunk under a scale
  key, and the integrity sidecars normalised (``sidecars``; both packages'
  buffered manifest records written first, ``flush_local``). Provenance is
  not compared."""
  flush_local()
  info = json.loads(open(os.path.join(root, "info")).read())
  out = {"info": info, "integrity": sidecars(root)}
  assert out["integrity"], f"no integrity sidecars under {root}"
  for scale in info["scales"]:
    d = os.path.join(root, scale["key"])
    for name in sorted(os.listdir(d)):
      if ".tmp." not in name:
        out[f"{scale['key']}/{name}"] = open(os.path.join(d, name), "rb").read()
  return out


LAYERS = {
  # uint8 image, aligned: one task, 5 mips, the fused kernel's route
  "image_u8": (np.uint8, (128, 128, 16), "pyramid2x2x1"),
  # uint64 segmentation, ragged y: one task, the iterated single step
  "seg_u64": (np.uint64, (96, 80, 16), "pool2x2x1"),
}


def _layer_data(kind):
  dtype, shape, _ = LAYERS[kind]
  rng = np.random.default_rng(17)
  if dtype == np.uint64:
    blocks = rng.integers(0, 4, (shape[0] // 4 + 1, shape[1] // 4 + 1, shape[2]))
    img = np.repeat(np.repeat(blocks, 4, 0), 4, 1)[: shape[0], : shape[1]]
    return (img.astype(np.uint64) * np.uint64(2**33 + 1)).astype(np.uint64)
  return rng.integers(0, 256, shape).astype(dtype)


def _make_layers(tmp_path, kind, names):
  data = _layer_data(kind)
  paths = {}
  for name in names:
    path = f"file://{tmp_path / name}"
    cls = JaxVolume if name.startswith("jax") else Volume
    cls.from_numpy(data, path, resolution=(8, 8, 40), chunk_size=(32, 32, 16))
    paths[name] = path
  return data, paths


@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_slice_matches_reference(tmp_path, kind):
  data, paths = _make_layers(tmp_path, kind, ["jax", "port"])
  # ingest: both packages write the same mip-0 bytes
  assert _layer_files(tmp_path / "jax") == _layer_files(tmp_path / "port")

  JaxLocalTaskQueue(parallel=1, progress=False).insert(
    jax_tc.create_downsampling_tasks(paths["jax"], mip=0, num_mips=5)
  )
  tasks = create_downsampling_tasks(paths["port"], mip=0, num_mips=5)
  assert len(tasks) == 1  # one task: its cutout is the whole layer
  method = pooling.method_for_layer(Volume(paths["port"]).layer_type)
  factors = pooling._normalize_factors((2, 2, 1), 5)
  assert _route(factors, method, False, pooling._work_array(data, method)) == (
    LAYERS[kind][2], 5
  )
  LocalTaskQueue(parallel=1).insert(tasks)

  prov = json.loads((tmp_path / "port" / "provenance").read_text())
  assert prov["processing"][-1]["method"]["task"] == "DownsampleTask"
  ref, out = _layer_files(tmp_path / "jax"), _layer_files(tmp_path / "port")
  assert len(ref["info"]["scales"]) == 6
  assert out["info"] == ref["info"]
  assert sorted(out) == sorted(ref)
  for key in ref:
    assert out[key] == ref[key], key


@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_port_runs_payloads_the_reference_serialized(tmp_path, kind):
  _, paths = _make_layers(tmp_path, kind, ["jax", "jax_payloads"])
  JaxLocalTaskQueue(parallel=1, progress=False).insert(
    jax_tc.create_downsampling_tasks(paths["jax"], mip=0, num_mips=5)
  )
  payloads = [
    jax_serialize(t)
    for t in jax_tc.create_downsampling_tasks(paths["jax_payloads"], mip=0, num_mips=5)
  ]
  assert all('"module": "igneous_tpu.tasks.image"' in p for p in payloads)
  LocalTaskQueue(parallel=1).insert(payloads)

  ref = _layer_files(tmp_path / "jax")
  out = _layer_files(tmp_path / "jax_payloads")
  assert out["info"] == ref["info"]
  assert sorted(out) == sorted(ref)
  for key in ref:
    assert out[key] == ref[key], key
